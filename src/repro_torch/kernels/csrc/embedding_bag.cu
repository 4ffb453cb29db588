// Embedding bag forward (B5) and its COO-row backward (B6), for Hopper
// (sm_90a), each as one grouped launch over the F fields of one lookup.
//
// Replaces: repro/kernels/embedding_bag.py:_sum_kernel / _max_kernel (the
// Pallas TPU forward, with the mean divide and the empty-bag rule of its
// _fwd_call) and :_bwd_coo_kernel (the COO contribution rows, with the
// sentinel ids of embedding_bag_coo_grad). The reference launches them once
// per field (repro/models/dlrm.py:_field_lookup loops over the fields).
//
//   B5:  out[b, f] = pool_{l < len[b, f]} table_f[clip(ids[b, f, l], 0,
//        V_f - 1)];  pool = sum | mean (sum / max(len, 1)) | max (empty
//        bag -> 0)
//   B6:  rows[f, b*L + l] = g[b, f] * w(b, f, l),  w = [l < len] or
//        [l < len] / max(len, 1) in fp32;  out_ids[f, b*L + l] = clip(ids)
//        or V_f (invalid slot)
//
// What bounds them on this card: bytes, and at the models' shapes the
// launch. dlrm-mlperf pools 26 one-hot fields of D 128: at B 512 a field's
// rows are 0.26 MB (0.08 us at 3.35 TB/s), far below one launch's few
// microseconds, so one launch per field (26 a forward, 26 a backward, each
// after two int32 copies of its strided ids and lengths) spent its time on
// launches. The design:
//  - One launch covers a group: the fields of one lookup, sharing B, L, D,
//    dtype and pooling. The group's table pointers, vocab sizes and the
//    strides of ids (B, F, L) and lengths (B, F) travel in a struct passed
//    by value as a kernel parameter: no copy to the device, no
//    synchronisation. ids and lengths are read through their strides, so a
//    field's slice needs no copy, and B5 writes the (B, F, D) output the
//    model consumes, so no stack follows.
//  - Every launch adds a bag's rows in slot order l = 0, 1, ... in fp32
//    with one rounding each, so every output equals that of a plain
//    per-slot loop (and of the per-field kernel this replaces) bit for
//    bit, whatever the launch. The host picks the launch from L, D, the
//    dtype and the alignment (fwd_plan); none changes a result.
//  - Short bags (L <= 4: dlrm's one-hot fields), and long ones whose rows
//    are under 128 bytes: grid (bag blocks, F), blocks of four warps, a bag
//    to a power-of-two group of lanes of one warp (all 32 at D 128 fp32):
//    lane c owns columns [c*VEC, (c+1)*VEC) and reads a row's share with
//    one 16-byte ld.global.nc.v4 (4 fp32 or 8 bf16). A round loads the rows
//    of U slots (all of a short bag, else 8) before adding any of them, and
//    reads the next U ids while those rows are in flight.
//  - Long bags of rows of 128 bytes or more (LSR's history: 64 slots of
//    D 64; the deep kernel): grid (B, F), one warp a bag, a block each.
//    At LSR's 32 to 192 bags a launch is bound by rounds of load latency
//    on few SMs, not by bytes, so a round covers 64 slots and every row of
//    it is in flight at once. Each lane loads one id of each 32
//    (coalesced), the warp shares them through shared memory and copies
//    the round's rows into shared memory with 16-byte cp.async,
//    32 / (2*BYTES) rows an instruction: copies hold no registers, so the
//    depth does not rest on the registers the compiler allots (with the
//    rows held in registers, how many loads stayed in flight changed from
//    one small edit of the source to the next). Lane c then adds columns
//    [c*VEC, (c+1)*VEC) of each row from shared memory, BYTES = VEC*size
//    the narrowest of 4, 8 and 16 that covers a row in one pass of the
//    warp (D 64: 4 bytes of bf16, 8 of fp32).
//  - B6 gives a slot row a lane group as B5's short path does and writes
//    it with 16-byte stores.
//  - The 16-byte (and deep) paths run when D is a multiple of the 16-byte
//    vector and every table and the output (B6: g and the rows) are
//    16-byte aligned; otherwise one element a lane, 8 rows ahead (B5) in
//    blocks of four warps.
//
// Numerics follow the reference's op order: the sum is rounded to the
// table's dtype, then divided by max(len, 1) in that dtype; max starts at
// the dtype's lowest finite value and propagates NaN, as jnp.maximum does.
// fp32 and bf16 tables (bf16 accumulates in fp32 and rounds once).
//
// Interface: plain C, loaded with ctypes. The host functions launch on the
// caller's stream, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxFields = 64;   // fields in one launch (dlrm: 13 a side)
constexpr int kThreads = 128;    // threads a block (four warps)
constexpr int kShortBag = 4;     // bags up to this L load all rows at once
constexpr int kLongBag = 8;      // longer bags: rows loaded ahead of adds
constexpr int kDeepBag = 64;     // the deep kernel's slots a round
constexpr int kDeepRow = 128;    // bytes of a row from which it runs

enum Pooling { kSum = 0, kMean = 1, kMax = 2 };

// One group of fields; a kernel parameter, passed by value.
struct BagGroup {
  const void* tables[kMaxFields];  // B6 leaves them null
  int vocab[kMaxFields];
  long long ids_stride[3];         // ids (B, F, L), in elements
  long long len_stride[2];         // lengths (B, F), in elements
  int B, L, D;
  int lanes;                       // lanes sharing a bag or a slot row
};
// with the kernels' other parameters (at most five pointers), under the
// 4 KB a launch's parameters may take
static_assert(sizeof(BagGroup) + 8 * sizeof(void*) <= 4096,
              "the group descriptor outgrew the kernel parameter space");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision, as fp32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// the dtype's lowest finite value (jnp.finfo(dtype).min), as fp32 bits
template <typename T>
__device__ __forceinline__ float lowest();
template <>
__device__ __forceinline__ float lowest<float>() {
  return __uint_as_float(0xff7fffffu);
}
template <>
__device__ __forceinline__ float lowest<__nv_bfloat16>() {
  return __uint_as_float(0xff7f0000u);
}

__device__ __forceinline__ int clip_id(int id, int V) {
  return min(max(id, 0), V - 1);
}

// VEC consecutive elements of T, loaded (read-only path) or stored as fp32
// values; VEC * sizeof(T) is 16 bytes or one element (and 8 or 4 bytes for
// the deep kernel's stores)
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    x[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *p = x[0];
  }
};

template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i],
                                                             x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

// 8 and 4 bytes of bf16, stored
template <int VEC>
struct Vec<__nv_bfloat16, VEC> {
  static_assert(VEC == 4 || VEC == 2, "8 or 4 bytes of bf16");
  using Word = typename std::conditional<VEC == 4, uint2, unsigned>::type;
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    Word v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<Word*>(p) = v;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    x[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    *p = __float2bfloat16(x[0]);
  }
};

// B5: grid (bag blocks, F); a bag per lane group, columns per lane
// (U: the slots whose rows are loaded ahead of their adds; SHORT: the
// host launches this template only for L <= U)
template <typename T, int VEC, int POOL, int U, bool SHORT>
__global__ void __launch_bounds__(kThreads)
embedding_bag_fwd_grouped_kernel(const BagGroup grp,
                                 const int32_t* __restrict__ ids,
                                 const int32_t* __restrict__ lengths,
                                 T* __restrict__ out) {
  const int lanes = grp.lanes;
  const int f = blockIdx.y;
  const int b = blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  if (b >= grp.B) return;
  const int sub = threadIdx.x & (lanes - 1);
  const T* table = static_cast<const T*>(grp.tables[f]);
  const int V = grp.vocab[f];
  const int D = grp.D;
  const int len = lengths[b * grp.len_stride[0] + f * grp.len_stride[1]];
  const int n = min(max(len, 0), grp.L);
  const int32_t* bag = ids + b * grp.ids_stride[0] + f * grp.ids_stride[1];
  const long long sl = grp.ids_stride[2];
  T* o = out + ((long long)b * gridDim.y + f) * D;
  for (int c = sub * VEC; c < D; c += lanes * VEC) {
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = POOL == kMax ? lowest<T>() : 0.0f;
    // A long bag reads its ids at slot min(l, n - 1): every id load is
    // unconditional, so the U of a round issue back to back (a branch
    // around each made them wait on one another). A short bag is one
    // round: ids read for slots < n only, no next round to read ahead
    // for. Slots past n are not added.
    if (n > 0) {
      const int last = n - 1;
      int id[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (SHORT)
          id[j] = j < n ? clip_id(bag[j * sl], V) : 0;
        else
          id[j] = clip_id(bag[min(j, last) * sl], V);
      }
      for (int base = 0; base < n; base += U) {
        float x[U][VEC];
#pragma unroll
        for (int j = 0; j < U; ++j)
          if (base + j < n)
            Vec<T, VEC>::load(table + (long long)id[j] * D + c, x[j]);
        if (!SHORT) {  // the next round's ids, while rows fly
#pragma unroll
          for (int j = 0; j < U; ++j)
            id[j] = clip_id(bag[min(base + U + j, last) * sl], V);
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {  // in slot order
          if (base + j < n) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const float e = x[j][v];
              if (POOL == kMax) {
                acc[v] = (e > acc[v] || isnan(e)) ? e : acc[v];
              } else {
                acc[v] += e;
              }
            }
          }
        }
      }
    }
    float r[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      if (POOL == kMax) {
        r[v] = round_to<T>(len > 0 ? acc[v] : 0.0f);
      } else {
        r[v] = round_to<T>(acc[v]);
        if (POOL == kMean)
          r[v] = round_to<T>(r[v] / round_to<T>((float)max(len, 1)));
      }
    }
    Vec<T, VEC>::store(o + c, r);
  }
}

// B5's deep kernel: a block is one warp and one bag; a round stages the
// rows of kDeepBag slots in shared memory (at most 32 KB)
constexpr int kDeepThreads = 32;

template <int BYTES>
struct Words;
template <>
struct Words<4> {
  using type = unsigned;
};
template <>
struct Words<8> {
  using type = uint2;
};
template <>
struct Words<16> {
  using type = uint4;
};

// an asynchronous 16-byte copy from global to shared memory (L2 only)
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(gmem));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a lane's VEC elements of T, staged in shared memory, as fp32 (bf16 to
// fp32 is exact: the 16 bits on top of 16 zero bits)
template <typename T, int VEC>
__device__ __forceinline__ void widen(const unsigned char* p, float* x) {
  constexpr int kWords = VEC * (int)sizeof(T) / 4;
  using W = typename Words<4 * kWords>::type;
  const W w = *reinterpret_cast<const W*>(p);
  const unsigned* u = reinterpret_cast<const unsigned*>(&w);
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if (sizeof(T) == 4) {
      x[i] = __uint_as_float(u[i]);
    } else {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// B5 on a small grid (fwd_plan's deep path): grid (B, F), one warp a bag,
// lane s owning columns c0 + [s*VEC, (s+1)*VEC) of each pass over a slab
// of 32*VEC columns (32*BYTES bytes of a row). A round covers U slots:
//  - each lane loads the ids of slots base + s, base + s + 32 (coalesced,
//    clamped at L - 1, none waiting on the length) into shared memory;
//  - the warp copies the round's slabs into shared memory with 16-byte
//    asynchronous copies, 32 / (2*BYTES) rows an instruction (a D-64 bf16
//    row is 8 lanes' copy): every row of the round is in flight at once,
//    whatever registers the compiler gives the kernel;
//  - each lane adds its columns of the U rows in slot order.
// The next round's ids load while the rows fly. A lane past D adds what
// it finds and stores nothing.
template <typename T, int VEC, int POOL>
__global__ void __launch_bounds__(kDeepThreads)
embedding_bag_fwd_deep_kernel(const BagGroup grp,
                              const int32_t* __restrict__ ids,
                              const int32_t* __restrict__ lengths,
                              T* __restrict__ out) {
  constexpr int U = kDeepBag;
  constexpr int K = (U + 31) / 32;   // ids a lane loads a round
  constexpr int BYTES = VEC * (int)sizeof(T);
  constexpr int SLAB = 32 * BYTES;   // bytes of a row a pass covers
  constexpr int CHUNKS = SLAB / 16;  // 16-byte copies a slab
  constexpr int ROWS = 32 / CHUNKS;  // rows a copy instruction covers
  __shared__ __align__(16) unsigned char rows[U][SLAB];
  __shared__ __align__(16) int slot_ids[K * 32];
  const int f = blockIdx.y;
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int chunk = s % CHUNKS;      // this lane's copy of a slab ...
  const int first = s / CHUNKS;      // ... in rows first, first + ROWS, ...
  const T* table = static_cast<const T*>(grp.tables[f]);
  const int V = grp.vocab[f];
  const int D = grp.D;
  const int L = grp.L;
  const int len = lengths[b * grp.len_stride[0] + f * grp.len_stride[1]];
  const int n = min(max(len, 0), L);
  const int32_t* bag = ids + b * grp.ids_stride[0] + f * grp.ids_stride[1];
  const long long sl = grp.ids_stride[2];
  const unsigned row_bytes = (unsigned)D * sizeof(T);
  T* o = out + ((long long)b * gridDim.y + f) * D;
  for (int c0 = 0; c0 < D; c0 += 32 * VEC) {
    const unsigned at = c0 * (unsigned)sizeof(T) + 16 * chunk;
    const bool copies = at < row_bytes;  // a chunk inside the row
    const char* src = reinterpret_cast<const char*>(table) + at;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = POOL == kMax ? lowest<T>() : 0.0f;
    int next[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      next[k] = clip_id(bag[min(s + 32 * k, L - 1) * sl], V);
    for (int base = 0; base < n; base += U) {
      const int cnt = min(n - base, U);
      __syncwarp();                 // every lane done with the last round
#pragma unroll
      for (int k = 0; k < K; ++k) {
        slot_ids[32 * k + s] = next[k];
        // the next round's ids, while this round's rows fly
        next[k] = clip_id(bag[min(base + U + s + 32 * k, L - 1) * sl], V);
      }
      __syncwarp();
#pragma unroll
      for (int j = first; j < U; j += ROWS)
        if (copies && j < cnt)
          copy16_async(rows[j] + 16 * chunk,
                       src + (unsigned long long)(unsigned)slot_ids[j] *
                                 row_bytes);
      copies_done();
      __syncwarp();                 // the other lanes' copies landed
#pragma unroll
      for (int j = 0; j < U; ++j) {  // in slot order
        if (j < cnt) {
          float e[VEC];
          widen<T, VEC>(rows[j] + s * BYTES, e);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            if (POOL == kMax) {
              acc[v] = (e[v] > acc[v] || isnan(e[v])) ? e[v] : acc[v];
            } else {
              acc[v] += e[v];
            }
          }
        }
      }
    }
    const int c = c0 + s * VEC;
    if (c < D) {
      float r[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (POOL == kMax) {
          r[v] = round_to<T>(len > 0 ? acc[v] : 0.0f);
        } else {
          r[v] = round_to<T>(acc[v]);
          if (POOL == kMean)
            r[v] = round_to<T>(r[v] / round_to<T>((float)max(len, 1)));
        }
      }
      Vec<T, VEC>::store(o + c, r);
    }
  }
}

// B6: grid (slot-row blocks, F); a slot row per lane group
template <typename T, int VEC, bool MEAN>
__global__ void __launch_bounds__(kThreads)
embedding_bag_bwd_coo_grouped_kernel(const BagGroup grp,
                                     const T* __restrict__ g,
                                     const int32_t* __restrict__ ids,
                                     const int32_t* __restrict__ lengths,
                                     T* __restrict__ rows,
                                     int32_t* __restrict__ out_ids) {
  const int lanes = grp.lanes;
  const int f = blockIdx.y;
  const long long n_slots = (long long)grp.B * grp.L;
  const long long slot = (long long)blockIdx.x * (blockDim.x / lanes) +
                         threadIdx.x / lanes;
  if (slot >= n_slots) return;
  const int sub = threadIdx.x & (lanes - 1);
  const int b = (int)(slot / grp.L);
  const int l = (int)(slot - (long long)b * grp.L);
  const int len = lengths[b * grp.len_stride[0] + f * grp.len_stride[1]];
  const bool valid = l < len;
  float w = valid ? 1.0f : 0.0f;
  if (MEAN) w = w / (float)max(len, 1);
  const int D = grp.D;
  const T* src = g + ((long long)b * gridDim.y + f) * D;
  T* dst = rows + ((long long)f * n_slots + slot) * D;
  for (int c = sub * VEC; c < D; c += lanes * VEC) {
    float x[VEC];
    Vec<T, VEC>::load(src + c, x);
#pragma unroll
    for (int v = 0; v < VEC; ++v) x[v] = round_to<T>(x[v] * w);
    Vec<T, VEC>::store(dst + c, x);
  }
  if (sub == 0) {
    const int V = grp.vocab[f];
    out_ids[f * n_slots + slot] =
        valid ? clip_id(ids[b * grp.ids_stride[0] + f * grp.ids_stride[1] +
                            l * grp.ids_stride[2]],
                        V)
              : V;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// lanes for `chunks` column chunks: the next power of two, at most a warp
int lanes_for(int chunks) {
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  return lanes;
}

// The grid for `items` bags or slot rows a field, grp.lanes lanes an item
// and `threads` threads a block; false if it does not fit.
bool launch_grid(const BagGroup& grp, long long items, int n_fields,
                 int threads, dim3* grid) {
  const long long per_block = threads / grp.lanes;
  const long long blocks = (items + per_block - 1) / per_block;
  if (blocks > INT_MAX) return false;
  *grid = dim3((unsigned)blocks, (unsigned)n_fields);
  return true;
}

// B5's launch: the bytes a lane loads of a row (the deep kernel: copies a
// pass of the warp's, 32 lanes of them), depth (kShort: all of a bag's
// rows in one round; kLong: 8 rows ahead; kDeep: the deep kernel),
// threads a block and lanes a bag.
enum Depth { kShort = 0, kLong = 1, kDeep = 2 };
struct FwdPlan {
  int bytes, depth, threads, lanes;
};

constexpr int slots_ahead(int depth) {
  return depth == kShort ? kShortBag : depth == kLong ? kLongBag : kDeepBag;
}

// The launch for bags of L slots and D elements of esz bytes; widest: 16
// where the 16-byte path is open, else esz. Neither B nor F enters: the
// deep kernel was as fast or faster than the 16-byte path from 32 to 8,192
// bags (scripts/bag_ablations.py).
FwdPlan fwd_plan(int L, int D, int esz, int widest) {
  const int row = D * esz;
  if (L <= kShortBag || widest != 16 || row < kDeepRow)
    return FwdPlan{widest, L <= kShortBag ? kShort : kLong, kThreads,
                   lanes_for(row / widest)};
  // the narrowest of 16, 8 and 4 bytes a lane that covers a row in one
  // pass of the warp
  int bytes = 16;
  while (bytes > 4 && row / (bytes / 2) <= 32) bytes /= 2;
  return FwdPlan{bytes, kDeep, kDeepThreads, kDeepThreads};
}

template <typename T, int VEC, int DEPTH, int POOL>
void launch_fwd_kernel(const BagGroup& grp, dim3 grid, int threads,
                       const int32_t* ids, const int32_t* lengths, T* out,
                       cudaStream_t stream) {
  if constexpr (DEPTH == kDeep)
    embedding_bag_fwd_deep_kernel<T, VEC, POOL>
        <<<grid, threads, 0, stream>>>(grp, ids, lengths, out);
  else
    embedding_bag_fwd_grouped_kernel<T, VEC, POOL, slots_ahead(DEPTH),
                                     DEPTH == kShort>
        <<<grid, threads, 0, stream>>>(grp, ids, lengths, out);
}

template <typename T, int VEC, int DEPTH>
cudaError_t launch_fwd(BagGroup grp, const FwdPlan& plan, int n_fields,
                       const int32_t* ids, const int32_t* lengths, T* out,
                       int pooling, cudaStream_t stream) {
  grp.lanes = plan.lanes;
  dim3 grid;
  if (!launch_grid(grp, grp.B, n_fields, plan.threads, &grid))
    return cudaErrorInvalidConfiguration;
  if (pooling == kSum) {
    launch_fwd_kernel<T, VEC, DEPTH, kSum>(grp, grid, plan.threads, ids,
                                           lengths, out, stream);
  } else if (pooling == kMean) {
    launch_fwd_kernel<T, VEC, DEPTH, kMean>(grp, grid, plan.threads, ids,
                                            lengths, out, stream);
  } else if (pooling == kMax) {
    launch_fwd_kernel<T, VEC, DEPTH, kMax>(grp, grid, plan.threads, ids,
                                           lengths, out, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the template of a plan: 16-byte or one-element loads at the short and
// long depths, 16, 8 or 4 bytes at the deep one
template <typename T>
cudaError_t launch_fwd_plan(const BagGroup& grp, const FwdPlan& plan,
                            int n_fields, const int32_t* ids,
                            const int32_t* lengths, T* out, int pooling,
                            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const auto args = [&](auto launch) {
    return launch(grp, plan, n_fields, ids, lengths, out, pooling, stream);
  };
  if (plan.depth == kDeep) {
    if (plan.bytes == 16) return args(launch_fwd<T, kVec, kDeep>);
    if (plan.bytes == 8) return args(launch_fwd<T, kVec / 2, kDeep>);
    if (plan.bytes == 4) return args(launch_fwd<T, kVec / 4, kDeep>);
    return cudaErrorInvalidValue;
  }
  if (plan.bytes == 16)
    return plan.depth == kShort ? args(launch_fwd<T, kVec, kShort>)
                                : args(launch_fwd<T, kVec, kLong>);
  return plan.depth == kShort ? args(launch_fwd<T, 1, kShort>)
                              : args(launch_fwd<T, 1, kLong>);
}

template <typename T>
bool fwd_vec16(const BagGroup& grp, int n_fields, const void* out) {
  bool vec = grp.D % (16 / sizeof(T)) == 0 && aligned16(out);
  for (int f = 0; f < n_fields; ++f) vec = vec && aligned16(grp.tables[f]);
  return vec;
}

template <typename T>
cudaError_t fwd_dtype(const BagGroup& grp, int n_fields, const void* ids,
                      const void* lengths, void* out, int pooling,
                      cudaStream_t stream) {
  const int esz = (int)sizeof(T);
  const FwdPlan plan = fwd_plan(grp.L, grp.D, esz,
                                fwd_vec16<T>(grp, n_fields, out) ? 16 : esz);
  return launch_fwd_plan<T>(grp, plan, n_fields,
                            static_cast<const int32_t*>(ids),
                            static_cast<const int32_t*>(lengths),
                            static_cast<T*>(out), pooling, stream);
}

template <typename T, int VEC>
cudaError_t launch_bwd(BagGroup grp, int n_fields, const T* g,
                       const int32_t* ids, const int32_t* lengths, T* rows,
                       int32_t* out_ids, int mean, cudaStream_t stream) {
  grp.lanes = lanes_for(grp.D / VEC);
  dim3 grid;
  if (!launch_grid(grp, (long long)grp.B * grp.L, n_fields, kThreads, &grid))
    return cudaErrorInvalidConfiguration;
  if (mean) {
    embedding_bag_bwd_coo_grouped_kernel<T, VEC, true>
        <<<grid, kThreads, 0, stream>>>(grp, g, ids, lengths, rows, out_ids);
  } else {
    embedding_bag_bwd_coo_grouped_kernel<T, VEC, false>
        <<<grid, kThreads, 0, stream>>>(grp, g, ids, lengths, rows, out_ids);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dtype(const BagGroup& grp, int n_fields, const void* g,
                      const void* ids, const void* lengths, void* rows,
                      void* out_ids, int mean, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = grp.D % kVec == 0 && aligned16(g) && aligned16(rows);
  const T* gg = static_cast<const T*>(g);
  const int32_t* i = static_cast<const int32_t*>(ids);
  const int32_t* n = static_cast<const int32_t*>(lengths);
  T* r = static_cast<T*>(rows);
  int32_t* o = static_cast<int32_t*>(out_ids);
  return vec ? launch_bwd<T, kVec>(grp, n_fields, gg, i, n, r, o, mean,
                                   stream)
             : launch_bwd<T, 1>(grp, n_fields, gg, i, n, r, o, mean, stream);
}

// The descriptor of a group, or false for a field count or vocab size the
// kernels do not take.
bool make_group(BagGroup* grp, const void* const* tables, const int* vocabs,
                int n_fields, const long long* ids_strides,
                const long long* len_strides, int B, int L, int D) {
  if (n_fields < 1 || n_fields > kMaxFields || B < 0 || L < 0 || D < 0)
    return false;
  *grp = BagGroup{};
  for (int f = 0; f < n_fields; ++f) {
    if (vocabs[f] < 1) return false;
    grp->tables[f] = tables ? tables[f] : nullptr;
    grp->vocab[f] = vocabs[f];
  }
  for (int k = 0; k < 3; ++k) grp->ids_stride[k] = ids_strides[k];
  for (int k = 0; k < 2; ++k) grp->len_stride[k] = len_strides[k];
  grp->B = B;
  grp->L = L;
  grp->D = D;
  return true;
}

}  // namespace

extern "C" {

// B5 over a group. tables: n_fields pointers to (V_f, D) tables of one
// dtype; vocabs: the n_fields V_f; ids: int32 (B, n_fields, L) and
// lengths: int32 (B, n_fields), each read through its element strides;
// out: contiguous (B, n_fields, D) of the tables' dtype. pooling: 0 sum,
// 1 mean, 2 max; dtype: 0 fp32, 1 bf16. All on the current device.
int embedding_bag_fwd_grouped(const void* const* tables, const int* vocabs,
                              int n_fields, const void* ids,
                              const long long* ids_strides,
                              const void* lengths,
                              const long long* len_strides, void* out, int B,
                              int L, int D, int pooling, int dtype,
                              void* stream) {
  BagGroup grp;
  if (!make_group(&grp, tables, vocabs, n_fields, ids_strides, len_strides,
                  B, L, D))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)fwd_dtype<float>(grp, n_fields, ids, lengths, out, pooling, s);
  if (dtype == 1)
    return (int)fwd_dtype<__nv_bfloat16>(grp, n_fields, ids, lengths, out,
                                         pooling, s);
  return (int)cudaErrorInvalidValue;
}

// The launch B5 makes for a group of n_fields fields, B bags, L slots and
// D columns of dtype (0 fp32, 1 bf16) whose tables and output are 16-byte
// aligned (aligned != 0) or not: out[0..4] = the elements a lane adds of
// a row (VEC), the rows a round loads before adding them (U), threads a
// block, blocks, lanes a bag.
int embedding_bag_fwd_plan(int n_fields, int B, int L, int D, int dtype,
                           int aligned, int* out) {
  if (n_fields < 1 || B < 1 || L < 0 || D < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int esz = dtype == 0 ? 4 : 2;
  const bool vec = aligned && D % (16 / esz) == 0;
  const FwdPlan p = fwd_plan(L, D, esz, vec ? 16 : esz);
  const int per_block = p.threads / p.lanes;
  out[0] = p.bytes / esz;
  out[1] = slots_ahead(p.depth);
  out[2] = p.threads;
  out[3] = (B + per_block - 1) / per_block * n_fields;
  out[4] = p.lanes;
  return (int)cudaSuccess;
}

// B6 over a group. g: contiguous (B, n_fields, D), the grouped output's
// gradient; ids, lengths and vocabs as for B5; rows: contiguous
// (n_fields, B*L, D) of g's dtype; out_ids: contiguous (n_fields, B*L)
// int32. mean: 0 sum weights, 1 mean weights.
int embedding_bag_bwd_coo_grouped(const void* g, const int* vocabs,
                                  int n_fields, const void* ids,
                                  const long long* ids_strides,
                                  const void* lengths,
                                  const long long* len_strides, void* rows,
                                  void* out_ids, int B, int L, int D,
                                  int mean, int dtype, void* stream) {
  BagGroup grp;
  if (!make_group(&grp, nullptr, vocabs, n_fields, ids_strides, len_strides,
                  B, L, D))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * L == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)bwd_dtype<float>(grp, n_fields, g, ids, lengths, rows,
                                 out_ids, mean, s);
  if (dtype == 1)
    return (int)bwd_dtype<__nv_bfloat16>(grp, n_fields, g, ids, lengths,
                                         rows, out_ids, mean, s);
  return (int)cudaErrorInvalidValue;
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
