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
//  - Grid (bag blocks, F). A bag (b, f) belongs to a power-of-two group of
//    lanes of one warp (all 32 at D 128 fp32): lane c owns columns
//    [c*VEC, (c+1)*VEC) and reads a row's share with one 16-byte
//    ld.global.nc.v4 (4 fp32 or 8 bf16). A round loads the rows of U slots
//    (all of a bag up to L 4, else 8) before adding any of them, and reads
//    the next U ids while those rows are in flight; the adds run in slot
//    order l = 0, 1, ... in fp32 with one rounding each, so every output
//    equals that of a plain per-slot loop (and of the per-field kernel this
//    replaces) bit for bit. B6 gives a slot row the same lane
//    group and writes it with 16-byte stores.
//  - The 16-byte path runs when D is a multiple of the vector width and
//    every table and the output (B6: g and the rows) are 16-byte aligned;
//    otherwise one element a lane. The choice is per launch and does not
//    change any result.
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

namespace {

constexpr int kMaxFields = 64;   // fields in one launch (dlrm: 13 a side)
constexpr int kThreads = 128;    // threads a block (four warps)
constexpr int kShortBag = 4;     // bags up to this L load all rows at once
constexpr int kLongBag = 8;      // longer bags: rows loaded ahead of adds

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
// values; VEC * sizeof(T) is 16 bytes or one element
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
// and kThreads threads a block; false if it does not fit.
bool launch_grid(const BagGroup& grp, long long items, int n_fields,
                 dim3* grid) {
  const long long per_block = kThreads / grp.lanes;
  const long long blocks = (items + per_block - 1) / per_block;
  if (blocks > INT_MAX) return false;
  *grid = dim3((unsigned)blocks, (unsigned)n_fields);
  return true;
}

template <typename T, int VEC, int U, bool SHORT>
cudaError_t launch_fwd(BagGroup grp, int n_fields, const int32_t* ids,
                       const int32_t* lengths, T* out, int pooling,
                       cudaStream_t stream) {
  grp.lanes = lanes_for(grp.D / VEC);
  dim3 grid;
  if (!launch_grid(grp, grp.B, n_fields, &grid))
    return cudaErrorInvalidConfiguration;
  if (pooling == kSum) {
    embedding_bag_fwd_grouped_kernel<T, VEC, kSum, U, SHORT>
        <<<grid, kThreads, 0, stream>>>(grp, ids, lengths, out);
  } else if (pooling == kMean) {
    embedding_bag_fwd_grouped_kernel<T, VEC, kMean, U, SHORT>
        <<<grid, kThreads, 0, stream>>>(grp, ids, lengths, out);
  } else if (pooling == kMax) {
    embedding_bag_fwd_grouped_kernel<T, VEC, kMax, U, SHORT>
        <<<grid, kThreads, 0, stream>>>(grp, ids, lengths, out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Short bags (dlrm's one- and two-hot fields) load all their rows at once
// with few registers, so more warps fit an SM; long ones (LSR's history of
// 64) load 8 rows ahead of their adds. scripts/bag_ablations.py times the
// other depths at both.
template <typename T, int VEC>
cudaError_t launch_fwd_depth(const BagGroup& grp, int n_fields,
                             const int32_t* ids, const int32_t* lengths,
                             T* out, int pooling, cudaStream_t stream) {
  if (grp.L <= kShortBag)
    return launch_fwd<T, VEC, kShortBag, true>(grp, n_fields, ids, lengths,
                                               out, pooling, stream);
  return launch_fwd<T, VEC, kLongBag, false>(grp, n_fields, ids, lengths,
                                             out, pooling, stream);
}

template <typename T>
cudaError_t fwd_dtype(const BagGroup& grp, int n_fields, const void* ids,
                      const void* lengths, void* out, int pooling,
                      cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec = grp.D % kVec == 0 && aligned16(out);
  for (int f = 0; f < n_fields; ++f) vec = vec && aligned16(grp.tables[f]);
  const int32_t* i = static_cast<const int32_t*>(ids);
  const int32_t* n = static_cast<const int32_t*>(lengths);
  T* o = static_cast<T*>(out);
  return vec ? launch_fwd_depth<T, kVec>(grp, n_fields, i, n, o, pooling,
                                         stream)
             : launch_fwd_depth<T, 1>(grp, n_fields, i, n, o, pooling,
                                      stream);
}

template <typename T, int VEC>
cudaError_t launch_bwd(BagGroup grp, int n_fields, const T* g,
                       const int32_t* ids, const int32_t* lengths, T* rows,
                       int32_t* out_ids, int mean, cudaStream_t stream) {
  grp.lanes = lanes_for(grp.D / VEC);
  dim3 grid;
  if (!launch_grid(grp, (long long)grp.B * grp.L, n_fields, &grid))
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
