// The segmented merge: SparseRows.to_dense on the card, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference densifies a COO row gradient with
// one XLA scatter-add (repro/embeddings/sparse.py, SparseRows.to_dense). On
// the card the port first took aten's sorted index_put_(accumulate=True)
// for inputs past 3,072 ids, and that is what this kernel is added for:
// recommendation ids are skewed. index_put_ gives every run of one id to one
// warp, which adds the run's rows one after another, each add waiting on a
// load. Under Zipf 1.05 one id of a 65,536-entry batch owns up to ~13,800
// entries, so the longest runs set the time: ~0.5 us a row, 55 ms of a dlrm
// training step's 95 ms on the card, where the bytes (rows read once, the
// output written once) take ~0.25 ms at 3.35 TB/s.
//
//   out[v] = sum of rows[i] over ids[i] == v,   0 <= v < vocab
//
// An id outside [0, vocab) drops (ids == vocab is the padding sentinel).
//
// What bounds it once the runs are cut: bytes. Design: the wrapper sorts the
// ids stably (torch.sort, keeping each entry's position); the host function
// zero-fills out (cudaMemsetAsync: one runtime call, where a torch fill is a
// dispatched op the host pays more for) and launches two passes.
//  * Pass 1: the sorted stream is cut into chunks of kChunk entries, one
//    warp a chunk and column tile (32 lanes x VEC elements of a row). A lane
//    holds its VEC columns of a sum in fp32. The warp loads kAhead rows
//    before it adds any of them, so the loads overlap. A run that starts and
//    ends inside the chunk is written straight to its output row, rounded
//    once: its only write. A run that crosses a chunk edge leaves the
//    chunk's partial sum in fp32 scratch, at most two a chunk: the head
//    slot holds the chunk's first run if it began in an earlier chunk (the
//    whole chunk, if the run also goes on past it), the tail slot the
//    chunk's last run if it began in the chunk and goes on into the next.
//  * Pass 2: the chunk in which a crossing run begins owns it. Its warp
//    finds the chunk where the run ends (a ballot over 32 chunk edges a
//    step), adds the owner's tail and then each later chunk's head in chunk
//    order, kAhead partials loaded at a time, and writes the row once,
//    rounded once to the rows' dtype.
//  * Every sum runs in an order fixed by the stable sort and kChunk, so two
//    calls give the same bits. No atomics. A warp of pass 1 adds kChunk rows
//    whatever the skew; a run of 13,800 rows costs pass 2 ~216 partials.
//  * 16-byte loads and stores (VEC = 4 fp32 or 8 bf16 a lane) where W is a
//    multiple of VEC and rows and out are 16-byte aligned; one element a lane
//    otherwise. The wrapper picks VEC (kernels/segment_merge.py,
//    lane_width); the host function refuses a VEC the operands do not allow.
//  * Rows of ids outside the table are never loaded.
//
// Takes fp32 and bf16 rows of any width W, n < 2^31 entries. Interface: plain
// C, loaded with ctypes. The host function launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kChunk = 64;   // sorted entries a warp sums in pass 1
constexpr int kAhead = 8;    // rows (pass 1) or partials (pass 2) in flight
constexpr int kWarps = 8;    // warps a block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk % 32 == 0 && kChunk % kAhead == 0,
              "a chunk is whole lanes and whole rounds of loads");

__device__ __forceinline__ bool in_table(int id, int vocab) {
  return (unsigned)id < (unsigned)vocab;
}

__device__ __forceinline__ unsigned word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

// the value lane j % 32 holds for entry j of a chunk
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[kChunk / 32], int j) {
  V v = a[0];
#pragma unroll
  for (int h = 1; h < kChunk / 32; ++h)
    if (j >= h * 32) v = a[h];
  return v;
}

// a lane's VEC elements of a row as loaded: 16 bytes, or one element
template <typename T, int VEC>
struct Bits {
  uint4 b = make_uint4(0, 0, 0, 0);
};
template <typename T>
struct Bits<T, 1> {
  T b = T();
};

template <typename T, int VEC>
__device__ __forceinline__ Bits<T, VEC> load_bits(const T* p) {
  Bits<T, VEC> r;
  if constexpr (VEC == 1)
    r.b = p[0];
  else
    r.b = __ldg(reinterpret_cast<const uint4*>(p));
  return r;
}

// element i of a lane's share, in fp32
template <typename T, int VEC>
__device__ __forceinline__ float element(const Bits<T, VEC>& r, int i) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4)
      return r.b;
    else
      return __bfloat162float(r.b);
  } else if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(r.b, i));
  } else {
    const unsigned w = word(r.b, i / 2);
    return __uint_as_float(i % 2 == 0 ? w << 16 : w & 0xffff0000u);
  }
}

// a sum rounded once to T, stored
template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p, const float (&a)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4)
      p[0] = a[0];
    else
      p[0] = __float2bfloat16(a[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(a[2 * k])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16(a[2 * k + 1]))
              << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// a partial sum in fp32 scratch
template <int VEC>
__device__ __forceinline__ void store_part(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = a[0];
  } else {
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_part(const float* p, float (&a)[VEC]) {
  if constexpr (VEC == 1) {
    a[0] = p[0];
  } else {
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      a[4 * k] = v.x;
      a[4 * k + 1] = v.y;
      a[4 * k + 2] = v.z;
      a[4 * k + 3] = v.w;
    }
  }
}

// Pass 1: one warp a (chunk, column tile). sid: the sorted ids; pos: each
// sorted entry's row in rows; out zero-filled; part (chunks, 2, W): head
// then tail slot.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    segment_merge_chunks_kernel(const int* __restrict__ sid,
                                const long long* __restrict__ pos,
                                const T* __restrict__ rows,
                                T* __restrict__ out, float* __restrict__ part,
                                int n, int W, int vocab, int tiles) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long chunk = warp / tiles;
  const long long begin = chunk * kChunk;
  if (begin >= n) return;  // the whole warp
  const int col = ((int)(warp % tiles) * 32 + lane) * VEC;
  const bool on = col < W;  // VEC divides W on the 16-byte path
  const int len = (int)min((long long)kChunk, n - begin);

  int ids[kChunk / 32];
  long long at[kChunk / 32];
#pragma unroll
  for (int h = 0; h < kChunk / 32; ++h) {
    const int j = h * 32 + lane;
    ids[h] = j < len ? sid[begin + j] : -1;
    at[h] = j < len ? pos[begin + j] : 0;
  }
  // the ids on either side of the chunk (-1: none)
  const int before = begin > 0 ? sid[begin - 1] : -1;
  const int after = begin + kChunk < n ? sid[begin + kChunk] : -1;
  float* head = part + 2 * chunk * (long long)W + col;
  float* tail = head + W;

  float acc[VEC];
  int cur = -1;
  bool from_before = false;  // cur's run began in an earlier chunk
  auto flush = [&](bool goes_on) {
    if (!on || !in_table(cur, vocab)) return;
    if (from_before)
      store_part<VEC>(head, acc);
    else if (goes_on)
      store_part<VEC>(tail, acc);
    else
      store_row<T, VEC>(out + (long long)cur * W + col, acc);
  };
#pragma unroll 1
  for (int base = 0; base < len; base += kAhead) {
    Bits<T, VEC> r[kAhead];
    int x[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = base + u;
      x[u] = __shfl_sync(kFull, pick(ids, j), j & 31);
      const long long e = __shfl_sync(kFull, pick(at, j), j & 31);
      if (on && j < len && in_table(x[u], vocab))
        r[u] = load_bits<T, VEC>(rows + e * W + col);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = base + u;
      if (j >= len) break;
      if (j > 0 && x[u] == cur) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += element<T, VEC>(r[u], i);
        continue;
      }
      if (j > 0) flush(false);  // a run ended inside the chunk
      from_before = j == 0 && before == x[u];
      cur = x[u];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = element<T, VEC>(r[u], i);
    }
  }
  flush(after == cur);
}

// Pass 2: the owner of a run that crosses chunk edges adds its partials in
// chunk order and writes its row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    segment_merge_spans_kernel(const int* __restrict__ sid,
                               const float* __restrict__ part,
                               T* __restrict__ out, int n, int W, int vocab,
                               int tiles) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long chunk = warp / tiles;
  const long long begin = chunk * kChunk;
  const long long last = begin + kChunk - 1;  // the chunk's last entry
  if (last + 1 >= n) return;                  // nothing after the chunk
  const int id = sid[last];
  if (sid[last + 1] != id || !in_table(id, vocab)) return;
  if (begin > 0 && sid[begin - 1] == id) return;  // an earlier chunk owns it
  // the chunk the run ends in: the first one the run does not go past
  long long end = chunk + 1;
  for (;;) {
    const long long next = (end + lane + 1) * kChunk;
    const bool goes_on = next < n && sid[next] == id;
    const unsigned stop = __ballot_sync(kFull, !goes_on);
    if (stop) {
      end += __ffs(stop) - 1;
      break;
    }
    end += 32;
  }
  const int col = ((int)(warp % tiles) * 32 + lane) * VEC;
  if (col >= W) return;
  float acc[VEC];
  load_part<VEC>(part + (2 * chunk + 1) * (long long)W + col, acc);
  for (long long c0 = chunk + 1; c0 <= end; c0 += kAhead) {
    float p[kAhead][VEC];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u <= end)
        load_part<VEC>(part + 2 * (c0 + u) * (long long)W + col, p[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u <= end) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += p[u][i];
      }
  }
  store_row<T, VEC>(out + (long long)id * W + col, acc);
}

template <typename T, int VEC>
cudaError_t launch(const int* sid, const long long* pos, const void* rows,
                   void* out, float* part, int n, int W, int vocab,
                   cudaStream_t s) {
  const int tiles = (W + 32 * VEC - 1) / (32 * VEC);
  const long long chunks = ((long long)n + kChunk - 1) / kChunk;
  const long long blocks = (chunks * tiles + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  segment_merge_chunks_kernel<T, VEC><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
      sid, pos, static_cast<const T*>(rows), static_cast<T*>(out), part, n,
      W, vocab, tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (chunks > 1)
    segment_merge_spans_kernel<T, VEC>
        <<<(unsigned)blocks, kWarps * 32, 0, s>>>(
            sid, part, static_cast<T*>(out), n, W, vocab, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const int* sid, const long long* pos,
                         const void* rows, void* out, float* part, int n,
                         int W, int vocab, int vec, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == 1)
    return launch<T, 1>(sid, pos, rows, out, part, n, W, vocab, s);
  if (vec != kVec || W % kVec != 0 || (uintptr_t)rows % 16 != 0 ||
      (uintptr_t)out % 16 != 0 || (uintptr_t)part % 16 != 0)
    return cudaErrorInvalidValue;
  return launch<T, kVec>(sid, pos, rows, out, part, n, W, vocab, s);
}

}  // namespace

extern "C" {

// sorted_ids (n,) int32, stably sorted; positions (n,) int64: each sorted
// entry's row of rows (n, W) (dtype 0 fp32, 1 bf16); out (vocab, W) of
// rows' dtype, zero-filled here; partials (ceil(n / kChunk), 2, W) fp32
// scratch; vec: elements a lane loads at once (1, or 16 bytes' worth). All
// contiguous on the current device.
int segment_merge(const void* sorted_ids, const void* positions,
                  const void* rows, void* out, void* partials, int n, int W,
                  int vocab, int dtype, int vec, void* stream) {
  if (n < 0 || W < 0 || vocab < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)vocab * W * (dtype == 0 ? 4 : 2), s);
  if (err != cudaSuccess || n == 0 || W == 0 || vocab == 0) return (int)err;
  const int* sid = static_cast<const int*>(sorted_ids);
  const long long* pos = static_cast<const long long*>(positions);
  float* part = static_cast<float*>(partials);
  if (dtype == 0)
    return (int)launch_dtype<float>(sid, pos, rows, out, part, n, W, vocab,
                                    vec, s);
  return (int)launch_dtype<__nv_bfloat16>(sid, pos, rows, out, part, n, W,
                                          vocab, vec, s);
}

// the sorted entries a chunk of pass 1 holds
int segment_merge_chunk(void) { return kChunk; }

const char* segment_merge_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
