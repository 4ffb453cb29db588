// Embedding bag forward (B5) and its COO-row backward (B6), for Hopper
// (sm_90a).
//
// Replaces: repro/kernels/embedding_bag.py:_sum_kernel / _max_kernel (the
// Pallas TPU forward, with the mean divide and the empty-bag rule of its
// _fwd_call) and :_bwd_coo_kernel (the COO contribution rows, with the
// sentinel ids of embedding_bag_coo_grad).
//
//   B5:  out[b] = pool_{l < len[b]} table[clip(ids[b, l], 0, V - 1)]
//        pool = sum | mean (sum / max(len, 1)) | max (empty bag -> 0)
//   B6:  rows[b*L + l] = g[b] * w(b, l),  w = [l < len] or [l < len] /
//        max(len, 1) in fp32;  out_ids[b*L + l] = clip(ids) or V (invalid)
//
// What bounds them on this card: bytes. At the LSR training shape (B = 32,
// L = 64, D = 64, V = 50,000, fp32) B5 reads at most 2,048 table rows
// (~0.5 MB) and B6 writes 2,048 rows (~0.5 MB): ~0.16 us each at 3.35 TB/s,
// far below a launch's few microseconds, so both are launch-latency bound
// at the model's shapes. The design is simple and correct first. The TPU
// grid ran (B, L) steps in order, one (1, D) row DMA per step, with the
// output block revisited across l. Here one block owns a bag and a D tile
// (one column a thread, so a row read is coalesced): it reads len[b], loops
// over l < min(len, L), clips each id itself (no separate safe-ids pass),
// accumulates in an fp32 register and stores once, after the mean divide
// or the max rule. Sum, mean and max are template parameters of the one
// kernel. B6 is one thread per (slot, d) element, each written once; the
// d == 0 thread of a slot also writes its id, in the same launch.
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

#include <cstdint>

namespace {

constexpr int kMaxThreads = 128;  // B5 threads per block (one column each)
constexpr int kCooThreads = 256;  // B6 threads per block

enum Pooling { kSum = 0, kMean = 1, kMax = 2 };

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

template <typename T, int POOL>
__global__ void __launch_bounds__(kMaxThreads)
embedding_bag_fwd_kernel(const T* __restrict__ table,
                         const int32_t* __restrict__ ids,
                         const int32_t* __restrict__ lengths,
                         T* __restrict__ out, int V, int D, int L) {
  const int b = blockIdx.x;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int len = lengths[b];
  const int n = min(max(len, 0), L);
  const int32_t* bag = ids + (int64_t)b * L;
  float acc = POOL == kMax ? lowest<T>() : 0.0f;
  for (int l = 0; l < n; ++l) {
    const int id = min(max(bag[l], 0), V - 1);
    const float x = to_f32(table[(int64_t)id * D + d]);
    if (POOL == kMax) {
      acc = (x > acc || isnan(x)) ? x : acc;
    } else {
      acc += x;
    }
  }
  T r;
  if (POOL == kMax) {
    r = from_f32<T>(len > 0 ? acc : 0.0f);
  } else {
    r = from_f32<T>(acc);
    if (POOL == kMean) {
      const float denom = to_f32(from_f32<T>((float)max(len, 1)));
      r = from_f32<T>(to_f32(r) / denom);
    }
  }
  out[(int64_t)b * D + d] = r;
}

template <typename T, bool MEAN>
__global__ void __launch_bounds__(kCooThreads)
embedding_bag_bwd_coo_kernel(const T* __restrict__ g,
                             const int32_t* __restrict__ ids,
                             const int32_t* __restrict__ lengths,
                             T* __restrict__ rows,
                             int32_t* __restrict__ out_ids, int V, int D,
                             int L, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t slot = i / D;
  const int d = (int)(i - slot * D);
  const int b = (int)(slot / L);
  const int l = (int)(slot - (int64_t)b * L);
  const int len = lengths[b];
  const bool valid = l < len;
  float w = valid ? 1.0f : 0.0f;
  if (MEAN) w = w / (float)max(len, 1);
  rows[i] = from_f32<T>(to_f32(g[(int64_t)b * D + d]) * w);
  if (d == 0) out_ids[slot] = valid ? min(max(ids[slot], 0), V - 1) : V;
}

template <typename T>
cudaError_t launch_fwd(const void* table, const void* ids,
                       const void* lengths, void* out, int B, int L, int V,
                       int D, int pooling, cudaStream_t stream) {
  const int threads = min(kMaxThreads, (D + 31) / 32 * 32);
  const dim3 grid(B, (D + threads - 1) / threads);
  const T* t = (const T*)table;
  const int32_t* i = (const int32_t*)ids;
  const int32_t* n = (const int32_t*)lengths;
  T* o = (T*)out;
  if (pooling == kSum) {
    embedding_bag_fwd_kernel<T, kSum><<<grid, threads, 0, stream>>>(
        t, i, n, o, V, D, L);
  } else if (pooling == kMean) {
    embedding_bag_fwd_kernel<T, kMean><<<grid, threads, 0, stream>>>(
        t, i, n, o, V, D, L);
  } else if (pooling == kMax) {
    embedding_bag_fwd_kernel<T, kMax><<<grid, threads, 0, stream>>>(
        t, i, n, o, V, D, L);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_coo(const void* g, const void* ids,
                           const void* lengths, void* rows, void* out_ids,
                           int B, int L, int V, int D, int mean,
                           cudaStream_t stream) {
  const int64_t total = (int64_t)B * L * D;
  const int64_t blocks = (total + kCooThreads - 1) / kCooThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* gg = (const T*)g;
  const int32_t* i = (const int32_t*)ids;
  const int32_t* n = (const int32_t*)lengths;
  if (mean) {
    embedding_bag_bwd_coo_kernel<T, true>
        <<<(unsigned)blocks, kCooThreads, 0, stream>>>(
            gg, i, n, (T*)rows, (int32_t*)out_ids, V, D, L, total);
  } else {
    embedding_bag_bwd_coo_kernel<T, false>
        <<<(unsigned)blocks, kCooThreads, 0, stream>>>(
            gg, i, n, (T*)rows, (int32_t*)out_ids, V, D, L, total);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table: (V, D); ids: (B, L) int32; lengths: (B,) int32; out: (B, D), the
// table's dtype. pooling: 0 sum, 1 mean, 2 max; dtype: 0 fp32, 1 bf16. All
// contiguous on the current device; B, D >= 1 and V >= 1.
int embedding_bag_fwd(const void* table, const void* ids,
                      const void* lengths, void* out, int B, int L, int V,
                      int D, int pooling, int dtype, void* stream) {
  if (B == 0 || D == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_fwd<float>(table, ids, lengths, out, B, L, V, D,
                                  pooling, s);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(table, ids, lengths, out, B, L, V,
                                          D, pooling, s);
  return (int)cudaErrorInvalidValue;
}

// g: (B, D); ids: (B, L) int32; lengths: (B,) int32; rows: (B*L, D), g's
// dtype; out_ids: (B*L,) int32. mean: 0 sum weights, 1 mean weights.
int embedding_bag_bwd_coo(const void* g, const void* ids, const void* lengths,
                          void* rows, void* out_ids, int B, int L, int V,
                          int D, int mean, int dtype, void* stream) {
  if ((int64_t)B * L * D == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_bwd_coo<float>(g, ids, lengths, rows, out_ids, B, L,
                                      V, D, mean, s);
  if (dtype == 1)
    return (int)launch_bwd_coo<__nv_bfloat16>(g, ids, lengths, rows, out_ids,
                                              B, L, V, D, mean, s);
  return (int)cudaErrorInvalidValue;
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
