// DLRM dot interaction forward (B7), for Hopper (sm_90a).
//
// Replaces: repro/kernels/dot_interaction.py:_kernel (the Pallas TPU
// kernel, pallas_call in its dot_interaction wrapper), and with the
// self-interaction flag the rest of repro/models/interactions.py's
// dot_interaction.
//
//   T   = [dense_out[b]; sparse_embs[b, 0..F-1]]          (F1 = F + 1 rows)
//   out[b] = dense_out[b] ++ { T_i . T_j : j < i }         (j <= i if self)
//
// in row-major tril order (1,0), (2,0), (2,1), (3,0), ... as np.tril_indices
// gives it, accumulated in fp32 and cast once to the inputs' dtype.
//
// What bounds it on this card: bytes. At the scoring shape (B = 512, F = 26,
// D = 128, fp32) it reads 262,144 + 6,815,744 B and writes 980,992 B: 8.06 MB,
// 2.41 us at 3.35 TB/s, against 46.0 MFLOP, 0.69 us at 67 TFLOP/s. The TPU
// kernel concatenated [dense; sparse] in HBM, ran an MXU batched product over
// (bb, F1, D) blocks and gathered the triangle from the (F1, F1) Gram block in
// VMEM. Here one block owns one sample: it reads dense_out and sparse_embs
// through two pointers (so the concatenation never reaches device memory),
// loads its F1 x D rows into shared memory as fp32 with 16-byte reads, writes
// the dense copy, and then each thread computes whole kept pairs (never the
// upper triangle) from shared memory and writes each once. Rows are padded to
// D + 1 floats so that threads reading rows j, j+1, ... at the same column hit
// different banks. A simple kernel, correct first: the later speed work moves
// the products to tensor cores with F1 padded to 32.
//
// Takes any B, 1 <= D <= 256 and F1 <= 64 (shared memory up to 64 KB); fp32
// and bf16 inputs. Interface: plain C, loaded with ctypes. The host function
// launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxD = 256;
constexpr int kMaxF1 = 64;
constexpr int kMaxThreads = 512;

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

// first pair index of tril row i: i (i + 1) / 2 - skip * i, skip = 1 for the
// strict triangle (row i holds j < i), 0 with the diagonal (j <= i)
__device__ __forceinline__ int row_start(int i, int skip) {
  return i * (i + 1) / 2 - skip * i;
}

// VEC: 16-byte loads (16 / sizeof(T) elements); the host checks alignment
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dot_interaction_fwd_kernel(const T* __restrict__ dense,
                           const T* __restrict__ sparse, T* __restrict__ out,
                           int F, int D, int skip, int n_pairs) {
  extern __shared__ float t[];                 // (F1, D + 1) fp32
  const int b = blockIdx.x;
  const int F1 = F + 1;
  const int S = D + 1;
  const T* drow = dense + (int64_t)b * D;
  const T* srow = sparse + (int64_t)b * F * D;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = D / V;
    for (int idx = threadIdx.x; idx < F1 * per_row; idx += blockDim.x) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * V;
      const T* src = r == 0 ? drow + c : srow + (int64_t)(r - 1) * D + c;
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) t[r * S + c + k] = to_f32(e[k]);
    }
  } else {
    for (int idx = threadIdx.x; idx < F1 * D; idx += blockDim.x) {
      const int r = idx / D;
      const int c = idx - r * D;
      t[r * S + c] = to_f32(r == 0 ? drow[c] : srow[(int64_t)(r - 1) * D + c]);
    }
  }
  __syncthreads();

  T* orow = out + (int64_t)b * (D + n_pairs);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    orow[d] = from_f32<T>(t[d]);               // exact: t holds T's values
  }
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    // the tril row of pair p: a float guess, then exact integer steps
    const float root = sqrtf(8.0f * p + 1.0f);
    int i = skip ? (int)((1.0f + root) * 0.5f) : (int)((root - 1.0f) * 0.5f);
    while (i > 0 && row_start(i, skip) > p) --i;
    while (row_start(i + 1, skip) <= p) ++i;
    const int j = p - row_start(i, skip);
    const float* ti = t + i * S;
    const float* tj = t + j * S;
    float acc = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) acc = fmaf(ti[d], tj[d], acc);
    orow[D + p] = from_f32<T>(acc);
  }
}

size_t smem_bytes(int F, int D) {
  return (size_t)(F + 1) * (D + 1) * sizeof(float);
}

template <typename T, bool VEC>
cudaError_t launch(const void* dense, const void* sparse, void* out, int B,
                   int F, int D, int skip, int n_pairs, cudaStream_t stream) {
  const size_t smem = smem_bytes(F, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dot_interaction_fwd_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int threads = (max(n_pairs, D) + 31) / 32 * 32;
  threads = min(max(threads, 64), kMaxThreads);
  dot_interaction_fwd_kernel<T, VEC><<<B, threads, smem, stream>>>(
      (const T*)dense, (const T*)sparse, (T*)out, F, D, skip, n_pairs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* dense, const void* sparse, void* out,
                         int B, int F, int D, int skip, int n_pairs,
                         cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      D % V == 0 &&
      (((uintptr_t)dense | (uintptr_t)sparse) & (uintptr_t)15) == 0;
  if (aligned)
    return launch<T, true>(dense, sparse, out, B, F, D, skip, n_pairs, stream);
  return launch<T, false>(dense, sparse, out, B, F, D, skip, n_pairs, stream);
}

}  // namespace

extern "C" {

// dense: (B, D); sparse: (B, F, D); out: (B, D + n_pairs), all contiguous in
// one dtype (0 fp32, 1 bf16) on the current device. self_interaction: 0 keeps
// j < i (n_pairs = F1 (F1 - 1) / 2), 1 keeps j <= i (F1 (F1 + 1) / 2).
int dot_interaction_fwd(const void* dense, const void* sparse, void* out,
                        int B, int F, int D, int self_interaction, int dtype,
                        void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (D < 1 || D > kMaxD || F < 0 || F + 1 > kMaxF1)
    return (int)cudaErrorInvalidValue;
  const int F1 = F + 1;
  const int skip = self_interaction ? 0 : 1;
  const int n_pairs = F1 * (F1 + 1) / 2 - skip * F1;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_dtype<float>(dense, sparse, out, B, F, D, skip,
                                    n_pairs, s);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(dense, sparse, out, B, F, D, skip,
                                            n_pairs, s);
  return (int)cudaErrorInvalidValue;
}

long long dot_interaction_fwd_smem_bytes(int F, int D) {
  return (long long)smem_bytes(F, D);
}

const char* dot_interaction_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
