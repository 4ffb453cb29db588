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
// What bounds it on this card: bytes. At the dlrm training shape (B = 8,192,
// F = 26, D = 128, fp32) it reads 4.19 + 109.05 MB and writes 15.70 MB:
// 128.9 MB, 38.5 us at 3.35 TB/s, against 0.74 GFLOP of kept pairs (11 us
// at fp32's 67 TFLOP/s). The TPU kernel concatenated [dense; sparse] in
// HBM, ran an MXU batched product over (bb, F1, D) blocks and gathered the
// triangle from the (F1, F1) Gram block in VMEM. The first Hopper version
// (one sample a block, scalar fmaf from shared memory) spent its time on
// 2 x 26 shared-memory reads of every element.
//
// Design: a sample's Gram matrix on tensor cores, from registers.
//  * T's rows are padded to RB = ceil(F1 / 16) row blocks of 16 (a
//    template; 2 at dlrm). The products run on mma.sync.m16n8k8 with TF32
//    operands, at fp32 accuracy as 3xTF32 for fp32 inputs (each operand
//    split once into hi = tf32(x) and lo = tf32(x - hi); lo*hi + hi*lo +
//    hi*hi; one pass misses the 1e-4 gate) and in one exact pass for bf16
//    inputs (8 significant bits fit TF32's 11).
//  * A k-step's products go into a fresh fragment (C = 0) and are then added
//    to the fp32 sum with one rounded add: the tensor core's own accumulate
//    truncates, which over the 48 mma a pair takes at D 128 costs ~3x the
//    error (9.2e-5 against 3.4e-5 at dlrm's shapes, std-1 inputs).
//  * B comes from A. For the Gram matrix the B fragment of column block c
//    (8 rows of T) is made of A-fragment registers of the same rows: (a0,
//    a2) of row block c / 2 for even c, (a1, a3) for odd c. So every element
//    of T is loaded from device memory once a sample, split once, and used
//    by every tile it belongs to.
//  * Only the lower tiles: row block r multiplies column blocks 0..2r+1
//    (RB (RB + 1) tiles: 6 of the 8 at dlrm), and skips a column block that
//    starts at or past F1. The upper triangle is never computed or written.
//  * 16-byte loads straight into fragments, by permuting k: lane (g, t)
//    loads physical columns 16s + 4t .. 4t + 3 of its rows (g, g + 8 of
//    each row block) and serves them as logical columns t and t + 4 of
//    k-steps 2s (the first two) and 2s + 1 (the last two). A sum over k
//    may take k in any order when both operands take the same one, and B
//    from A makes that automatic. A quad reads 64 contiguous bytes of a
//    row; no shared memory for the inputs. A 4-byte path (one element a
//    load, each column bounds-checked) serves D % 4 != 0 and unaligned
//    pointers, chosen per launch. Rows past F1 and columns past D are
//    zero in both operands; the concatenation never reaches memory (rows
//    come from dense_out and sparse_embs through two pointers).
//  * Loads ahead: a register ring; chunk m + kAhead of 16 columns is issued
//    before chunk m is multiplied. The loads set the pace at training: cut
//    the products out and most of the launch's time stays
//    (scripts/dot_ablations.py). Copying a sample's rows whole into shared
//    memory first, a block a sample, was slower on the card: the copy's
//    wait is not hidden.
//  * Parallelism from the shape alone. A sample takes KS warps (1, or up to
//    4 while the batch is small: B 512 gives 4, B 8,192 1), each taking
//    every KS-th chunk; the other warps' partial sums reach the first
//    through shared memory and are added in split order. A block holds
//    kMaxSamples / KS samples, halved while the grid would be under one
//    block an SM or the shared memory would pass 48 KB.
//  * Epilogue through shared memory: a sample's dense copy (from its
//    row-0 registers, exact) and its sums at their tril positions are
//    staged in the output dtype; then the block writes its samples'
//    contiguous span of out with 16-byte stores, element stores at the
//    span's unaligned ends (the staging is offset by the span's
//    misalignment, so both sides of every 16-byte store are aligned).
//  * No atomics: each output is a fixed-order sum, so two calls give the
//    same bits.
//
// Takes any B, 1 <= D <= 256 and F1 <= 64; fp32 and bf16 inputs.
// Interface: plain C, loaded with ctypes. The host function launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hstu_fwd_tile.cuh"

namespace {

using hstu_fwd::mma_tf32;
using hstu_fwd::split_tf32;
using hstu_fwd::to_tf32;

constexpr int kMaxD = 256;
constexpr int kMaxF1 = 64;
constexpr int kFp32Passes = 3;        // 3xTF32 for fp32 inputs
constexpr bool kStepPartials = true;  // a k-step's sums added rounded
constexpr bool kVecLoads = true;      // the 16-byte path where it applies
constexpr int kAhead = 1;             // chunks loaded ahead
constexpr bool kL2Lines = true;       // fp32 loads ask L2 for 128 bytes
constexpr int kMaxSamples = 4;        // warps a block
constexpr int kMaxSplit = 4;          // warps a sample at most
static_assert(kMaxSamples % kMaxSplit == 0, "a block holds whole samples");
constexpr long long kSplitWarps = 16 * 132;  // split while B KS is under
constexpr long long kFillBlocks = 132;  // one block an H100 SM
constexpr int kStageBytes = 48 * 1024;  // static limit of dynamic smem

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

// columns col .. col + 3 of one row as fp32; zero past D or for a padding
// row (row == nullptr). VEC: one 16-byte (fp32) or 8-byte (bf16) load, the
// host having checked D % 4 == 0 and the pointers' alignment; an fp32 load
// asks L2 for the whole 128-byte line, so the next chunk's half of it is
// on its way too.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(float (&v)[4], const T* row, int col,
                                      int D) {
  if (VEC) {
    if (row != nullptr && col < D) {
      if constexpr (std::is_same<T, float>::value) {
        if constexpr (kL2Lines) {
          asm("ld.global.nc.L2::128B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
              : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
              : "l"(row + col));
        } else {
          const float4 x = __ldg(reinterpret_cast<const float4*>(row + col));
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        }
      } else {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(row + col));
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = to_f32(e[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = 0.0f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = row != nullptr && col + k < D ? to_f32(row[col + k]) : 0.0f;
  }
}

// d = a * b + 0 (a fresh fragment)
__device__ __forceinline__ void mma_tf32_c0(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// KS warps a sample, from the shape alone: 1, doubled (up to 4, and to
// the chunks a sample has) while B KS warps would stay under kSplitWarps;
// only for up to 2 row blocks
int warps_per_sample(long long B, int F, int D) {
  int ks = 1;
  if ((F + 16) / 16 > 2) return ks;
  while (ks < kMaxSplit && 2 * ks <= (D + 15) / 16 &&
         B * 2 * ks <= kSplitWarps)
    ks *= 2;
  return ks;
}

// bytes of shared memory: the staging (16-aligned, 16 bytes of slack for
// the span's misalignment), then the KS - 1 partial accumulators a sample
size_t smem_bytes(int S, int KS, int W, int esz, int nt) {
  const size_t stage = ((size_t)S * W * esz + 16 + 15) / 16 * 16;
  return stage + (size_t)S * (KS - 1) * nt * 4 * 32 * sizeof(float);
}

// S samples a block, from the shape alone (see the header note)
int samples_per_block(long long B, int KS, int W, int esz, int nt) {
  int s = kMaxSamples / KS;
  while (s > 1 && ((B + s - 1) / s < kFillBlocks ||
                   smem_bytes(s, KS, W, esz, nt) > kStageBytes))
    s /= 2;
  return s;
}

// RB: row blocks of 16 (F1 <= 16 RB); VEC: the vector-load path.
// Block x takes samples S x .. S x + S - 1 with KS warps each: warp w
// takes sample S x + w / KS and its chunks w % KS, + KS, ...
template <typename T, int RB, bool VEC>
__global__ void __launch_bounds__(kMaxSamples * 32)
dot_interaction_fwd_kernel(const T* __restrict__ dense,
                           const T* __restrict__ sparse, T* __restrict__ out,
                           long long B, int F, int D, int skip, int n_pairs,
                           int KS) {
  constexpr int NT = RB * (RB + 1);       // lower tiles: (r, c <= 2r + 1)
  constexpr int DEPTH = kAhead;           // chunks loaded ahead
  constexpr int NB = DEPTH + 1;           // ring slots
  constexpr int PASSES = std::is_same<T, float>::value ? kFp32Passes : 1;
  extern __shared__ __align__(16) unsigned char stage_raw[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = (blockDim.x >> 5) / KS;
  const int slot = warp / KS, split = warp - slot * KS;
  const long long s0 = (long long)blockIdx.x * S;
  const int n_here = (int)min((long long)S, B - s0);
  const int F1 = F + 1;
  const int W = D + n_pairs;
  T* gout = out + s0 * W;
  const int mis = (int)((uintptr_t)gout & 15);  // a multiple of sizeof(T)
  T* stage = reinterpret_cast<T*>(stage_raw + mis);
  T* st = stage + (long long)slot * W;
  // the KS - 1 partial sums of each sample, lane-major: conflict-free
  float* part_s = reinterpret_cast<float*>(
      stage_raw + ((size_t)S * W * sizeof(T) + 16 + 15) / 16 * 16);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  if (slot < n_here) {
    const long long b = s0 + slot;
    // this lane's rows: 16 r + g (h = 0) and 16 r + g + 8 (h = 1)
    const T* rows[RB][2];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int R = 16 * r + 8 * h + g;
        rows[r][h] = R == 0 ? dense + b * D
                     : R < F1 ? sparse + (b * F + R - 1) * D
                              : nullptr;
      }
    float buf[NB][RB][2][4];
    const int nch = (D + 15) >> 4;        // chunks of 16 columns
    const int mine = (nch - split + KS - 1) / KS;  // this warp's chunks
    // this warp's m-th chunk: columns 16 (split + m KS) + 4t .. + 3
    auto load_chunk = [&](float (&dst)[RB][2][4], int m) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          load4<T, VEC>(dst[r][h], rows[r][h], 16 * (split + m * KS) + 4 * t,
                        D);
    };
#pragma unroll
    for (int u = 0; u < DEPTH; ++u)
      if (u < mine) load_chunk(buf[u], u);
    for (int base = 0; base < mine; base += NB) {
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int m = base + u;
        if (m >= mine) break;
        // chunk m + DEPTH is issued before chunk m is multiplied
        if (m + DEPTH < mine) load_chunk(buf[(u + DEPTH) % NB], m + DEPTH);
        const int s = split + m * KS;
        const float(&cur)[RB][2][4] = buf[u];
        if (g == 0) {                     // row 0 is dense_out: its copy
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 16 * s + 4 * t + e;
            if (col < D) st[col] = from_f32<T>(cur[0][0][e]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {  // k-steps 2s and 2s + 1
          uint32_t hi[RB][4], lo[RB][4];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            // a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
            // t + 4): physical columns 4t + 2kk and 4t + 2kk + 1
            const float a[4] = {cur[r][0][2 * kk], cur[r][1][2 * kk],
                                cur[r][0][2 * kk + 1], cur[r][1][2 * kk + 1]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (PASSES == 3) split_tf32(a[e], hi[r][e], lo[r][e]);
              else hi[r][e] = to_tf32(a[e]);
            }
          }
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int c = 0; c <= 2 * r + 1; ++c) {
              if (8 * c >= F1) continue;  // warp-uniform
              float(&cc)[4] = acc[r * (r + 1) + c];
              // B from A: column block c is rows 8c .. 8c + 7, held as
              // (a0, a2) (even c) or (a1, a3) (odd c) of row block c / 2
              const int q = c >> 1, o = c & 1;
              const uint32_t bh[2] = {hi[q][o], hi[q][o + 2]};
              const uint32_t bl[2] = {lo[q][o], lo[q][o + 2]};
              if (kStepPartials) {
                // the k-step in a fresh fragment, then one rounded add:
                // the tensor core's own accumulate truncates
                float part[4];
                if (PASSES == 3) {
                  mma_tf32_c0(part, lo[r], bh);
                  mma_tf32(part, hi[r], bl);
                  mma_tf32(part, hi[r], bh);
                } else {
                  mma_tf32_c0(part, hi[r], bh);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) cc[e] += part[e];
              } else {
                if (PASSES == 3) {
                  mma_tf32(cc, lo[r], bh);
                  mma_tf32(cc, hi[r], bl);
                }
                mma_tf32(cc, hi[r], bh);
              }
            }
        }
      }
    }
    if (split > 0) {
      float* p = part_s + (size_t)(slot * (KS - 1) + split - 1) * NT * 128;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[(n * 4 + e) * 32 + lane] = acc[n][e];
    }
  }
  if (KS > 1) __syncthreads();            // block-uniform
  if (slot < n_here && split == 0) {
    // the other warps' partial sums, in split order: a fixed order
    for (int k = 1; k < KS; ++k) {
      const float* p = part_s + (size_t)(slot * (KS - 1) + k - 1) * NT * 128;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += p[(n * 4 + e) * 32 + lane];
    }
    // c0 (row g, col 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c <= 2 * r + 1; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * r + g + 8 * (e >> 1);
          const int j = 8 * c + 2 * t + (e & 1);
          if (i < F1 && j <= i - skip)
            st[D + row_start(i, skip) + j] =
                from_f32<T>(acc[r * (r + 1) + c][e]);
        }
  }
  __syncthreads();

  // the block's samples own one contiguous span of out
  const int n = n_here * W;
  constexpr int E = (int)sizeof(T);
  const int head = min(n, mis ? (16 - mis) / E : 0);
  const int n16 = (n - head) * E / 16;
  for (int i = threadIdx.x; i < head; i += blockDim.x) gout[i] = stage[i];
  uint4* gv = reinterpret_cast<uint4*>(gout + head);
  const uint4* sv = reinterpret_cast<const uint4*>(stage + head);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) gv[i] = sv[i];
  for (int i = head + n16 * 16 / E + threadIdx.x; i < n; i += blockDim.x)
    gout[i] = stage[i];
}

template <typename T, int RB, bool VEC>
cudaError_t launch(const void* dense, const void* sparse, void* out,
                   long long B, int F, int D, int skip, int n_pairs,
                   cudaStream_t stream) {
  constexpr int NT = RB * (RB + 1);
  const int W = D + n_pairs, esz = (int)sizeof(T);
  const int KS = warps_per_sample(B, F, D);
  const int S = samples_per_block(B, KS, W, esz, NT);
  const size_t smem = smem_bytes(S, KS, W, esz, NT);
  const long long blocks = (B + S - 1) / S;
  dot_interaction_fwd_kernel<T, RB, VEC><<<(unsigned)blocks, S * KS * 32,
                                           smem, stream>>>(
      (const T*)dense, (const T*)sparse, (T*)out, B, F, D, skip, n_pairs, KS);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_rb(const void* dense, const void* sparse, void* out,
                      long long B, int F, int D, int skip, int n_pairs,
                      cudaStream_t stream) {
  switch ((F + 16) / 16) {                  // ceil(F1 / 16)
    case 1:
      return launch<T, 1, VEC>(dense, sparse, out, B, F, D, skip, n_pairs,
                               stream);
    case 2:
      return launch<T, 2, VEC>(dense, sparse, out, B, F, D, skip, n_pairs,
                               stream);
    case 3:
      return launch<T, 3, VEC>(dense, sparse, out, B, F, D, skip, n_pairs,
                               stream);
    default:
      return launch<T, 4, VEC>(dense, sparse, out, B, F, D, skip, n_pairs,
                               stream);
  }
}

template <typename T>
cudaError_t launch_dtype(const void* dense, const void* sparse, void* out,
                         long long B, int F, int D, int skip, int n_pairs,
                         cudaStream_t stream) {
  constexpr uintptr_t A = 4 * sizeof(T);    // bytes of one vector load
  const bool aligned = kVecLoads && D % 4 == 0 &&
                       (((uintptr_t)dense | (uintptr_t)sparse) & (A - 1)) == 0;
  if (aligned)
    return launch_rb<T, true>(dense, sparse, out, B, F, D, skip, n_pairs,
                              stream);
  return launch_rb<T, false>(dense, sparse, out, B, F, D, skip, n_pairs,
                             stream);
}

int pairs_of(int F1, int skip) { return F1 * (F1 + 1) / 2 - skip * F1; }

}  // namespace

extern "C" {

// dense: (B, D); sparse: (B, F, D); out: (B, D + n_pairs), all contiguous in
// one dtype (0 fp32, 1 bf16) on the current device. self_interaction: 0 keeps
// j < i (n_pairs = F1 (F1 - 1) / 2), 1 keeps j <= i (F1 (F1 + 1) / 2).
int dot_interaction_fwd(const void* dense, const void* sparse, void* out,
                        int B, int F, int D, int self_interaction, int dtype,
                        void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (B < 0 || D < 1 || D > kMaxD || F < 0 || F + 1 > kMaxF1)
    return (int)cudaErrorInvalidValue;
  const int skip = self_interaction ? 0 : 1;
  const int n_pairs = pairs_of(F + 1, skip);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_dtype<float>(dense, sparse, out, B, F, D, skip,
                                    n_pairs, s);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(dense, sparse, out, B, F, D, skip,
                                            n_pairs, s);
  return (int)cudaErrorInvalidValue;
}

// the samples a block the launch would use for this shape
int dot_interaction_fwd_samples_per_block(int B, int F, int D,
                                          int self_interaction, int dtype) {
  const int W = D + pairs_of(F + 1, self_interaction ? 0 : 1);
  const int rb = (F + 16) / 16;
  return samples_per_block(B, warps_per_sample(B, F, D), W,
                           dtype == 1 ? 2 : 4, rb * (rb + 1));
}

// the warps a sample the launch would use for this shape
int dot_interaction_fwd_warps_per_sample(int B, int F, int D) {
  return warps_per_sample(B, F, D);
}

const char* dot_interaction_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
