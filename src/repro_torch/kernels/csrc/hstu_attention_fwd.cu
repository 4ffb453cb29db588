// HSTU pointwise attention forward under the ROO mask, for Hopper (sm_90a).
//
// Replaces: repro/kernels/hstu_attention.py:_fwd_kernel (with its
// _block_scores_and_mask), the Pallas TPU forward. It computes, per (b, h):
//
//   out[i] = sum_j  SiLU(q_i . k_j / sqrt(Dqk) + rab[h, clip(i - j)]) / S
//                   * mask[b, i, j] * v_j
//
// with the ROO mask generated in-kernel from n_hist, hist_lengths[b] and
// target_counts[b]: history rows causal over history, target rows over the
// whole valid history plus their own diagonal, and row/column validity.
//
// What bounds it on this card: at the serving shape (B = 64, H = 2, S = 80,
// Dqk = Dv = 32, fp32) one call must move ~5.2 MB (~1.6 us at 3.35 TB/s)
// and do ~16 MFLOP for the cells the ROO mask keeps (~0.2 us at 67 TFLOP/s
// fp32), so bytes set the bound. This first version is far from it: its
// dot products are serial FMA chains that read two shared-memory operands
// each, and at 164 registers a thread (-Xptxas -v) an SM holds 3 blocks,
// too few warps to hide that latency. The design keeps everything that is
// reused on chip: one block owns a (b*h, 32-row q tile), holds the q tile,
// the head's rab row and each 32-column k/v tile in shared memory, and
// accumulates the 32 x Dv output tile in fp32 registers, written once (the
// Pallas kernel instead revisits its output block across the k grid).
// k tiles that the ROO mask rules out for the whole q tile are skipped, so
// history-row tiles stop at the causal diagonal and target-row tiles read
// only the valid history plus their own diagonal tile. Lengths are read by
// the block itself (no scalar prefetch) and the ragged edge gets bounded
// loads (no pad-and-crop); the 1/S factor uses the unpadded S.
//
// Plain CUDA cores in fp32 (no wgmma/TMA yet): the reference is fp32 end
// to end and this kernel must agree with it to summation order.
//
// Interface: plain C, loaded with ctypes. The host function launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;            // q rows per block
constexpr int BK = 32;            // k columns per tile
constexpr int NT = 128;           // threads per block
constexpr int TPR = NT / BQ;      // threads sharing one output row (4)
constexpr int MAX_D = 128;        // largest Dqk / Dv the kernel takes
constexpr int ACC = MAX_D / TPR;  // output accumulators per thread (32)

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(NT)
hstu_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ rab,
                const int* __restrict__ hist_lengths,
                const int* __restrict__ target_counts,
                float* __restrict__ out, int H, int S, int Dqk, int Dv,
                int n_hist, int max_rel, int use_rab, float inv_sqrt_d,
                float inv_s) {
  extern __shared__ float smem[];
  const int ldk = Dqk + 1;               // +1 pad: conflict-free k_s reads
  const int ldp = BK + 1;
  float* q_s = smem;                     // BQ x ldk
  float* k_s = q_s + BQ * ldk;           // BK x ldk
  float* v_s = k_s + BK * ldk;           // BK x Dv
  float* p_s = v_s + BK * Dv;            // BQ x ldp  (masked SiLU / S)
  float* rab_s = p_s + BQ * ldp;         // 2*max_rel+1 (use_rab only)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const size_t base_qk = (size_t)bh * S * Dqk;
  const size_t base_v = (size_t)bh * S * Dv;

  const int hl = hist_lengths[b];
  const int tc = target_counts[b];
  // valid history columns are [0, hist_end); valid target slots
  // [n_hist, tgt_end)
  const int hist_end = max(0, min(hl, n_hist));
  const int tgt_end = n_hist + max(0, min(tc, S - n_hist));

  for (int idx = tid; idx < BQ * Dqk; idx += NT) {
    const int r = idx / Dqk, d = idx - r * Dqk;
    const int row = q0 + r;
    q_s[r * ldk + d] = row < S ? q[base_qk + (size_t)row * Dqk + d] : 0.0f;
  }
  if (use_rab) {
    const int nrab = 2 * max_rel + 1;
    for (int t = tid; t < nrab; t += NT) rab_s[t] = rab[(size_t)h * nrab + t];
  }

  const int r_own = tid / TPR;           // this thread's output row
  const int c_own = tid - r_own * TPR;   // and its first output column
  float acc[ACC];
#pragma unroll
  for (int t = 0; t < ACC; ++t) acc[t] = 0.0f;

  const int q_last = min(q0 + BQ, S) - 1;
  for (int k0 = 0; k0 < S; k0 += BK) {
    const int k_last = min(k0 + BK, S) - 1;
    // Tile skip (uniform over the block): a history column j is reachable
    // from some row of the tile iff j is valid and some row i >= j (history
    // rows are causal, target rows sit past every history column); a target
    // column only from its own diagonal row.
    const bool hist_live = k0 < hist_end && q_last >= k0;
    const int lo = max(max(k0, n_hist), q0);
    const int hi = min(min(k_last, tgt_end - 1), q_last);
    if (!hist_live && lo > hi) continue;

    __syncthreads();  // previous tile's readers are done (and q_s is loaded)
    for (int idx = tid; idx < BK * Dqk; idx += NT) {
      const int c = idx / Dqk, d = idx - c * Dqk;
      const int col = k0 + c;
      k_s[c * ldk + d] = col < S ? k[base_qk + (size_t)col * Dqk + d] : 0.0f;
    }
    for (int idx = tid; idx < BK * Dv; idx += NT) {
      const int c = idx / Dv, d = idx - c * Dv;
      const int col = k0 + c;
      v_s[c * Dv + d] = col < S ? v[base_v + (size_t)col * Dv + d] : 0.0f;
    }
    __syncthreads();

    for (int idx = tid; idx < BQ * BK; idx += NT) {
      const int r = idx / BK, c = idx - r * BK;
      const int i = q0 + r, j = k0 + c;
      const bool is_hq = i < n_hist, is_hk = j < n_hist;
      const bool st = is_hk ? (!is_hq || j <= i) : (!is_hq && i == j);
      const bool vr = is_hq ? (i < hl) : (i - n_hist < tc);
      const bool vc = is_hk ? (j < hl) : (j - n_hist < tc);
      float p = 0.0f;
      if (i < S && j < S && st && vr && vc) {
        float s = 0.0f;
        for (int d = 0; d < Dqk; ++d)
          s = fmaf(q_s[r * ldk + d], k_s[c * ldk + d], s);
        s *= inv_sqrt_d;
        if (use_rab) {
          const int delta = min(max(i - j, -max_rel), max_rel) + max_rel;
          s += rab_s[delta];
        }
        p = silu(s) * inv_s;
      }
      p_s[r * ldp + c] = p;
    }
    __syncthreads();

    const float* prow = p_s + r_own * ldp;
    for (int c = 0; c < BK; ++c) {
      const float p = prow[c];
      const float* vrow = v_s + c * Dv;
#pragma unroll
      for (int t = 0; t < ACC; ++t) {
        const int d = c_own + t * TPR;
        if (d < Dv) acc[t] = fmaf(p, vrow[d], acc[t]);
      }
    }
  }

  const int row = q0 + r_own;
  if (row < S) {
    float* orow = out + base_v + (size_t)row * Dv;
#pragma unroll
    for (int t = 0; t < ACC; ++t) {
      const int d = c_own + t * TPR;
      if (d < Dv) orow[d] = acc[t];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs; the wrapper checks it.
long long hstu_attention_fwd_smem_bytes(int Dqk, int Dv, int max_rel,
                                        int use_rab) {
  const long long nrab = use_rab ? 2LL * max_rel + 1 : 0;
  return (long long)sizeof(float) *
         ((long long)(BQ + BK) * (Dqk + 1) + (long long)BK * Dv +
          (long long)BQ * (BK + 1) + nrab);
}

// q, k: (B, H, S, Dqk); v, out: (B, H, S, Dv); rab: (H, 2*max_rel+1) or
// null when use_rab == 0; hist_lengths, target_counts: (B,) int32. All
// contiguous fp32 on the current device.
int hstu_attention_fwd(const void* q, const void* k, const void* v,
                       const void* rab, const void* hist_lengths,
                       const void* target_counts, void* out, int B, int H,
                       int S, int Dqk, int Dv, int n_hist, int max_rel,
                       int use_rab, void* stream) {
  if (B * H == 0 || S == 0) return (int)cudaSuccess;
  const long long smem = hstu_attention_fwd_smem_bytes(Dqk, Dv, max_rel,
                                                       use_rab);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hstu_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  hstu_fwd_kernel<<<grid, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)rab,
      (const int*)hist_lengths, (const int*)target_counts, (float*)out, H, S,
      Dqk, Dv, n_hist, max_rel, use_rab, 1.0f / sqrtf((float)Dqk),
      1.0f / (float)S);
  return (int)cudaGetLastError();
}

const char* hstu_attention_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
