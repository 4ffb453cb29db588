// Cached-prefix HSTU pointwise attention forward (incremental serving), for
// Hopper (sm_90a).
//
// Replaces: repro/kernels/hstu_attention.py:_prefix_fwd_kernel, the Pallas
// TPU forward of the incremental path. Rows are one request's
// [n_new new events | m targets]; columns are the user's K/V buffer
// [n_hist cached history | m targets]. Per (b, h):
//
//   out[r] = sum_j  SiLU(q_r . k_j / sqrt(Dqk) + rab[h, clip(pos(r) - j)])
//                   / scale_len * mask[b, r, j] * v_j
//
// where new row r sits at absolute position pos(r) = prefix[b] + r and
// target row r at pos(r) = r + (n_hist - n_new). The mask, generated
// in-kernel from n_hist, n_new and the three (B,) counts prefix, new and
// target: a new row sees history columns j <= pos(r) and j < prefix + new
// (no target); a target row sees the valid history j < prefix + new and its
// own diagonal column n_hist + (r - n_new); rows past new or target counts
// are exactly 0. scale_len (hist_len + m_targets) is the 1/n of the
// equivalent full sequence, passed in, so extend-only calls (no target
// rows) normalize like extend-and-score calls.
//
// What bounds it on this card: at the serving shape (B = 64, H = 2,
// n_hist = 64, m = 16, n_new = 8, Dqk = Dv = 32, fp32) one call must read
// the kept q rows and k/v columns and write the output, well under 2 MB
// (< 1 us at 3.35 TB/s), and do a few MFLOP for the cells the mask keeps
// (< 0.1 us at 67 TFLOP/s fp32): bytes set the bound. This first version
// is B1's design (csrc/hstu_attention_fwd.cu) with the row and column maps
// of the prefix layout, and is far from that bound for the same reasons
// (serial FMA chains on shared-memory operands, few warps per SM). One
// block owns a (b*h, 32-row tile of the R rows), holds the q tile, the
// head's rab row and each 32-column k/v tile in shared memory, and
// accumulates its 32 x Dv output tile in fp32 registers, stored once.
// Rows and columns have different lengths and maps, so the tile skip is
// computed from them: a tile's valid new rows need history columns up to
// min(prefix + last valid new row, prefix + new - 1); its valid target rows
// need the valid history plus the target columns on their diagonals; every
// other k tile is skipped. A tile may hold new and target rows together,
// and n_hist, n_new and m need not be multiples of 32. The counts are read
// by the block itself and ragged edges get bounded loads (no pad-and-crop).
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
hstu_prefix_fwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ rab,
                       const int* __restrict__ prefix_lengths,
                       const int* __restrict__ new_counts,
                       const int* __restrict__ target_counts,
                       float* __restrict__ out, int H, int R, int C, int Dqk,
                       int Dv, int n_hist, int n_new, int max_rel,
                       int use_rab, float inv_sqrt_d, float inv_scale) {
  extern __shared__ float smem[];
  const int ldk = Dqk + 1;               // +1 pad: conflict-free k_s reads
  const int ldp = BK + 1;
  float* q_s = smem;                     // BQ x ldk
  float* k_s = q_s + BQ * ldk;           // BK x ldk
  float* v_s = k_s + BK * ldk;           // BK x Dv
  float* p_s = v_s + BK * Dv;            // BQ x ldp  (masked SiLU / n)
  float* rab_s = p_s + BQ * ldp;         // 2*max_rel+1 (use_rab only)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const size_t base_q = (size_t)bh * R * Dqk;
  const size_t base_k = (size_t)bh * C * Dqk;
  const size_t base_v = (size_t)bh * C * Dv;
  const size_t base_o = (size_t)bh * R * Dv;

  const int pfx = prefix_lengths[b];
  const int nc = new_counts[b];
  const int tc = target_counts[b];
  // valid history columns are [0, hist_end): j < prefix + new and j < n_hist
  const int hist_end =
      (int)max(0LL, min((long long)pfx + nc, (long long)n_hist));
  const int n_tgt = R - n_new;           // target rows (0: extend-only call)

  // Tile skip bounds (uniform over the block). Valid new rows of this tile
  // are [q0, new_hi]; valid target rows [tgt_lo, tgt_hi].
  const int q_last = min(q0 + BQ, R) - 1;
  const int new_hi = min(q_last, min(n_new, nc) - 1);
  const int tgt_lo = max(q0, n_new);
  const int tgt_hi = min(q_last, n_new + min(max(tc, 0), n_tgt) - 1);
  int hist_hi = -1;                      // last history column needed
  if (new_hi >= q0)
    hist_hi = (int)min((long long)pfx + new_hi, (long long)hist_end - 1);
  if (tgt_lo <= tgt_hi) hist_hi = hist_end - 1;
  // target columns on the valid target rows' diagonals
  const int tcol_lo = n_hist + (tgt_lo - n_new);
  const int tcol_hi = tgt_lo <= tgt_hi ? min(n_hist + (tgt_hi - n_new), C - 1)
                                       : -1;

  for (int idx = tid; idx < BQ * Dqk; idx += NT) {
    const int r = idx / Dqk, d = idx - r * Dqk;
    const int row = q0 + r;
    q_s[r * ldk + d] = row < R ? q[base_q + (size_t)row * Dqk + d] : 0.0f;
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

  for (int k0 = 0; k0 < C; k0 += BK) {
    const int k_last = min(k0 + BK, C) - 1;
    const bool hist_live = k0 <= hist_hi;
    const bool tgt_live = max(k0, tcol_lo) <= min(k_last, tcol_hi);
    if (!hist_live && !tgt_live) continue;

    __syncthreads();  // previous tile's readers are done (and q_s is loaded)
    for (int idx = tid; idx < BK * Dqk; idx += NT) {
      const int c = idx / Dqk, d = idx - c * Dqk;
      const int col = k0 + c;
      k_s[c * ldk + d] = col < C ? k[base_k + (size_t)col * Dqk + d] : 0.0f;
    }
    for (int idx = tid; idx < BK * Dv; idx += NT) {
      const int c = idx / Dv, d = idx - c * Dv;
      const int col = k0 + c;
      v_s[c * Dv + d] = col < C ? v[base_v + (size_t)col * Dv + d] : 0.0f;
    }
    __syncthreads();

    for (int idx = tid; idx < BQ * BK; idx += NT) {
      const int rr = idx / BK, c = idx - rr * BK;
      const int r = q0 + rr, j = k0 + c;
      const bool is_new = r < n_new, is_hk = j < n_hist;
      const int pos = is_new ? pfx + r : r + (n_hist - n_new);
      const bool st = is_hk ? (!is_new || j <= pos)
                            : (!is_new && r - n_new == j - n_hist);
      const bool vr = is_new ? (r < nc) : (r - n_new < tc);
      const bool vc = is_hk ? (j < hist_end) : (j - n_hist < tc);
      float p = 0.0f;
      if (r < R && j < C && st && vr && vc) {
        float s = 0.0f;
        for (int d = 0; d < Dqk; ++d)
          s = fmaf(q_s[rr * ldk + d], k_s[c * ldk + d], s);
        s *= inv_sqrt_d;
        if (use_rab) {
          const int delta = min(max(pos - j, -max_rel), max_rel) + max_rel;
          s += rab_s[delta];
        }
        p = silu(s) * inv_scale;
      }
      p_s[rr * ldp + c] = p;
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
  if (row < R) {
    float* orow = out + base_o + (size_t)row * Dv;
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
long long hstu_attention_prefix_fwd_smem_bytes(int Dqk, int Dv, int max_rel,
                                               int use_rab) {
  const long long nrab = use_rab ? 2LL * max_rel + 1 : 0;
  return (long long)sizeof(float) *
         ((long long)(BQ + BK) * (Dqk + 1) + (long long)BK * Dv +
          (long long)BQ * (BK + 1) + nrab);
}

// q: (B, H, R, Dqk) with R = n_new + m; k: (B, H, C, Dqk) and v: (B, H, C,
// Dv) with C = n_hist + m; out: (B, H, R, Dv); rab: (H, 2*max_rel+1) or null
// when use_rab == 0; prefix_lengths, new_counts, target_counts: (B,) int32.
// All contiguous fp32 on the current device.
int hstu_attention_prefix_fwd(const void* q, const void* k, const void* v,
                              const void* rab, const void* prefix_lengths,
                              const void* new_counts,
                              const void* target_counts, void* out, int B,
                              int H, int R, int C, int Dqk, int Dv,
                              int n_hist, int n_new, int scale_len,
                              int max_rel, int use_rab, void* stream) {
  if (B * H == 0 || R == 0) return (int)cudaSuccess;
  const long long smem = hstu_attention_prefix_fwd_smem_bytes(Dqk, Dv,
                                                              max_rel,
                                                              use_rab);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hstu_prefix_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (R + BQ - 1) / BQ);
  hstu_prefix_fwd_kernel<<<grid, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)rab,
      (const int*)prefix_lengths, (const int*)new_counts,
      (const int*)target_counts, (float*)out, H, R, C, Dqk, Dv, n_hist,
      n_new, max_rel, use_rab, 1.0f / sqrtf((float)Dqk),
      1.0f / (float)scale_len);
  return (int)cudaGetLastError();
}

const char* hstu_attention_prefix_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
