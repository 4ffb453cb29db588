// HSTU pointwise attention backward under the ROO mask, for Hopper (sm_90a):
// two kernels, B2 (dq + drab) and B3 (dk + dv).
//
// Replaces: repro/kernels/hstu_attention.py:_bwd_dq_kernel (B2) and
// :_bwd_dkv_kernel (B3), the Pallas TPU backward. With the forward
//
//   s_ij = q_i . k_j / sqrt(Dqk) + rab[h, clip(i - j) + max_rel]
//   a_ij = SiLU(s_ij) / S * mask[b, i, j],   out_i = sum_j a_ij v_j
//
// and the output gradient g, both recompute s blockwise (no O(S^2)
// residual) and compute
//
//   ds_ij = (g_i . v_j) / S * SiLU'(s_ij) * mask[b, i, j]
//   dq_i  = sum_j ds_ij k_j / sqrt(Dqk)        (B2)
//   drab[h, t] = sum over b, i, j with clip(i - j) + max_rel == t of ds_ij
//   dk_j  = sum_i ds_ij q_i / sqrt(Dqk)        (B3)
//   dv_j  = sum_i a_ij g_i                     (B3)
//
// The mask is generated in-kernel from n_hist, hist_lengths[b] and
// target_counts[b], exactly as in the forward (hstu_attention_fwd.cu).
//
// What bounds them on this card: at the training shape (B = 32, H = 2,
// S = 80, Dqk = Dv = 32, fp32) each kernel must read the kept q, k, v and g
// rows once (~2 MB) and write its outputs once (~1.3 MB for dq, ~1.3 MB
// each for dk and dv): under 2 us at 3.35 TB/s, against well under 1 us of
// fp32 arithmetic at 67 TFLOP/s. So bytes set the bound. This first version
// is far from it for the same reasons as the forward: serial FMA chains
// that read two shared-memory operands each, and __syncthreads around
// unoverlapped global loads.
//
// Design. The TPU grid revisited its output blocks across the inner grid
// axis (and the drab block across the whole q x k sub-grid); GPU blocks run
// in any order, so each block owns its output rows and loops over the other
// axis inside the block:
//   * B2: one block per (b*h, 32-row q tile) walks the k tiles the ROO mask
//     admits for that q tile (B1's skip) and keeps the 32 x Dqk dq tile in
//     fp32 registers, stored once. For drab it sums each diagonal of the ds
//     tile (fixed order), folds the sums into the head's compact delta table
//     in shared memory -- the diagonals whose global delta clips to +-max_rel
//     are folded by one thread, in order, as the reference's clip does -- and
//     writes the block's partial table once to a (H, B * n_q_tiles, nrab)
//     scratch buffer. The caller reduces it over its middle axis in a fixed
//     order. No float atomics anywhere: two calls give the same bits.
//   * B3: one block per (b*h, 32-column k tile) walks the q tiles whose rows
//     the mask lets see that k tile (the mirror of B1's skip: a history k
//     tile is read by valid history rows from its first column on and by
//     every valid target row; a target k tile only by the q tile holding its
//     diagonal) and keeps the 32 x Dqk dk and 32 x Dv dv tiles in fp32
//     registers, stored once.
// Both read the lengths in-block, load the ragged edge with bounds (no
// pad-and-crop), use the unpadded S for 1/S, and give exact zeros for
// masked rows and columns.
//
// Plain CUDA cores in fp32 (no wgmma/TMA/cp.async yet): the reference is
// fp32 end to end.
//
// Interface: plain C, loaded with ctypes. Each host function launches one
// kernel on the caller's stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BT = 32;            // rows of a q tile == columns of a k tile
constexpr int NT = 128;           // threads per block
constexpr int TPR = NT / BT;      // threads sharing one output row (4)
constexpr int MAX_D = 128;        // largest Dqk / Dv the kernels take
constexpr int ACC = MAX_D / TPR;  // accumulators per thread and output (32)
constexpr int NDIAG = 2 * BT - 1; // diagonals of one tile (63)

struct Lengths {
  int hl, tc;          // raw per-request lengths
  int hist_end;        // valid history positions are [0, hist_end)
  int tgt_end;         // valid target positions are [n_hist, tgt_end)
};

__device__ __forceinline__ Lengths read_lengths(const int* hist_lengths,
                                                const int* target_counts,
                                                int b, int S, int n_hist) {
  Lengths L;
  L.hl = hist_lengths[b];
  L.tc = target_counts[b];
  L.hist_end = max(0, min(L.hl, n_hist));
  L.tgt_end = n_hist + max(0, min(L.tc, S - n_hist));
  return L;
}

// Whether the ROO mask keeps any cell of the (q tile, k tile) pair; uniform
// over the block. A history column j is seen by valid history rows i >= j
// and by every valid target row; a target column only by its own diagonal.
__device__ __forceinline__ bool tile_live(int q0, int k0, int S, int n_hist,
                                          const Lengths& L) {
  const int q_last = min(q0 + BT, S) - 1;
  const int k_last = min(k0 + BT, S) - 1;
  const int hrow_hi = min(q_last, L.hist_end - 1);      // valid history rows
  const int trow_lo = max(q0, n_hist);                  // valid target rows
  const int trow_hi = min(q_last, L.tgt_end - 1);
  const bool any_trow = trow_lo <= trow_hi;
  const bool hist_cols = k0 < L.hist_end;
  if (hist_cols && (any_trow || (q0 <= hrow_hi && hrow_hi >= k0)))
    return true;
  const int lo = max(max(k0, n_hist), trow_lo);
  const int hi = min(k_last, trow_hi);
  return lo <= hi;
}

__device__ __forceinline__ bool keep(int i, int j, int S, int n_hist,
                                     const Lengths& L) {
  const bool is_hq = i < n_hist, is_hk = j < n_hist;
  const bool st = is_hk ? (!is_hq || j <= i) : (!is_hq && i == j);
  const bool vr = is_hq ? (i < L.hl) : (i - n_hist < L.tc);
  const bool vc = is_hk ? (j < L.hl) : (j - n_hist < L.tc);
  return i < S && j < S && st && vr && vc;
}

// Loads rows [r0, r0 + BT) of a (S, D) matrix into a BT x ld tile; rows past
// S read as 0.
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int r0, int S, int D) {
  for (int idx = threadIdx.x; idx < BT * D; idx += NT) {
    const int r = idx / D, d = idx - r * D;
    const int row = r0 + r;
    dst[r * ld + d] = row < S ? src[(size_t)row * D + d] : 0.0f;
  }
}

// One cell (r, c) of a (q tile, k tile) pair, at global position (i, j):
// both values are exactly 0 where the mask drops the cell.
struct Cell {
  float a, ds;         // masked SiLU(s) / S and dL/ds
};

__device__ __forceinline__ Cell cell(const float* q_s, const float* k_s,
                                     const float* g_s, const float* v_s,
                                     const float* rab_s, int ldk, int ldv,
                                     int r, int c, int i, int j, int S,
                                     int n_hist, int Dqk, int Dv,
                                     int max_rel, int use_rab,
                                     float inv_sqrt_d, float inv_s,
                                     const Lengths& L) {
  Cell out{0.0f, 0.0f};
  if (!keep(i, j, S, n_hist, L)) return out;
  float s = 0.0f;
  for (int d = 0; d < Dqk; ++d)
    s = fmaf(q_s[r * ldk + d], k_s[c * ldk + d], s);
  s *= inv_sqrt_d;
  if (use_rab) s += rab_s[min(max(i - j, -max_rel), max_rel) + max_rel];
  float da = 0.0f;
  for (int d = 0; d < Dv; ++d)
    da = fmaf(g_s[r * ldv + d], v_s[c * ldv + d], da);
  const float sig = 1.0f / (1.0f + expf(-s));
  out.a = s * sig * inv_s;
  out.ds = da * inv_s * (sig * (1.0f + s * (1.0f - sig)));
  return out;
}

// ---------------------------------------------------------------------------
// B2: dq and the per-block drab partials
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT)
hstu_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ rab,
                   const float* __restrict__ g,
                   const int* __restrict__ hist_lengths,
                   const int* __restrict__ target_counts,
                   float* __restrict__ dq, float* __restrict__ drab_part,
                   int B, int H, int S, int Dqk, int Dv, int n_hist,
                   int max_rel, int use_rab, float inv_sqrt_d, float inv_s) {
  extern __shared__ float smem[];
  const int ldk = Dqk + 1, ldv = Dv + 1, ldp = BT + 1;
  const int nrab = 2 * max_rel + 1;
  float* q_s = smem;                       // BT x ldk
  float* g_s = q_s + BT * ldk;             // BT x ldv
  float* k_s = g_s + BT * ldv;             // BT x ldk
  float* v_s = k_s + BT * ldk;             // BT x ldv
  float* ds_s = v_s + BT * ldv;            // BT x ldp
  float* diag_s = ds_s + BT * ldp;         // NDIAG
  float* rab_s = diag_s + NDIAG;           // nrab (use_rab only)
  float* drab_s = rab_s + nrab;            // nrab (use_rab only)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BT;
  const size_t base_qk = (size_t)bh * S * Dqk;
  const size_t base_v = (size_t)bh * S * Dv;
  const Lengths L = read_lengths(hist_lengths, target_counts, b, S, n_hist);

  load_tile(q_s, ldk, q + base_qk, q0, S, Dqk);
  load_tile(g_s, ldv, g + base_v, q0, S, Dv);
  if (use_rab) {
    for (int t = tid; t < nrab; t += NT) {
      rab_s[t] = rab[(size_t)h * nrab + t];
      drab_s[t] = 0.0f;
    }
  }

  const int r_own = tid / TPR;
  const int c_own = tid - r_own * TPR;
  float acc[ACC];
#pragma unroll
  for (int t = 0; t < ACC; ++t) acc[t] = 0.0f;

  for (int k0 = 0; k0 < S; k0 += BT) {
    if (!tile_live(q0, k0, S, n_hist, L)) continue;
    __syncthreads();  // previous tile's readers are done (q/g/rab loaded)
    load_tile(k_s, ldk, k + base_qk, k0, S, Dqk);
    load_tile(v_s, ldv, v + base_v, k0, S, Dv);
    __syncthreads();

    for (int idx = tid; idx < BT * BT; idx += NT) {
      const int r = idx / BT, c = idx - r * BT;
      const Cell x = cell(q_s, k_s, g_s, v_s, rab_s, ldk, ldv, r, c, q0 + r,
                          k0 + c, S, n_hist, Dqk, Dv, max_rel, use_rab,
                          inv_sqrt_d, inv_s, L);
      ds_s[r * ldp + c] = x.ds;
    }
    __syncthreads();

    const float* drow = ds_s + r_own * ldp;
    for (int c = 0; c < BT; ++c) {
      const float p = drow[c];
      const float* krow = k_s + c * ldk;
#pragma unroll
      for (int t = 0; t < ACC; ++t) {
        const int d = c_own + t * TPR;
        if (d < Dqk) acc[t] = fmaf(p, krow[d], acc[t]);
      }
    }

    if (use_rab) {
      // diagonal u holds the cells with r - c == u - (BT - 1)
      if (tid < NDIAG) {
        const int off = tid - (BT - 1);
        float sum = 0.0f;
        for (int r = max(0, off); r < min(BT, BT + off); ++r)
          sum += ds_s[r * ldp + (r - off)];
        diag_s[tid] = sum;
      }
      __syncthreads();
      // fold into the delta table: an unclipped diagonal has a bin of its
      // own; the clipped ones are summed in order by one thread
      const int base = q0 - k0 - (BT - 1);   // global delta of diagonal 0
      if (tid < NDIAG) {
        const int delta = base + tid;
        if (delta > -max_rel && delta < max_rel)
          drab_s[delta + max_rel] += diag_s[tid];
      } else if (tid == NDIAG) {
        float lo = 0.0f, hi = 0.0f;
        bool any_lo = false, any_hi = false;
        for (int u = 0; u < NDIAG; ++u) {
          const int delta = base + u;
          if (delta <= -max_rel) { lo += diag_s[u]; any_lo = true; }
          else if (delta >= max_rel) { hi += diag_s[u]; any_hi = true; }
        }
        if (any_lo) drab_s[0] += lo;
        if (any_hi) drab_s[2 * max_rel] += hi;
      }
    }
  }

  const int row = q0 + r_own;
  if (row < S) {
    float* out = dq + base_qk + (size_t)row * Dqk;
#pragma unroll
    for (int t = 0; t < ACC; ++t) {
      const int d = c_own + t * TPR;
      if (d < Dqk) out[d] = acc[t] * inv_sqrt_d;
    }
  }
  if (use_rab) {
    __syncthreads();
    const int n_qt = gridDim.y;
    float* part = drab_part +
        ((size_t)h * B * n_qt + (size_t)b * n_qt + blockIdx.y) * nrab;
    for (int t = tid; t < nrab; t += NT) part[t] = drab_s[t];
  }
}

// ---------------------------------------------------------------------------
// B3: dk and dv
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT)
hstu_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ rab,
                    const float* __restrict__ g,
                    const int* __restrict__ hist_lengths,
                    const int* __restrict__ target_counts,
                    float* __restrict__ dk, float* __restrict__ dv, int H,
                    int S, int Dqk, int Dv, int n_hist, int max_rel,
                    int use_rab, float inv_sqrt_d, float inv_s) {
  extern __shared__ float smem[];
  const int ldk = Dqk + 1, ldv = Dv + 1, ldp = BT + 1;
  const int nrab = 2 * max_rel + 1;
  float* k_s = smem;                       // BT x ldk
  float* v_s = k_s + BT * ldk;             // BT x ldv
  float* q_s = v_s + BT * ldv;             // BT x ldk
  float* g_s = q_s + BT * ldk;             // BT x ldv
  float* a_s = g_s + BT * ldv;             // BT x ldp (row = q, col = k)
  float* ds_s = a_s + BT * ldp;            // BT x ldp
  float* rab_s = ds_s + BT * ldp;          // nrab (use_rab only)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BT;
  const size_t base_qk = (size_t)bh * S * Dqk;
  const size_t base_v = (size_t)bh * S * Dv;
  const Lengths L = read_lengths(hist_lengths, target_counts, b, S, n_hist);

  load_tile(k_s, ldk, k + base_qk, k0, S, Dqk);
  load_tile(v_s, ldv, v + base_v, k0, S, Dv);
  if (use_rab)
    for (int t = tid; t < nrab; t += NT) rab_s[t] = rab[(size_t)h * nrab + t];

  const int c_own = tid / TPR;             // this thread's k column
  const int d_own = tid - c_own * TPR;     // and its first output dim
  float acc_k[ACC], acc_v[ACC];
#pragma unroll
  for (int t = 0; t < ACC; ++t) {
    acc_k[t] = 0.0f;
    acc_v[t] = 0.0f;
  }

  // rows before k0 see no column of this tile (history rows are causal,
  // target rows start at n_hist > every history column, and a target
  // column is seen only from its own row)
  for (int q0 = k0; q0 < S; q0 += BT) {
    if (!tile_live(q0, k0, S, n_hist, L)) continue;
    __syncthreads();
    load_tile(q_s, ldk, q + base_qk, q0, S, Dqk);
    load_tile(g_s, ldv, g + base_v, q0, S, Dv);
    __syncthreads();

    for (int idx = tid; idx < BT * BT; idx += NT) {
      const int r = idx / BT, c = idx - r * BT;
      const Cell x = cell(q_s, k_s, g_s, v_s, rab_s, ldk, ldv, r, c, q0 + r,
                          k0 + c, S, n_hist, Dqk, Dv, max_rel, use_rab,
                          inv_sqrt_d, inv_s, L);
      a_s[r * ldp + c] = x.a;
      ds_s[r * ldp + c] = x.ds;
    }
    __syncthreads();

    for (int r = 0; r < BT; ++r) {
      const float a = a_s[r * ldp + c_own];
      const float ds = ds_s[r * ldp + c_own];
      const float* grow = g_s + r * ldv;
      const float* qrow = q_s + r * ldk;
#pragma unroll
      for (int t = 0; t < ACC; ++t) {
        const int d = d_own + t * TPR;
        if (d < Dv) acc_v[t] = fmaf(a, grow[d], acc_v[t]);
        if (d < Dqk) acc_k[t] = fmaf(ds, qrow[d], acc_k[t]);
      }
    }
  }

  const int col = k0 + c_own;
  if (col < S) {
    float* ok = dk + base_qk + (size_t)col * Dqk;
    float* ov = dv + base_v + (size_t)col * Dv;
#pragma unroll
    for (int t = 0; t < ACC; ++t) {
      const int d = d_own + t * TPR;
      if (d < Dqk) ok[d] = acc_k[t] * inv_sqrt_d;
      if (d < Dv) ov[d] = acc_v[t];
    }
  }
}

cudaError_t set_smem(const void* kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of each kernel needs; the wrapper checks
// it.
long long hstu_attention_bwd_dq_smem_bytes(int Dqk, int Dv, int max_rel,
                                           int use_rab) {
  const long long nrab = use_rab ? 2LL * max_rel + 1 : 0;
  return (long long)sizeof(float) *
         (2LL * BT * (Dqk + 1) + 2LL * BT * (Dv + 1) +
          (long long)BT * (BT + 1) + NDIAG + 2 * nrab);
}

long long hstu_attention_bwd_dkv_smem_bytes(int Dqk, int Dv, int max_rel,
                                            int use_rab) {
  const long long nrab = use_rab ? 2LL * max_rel + 1 : 0;
  return (long long)sizeof(float) *
         (2LL * BT * (Dqk + 1) + 2LL * BT * (Dv + 1) +
          2LL * BT * (BT + 1) + nrab);
}

// q, k, dq: (B, H, S, Dqk); v, g: (B, H, S, Dv); rab: (H, 2*max_rel+1) or
// null when use_rab == 0; hist_lengths, target_counts: (B,) int32;
// drab_part: (H, B * ceil(S / 32), 2*max_rel+1), written only when use_rab.
// All contiguous fp32 on the current device.
int hstu_attention_bwd_dq(const void* q, const void* k, const void* v,
                          const void* rab, const void* g,
                          const void* hist_lengths, const void* target_counts,
                          void* dq, void* drab_part, int B, int H, int S,
                          int Dqk, int Dv, int n_hist, int max_rel,
                          int use_rab, void* stream) {
  if (B * H == 0 || S == 0) return (int)cudaSuccess;
  const long long smem =
      hstu_attention_bwd_dq_smem_bytes(Dqk, Dv, max_rel, use_rab);
  const cudaError_t e = set_smem((const void*)hstu_bwd_dq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + BT - 1) / BT);
  hstu_bwd_dq_kernel<<<grid, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)rab,
      (const float*)g, (const int*)hist_lengths, (const int*)target_counts,
      (float*)dq, (float*)drab_part, B, H, S, Dqk, Dv, n_hist, max_rel,
      use_rab, 1.0f / sqrtf((float)Dqk), 1.0f / (float)S);
  return (int)cudaGetLastError();
}

// k, dk: (B, H, S, Dqk); v, dv: (B, H, S, Dv); the rest as above.
int hstu_attention_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* rab, const void* g,
                           const void* hist_lengths,
                           const void* target_counts, void* dk, void* dv,
                           int B, int H, int S, int Dqk, int Dv, int n_hist,
                           int max_rel, int use_rab, void* stream) {
  if (B * H == 0 || S == 0) return (int)cudaSuccess;
  const long long smem =
      hstu_attention_bwd_dkv_smem_bytes(Dqk, Dv, max_rel, use_rab);
  const cudaError_t e = set_smem((const void*)hstu_bwd_dkv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (S + BT - 1) / BT);
  hstu_bwd_dkv_kernel<<<grid, NT, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)rab,
      (const float*)g, (const int*)hist_lengths, (const int*)target_counts,
      (float*)dk, (float*)dv, H, S, Dqk, Dv, n_hist, max_rel, use_rab,
      1.0f / sqrtf((float)Dqk), 1.0f / (float)S);
  return (int)cudaGetLastError();
}

const char* hstu_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
