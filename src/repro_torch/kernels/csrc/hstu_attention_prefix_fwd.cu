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
// the kept q rows and k/v columns and write the output, ~1.6 MB (~0.5 us
// at 3.35 TB/s), and do a few MFLOP for the cells the mask keeps: bytes set
// the bound, and a single launch's latency floor of a few us sits above
// it. The design is B1's (hstu_fwd_tile.cuh; see hstu_attention_fwd.cu for
// what it does about the first version's serial FMA chains, oversized
// accumulators and unoverlapped loads). What matters most here: a head has
// only 24 rows (two 16-row tiles), so the first version ran one 4-warp
// block per head walking its k tiles in series (128 blocks, under one an
// SM); now each row tile's k tiles are split among 4 warps (8 warps a
// head, 256 blocks at that shape), summed in a fixed order. At prefix 0
// with n_new = n_hist this runs the same tile body, configuration and
// summation order as B1, so the two agree bit for bit.
//
// This file holds the prefix layout's row and column maps and its tile
// skip: a tile's valid new rows need history columns up to
// min(prefix + last valid new row, prefix + new - 1); its valid target
// rows need the valid history plus the target columns on their diagonals;
// every other k tile is skipped.
//
// bf16 (hstu_attention_prefix_fwd_bf16): the same kernel on bf16 q, the
// bf16 K/V buffer and rab, writing a bf16 output; fp32 inside and one
// rounding at the store, as B1's bf16 variant (hstu_fwd_tile.cuh).
//
// Interface: plain C, loaded with ctypes. The host function launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include "hstu_fwd_tile.cuh"

namespace {

using namespace hstu_fwd;

struct PrefixLayout {
  int n_hist, n_new, n_tgt, C;
  int pfx, nc, tc;
  int hist_end;   // valid history columns: j < prefix + new, j < n_hist

  __device__ bool keep(int r, int j) const {
    const bool is_new = r < n_new, is_hk = j < n_hist;
    const bool st = is_hk ? (!is_new || j <= pos(r))
                          : (!is_new && r - n_new == j - n_hist);
    const bool vr = is_new ? (r < nc) : (r - n_new < tc);
    const bool vc = is_hk ? (j < hist_end) : (j - n_hist < tc);
    return st && vr && vc;
  }
  __device__ int pos(int r) const {
    return r < n_new ? pfx + r : r + (n_hist - n_new);
  }
  __device__ bool live(int r_lo, int r_hi, int j_lo, int j_hi) const {
    // valid new rows [r_lo, new_hi]; valid target rows [tgt_lo, tgt_hi]
    const int new_hi = min(r_hi, min(n_new, nc) - 1);
    const int tgt_lo = max(r_lo, n_new);
    const int tgt_hi = min(r_hi, n_new + min(max(tc, 0), n_tgt) - 1);
    int hist_hi = -1;                    // last history column needed
    if (new_hi >= r_lo)
      hist_hi = (int)min((long long)pfx + new_hi, (long long)hist_end - 1);
    if (tgt_lo <= tgt_hi) hist_hi = hist_end - 1;
    // target columns on the valid target rows' diagonals
    const int tcol_lo = n_hist + (tgt_lo - n_new);
    const int tcol_hi =
        tgt_lo <= tgt_hi ? min(n_hist + (tgt_hi - n_new), C - 1) : -1;
    return j_lo <= hist_hi || max(j_lo, tcol_lo) <= min(j_hi, tcol_hi);
  }
};

template <int DP, class T>
__global__ void __launch_bounds__(NT, 4)
hstu_prefix_fwd_kernel(TileArgs<T> a, const int* __restrict__ prefix_lengths,
                       const int* __restrict__ new_counts,
                       const int* __restrict__ target_counts, int H,
                       int n_hist, int n_new) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  PrefixLayout L;
  L.n_hist = n_hist;
  L.n_new = n_new;
  L.n_tgt = a.R - n_new;               // 0: an extend-only call
  L.C = a.C;
  L.pfx = prefix_lengths[b];
  L.nc = new_counts[b];
  L.tc = target_counts[b];
  L.hist_end =
      (int)max(0LL, min((long long)L.pfx + L.nc, (long long)n_hist));
  a.q += (size_t)bh * a.R * a.Dqk;
  a.k += (size_t)bh * a.C * a.Dqk;
  a.v += (size_t)bh * a.C * a.Dv;
  a.out += (size_t)bh * a.R * a.Dv;
  if (a.rab != nullptr) a.rab += (size_t)h * (2 * a.max_rel + 1);
  fwd_tile<DP>(L, a, smem);
}

template <int DP, class T>
cudaError_t launch(const TileArgs<T>& a, const int* pfx, const int* nc,
                   const int* tc, int BH, int H, int n_hist, int n_new,
                   int nrab, cudaStream_t stream) {
  const long long smem =
      smem_bytes(TileConfig{a.rb, a.ks}, DP, nrab, sizeof(T));
  const cudaError_t e = set_smem(hstu_prefix_fwd_kernel<DP, T>, smem);
  if (e != cudaSuccess) return e;
  const int rt = (a.R + ROWS - 1) / ROWS;
  const dim3 grid(BH, (rt + a.rb - 1) / a.rb);
  hstu_prefix_fwd_kernel<DP, T><<<grid, NT, (size_t)smem, stream>>>(
      a, pfx, nc, tc, H, n_hist, n_new);
  return cudaGetLastError();
}

template <class T>
int run(const void* q, const void* k, const void* v, const void* rab,
        const void* prefix_lengths, const void* new_counts,
        const void* target_counts, void* out, int B, int H, int R, int C,
        int Dqk, int Dv, int n_hist, int n_new, int scale_len, int max_rel,
        int use_rab, void* stream) {
  if (B * H == 0 || R == 0) return (int)cudaSuccess;
  const TileConfig cfg = tile_config((long long)B * H, R);
  TileArgs<T> a;
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.rab = use_rab ? (const T*)rab : nullptr;
  a.out = (T*)out;
  a.R = R;
  a.C = C;
  a.Dqk = Dqk;
  a.Dv = Dv;
  a.max_rel = max_rel;
  a.vec_qk = vec_ok(q, k, Dqk, sizeof(T));
  a.vec_v = vec_ok(v, v, Dv, sizeof(T));
  a.inv_sqrt_d = 1.0f / sqrtf((float)Dqk);
  a.inv_scale = 1.0f / (float)scale_len;
  a.rb = cfg.rb;
  a.ks = cfg.ks;
  const int nrab = rab_window(max_rel, use_rab);
  const int* pfx = (const int*)prefix_lengths;
  const int* nc = (const int*)new_counts;
  const int* tc = (const int*)target_counts;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (padded_d(Dqk, Dv)) {
    case 32:
      return (int)launch<32>(a, pfx, nc, tc, B * H, H, n_hist, n_new, nrab,
                             st);
    case 64:
      return (int)launch<64>(a, pfx, nc, tc, B * H, H, n_hist, n_new, nrab,
                             st);
    default:
      return (int)launch<128>(a, pfx, nc, tc, B * H, H, n_hist, n_new, nrab,
                              st);
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block may need, at most; the wrapper checks it.
long long hstu_attention_prefix_fwd_smem_bytes(int Dqk, int Dv, int max_rel,
                                               int use_rab) {
  return max_smem_bytes(Dqk, Dv, rab_window(max_rel, use_rab));
}

long long hstu_attention_prefix_fwd_bf16_smem_bytes(int Dqk, int Dv,
                                                    int max_rel,
                                                    int use_rab) {
  return max_smem_bytes(Dqk, Dv, rab_window(max_rel, use_rab), 2);
}

// q: (B, H, R, Dqk) with R = n_new + m; k: (B, H, C, Dqk) and v: (B, H, C,
// Dv) with C = n_hist + m; out: (B, H, R, Dv); rab: (H, 2*max_rel+1) or null
// when use_rab == 0; prefix_lengths, new_counts, target_counts: (B,) int32.
// All contiguous on the current device: fp32 here, bf16 (q, k, v, rab,
// out) in hstu_attention_prefix_fwd_bf16.
int hstu_attention_prefix_fwd(const void* q, const void* k, const void* v,
                              const void* rab, const void* prefix_lengths,
                              const void* new_counts,
                              const void* target_counts, void* out, int B,
                              int H, int R, int C, int Dqk, int Dv,
                              int n_hist, int n_new, int scale_len,
                              int max_rel, int use_rab, void* stream) {
  return run<float>(q, k, v, rab, prefix_lengths, new_counts, target_counts,
                    out, B, H, R, C, Dqk, Dv, n_hist, n_new, scale_len,
                    max_rel, use_rab, stream);
}

int hstu_attention_prefix_fwd_bf16(const void* q, const void* k,
                                   const void* v, const void* rab,
                                   const void* prefix_lengths,
                                   const void* new_counts,
                                   const void* target_counts, void* out,
                                   int B, int H, int R, int C, int Dqk,
                                   int Dv, int n_hist, int n_new,
                                   int scale_len, int max_rel, int use_rab,
                                   void* stream) {
  return run<__nv_bfloat16>(q, k, v, rab, prefix_lengths, new_counts,
                            target_counts, out, B, H, R, C, Dqk, Dv, n_hist,
                            n_new, scale_len, max_rel, use_rab, stream);
}

const char* hstu_attention_prefix_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
