// The tile body shared by the HSTU forward kernels (B1:
// hstu_attention_fwd.cu, B4: hstu_attention_prefix_fwd.cu), for Hopper
// (sm_90a). Each kernel supplies a Layout: its row and column maps (which
// cells the mask keeps, each row's position for rab) and its tile skip.
// B1's is the ROO mask (RooMask, below), which the backward kernels B2 and
// B3 (hstu_attention_bwd.cu) read too. Everything else lives here once.
//
// Per (b, h), rows r < R and columns j < C:
//
//   out[r] = sum_j  SiLU(q_r . k_j * inv_sqrt_d + rab[h, clip(pos(r) - j)])
//                   * inv_scale * keep(r, j) * v_j
//
// Design:
//  * Products on tensor cores at fp32 accuracy: warp-level
//    mma.sync.m16n8k8 with tf32 operands and fp32 accumulators, each
//    operand split as hi = tf32(x), lo = tf32(x - hi) and accumulated as
//    lo*hi + hi*lo + hi*hi (3xTF32), for q.k^T and for p.v.
//  * A warp owns 16 q rows. The score fragment stays in registers: mask,
//    scale, rab, SiLU and 1/S are applied there, and the fragment is the A
//    operand of p.v as it is: the k index of p.v is permuted so that A's
//    column t holds score column 2t and column t+4 score column 2t+1, and
//    v's rows are read in the same order (no shuffle, no barrier).
//  * Accumulators sized to the padded D (32, 64 or 128, a template); the
//    padding columns are zero in shared memory; the loops over D stop at
//    the real D's 8-column blocks.
//  * A block covers one (b*h) and RB row tiles of 16; its 4 warps split
//    the k tiles KS = 4 / RB ways (warp w: row tile w / KS, k tiles
//    kt = t*KS + w % KS). Partial outputs are summed through shared memory
//    in a fixed order (split 0, then 1, 2, 3): no atomics, same bits on
//    every call. The host picks RB from the shape alone
//    (tile_config), so B1 and B4 on the same shape run the same order.
//  * k and v tiles (16 columns) arrive by 16-byte cp.async (4-byte where
//    D % 4 != 0 or a pointer is not 16-byte aligned) into a double-buffered
//    ring of rounds (KS tiles each): round t+1 is in flight while round t
//    is multiplied. Rows are padded to D + 4 floats, so every fragment
//    load is free of bank conflicts. Out-of-range rows are zero-filled by
//    the copy itself (src-size 0): no pad-and-crop on the host.
//  * A k tile that no row of the block can see is never loaded; a warp
//    multiplies only the tiles its own rows can see, and a row the mask
//    zeroes (a padded history row, a target slot past the count) sees
//    none. A block none of whose rows keeps a cell stages nothing and
//    writes its rows' zeros.
//  * Half the rab row in shared memory. Both layouts keep a cell only where
//    pos(r) >= j, so only the bins of deltas 0..max_rel (bins max_rel..
//    2*max_rel, rab_window) are ever read, and a block stages those alone:
//    at D 128 and max_rel 8,256 that is 100,612 B a block instead of
//    133,636, and two blocks fit an SM's 228 KB.
//  * The element type T is a template: float, or __nv_bfloat16 for bf16
//    models. A bf16 variant reads q, k, v and rab as bf16 (half the bytes),
//    keeps its tiles in shared memory as bf16 (rows padded to D + 8), widens
//    each fragment element to fp32 as it loads it, computes in fp32 and
//    rounds each output to bf16 once, at the store. A bf16 value is exact
//    in TF32 (its lo part is 0), so q.k^T is one TF32 mma (exact products,
//    fp32 sums) and p.v, p kept in fp32 (not rounded to bf16, as the
//    reference's jnp route rounds it), is two: lo(p)*v + hi(p)*v
//    (mma_acc). The same products as the fp32 kernel's 3xTF32 less the
//    terms that are exactly 0, in the same order: on bf16-valued inputs
//    the bf16 variant gives the fp32 kernel's output rounded to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hstu_fwd {

constexpr int ROWS = 16;          // q rows per warp (mma M)
constexpr int BK = 16;            // k columns per tile
constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;   // threads per block
constexpr long long FILL_BLOCKS = 4 * 132;  // four blocks per H100 SM

struct TileConfig {
  int rb;                         // row tiles per block
  int ks;                         // k-tile split: 4 / rb warps per row tile
};

// Chosen from the shape alone, so B1 and B4 at the same (B*H, R) agree.
// As many row tiles a block as its 4 warps hold (up to 4); fewer, with the
// k tiles split among the spare warps, while the grid would be under four
// blocks an SM (a launch here is latency-bound: more, shorter warps win).
inline TileConfig tile_config(long long n_heads, int R) {
  const int rt = (R + ROWS - 1) / ROWS;
  int rb = 1;
  while (rb < rt && rb < NWARPS) rb *= 2;
  while (rb > 1 && n_heads * ((rt + rb - 1) / rb) < FILL_BLOCKS) rb /= 2;
  return {rb, NWARPS / rb};
}

// D padded for the templates; the wrappers take D <= 128
inline int padded_d(int dqk, int dv) {
  const int d = dqk > dv ? dqk : dv;
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// Row stride (elements) of a shared tile of element size ES bytes: D
// padded by 16 bytes, which keeps rows 16-byte aligned for cp.async and
// every fragment load free of bank conflicts
__host__ __device__ constexpr int tile_ld(int dp, int es) {
  return dp + 16 / es;
}

// The rab bins a block stages (fp32): deltas 0..max_rel, the only ones a
// kept cell reads (module note). B1, B4, B2 and B3 all stage this window.
__host__ __device__ inline int rab_window(int max_rel, bool use_rab) {
  return use_rab ? max_rel + 1 : 0;
}

// Dynamic shared memory of one block: the q rows, the two-stage ring of KS
// k and v tiles (elements of ES bytes), and nrab staged rab bins (fp32).
inline long long smem_bytes(const TileConfig& c, int dp, int nrab,
                            int es = 4) {
  const long long ld = tile_ld(dp, es);
  return (long long)es * ((long long)c.rb * ROWS * ld +
                          2LL * c.ks * 2 * BK * ld) +
         4LL * nrab;
}

// The most any configuration needs (the 4-way split).
inline long long max_smem_bytes(int dqk, int dv, int nrab, int es = 4) {
  return smem_bytes(TileConfig{1, NWARPS}, padded_d(dqk, dv), nrab, es);
}

// fp32 <-> the element type: widening is exact, narrowing rounds to
// nearest even
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split once into its hi and lo parts.
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], hi[e], lo[e]);
  }
};

// c += a * b at fp32 accuracy: lo*hi + hi*lo + hi*hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a,
                                           const float (&b)[2]) {
  uint32_t bh[2], bl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) split_tf32(b[e], bh[e], bl[e]);
  mma_tf32(c, a.lo, bh);
  mma_tf32(c, a.hi, bl);
  mma_tf32(c, a.hi, bh);
}

// c += a * b at fp32 accuracy where an operand that is EXACT in TF32 (a
// widened bf16 value: its lo part is 0) skips the products with its lo
// part: mma_3xtf32's products less those that are exactly 0, in its order.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_acc(float (&c)[4], const SplitA& a,
                                        const float (&b)[2]) {
  if constexpr (!A_EXACT && !B_EXACT) {
    mma_3xtf32(c, a, b);
  } else if constexpr (B_EXACT) {
    const uint32_t bh[2] = {__float_as_uint(b[0]), __float_as_uint(b[1])};
    if constexpr (!A_EXACT) mma_tf32(c, a.lo, bh);
    mma_tf32(c, a.hi, bh);
  } else {
    uint32_t bh[2], bl[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) split_tf32(b[e], bh[e], bl[e]);
    mma_tf32(c, a.hi, bl);
    mma_tf32(c, a.hi, bh);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in_range) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = in_range ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in_range) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = in_range ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + n_rows) of a (n_src, d) matrix of T into shared rows
// of stride tile_ld(DP); rows past n_src are zero-filled, columns past d
// are left alone (the caller zeroes them once). vec: 16-byte cp.async
// chunks; else one element at a time (cp.async for fp32, a plain load and
// store for a 2-byte type, which cp.async cannot copy).
template <int DP, class T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int row0,
                                          int n_rows, int n_src, int d,
                                          bool vec) {
  constexpr int LD = tile_ld(DP, sizeof(T));
  constexpr int E = 16 / sizeof(T);     // elements a 16-byte chunk
  if (vec) {
    const int nch = d / E;
    for (int idx = threadIdx.x; idx < n_rows * (DP / E); idx += NT) {
      const int r = idx / (DP / E), ch = idx - r * (DP / E);
      if (ch >= nch) continue;
      const int row = row0 + r;
      const bool ok = row < n_src;
      cp_async16(dst + r * LD + E * ch,
                 src + (ok ? (size_t)row * d + E * ch : 0), ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < n_rows * DP; idx += NT) {
      const int r = idx / DP, c = idx - r * DP;
      if (c >= d) continue;
      const int row = row0 + r;
      const bool ok = row < n_src;
      if constexpr (sizeof(T) == 4)
        cp_async4(dst + r * LD + c, src + (ok ? (size_t)row * d + c : 0),
                  ok);
      else
        dst[r * LD + c] = ok ? src[(size_t)row * d + c] : from_f32<T>(0.0f);
    }
  }
}

// zero columns [d, DP) of n_rows shared rows
template <int DP, class T>
__device__ __forceinline__ void zero_pad(T* dst, int n_rows, int d) {
  constexpr int LD = tile_ld(DP, sizeof(T));
  if (d >= DP) return;
  for (int idx = threadIdx.x; idx < n_rows * DP; idx += NT) {
    const int r = idx / DP, c = idx - r * DP;
    if (c >= d) dst[r * LD + c] = from_f32<T>(0.0f);
  }
}

// n rab bins into fp32 shared memory (cp.async for fp32, widened one
// element at a time for bf16)
template <class T>
__device__ __forceinline__ void load_rab(float* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) {
    if constexpr (sizeof(T) == 4)
      cp_async4(dst + i, src + i, true);
    else
      dst[i] = to_f32(src[i]);
  }
}

// The ROO mask over positions 0..S-1 of [history | targets]: B1's layout,
// and B2's and B3's mask; i is a q position, j a k position.
struct RooMask {
  int S, n_hist, hl, tc;
  int hist_end;   // valid history positions are [0, hist_end)
  int tgt_end;    // valid target positions are [n_hist, tgt_end)

  __device__ RooMask(const int* hist_lengths, const int* target_counts,
                     int b, int S_, int n_hist_)
      : S(S_), n_hist(n_hist_), hl(hist_lengths[b]), tc(target_counts[b]) {
    hist_end = max(0, min(hl, n_hist));
    tgt_end = n_hist + max(0, min(tc, S - n_hist));
  }
  __device__ bool keep(int i, int j) const {
    const bool is_hq = i < n_hist, is_hk = j < n_hist;
    const bool st = is_hk ? (!is_hq || j <= i) : (!is_hq && i == j);
    const bool vr = is_hq ? (i < hl) : (i - n_hist < tc);
    const bool vc = is_hk ? (j < hl) : (j - n_hist < tc);
    return i < S && j < S && st && vr && vc;
  }
  __device__ int pos(int i) const { return i; }
  // Whether some q row of [i_lo, i_hi] keeps some k column of [j_lo, j_hi]:
  // a valid history column is seen by the valid history rows at or past it
  // and by every valid target row; a valid target column only by its own
  // diagonal.
  __device__ bool live(int i_lo, int i_hi, int j_lo, int j_hi) const {
    const int hrow_hi = min(i_hi, hist_end - 1);
    const int trow_lo = max(i_lo, n_hist);
    const int trow_hi = min(i_hi, tgt_end - 1);
    const int hcol_hi = min(j_hi, hist_end - 1);
    if (j_lo <= hcol_hi &&
        (trow_lo <= trow_hi || (i_lo <= hrow_hi && j_lo <= hrow_hi)))
      return true;
    return max(max(j_lo, n_hist), trow_lo) <= min(j_hi, trow_hi);
  }
};

template <class T>
struct TileArgs {
  const T* q;                     // (R, Dqk) of this (b, h)
  const T* k;                     // (C, Dqk)
  const T* v;                     // (C, Dv)
  const T* rab;                   // (2*max_rel+1) of this h, or null
  T* out;                         // (R, Dv)
  int R, C, Dqk, Dv, max_rel;
  int vec_qk, vec_v;              // 16-byte copies allowed
  float inv_sqrt_d, inv_scale;
  int rb, ks;                     // tile_config
};

// The block's work: row tiles [blockIdx.y * rb, +rb) of one (b, h).
// Layout: keep(r, j), pos(r) and live(r_lo, r_hi, j_lo, j_hi) (some row in
// [r_lo, r_hi] keeps some column in [j_lo, j_hi]), all for r < R, j < C;
// keep(r, j) implies pos(r) >= j.
template <int DP, class T, class Layout>
__device__ __forceinline__ void fwd_tile(const Layout& L, const TileArgs<T>& a,
                                         float* smem) {
  constexpr int LD = tile_ld(DP, sizeof(T));
  constexpr int NB = DP / 8;      // 8-column blocks of D
  constexpr bool EXACT = sizeof(T) == 2;  // bf16 operands: exact in TF32
  const int ks_n = a.ks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int my_rt = warp / ks_n, my_ks = warp - my_rt * ks_n;

  T* q_s = reinterpret_cast<T*>(smem);             // rb*16 x LD
  T* ring = q_s + a.rb * ROWS * LD;                 // [2][ks][k|v] BK x LD
  float* rab_s =                                    // max_rel+1
      reinterpret_cast<float*>(ring + 2 * ks_n * 2 * BK * LD);

  const int bq0 = blockIdx.y * a.rb * ROWS;
  const int bq_last = min(bq0 + a.rb * ROWS, a.R) - 1;
  const int wq0 = bq0 + my_rt * ROWS;
  const int wq_last = min(wq0 + ROWS, a.R) - 1;
  const int n_kt = (a.C + BK - 1) / BK;
  const int n_rounds = (n_kt + ks_n - 1) / ks_n;
  const int nb_qk = (a.Dqk + 7) >> 3, nb_v = (a.Dv + 7) >> 3;

  auto tile_live = [&](int kt, int r_lo, int r_hi) {
    const int k0 = kt * BK;
    return kt < n_kt && r_lo <= r_hi &&
           L.live(r_lo, r_hi, k0, min(k0 + BK, a.C) - 1);
  };
  auto next_round = [&](int t) {    // first round >= t the block needs
    for (; t < n_rounds; ++t)
      for (int s = 0; s < ks_n; ++s)
        if (tile_live(t * ks_n + s, bq0, bq_last)) return t;
    return n_rounds;
  };
  auto issue_round = [&](int t, int stage) {
    for (int s = 0; s < ks_n; ++s) {
      const int kt = t * ks_n + s;
      if (!tile_live(kt, bq0, bq_last)) continue;
      T* k_s = ring + ((stage * ks_n + s) * 2) * BK * LD;
      copy_rows<DP>(k_s, a.k, kt * BK, BK, a.C, a.Dqk, a.vec_qk);
      copy_rows<DP>(k_s + BK * LD, a.v, kt * BK, BK, a.C, a.Dv, a.vec_v);
    }
  };

  // a block none of whose rows keeps a cell writes its rows' zeros (they
  // are contiguous) and stages nothing
  int t = next_round(0);
  if (t == n_rounds) {
    T* out = a.out + (size_t)bq0 * a.Dv;
    for (int i = threadIdx.x; i < (bq_last - bq0 + 1) * a.Dv; i += NT)
      out[i] = from_f32<T>(0.0f);
    return;
  }
  // q, the staged rab bins and the first round; the first barrier of the
  // loop makes all of it visible
  copy_rows<DP>(q_s, a.q, bq0, a.rb * ROWS, a.R, a.Dqk, a.vec_qk);
  if (a.rab != nullptr) load_rab(rab_s, a.rab + a.max_rel, a.max_rel + 1);
  issue_round(t, 0);
  cp_async_commit();
  // padding columns, once: no copy ever writes them
  zero_pad<DP>(q_s, a.rb * ROWS, a.Dqk);
  for (int i = 0; i < 2 * ks_n; ++i) {
    zero_pad<DP>(ring + i * 2 * BK * LD, BK, a.Dqk);
    zero_pad<DP>(ring + (i * 2 + 1) * BK * LD, BK, a.Dv);
  }

  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  const T* qw = q_s + my_rt * ROWS * LD;
  int stage = 0;
  while (t < n_rounds) {
    const int t_next = next_round(t + 1);
    if (t_next < n_rounds) issue_round(t_next, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this round (and q) has landed for this thread
    __syncthreads();      // ... and for every thread

    const int kt = t * ks_n + my_ks;
    if (tile_live(kt, wq0, wq_last)) {
      const T* k_s = ring + ((stage * ks_n + my_ks) * 2) * BK * LD;
      const T* v_s = k_s + BK * LD;
      const int k0 = kt * BK;
      // scores: (16 x BK) = q (16 x Dqk) . k^T, two 8-column blocks
      float s[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        if (kk >= nb_qk) break;
        const T* qa = qw + g * LD + kk * 8 + t4;
        const SplitA af({to_f32(qa[0]), to_f32(qa[8 * LD]), to_f32(qa[4]),
                         to_f32(qa[8 * LD + 4])});
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const T* kb = k_s + (j * 8 + g) * LD + kk * 8 + t4;
          const float bf[2] = {to_f32(kb[0]), to_f32(kb[4])};
          mma_acc<EXACT, EXACT>(s[j], af, bf);
        }
      }
      // mask, scale, rab, SiLU and 1/S on the fragment; element e of block
      // j is row g (+8 for e >= 2), column 8j + 2*t4 (+1 for odd e)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wq0 + g + (e >> 1) * 8;
          const int c = k0 + j * 8 + 2 * t4 + (e & 1);
          float p = 0.0f;
          if (r < a.R && c < a.C && L.keep(r, c)) {
            float x = s[j][e] * a.inv_sqrt_d;
            if (a.rab != nullptr)   // the bin of delta pos(r) - c >= 0
              x += rab_s[min(L.pos(r) - c, a.max_rel)];
            p = silu(x) * a.inv_scale;
          }
          s[j][e] = p;
        }
      // out (16 x Dv) += p (16 x BK) . v, with the permuted k index
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const SplitA af({s[j][0], s[j][2], s[j][1], s[j][3]});
        const T* vb = v_s + (j * 8 + 2 * t4) * LD + g;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (n >= nb_v) break;
          const float bf[2] = {to_f32(vb[n * 8]), to_f32(vb[LD + n * 8])};
          mma_acc<false, EXACT>(o[n], af, bf);
        }
      }
    }
    __syncthreads();      // the stage is free for round t + 2
    t = t_next;
    stage ^= 1;
  }
  cp_async_wait<0>();

  // the k-split's partials, summed in a fixed order through the ring
  if (ks_n > 1) {
    __syncthreads();
    float* part = reinterpret_cast<float*>(ring);  // [rb][ks-1][NB][4][32]
    if (my_ks > 0 && wq0 < a.R) {
      float* p = part + ((my_rt * (ks_n - 1) + my_ks - 1) * NB) * 128;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (n >= nb_v) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) p[(n * 4 + e) * 32 + lane] = o[n][e];
      }
    }
    __syncthreads();
    if (my_ks == 0 && wq0 < a.R) {
      for (int s = 1; s < ks_n; ++s) {
        const float* p = part + ((my_rt * (ks_n - 1) + s - 1) * NB) * 128;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (n >= nb_v) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] += p[(n * 4 + e) * 32 + lane];
        }
      }
    }
  }
  if (my_ks != 0 || wq0 >= a.R) return;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    if (n >= nb_v) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wq0 + g + (e >> 1) * 8;
      const int c = n * 8 + 2 * t4 + (e & 1);
      if (r < a.R && c < a.Dv)
        a.out[(size_t)r * a.Dv + c] = from_f32<T>(o[n][e]);
    }
  }
}

// Host side, for the launchers of the .cu files: whether 16-byte copies
// may be used (rows of d elements of es bytes), and the dynamic shared
// memory a kernel needs above 48 KB.
inline bool vec_ok(const void* p0, const void* p1, int d, int es = 4) {
  return d % (16 / es) == 0 && (((uintptr_t)p0 | (uintptr_t)p1) & 15) == 0;
}

template <class F>
inline cudaError_t set_smem(F* kern, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace hstu_fwd
