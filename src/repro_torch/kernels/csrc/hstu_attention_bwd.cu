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
// target_counts[b] by the forward's RooMask (hstu_fwd_tile.cuh).
//
// What bounds them on this card: at the training shape (B = 32, H = 2,
// S = 80, Dqk = Dv = 32, fp32) each kernel must read the kept q, k, v and g
// rows once (~1.3 MB) and write its outputs once (~0.65 MB for dq, ~1.3 MB
// for dk and dv): under 1 us at 3.35 TB/s, against well under 1 us of
// arithmetic. So bytes set the bound; but, as for the forward, a launch of
// a few hundred short blocks with two dependent tile rounds has a latency
// floor of several us above it, and the design aims at that floor.
//
// Design: B1's tile body (hstu_fwd_tile.cuh) turned into a backward, one
// template (bwd_tile) for both kernels. A warp owns 16 output rows: 16 q
// rows in B2, 16 k columns in B3. The warp's two operand tiles stay in
// shared memory for the whole launch (B2: q and g; B3: k and v), and the
// other side streams past in 16-wide tiles (B2: k and v; B3: q and g):
//  * Products on tensor cores at fp32 accuracy: 3xTF32 mma.sync.m16n8k8
//    (lo*hi + hi*lo + hi*hi, fp32 accumulators) for every product: B2
//    s = q.k^T, da = g.v^T, dq += ds.k; B3 s^T = k.q^T, da^T = v.g^T,
//    dk += ds^T.q, dv += a^T.g. The score fragments are masked, scaled,
//    rab'd and turned into a and ds (SiLU and SiLU', times 1/S) in
//    registers, then fed to the next product as its A operand through the
//    permuted k index (A column t <-> tile column 2t, t+4 <-> 2t+1), with
//    the streamed rows read in that order: no shuffle, no barrier.
//  * B3 is the same body transposed. Its tile rows are k positions j and
//    its tile columns q positions i, so the mask is read as keep(i, j) with
//    the two swapped, the rab delta is i - j with i the tile COLUMN, and the
//    tile skip asks whether some q row of the streamed tile sees some k
//    column of the warp's (a history column: valid history rows from its
//    own row on and every valid target row; a target column: only its own
//    diagonal).
//  * Parallelism: a block covers one (b*h) and rb 16-row tiles; its 4 warps
//    split the streamed tiles ks = 4 / rb ways, chosen from (B*H, S) alone
//    by tile_config, as B1 does. The k-split partials of dq (B2) or dk and
//    dv (B3) are summed through shared memory in a fixed order (split 0,
//    then 1, 2, 3).
//  * Loads: 16-byte cp.async (4-byte where D % 4 != 0 or a pointer is not
//    16-byte aligned) into a double-buffered ring of rounds of ks tiles,
//    round t+1 in flight while round t is multiplied; rows padded to D + 4
//    floats (conflict-free fragment loads); out-of-range rows zero-filled
//    by the copy. Rounds start at the block's first live tile, a tile no
//    row of the block can see is never loaded, and a warp multiplies only
//    the tiles its own rows can see.
//  * Half the rab row in shared memory. The ROO mask keeps a cell only
//    where i >= j, so only the bins of deltas 0..max_rel (max_rel + 1 of
//    the 2 * max_rel + 1) are ever read or get a gradient: both kernels
//    stage those alone (with D 128 and max_rel 8,256 the whole row would
//    take B2 past the 227 KB a block may have), and the other bins' drab
//    is exactly 0.
//  * drab without float atomics, in two fixed-order stages. In B2 each warp
//    stages its 16 x 16 ds tile in shared memory and sums each of its 31
//    diagonals in row order (one lane a diagonal); the diagonals whose
//    delta clips to -max_rel or +max_rel are summed by a fixed shuffle
//    tree. After the round's barrier the block folds them into the head's
//    compact delta table in shared memory, one thread per delta of the
//    round adding the warps' sums in warp order (an unclipped delta has a
//    bin of its own; one thread adds the clipped sums to the bins of
//    -max_rel, which only max_rel 0 stages, and max_rel). The block writes
//    its table of the staged bins once to an (H, max_rel + 1,
//    B * row blocks) buffer, which the caller sums over its last
//    (contiguous) axis. Two calls give the same bits.
// Both read the lengths in-block, use the unpadded S for 1/S, and give
// exact zeros for masked rows (dq) and columns (dk, dv).
//
// bf16 (hstu_attention_bwd_dq_bf16, hstu_attention_bwd_dkv_bf16): the same
// kernels on bf16 q, k, v, g and rab, writing bf16 dq, dk and dv (the drab
// partials stay fp32, as the reference's). They hold bf16 tiles in shared
// memory and compute in fp32, as B1's bf16 variant (hstu_fwd_tile.cuh):
// the products of two bf16 operands (the scores and g.v^T) are one TF32
// mma, those of an fp32 fragment and a bf16 operand (ds.k, ds^T.q, a^T.g)
// two, and each output is rounded to bf16 once, at the store.
//
// Interface: plain C, loaded with ctypes. Each host function launches one
// kernel on the caller's stream, does not synchronise, and returns
// cudaGetLastError().

#include "hstu_fwd_tile.cuh"

namespace {

using namespace hstu_fwd;

constexpr int NDIAG = 2 * ROWS - 1;   // diagonals of a 16 x 16 tile (31)
constexpr int DS_LD = ROWS + 1;       // row stride of a staged ds tile
constexpr int DIAG_LD = NDIAG + 2;    // a warp's diagonal sums, lo, hi
static_assert(BK == ROWS, "the drab fold stages square 16 x 16 tiles");

template <class T>
struct BwdArgs {
  const T* hold1;       // the warps' own rows: q (B2) / k (B3), (S, Dqk)
  const T* hold2;       //                      g (B2) / v (B3), (S, Dv)
  const T* str1;        // the streamed tiles:  k (B2) / q (B3), (S, Dqk)
  const T* str2;        //                      v (B2) / g (B3), (S, Dv)
  const T* rab;         // (2*max_rel+1) of this h, or null
  T* out1;              // dq (B2) / dk (B3), (S, Dqk)
  T* out2;              // dv (B3), (S, Dv)
  float* part;          // drab partials (B2, rab only)
  int H, S, Dqk, Dv, max_rel;
  int vec_qk, vec_v;    // 16-byte copies allowed
  float inv_sqrt_d, inv_s;
  int rb, ks;           // tile_config
};

// Dynamic shared memory of one block: the two held tiles and the two-stage
// ring of ks streamed tile pairs (elements of es bytes), then fp32: the
// nwin staged rab bins and, for B2's drab, their delta table, the warps'
// staged ds tiles and their diagonal sums.
inline long long bwd_smem_bytes(const TileConfig& c, int dp, int nwin,
                                bool fold, int es = 4) {
  const long long ld = tile_ld(dp, es);
  long long n = nwin;
  if (fold) n += nwin + NWARPS * ROWS * DS_LD + NWARPS * DIAG_LD;
  return es * (2LL * c.rb * ROWS * ld + 2LL * c.ks * 2 * BK * ld) + 4 * n;
}

// B3 holds two accumulator sets (dk and dv): at D 64 and 128 it gets more
// registers a thread, and fewer blocks an SM, than B2.
template <int DP, bool DKV>
constexpr int min_blocks() {
  return DP <= 32 ? 4 : DP <= 64 ? (DKV ? 3 : 4) : 2;
}

// The block's work: row tiles [blockIdx.y * rb, +rb) of one (b, h).
template <int DP, bool DKV, class T>
__device__ __forceinline__ void bwd_tile(const RooMask& L,
                                         const BwdArgs<T>& a, float* smem) {
  constexpr int LD = tile_ld(DP, sizeof(T));
  constexpr int NB = DP / 8;      // 8-column blocks of D
  constexpr bool EXACT = sizeof(T) == 2;  // bf16 operands: exact in TF32
  const int ks_n = a.ks, S = a.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int my_rt = warp / ks_n, my_ks = warp - my_rt * ks_n;
  const bool use_rab = a.rab != nullptr;
  const bool fold = !DKV && use_rab;
  // the staged bins: deltas 0..max_rel (rab bins max_rel..2*max_rel)
  const int nwin = rab_window(a.max_rel, use_rab);

  T* h1_s = reinterpret_cast<T*>(smem);             // rb*16 x LD
  T* h2_s = h1_s + a.rb * ROWS * LD;                // rb*16 x LD
  T* ring = h2_s + a.rb * ROWS * LD;                // [2][ks][1|2] BK x LD
  float* rab_s =                                    // nwin
      reinterpret_cast<float*>(ring + 2 * ks_n * 2 * BK * LD);
  float* drab_s = rab_s + nwin;                     // nwin (fold)
  float* ds_s = drab_s + nwin;                      // NWARPS x 16 x DS_LD
  float* diag_s = ds_s + NWARPS * ROWS * DS_LD;     // NWARPS x DIAG_LD

  const int br0 = blockIdx.y * a.rb * ROWS;
  const int br_last = min(br0 + a.rb * ROWS, S) - 1;
  const int wr0 = br0 + my_rt * ROWS;
  const int wr_last = min(wr0 + ROWS, S) - 1;
  const int n_t = (S + BK - 1) / BK;
  const int nb_qk = (a.Dqk + 7) >> 3, nb_v = (a.Dv + 7) >> 3;

  // whether some row of [r_lo, r_hi] sees some column of tile ct; rows are
  // q positions in B2 and k positions in B3
  auto live = [&](int ct, int r_lo, int r_hi) {
    if (ct >= n_t || r_lo > r_hi) return false;
    const int c0 = ct * BK, c_hi = min(c0 + BK, S) - 1;
    return DKV ? L.live(c0, c_hi, r_lo, r_hi) : L.live(r_lo, r_hi, c0, c_hi);
  };
  int ct0 = 0;                      // rounds start at the first live tile
  while (ct0 < n_t && !live(ct0, br0, br_last)) ++ct0;
  const int n_rounds = (n_t - ct0 + ks_n - 1) / ks_n;
  auto next_round = [&](int t) {    // first round >= t the block needs
    for (; t < n_rounds; ++t)
      for (int s = 0; s < ks_n; ++s)
        if (live(ct0 + t * ks_n + s, br0, br_last)) return t;
    return n_rounds;
  };
  auto issue_round = [&](int t, int stage) {
    for (int s = 0; s < ks_n; ++s) {
      const int ct = ct0 + t * ks_n + s;
      if (!live(ct, br0, br_last)) continue;
      T* s1 = ring + ((stage * ks_n + s) * 2) * BK * LD;
      copy_rows<DP>(s1, a.str1, ct * BK, BK, S, a.Dqk, a.vec_qk);
      copy_rows<DP>(s1 + BK * LD, a.str2, ct * BK, BK, S, a.Dv, a.vec_v);
    }
  };

  // the held rows and rab first, then the first round; the first barrier
  // of the loop makes all of it visible
  copy_rows<DP>(h1_s, a.hold1, br0, a.rb * ROWS, S, a.Dqk, a.vec_qk);
  copy_rows<DP>(h2_s, a.hold2, br0, a.rb * ROWS, S, a.Dv, a.vec_v);
  if (use_rab) load_rab(rab_s, a.rab + a.max_rel, nwin);
  int t = next_round(0);
  if (t < n_rounds) issue_round(t, 0);
  cp_async_commit();
  // padding columns, once: no copy ever writes them
  zero_pad<DP>(h1_s, a.rb * ROWS, a.Dqk);
  zero_pad<DP>(h2_s, a.rb * ROWS, a.Dv);
  for (int i = 0; i < 2 * ks_n; ++i) {
    zero_pad<DP>(ring + i * 2 * BK * LD, BK, a.Dqk);
    zero_pad<DP>(ring + (i * 2 + 1) * BK * LD, BK, a.Dv);
  }
  if (fold)                         // visible after the first barrier
    for (int i = threadIdx.x; i < nwin; i += NT) drab_s[i] = 0.0f;

  float acc1[NB][4];                // dq (B2) / dk (B3)
  float acc2[DKV ? NB : 1][4];      // dv (B3)
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[n][e] = 0.0f;
      if constexpr (DKV) acc2[n][e] = 0.0f;
    }

  const T* h1w = h1_s + my_rt * ROWS * LD;
  const T* h2w = h2_s + my_rt * ROWS * LD;
  int stage = 0;
  while (t < n_rounds) {
    const int t_next = next_round(t + 1);
    if (t_next < n_rounds) issue_round(t_next, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this round (and the held rows) has landed here
    __syncthreads();      // ... and for every thread

    const int ct = ct0 + t * ks_n + my_ks;
    const bool warp_live = live(ct, wr0, wr_last);
    if (warp_live) {
      const T* s1 = ring + ((stage * ks_n + my_ks) * 2) * BK * LD;
      const T* s2 = s1 + BK * LD;
      const int c0 = ct * BK;
      // p = hold1 . str1^T (the scores), d = hold2 . str2^T (da): 16 x BK
      float p[BK / 8][4], d[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = d[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        if (kk >= nb_qk) break;
        const T* x = h1w + g * LD + kk * 8 + t4;
        const SplitA af({to_f32(x[0]), to_f32(x[8 * LD]), to_f32(x[4]),
                         to_f32(x[8 * LD + 4])});
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const T* y = s1 + (j * 8 + g) * LD + kk * 8 + t4;
          const float bf[2] = {to_f32(y[0]), to_f32(y[4])};
          mma_acc<EXACT, EXACT>(p[j], af, bf);
        }
      }
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        if (kk >= nb_v) break;
        const T* x = h2w + g * LD + kk * 8 + t4;
        const SplitA af({to_f32(x[0]), to_f32(x[8 * LD]), to_f32(x[4]),
                         to_f32(x[8 * LD + 4])});
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const T* y = s2 + (j * 8 + g) * LD + kk * 8 + t4;
          const float bf[2] = {to_f32(y[0]), to_f32(y[4])};
          mma_acc<EXACT, EXACT>(d[j], af, bf);
        }
      }
      // mask, scale, rab, SiLU / SiLU' and 1/S on the fragments; element e
      // of block j is tile row g (+8 for e >= 2), column 8j + 2*t4 (+1 for
      // odd e). p becomes a (B3 only), d becomes ds.
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wr0 + g + (e >> 1) * 8;
          const int c = c0 + j * 8 + 2 * t4 + (e & 1);
          const int i = DKV ? c : r, jk = DKV ? r : c;
          float av = 0.0f, dsv = 0.0f;
          if (L.keep(i, jk)) {
            float x = p[j][e] * a.inv_sqrt_d;
            if (use_rab)              // keep(i, jk) implies i >= jk
              x += rab_s[min(i - jk, a.max_rel)];
            const float sig = 1.0f / (1.0f + expf(-x));
            av = x * sig * a.inv_s;
            dsv = d[j][e] * a.inv_s * (sig * (1.0f + x * (1.0f - sig)));
          }
          p[j][e] = av;
          d[j][e] = dsv;
        }
      // acc1 += ds . str1 and (B3) acc2 += a . str2, with the permuted k
      // index: A column t is tile column 2t, t + 4 is 2t + 1
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const SplitA af({d[j][0], d[j][2], d[j][1], d[j][3]});
        const T* y = s1 + (j * 8 + 2 * t4) * LD + g;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          if (n >= nb_qk) break;
          const float bf[2] = {to_f32(y[n * 8]), to_f32(y[LD + n * 8])};
          mma_acc<false, EXACT>(acc1[n], af, bf);
        }
        if constexpr (DKV) {
          const SplitA aa({p[j][0], p[j][2], p[j][1], p[j][3]});
          const T* z = s2 + (j * 8 + 2 * t4) * LD + g;
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            if (n >= nb_v) break;
            const float bf[2] = {to_f32(z[n * 8]), to_f32(z[LD + n * 8])};
            mma_acc<false, EXACT>(acc2[n], aa, bf);
          }
        }
      }
      if (fold) {
        // stage the ds tile, sum diagonal `lane` (tile r - c == lane - 15)
        // in row order, and the clipped diagonals by a fixed tree
        float* st = ds_s + warp * ROWS * DS_LD;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[(g + (e >> 1) * 8) * DS_LD + j * 8 + 2 * t4 + (e & 1)] =
                d[j][e];
        __syncwarp();
        const int off = lane - (ROWS - 1);
        float sum = 0.0f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int c = r - off;
          if (c >= 0 && c < ROWS) sum += st[r * DS_LD + c];
        }
        const int delta = wr0 - c0 + off;     // i - j of the diagonal
        const bool diag = lane < NDIAG;
        float lo = 0.0f, hi = 0.0f;
        if (delta - lane <= -a.max_rel ||     // (warp-uniform) the tile
            delta - lane + NDIAG - 1 >= a.max_rel) {   // has clipped ones
          lo = diag && delta <= -a.max_rel ? sum : 0.0f;
          hi = diag && delta > -a.max_rel && delta >= a.max_rel ? sum : 0.0f;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            lo += __shfl_xor_sync(0xffffffffu, lo, o);
            hi += __shfl_xor_sync(0xffffffffu, hi, o);
          }
        }
        float* dg = diag_s + warp * DIAG_LD;
        if (diag) dg[lane] = sum;
        if (lane == 0) {
          dg[NDIAG] = lo;
          dg[NDIAG + 1] = hi;
        }
      }
    } else if (fold) {    // a warp without a tile adds zeros
      diag_s[warp * DIAG_LD + lane] = 0.0f;
      if (lane == 0) diag_s[warp * DIAG_LD + DIAG_LD - 1] = 0.0f;
    }
    __syncthreads();      // the stage is free for round t + 2
    if (fold) {
      // The round's diagonals into the delta table. Warp w = (rt, s) holds
      // delta d0 + 16 (rt - s) + u in its diagonal u, so the round spans
      // 16 (rb + ks - 2) + 31 <= 79 deltas: thread o owns delta
      // d0 - 16 (ks - 1) + o and adds the warps' sums for it in warp
      // order (unclipped deltas have distinct bins; a warp without a tile
      // this round left zeros); one thread adds the clipped sums, all low
      // then all high, in warp order. A delta under 0 sees only masked
      // cells (zeros) and has no staged bin; the low clipped bin is staged
      // only at max_rel 0, where it is the high one's.
      const int d0 = br0 - (ct0 + t * ks_n) * BK - (ROWS - 1);
      const int o = threadIdx.x;
      const int delta = d0 - BK * (ks_n - 1) + o;
      if (o < BK * (a.rb + ks_n - 2) + NDIAG && delta >= 0 &&
          delta < a.max_rel) {
        float x = drab_s[delta];
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) {
          const int rt = w / ks_n, sw = w - rt * ks_n;
          const int u = o - BK * (ks_n - 1) - ROWS * (rt - sw);
          if (u >= 0 && u < NDIAG) x += diag_s[w * DIAG_LD + u];
        }
        drab_s[delta] = x;
      } else if (o == NT - 1) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (k == 0 && a.max_rel > 0) continue;
          const int bin = k ? a.max_rel : 0;      // staged index
          float x = drab_s[bin];
#pragma unroll
          for (int w = 0; w < NWARPS; ++w)
            x += diag_s[w * DIAG_LD + NDIAG + k];
          drab_s[bin] = x;
        }
      }
    }
    t = t_next;
    stage ^= 1;
  }
  cp_async_wait<0>();

  // the k-split's partials, summed in a fixed order through the ring
  constexpr int NACC = DKV ? 2 : 1;
  if (ks_n > 1) {
    __syncthreads();
    // [rb][ks-1][NACC][NB][4][32]
    float* part = reinterpret_cast<float*>(ring);
    if (my_ks > 0 && wr0 < S) {
      float* q = part + ((my_rt * (ks_n - 1) + my_ks - 1) * NACC * NB) * 128;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          q[(n * 4 + e) * 32 + lane] = acc1[n][e];
          if constexpr (DKV) q[((NB + n) * 4 + e) * 32 + lane] = acc2[n][e];
        }
    }
    __syncthreads();
    if (my_ks == 0 && wr0 < S) {
      for (int s = 1; s < ks_n; ++s) {
        const float* q =
            part + ((my_rt * (ks_n - 1) + s - 1) * NACC * NB) * 128;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc1[n][e] += q[(n * 4 + e) * 32 + lane];
            if constexpr (DKV) acc2[n][e] += q[((NB + n) * 4 + e) * 32 + lane];
          }
      }
    }
  }
  if (fold) {                       // the block's drab partials
    __syncthreads();
    const size_t n_part = (size_t)(gridDim.x / a.H) * gridDim.y;
    for (int i = threadIdx.x; i < nwin; i += NT)
      a.part[(size_t)i * n_part] = drab_s[i];
  }
  if (my_ks != 0 || wr0 >= S) return;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wr0 + g + (e >> 1) * 8;
      const int c = n * 8 + 2 * t4 + (e & 1);
      if (r >= S) continue;
      if (c < a.Dqk)
        a.out1[(size_t)r * a.Dqk + c] =
            from_f32<T>(acc1[n][e] * a.inv_sqrt_d);
      if constexpr (DKV)
        if (c < a.Dv)
          a.out2[(size_t)r * a.Dv + c] = from_f32<T>(acc2[n][e]);
    }
}

// Per-(b, h) offsets, then the tile body.
template <int DP, bool DKV, class T>
__device__ __forceinline__ void bwd_block(BwdArgs<T> a,
                                          const int* hist_lengths,
                                          const int* target_counts,
                                          int n_hist) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const RooMask L(hist_lengths, target_counts, b, a.S, n_hist);
  const size_t qk = (size_t)bh * a.S * a.Dqk, vv = (size_t)bh * a.S * a.Dv;
  a.hold1 += qk;
  a.str1 += qk;
  a.out1 += qk;
  a.hold2 += vv;
  a.str2 += vv;
  if (a.rab != nullptr) {
    a.rab += (size_t)h * (2 * a.max_rel + 1);
    if (!DKV)   // drab partials: (H, max_rel + 1, B * row blocks)
      a.part += (size_t)h * (a.max_rel + 1) * (gridDim.x / a.H) *
                    gridDim.y +
                (size_t)b * gridDim.y + blockIdx.y;
  }
  if (DKV) a.out2 += vv;
  bwd_tile<DP, DKV>(L, a, smem);
}

template <int DP, class T>
__global__ void __launch_bounds__(NT, (min_blocks<DP, false>()))
hstu_bwd_dq_kernel(BwdArgs<T> a, const int* __restrict__ hist_lengths,
                   const int* __restrict__ target_counts, int n_hist) {
  bwd_block<DP, false>(a, hist_lengths, target_counts, n_hist);
}

template <int DP, class T>
__global__ void __launch_bounds__(NT, (min_blocks<DP, true>()))
hstu_bwd_dkv_kernel(BwdArgs<T> a, const int* __restrict__ hist_lengths,
                    const int* __restrict__ target_counts, int n_hist) {
  bwd_block<DP, true>(a, hist_lengths, target_counts, n_hist);
}

template <int DP, bool DKV, class T>
cudaError_t launch(const BwdArgs<T>& a, const int* hl, const int* tc, int BH,
                   int n_hist, cudaStream_t stream) {
  const int nwin = rab_window(a.max_rel, a.rab != nullptr);
  const long long smem = bwd_smem_bytes(TileConfig{a.rb, a.ks}, DP, nwin,
                                        !DKV && a.rab != nullptr, sizeof(T));
  void (*kern)(BwdArgs<T>, const int*, const int*, int) =
      DKV ? &hstu_bwd_dkv_kernel<DP, T> : &hstu_bwd_dq_kernel<DP, T>;
  const cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int rt = (a.S + ROWS - 1) / ROWS;
  const dim3 grid(BH, (rt + a.rb - 1) / a.rb);
  kern<<<grid, NT, (size_t)smem, stream>>>(a, hl, tc, n_hist);
  return cudaGetLastError();
}

// out2: dv (B3) or the drab partials (B2)
template <bool DKV, class T>
int run(const void* q, const void* k, const void* v, const void* rab,
        const void* g, const void* hist_lengths, const void* target_counts,
        void* out1, void* out2, int B, int H, int S, int Dqk, int Dv,
        int n_hist, int max_rel, int use_rab, void* stream) {
  if (B * H == 0 || S == 0) return (int)cudaSuccess;
  const TileConfig cfg = tile_config((long long)B * H, S);
  BwdArgs<T> a;
  a.hold1 = (const T*)(DKV ? k : q);
  a.hold2 = (const T*)(DKV ? v : g);
  a.str1 = (const T*)(DKV ? q : k);
  a.str2 = (const T*)(DKV ? g : v);
  a.rab = use_rab ? (const T*)rab : nullptr;
  a.out1 = (T*)out1;
  a.out2 = DKV ? (T*)out2 : nullptr;
  a.part = DKV ? nullptr : (float*)out2;
  a.H = H;
  a.S = S;
  a.Dqk = Dqk;
  a.Dv = Dv;
  a.max_rel = max_rel;
  a.vec_qk = vec_ok(q, k, Dqk, sizeof(T));
  a.vec_v = vec_ok(v, g, Dv, sizeof(T));
  a.inv_sqrt_d = 1.0f / sqrtf((float)Dqk);
  a.inv_s = 1.0f / (float)S;
  a.rb = cfg.rb;
  a.ks = cfg.ks;
  const int* hl = (const int*)hist_lengths;
  const int* tc = (const int*)target_counts;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (padded_d(Dqk, Dv)) {
    case 32: return (int)launch<32, DKV>(a, hl, tc, B * H, n_hist, st);
    case 64: return (int)launch<64, DKV>(a, hl, tc, B * H, n_hist, st);
    default: return (int)launch<128, DKV>(a, hl, tc, B * H, n_hist, st);
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of each kernel may need, at most (the
// 4-way split); the wrapper checks it.
long long hstu_attention_bwd_dq_smem_bytes(int Dqk, int Dv, int max_rel,
                                           int use_rab) {
  return bwd_smem_bytes(TileConfig{1, NWARPS}, padded_d(Dqk, Dv),
                        rab_window(max_rel, use_rab), use_rab != 0);
}

long long hstu_attention_bwd_dkv_smem_bytes(int Dqk, int Dv, int max_rel,
                                            int use_rab) {
  return bwd_smem_bytes(TileConfig{1, NWARPS}, padded_d(Dqk, Dv),
                        rab_window(max_rel, use_rab), false);
}

long long hstu_attention_bwd_dq_bf16_smem_bytes(int Dqk, int Dv, int max_rel,
                                                int use_rab) {
  return bwd_smem_bytes(TileConfig{1, NWARPS}, padded_d(Dqk, Dv),
                        rab_window(max_rel, use_rab), use_rab != 0, 2);
}

long long hstu_attention_bwd_dkv_bf16_smem_bytes(int Dqk, int Dv,
                                                 int max_rel, int use_rab) {
  return bwd_smem_bytes(TileConfig{1, NWARPS}, padded_d(Dqk, Dv),
                        rab_window(max_rel, use_rab), false, 2);
}

// Output rows (q rows of B2, k columns of B3) one block covers at this
// shape: 16 x tile_config's rb. B2 writes one drab partial row per block.
int hstu_attention_bwd_rows_per_block(long long n_heads, int S) {
  return tile_config(n_heads, S).rb * ROWS;
}

// q, k, dq: (B, H, S, Dqk); v, g: (B, H, S, Dv); rab: (H, 2*max_rel+1) or
// null when use_rab == 0; hist_lengths, target_counts: (B,) int32;
// drab_part: (H, max_rel+1, B * ceil(S / rows_per_block)), the partials of
// drab's bins max_rel..2*max_rel (deltas 0..max_rel; the others' are 0),
// written only when use_rab. All contiguous on the current device: fp32 here, bf16 (q,
// k, v, rab, g, dq; drab_part stays fp32) in hstu_attention_bwd_dq_bf16.
int hstu_attention_bwd_dq(const void* q, const void* k, const void* v,
                          const void* rab, const void* g,
                          const void* hist_lengths, const void* target_counts,
                          void* dq, void* drab_part, int B, int H, int S,
                          int Dqk, int Dv, int n_hist, int max_rel,
                          int use_rab, void* stream) {
  return run<false, float>(q, k, v, rab, g, hist_lengths, target_counts, dq,
                           drab_part, B, H, S, Dqk, Dv, n_hist, max_rel,
                           use_rab, stream);
}

int hstu_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                               const void* rab, const void* g,
                               const void* hist_lengths,
                               const void* target_counts, void* dq,
                               void* drab_part, int B, int H, int S, int Dqk,
                               int Dv, int n_hist, int max_rel, int use_rab,
                               void* stream) {
  return run<false, __nv_bfloat16>(q, k, v, rab, g, hist_lengths,
                                   target_counts, dq, drab_part, B, H, S,
                                   Dqk, Dv, n_hist, max_rel, use_rab, stream);
}

// k, dk: (B, H, S, Dqk); v, dv: (B, H, S, Dv); the rest as above (bf16 in
// hstu_attention_bwd_dkv_bf16).
int hstu_attention_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* rab, const void* g,
                           const void* hist_lengths,
                           const void* target_counts, void* dk, void* dv,
                           int B, int H, int S, int Dqk, int Dv, int n_hist,
                           int max_rel, int use_rab, void* stream) {
  return run<true, float>(q, k, v, rab, g, hist_lengths, target_counts, dk,
                          dv, B, H, S, Dqk, Dv, n_hist, max_rel, use_rab,
                          stream);
}

int hstu_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                const void* rab, const void* g,
                                const void* hist_lengths,
                                const void* target_counts, void* dk,
                                void* dv, int B, int H, int S, int Dqk,
                                int Dv, int n_hist, int max_rel, int use_rab,
                                void* stream) {
  return run<true, __nv_bfloat16>(q, k, v, rab, g, hist_lengths,
                                  target_counts, dk, dv, B, H, S, Dqk, Dv,
                                  n_hist, max_rel, use_rab, stream);
}

const char* hstu_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
