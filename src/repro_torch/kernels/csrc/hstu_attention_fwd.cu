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
// Masked rows are exactly 0; the 1/S factor uses the unpadded S.
//
// What bounds it on this card: at the serving shape (B = 64, H = 2, S = 80,
// Dqk = Dv = 32, fp32) one call must move the kept q, k, v rows and the
// output, ~3.3 MB (~1 us at 3.35 TB/s), and do ~16 MFLOP for the cells the
// ROO mask keeps (~0.2 us at 67 TFLOP/s fp32): bytes set the bound. But a
// launch of a few hundred short blocks with 2-3 dependent tile stages has
// a latency floor of a few us, above that bound; the design aims at the
// floor. What held the first version back, and what this one does:
//  * serial 32-long FMA chains on two shared-memory operands per FMA:
//    the products run on tensor cores (mma.sync m16n8k8, 3xTF32 at fp32
//    accuracy) from conflict-free fragment loads;
//  * accumulators sized for D = 128 whatever Dv (164 registers, 3 blocks
//    an SM): templates for D padded to 32, 64 and 128, and the scores
//    stay in the mma fragments;
//  * scalar loads behind three barriers per k tile: 16-byte cp.async into
//    a double-buffered ring, round t+1 in flight while t is multiplied;
//  * 384 blocks of one 32-row tile each: 16-row warps, and the k tiles
//    split among a block's warps where a head has few row tiles.
// The tile body is hstu_fwd_tile.cuh (shared with the cached-prefix
// forward), and so is the ROO mask (RooMask, shared with the backward).
// At gr-train-long's shape (S 8,256, D 128, histories of 4,096-8,192
// padded to 8,192) two of the header's points carry the kernel: the tile
// skip reads the rows' validity (a padded row walking the valid history's
// tiles cost ~1.67x the kept tiles over that traffic), and a block stages
// only the rab bins a kept cell reads, so two blocks share an SM.
//
// bf16 (hstu_attention_fwd_bf16): the same kernel on bf16 q, k, v and rab,
// writing a bf16 output: half the bytes at the serving shape (~1.7 MB).
// It computes in fp32 and rounds once, at the store (the tile header says
// how): the reference's Pallas kernel also reads bf16 tiles and computes
// in fp32.
//
// Interface: plain C, loaded with ctypes. The host function launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include "hstu_fwd_tile.cuh"

namespace {

using namespace hstu_fwd;

template <int DP, class T>
__global__ void __launch_bounds__(NT, 4)
hstu_fwd_kernel(TileArgs<T> a, const int* __restrict__ hist_lengths,
                const int* __restrict__ target_counts, int H, int n_hist) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int S = a.R;
  const RooMask L(hist_lengths, target_counts, b, S, n_hist);
  a.q += (size_t)bh * S * a.Dqk;
  a.k += (size_t)bh * S * a.Dqk;
  a.v += (size_t)bh * S * a.Dv;
  a.out += (size_t)bh * S * a.Dv;
  if (a.rab != nullptr) a.rab += (size_t)h * (2 * a.max_rel + 1);
  fwd_tile<DP>(L, a, smem);
}

template <int DP, class T>
cudaError_t launch(const TileArgs<T>& a, const int* hl, const int* tc,
                   int BH, int H, int n_hist, int nrab, cudaStream_t stream) {
  const long long smem =
      smem_bytes(TileConfig{a.rb, a.ks}, DP, nrab, sizeof(T));
  const cudaError_t e = set_smem(hstu_fwd_kernel<DP, T>, smem);
  if (e != cudaSuccess) return e;
  const int rt = (a.R + ROWS - 1) / ROWS;
  const dim3 grid(BH, (rt + a.rb - 1) / a.rb);
  hstu_fwd_kernel<DP, T><<<grid, NT, (size_t)smem, stream>>>(a, hl, tc, H,
                                                            n_hist);
  return cudaGetLastError();
}

template <class T>
int run(const void* q, const void* k, const void* v, const void* rab,
        const void* hist_lengths, const void* target_counts, void* out,
        int B, int H, int S, int Dqk, int Dv, int n_hist, int max_rel,
        int use_rab, void* stream) {
  if (B * H == 0 || S == 0) return (int)cudaSuccess;
  const TileConfig cfg = tile_config((long long)B * H, S);
  TileArgs<T> a;
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.rab = use_rab ? (const T*)rab : nullptr;
  a.out = (T*)out;
  a.R = S;
  a.C = S;
  a.Dqk = Dqk;
  a.Dv = Dv;
  a.max_rel = max_rel;
  a.vec_qk = vec_ok(q, k, Dqk, sizeof(T));
  a.vec_v = vec_ok(v, v, Dv, sizeof(T));
  a.inv_sqrt_d = 1.0f / sqrtf((float)Dqk);
  a.inv_scale = 1.0f / (float)S;
  a.rb = cfg.rb;
  a.ks = cfg.ks;
  const int nrab = rab_window(max_rel, use_rab);
  const int* hl = (const int*)hist_lengths;
  const int* tc = (const int*)target_counts;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (padded_d(Dqk, Dv)) {
    case 32: return (int)launch<32>(a, hl, tc, B * H, H, n_hist, nrab, st);
    case 64: return (int)launch<64>(a, hl, tc, B * H, H, n_hist, nrab, st);
    default: return (int)launch<128>(a, hl, tc, B * H, H, n_hist, nrab, st);
  }
}

// The occupancy query: the blocks of kern an SM holds once the launch's
// shared-memory attribute is set.
template <class F>
cudaError_t occupancy(F* kern, long long smem, int* blocks) {
  const cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, NT,
                                                       (size_t)smem);
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block may need, at most; the wrapper checks it.
long long hstu_attention_fwd_smem_bytes(int Dqk, int Dv, int max_rel,
                                        int use_rab) {
  return max_smem_bytes(Dqk, Dv, rab_window(max_rel, use_rab));
}

long long hstu_attention_fwd_bf16_smem_bytes(int Dqk, int Dv, int max_rel,
                                             int use_rab) {
  return max_smem_bytes(Dqk, Dv, rab_window(max_rel, use_rab), 2);
}

// Blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and a
// block's shared memory, at the configuration an fp32 launch of this shape
// takes; returns a CUDA error code.
int hstu_attention_fwd_occupancy(int B, int H, int S, int Dqk, int Dv,
                                 int max_rel, int use_rab, int* blocks,
                                 long long* smem) {
  const int dp = padded_d(Dqk, Dv);
  *smem = smem_bytes(tile_config((long long)B * H, S), dp,
                     rab_window(max_rel, use_rab));
  cudaError_t e;
  switch (dp) {
    case 32: e = occupancy(hstu_fwd_kernel<32, float>, *smem, blocks); break;
    case 64: e = occupancy(hstu_fwd_kernel<64, float>, *smem, blocks); break;
    default: e = occupancy(hstu_fwd_kernel<128, float>, *smem, blocks);
  }
  return (int)e;
}

// q, k: (B, H, S, Dqk); v, out: (B, H, S, Dv); rab: (H, 2*max_rel+1) or
// null when use_rab == 0; hist_lengths, target_counts: (B,) int32. All
// contiguous on the current device: fp32 here, bf16 (q, k, v, rab, out)
// in hstu_attention_fwd_bf16.
int hstu_attention_fwd(const void* q, const void* k, const void* v,
                       const void* rab, const void* hist_lengths,
                       const void* target_counts, void* out, int B, int H,
                       int S, int Dqk, int Dv, int n_hist, int max_rel,
                       int use_rab, void* stream) {
  return run<float>(q, k, v, rab, hist_lengths, target_counts, out, B, H, S,
                    Dqk, Dv, n_hist, max_rel, use_rab, stream);
}

int hstu_attention_fwd_bf16(const void* q, const void* k, const void* v,
                            const void* rab, const void* hist_lengths,
                            const void* target_counts, void* out, int B,
                            int H, int S, int Dqk, int Dv, int n_hist,
                            int max_rel, int use_rab, void* stream) {
  return run<__nv_bfloat16>(q, k, v, rab, hist_lengths, target_counts, out,
                            B, H, S, Dqk, Dv, n_hist, max_rel, use_rab,
                            stream);
}

const char* hstu_attention_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
