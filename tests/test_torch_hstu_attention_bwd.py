"""The numerics of the CUDA backward kernels (B2: dq + drab, B3: dk + dv),
emulated on the CPU.

Every product of B2 and B3 runs on tensor cores as 3xTF32 (hi = tf32(x),
lo = tf32(x - hi); lo·hi + hi·lo + hi·hi, fp32 accumulators): B2 s = q·kᵀ,
da = g·vᵀ, dq = ds·k; B3 sᵀ = k·qᵀ, daᵀ = v·gᵀ, dk = dsᵀ·q, dv = aᵀ·g.
Emulated here in torch (``tf32x3_matmul`` of the forward's test), the
gradients must stay within the card's gate of the dense oracle
``hstu_attention_bwd_ref``: |got - plain| <= tol + tol |plain| with tol
1e-5 for dq, dk, dv and 1e-4 for drab (a sum over B·S² cells). The
oracle itself is held against jax.grad of the reference in
``test_torch_train.py``; one case here checks the emulation against it
too, at the reference's 1e-4.

drab is modelled in the kernel's fold order: per 16 x 16 tile the 31
diagonal sums in row order, the clipped ones through the warp's shuffle
tree; per block the tiles folded round by round, each delta's warps in
warp order, then the clipped sums (the header's ``tile_config`` and the
kernel's tile skip, mirrored below); then the blocks' partial tables
summed over their axis. The kernels themselves
run only on the card (``chip_smoke.py`` phase 4).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import hstu_attention_ref as jax_attention_ref
from repro_torch.core.masks import roo_spec
from repro_torch.kernels.hstu_attention_bwd import ROWS
from repro_torch.kernels.ref import hstu_attention_bwd_ref
from test_torch_hstu_attention import tf32_round, tf32x3_matmul

FILL_BLOCKS = 4 * 132      # hstu_fwd_tile.cuh: four blocks per H100 SM
NWARPS = 4

# (B, H, S, Dqk, Dv, n_hist, max_rel): hstu-gr's training sequence, S no
# multiple of 16, a short S with D % 4 != 0 and max_rel < S (clip), a clip
# case at S 80, and no history at all
SHAPES = {
    "gr80": (4, 2, 80, 32, 32, 64, 64),
    "ragged81": (3, 2, 81, 24, 16, 64, 64),
    "short17": (3, 3, 17, 18, 13, 12, 8),
    "clip80": (4, 2, 80, 32, 32, 64, 16),
    "targets40": (3, 2, 40, 32, 32, 0, 32),
}


def make_case(shape, seed):
    b, h, s, dqk, dv, n_hist, max_rel = shape
    rng = np.random.default_rng(seed)
    x = {name: rng.normal(size=size).astype(np.float32) for name, size in (
        ("q", (b, h, s, dqk)), ("k", (b, h, s, dqk)), ("v", (b, h, s, dv)),
        ("g", (b, h, s, dv)))}
    x["rab"] = (0.5 * rng.normal(size=(h, 2 * max_rel + 1))).astype(
        np.float32)
    hl = rng.integers(0, n_hist + 1, size=b).astype(np.int32)
    tc = rng.integers(0, s - n_hist + 1, size=b).astype(np.int32)
    hl[0], tc[0] = n_hist, s - n_hist
    x.update(hl=hl, tc=tc, n_hist=n_hist, max_rel=max_rel)
    return {k: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for k, a in x.items()}


def rab_bias(rab, s, max_rel):
    pos = torch.arange(s)
    delta = torch.clamp(pos[:, None] - pos[None, :], -max_rel,
                        max_rel) + max_rel
    return rab[:, delta][None], delta


def emulated_bwd(x, use_rab, mm=tf32x3_matmul):
    """(dq, dk, dv, ds) with the kernels' products and elementwise math."""
    q, k, v, g = x["q"], x["k"], x["v"], x["g"]
    s, dqk = q.shape[2], q.shape[3]
    inv_d = 1.0 / math.sqrt(dqk)
    scores = mm(q, k.transpose(-1, -2)) * inv_d
    if use_rab:
        scores = scores + rab_bias(x["rab"], s, x["max_rel"])[0]
    da = mm(g, v.transpose(-1, -2))
    mask = roo_spec(x["hl"], x["tc"], x["n_hist"]).dense(s)[:, None]
    sig = torch.sigmoid(scores)
    a = torch.where(mask, scores * sig * (1.0 / s), 0.0)
    ds = torch.where(mask, da * (1.0 / s) * (sig * (1.0 + scores *
                                                      (1.0 - sig))), 0.0)
    dq = mm(ds, k) * inv_d
    dk = mm(ds.transpose(-1, -2), q) * inv_d
    dv = mm(a.transpose(-1, -2), g)
    return dq, dk, dv, ds


def plain(x, use_rab):
    return hstu_attention_bwd_ref(
        x["q"], x["k"], x["v"], x["rab"] if use_rab else None, x["n_hist"],
        x["hl"], x["tc"], x["max_rel"], x["g"])


def within(got, want, tol):
    return bool(torch.all((got - want).abs() <= tol + tol * want.abs()))


# ---------------------------------------------------------------------------
# The kernels' tiling and drab fold order, mirrored from the CUDA source
# ---------------------------------------------------------------------------

def tile_config(n_heads, rows):
    """hstu_fwd_tile.cuh's tile_config: (row tiles a block, k split)."""
    rt = -(-rows // ROWS)
    rb = 1
    while rb < rt and rb < NWARPS:
        rb *= 2
    while rb > 1 and n_heads * -(-rt // rb) < FILL_BLOCKS:
        rb //= 2
    return rb, NWARPS // rb


def tile_live(i_lo, i_hi, j_lo, j_hi, n_hist, hist_end, tgt_end):
    """RooMask::live: some q row of [i_lo, i_hi] keeps some k column of
    [j_lo, j_hi]."""
    hrow_hi = min(i_hi, hist_end - 1)
    trow_lo, trow_hi = max(i_lo, n_hist), min(i_hi, tgt_end - 1)
    if j_lo <= min(j_hi, hist_end - 1) and (
            trow_lo <= trow_hi or (i_lo <= hrow_hi and j_lo <= hrow_hi)):
        return True
    return max(j_lo, n_hist, trow_lo) <= min(j_hi, trow_hi)


def shuffle_tree(v):
    """Lane 0's value after the xor butterfly over 32 lanes (last dim)."""
    width = 16
    while width:
        v = v[..., :width] + v[..., width:2 * width]
        width //= 2
    return v[..., 0]


def diagonal_sums(ds, n_t):
    """(B, H, row tile, col tile, 31): each 16 x 16 tile's diagonals, u
    holding tile r - c == u - 15, summed in row order."""
    b, h, s, _ = ds.shape
    pad = torch.zeros(b, h, n_t * ROWS, n_t * ROWS)
    pad[:, :, :s, :s] = ds
    tiles = pad.reshape(b, h, n_t, ROWS, n_t, ROWS).permute(0, 1, 2, 4, 3, 5)
    diag = torch.zeros(b, h, n_t, n_t, 2 * ROWS - 1)
    for r in range(ROWS):
        us = [u for u in range(2 * ROWS - 1) if 0 <= r - u + ROWS - 1 < ROWS]
        cs = [r - u + ROWS - 1 for u in us]
        diag[..., us] = diag[..., us] + tiles[..., r, cs]
    return diag


def drab_fold(ds, hl, tc, n_hist, max_rel):
    """drab in B2's order; also checks that every skipped tile holds only
    zeros (the skip never drops a kept cell)."""
    b, h, s, _ = ds.shape
    rb, ks = tile_config(b * h, s)
    n_t = -(-s // ROWS)
    n_by = -(-n_t // rb)
    nrab = 2 * max_rel + 1
    diag = diagonal_sums(ds, n_t)
    u = torch.arange(2 * ROWS - 1)
    part = torch.zeros(h, nrab, b * n_by)
    for bi in range(b):
        hist_end = max(0, min(int(hl[bi]), n_hist))
        tgt_end = n_hist + max(0, min(int(tc[bi]), s - n_hist))

        def live(ct, r_lo, r_hi):
            if ct >= n_t or r_lo > r_hi:
                return False
            return tile_live(r_lo, r_hi, ct * ROWS,
                             min(ct * ROWS + ROWS, s) - 1, n_hist, hist_end,
                             tgt_end)

        for by in range(n_by):
            r_blk = (by * rb * ROWS, min((by + 1) * rb * ROWS, s) - 1)
            ct0 = 0
            while ct0 < n_t and not live(ct0, *r_blk):
                ct0 += 1
            rounds = []         # per round, its live (row tile, col tile)s
            for t in range(-(-(n_t - ct0) // ks)):
                tiles = []
                for w in range(NWARPS):
                    rt = by * rb + w // ks
                    ct = ct0 + t * ks + w % ks
                    r0 = rt * ROWS
                    if live(ct, r0, min(r0 + ROWS, s) - 1):
                        tiles.append((rt, ct))
                rounds.append(tiles)
            seen = torch.zeros(n_t, n_t, dtype=torch.bool)
            for rt, ct in sum(rounds, []):
                seen[rt, ct] = True
            for rt in range(by * rb, min((by + 1) * rb, n_t)):
                for ct in range(n_t):
                    if not seen[rt, ct]:
                        block = ds[bi, :, rt * ROWS:(rt + 1) * ROWS,
                                   ct * ROWS:(ct + 1) * ROWS]
                        assert not bool(block.any()), (bi, rt, ct)
            table = part[:, :, bi * n_by + by]
            for tiles in rounds:
                # unclipped: each delta's warps in warp order; then the
                # clipped sums, all low then all high, in warp order
                clipped = []
                for rt, ct in tiles:
                    d = diag[bi, :, rt, ct]                    # (H, 31)
                    delta = rt * ROWS - ct * ROWS - (ROWS - 1) + u
                    lo = delta <= -max_rel
                    hi = (delta > -max_rel) & (delta >= max_rel)
                    mid = ~lo & ~hi
                    table[:, delta[mid] + max_rel] += d[:, mid]
                    zero = torch.zeros(h, 1)
                    clipped.append([shuffle_tree(torch.cat(
                        [torch.where(m, d, 0.0), zero], -1)) for m in (lo,
                                                                       hi)])
                for k, bin_ in ((0, 0), (1, 2 * max_rel)):
                    for sums in clipped:
                        table[:, bin_] += sums[k]
    return part.sum(-1)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_tile_config_mirrors_the_header():
    # the training shape splits each 16-row tile 4 ways; a B*H this large
    # drops the split (chip_smoke.py phase 4's "no split" shape)
    assert tile_config(64, 80) == (1, 4)
    assert tile_config(264, 80) == (4, 1)
    assert tile_config(1000, 32) == (2, 2)


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tf32x3_backward_holds_the_gate(shape, use_rab):
    x = make_case(SHAPES[shape], seed=7)
    dq, dk, dv, ds = emulated_bwd(x, use_rab)
    want = plain(x, use_rab)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert within(got, ref, 1e-5), (name, float((got - ref).abs().max()))
    if use_rab:
        drab = drab_fold(ds, x["hl"], x["tc"], x["n_hist"], x["max_rel"])
        assert within(drab, want[3], 1e-4), float((drab - want[3]).abs()
                                                  .max())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_drab_fold_order_is_bitwise_on_repeat(shape):
    x = make_case(SHAPES[shape], seed=8)
    ds = emulated_bwd(x, True)[3]
    args = (x["hl"], x["tc"], x["n_hist"], x["max_rel"])
    first = drab_fold(ds, *args)
    assert torch.equal(first, drab_fold(ds.clone(), *args))
    assert within(first, plain(x, True)[3], 1e-4)


def test_one_tf32_pass_misses_the_gate():
    """A single TF32 product (no lo terms) leaves the 1e-5 gate on dq, dk
    and dv at the training shape: the split is what holds it."""
    x = make_case(SHAPES["gr80"], seed=7)
    one = lambda a, b: tf32_round(a) @ tf32_round(b)
    got = emulated_bwd(x, True, mm=one)[:3]
    want = plain(x, True)
    assert not any(within(a, b, 1e-5) for a, b in zip(got, want))


def test_emulation_matches_jax_grad():
    """The emulated gradients against jax.grad of the reference's dense
    forward, at the reference's 1e-4."""
    x = make_case(SHAPES["gr80"], seed=9)
    dq, dk, dv, ds = emulated_bwd(x, True)
    drab = drab_fold(ds, x["hl"], x["tc"], x["n_hist"], x["max_rel"])

    def loss(q, k, v, rab):
        out = jax_attention_ref(q, k, v, rab, x["n_hist"],
                                jnp.asarray(x["hl"].numpy()),
                                jnp.asarray(x["tc"].numpy()),
                                max_rel_pos=x["max_rel"])
        return jnp.sum(out * jnp.asarray(x["g"].numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x[n].numpy()) for n in ("q", "k", "v", "rab")))
    for got, ref in zip((dq, dk, dv, drab), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)
