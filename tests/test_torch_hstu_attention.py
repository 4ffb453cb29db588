"""The port's HSTU attention (repro_torch) held against the JAX reference.

Same numpy inputs go through the reference's dense oracle, its chunked jnp
path and its Pallas forward (interpret mode, as the reference's own tests
run it on the CPU), and through the port's ``torch-dense`` and
``torch-chunked`` backends, which dispatch's auto rung picks on the CPU. The
CUDA kernel itself is checked on the card by ``chip_smoke.py``.

Tolerance: atol = rtol = 1e-5 (fp32 on both sides; only summation order
differs).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.hstu import hstu_attention_chunked as jax_chunked
from repro.core.masks import roo_spec as jax_roo_spec
from repro.kernels.hstu_attention import hstu_attention as jax_pallas
from repro.kernels.ref import hstu_attention_ref as jax_ref
from repro_torch.core.masks import causal_spec, prefix_spec, roo_spec
from repro_torch.kernels import dispatch
from repro_torch.kernels import hstu_attention as kmod
from repro_torch.kernels.ref import hstu_attention_prefix_ref

TOL = dict(atol=1e-5, rtol=1e-5)

# (B, H, S, Dqk, Dv, n_hist, max_rel, hist_lengths, target_counts)
CASES = {
    # hstu-gr's full-width sequence: S = 64 history + 16 targets
    "gr80": (2, 2, 80, 32, 32, 64, 64, [64, 0], [16, 5]),
    # S = 100 is no multiple of the chunk (32); ragged lengths incl. zeros
    "ragged100": (3, 2, 100, 16, 24, 70, 32, [0, 70, 23], [0, 30, 7]),
    # pure causal: a history-only sequence with no target slots
    "causal48": (2, 1, 48, 8, 8, 48, 16, [48, 11], [0, 0]),
}


def make_inputs(case, seed=0):
    b, h, s, dqk, dv, n_hist, max_rel, hl, tc = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, dqk)).astype(np.float32)
    k = rng.normal(size=(b, h, s, dqk)).astype(np.float32)
    v = rng.normal(size=(b, h, s, dv)).astype(np.float32)
    rab = (0.5 * rng.normal(size=(h, 2 * max_rel + 1))).astype(np.float32)
    return dict(q=q, k=k, v=v, rab=rab, n_hist=n_hist, max_rel=max_rel,
                hl=np.asarray(hl, np.int32), tc=np.asarray(tc, np.int32))


def to_torch(x):
    return {key: torch.from_numpy(val) if isinstance(val, np.ndarray)
            else val for key, val in x.items()}


def torch_spec(t):
    if t["n_hist"] == t["q"].shape[2] and not bool(t["tc"].any()):
        return causal_spec(t["hl"], t["n_hist"])
    return roo_spec(t["hl"], t["tc"], t["n_hist"])


def port(x, backend, use_rab, **kw):
    t = to_torch(x)
    out = dispatch.hstu_attention(
        t["q"], t["k"], t["v"], t["rab"] if use_rab else None, torch_spec(t),
        backend=backend, max_rel_pos=t["max_rel"], **kw)
    return out.numpy()


def jax_args(x, use_rab):
    return (jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
            jnp.asarray(x["rab"]) if use_rab else None)


def valid_rows(x):
    """(B, S) bool: rows the ROO mask keeps."""
    s = x["q"].shape[2]
    pos = np.arange(s)
    return np.where(pos[None] < x["n_hist"], pos[None] < x["hl"][:, None],
                    (pos[None] - x["n_hist"]) < x["tc"][:, None])


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("case", sorted(CASES))
class TestAgainstReference:
    def test_dense_matches_jnp_oracle(self, case, use_rab):
        x = make_inputs(case)
        q, k, v, rab = jax_args(x, use_rab)
        want = np.asarray(jax_ref(q, k, v, rab, x["n_hist"],
                                  jnp.asarray(x["hl"]), jnp.asarray(x["tc"]),
                                  x["max_rel"]))
        np.testing.assert_allclose(port(x, "torch-dense", use_rab), want,
                                   **TOL)

    def test_chunked_matches_jnp_chunked(self, case, use_rab):
        x = make_inputs(case, seed=1)
        q, k, v, rab = jax_args(x, use_rab)
        spec = jax_roo_spec(jnp.asarray(x["hl"]), jnp.asarray(x["tc"]),
                            x["n_hist"])
        want = np.asarray(jax_chunked(q, k, v, rab, spec,
                                      max_rel_pos=x["max_rel"], chunk=32))
        got = port(x, "torch-chunked", use_rab, chunk=32)
        np.testing.assert_allclose(got, want, **TOL)

    def test_matches_pallas_interpret(self, case, use_rab):
        x = make_inputs(case, seed=2)
        q, k, v, rab = jax_args(x, use_rab)
        want = np.asarray(jax_pallas(q, k, v, rab, x["n_hist"],
                                     jnp.asarray(x["hl"]),
                                     jnp.asarray(x["tc"]), x["max_rel"],
                                     interpret=True))
        for backend in ("torch-dense", "torch-chunked"):
            np.testing.assert_allclose(port(x, backend, use_rab), want,
                                       **TOL, err_msg=backend)

    def test_masked_rows_exactly_zero(self, case, use_rab):
        x = make_inputs(case, seed=3)
        dead = ~valid_rows(x)
        assert dead.any()
        for backend in ("torch-dense", "torch-chunked"):
            out = port(x, backend, use_rab)
            assert np.all(out.transpose(0, 2, 1, 3)[dead] == 0.0), backend
            assert np.all(np.isfinite(out))


@pytest.mark.parametrize("chunk", [1, 7, 32, 80, 128])
def test_chunk_size_independence(chunk):
    x = make_inputs("gr80", seed=4)
    want = port(x, "torch-dense", True)
    np.testing.assert_allclose(port(x, "torch-chunked", True, chunk=chunk),
                               want, **TOL)


def test_kernel_wrapper_cpu_takes_plain_version(monkeypatch):
    # the entry the model calls: auto on a CPU tensor runs a plain version
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    x = make_inputs("ragged100", seed=5)
    t = to_torch(x)
    before = kmod.launch_count
    got = port(x, None, True)
    plain = kmod.hstu_attention_plain(t["q"], t["k"], t["v"], t["rab"],
                                      t["n_hist"], t["hl"], t["tc"],
                                      t["max_rel"])
    np.testing.assert_allclose(got, plain.numpy(), **TOL)
    assert kmod.launch_count == before      # the CPU path launches nothing
    assert kmod.hstu_attention_plain is kmod.hstu_attention_ref


def test_kernel_module_imports_without_nvcc():
    # importing (done above) compiled and loaded nothing
    assert kmod._lib is None
    assert kmod.SOURCE.exists()
    assert kmod.SOURCE.suffix == ".cu"


def test_cuda_backend_on_cpu_raises():
    x = make_inputs("gr80")
    with pytest.raises(ValueError, match="CUDA"):
        port(x, "cuda", True)
    t = to_torch(x)
    with pytest.raises(ValueError, match="CUDA"):
        kmod.hstu_attention_cuda(t["q"], t["k"], t["v"], t["rab"],
                                 t["n_hist"], t["hl"], t["tc"], t["max_rel"])


def test_auto_on_cpu_resolves_to_torch_chunked(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert dispatch.resolve_backend(None, torch.device("cpu")) == \
        "torch-chunked"
    assert dispatch.resolve_backend(None, torch.device("cuda")) == "cuda"
    x = make_inputs("gr80")
    np.testing.assert_array_equal(port(x, None, True),
                                  port(x, "torch-chunked", True))


def test_backend_ladder_and_env_split(monkeypatch):
    # the reference's env var never reaches the port
    monkeypatch.setenv("REPRO_HSTU_BACKEND", "pallas-interpret")
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert dispatch.resolve_backend(None, torch.device("cpu")) == \
        "torch-chunked"
    monkeypatch.setenv(dispatch.ENV_VAR, "torch-dense")
    assert dispatch.resolve_backend(None, torch.device("cpu")) == \
        "torch-dense"
    with dispatch.use_backend("torch-chunked"):       # scope beats env
        assert dispatch.resolve_backend() == "torch-chunked"
        assert dispatch.resolve_backend("cuda") == "cuda"   # arg beats all
    dispatch.set_default_backend("torch-chunked")
    try:                                              # default beats env
        assert dispatch.get_default_backend() == "torch-chunked"
        assert dispatch.resolve_backend() == "torch-chunked"
        with dispatch.use_backend("torch-dense"):     # scope beats default
            assert dispatch.resolve_backend() == "torch-dense"
    finally:
        dispatch.set_default_backend(None)
    assert dispatch.get_default_backend() is None
    monkeypatch.setenv(dispatch.ENV_VAR, "pallas")
    with pytest.raises(ValueError):
        dispatch.resolve_backend()


# ---------------------------------------------------------------------------
# The numerics of the CUDA forward kernels (B1, B4): every product (q·kᵀ and
# p·v) runs on tensor cores as 3xTF32 (hi = tf32(x), lo = tf32(x - hi);
# lo·hi + hi·lo + hi·hi, fp32 accumulators). Emulated here in torch, this
# must stay within the card's gate (|got - plain| <= 1e-5 + 1e-5 |plain|)
# of the fp32 oracles at the shapes chip_smoke.py checks.
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to nearest (ties away from zero) on the low
    13 mantissa bits of fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands split into tf32 hi + lo parts; the small
    cross terms first, then hi·hi, as the kernel accumulates them."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 2 ** -11), 3.0])
    got = tf32_round(x)
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                         -(1.0 + 2 ** -10), 3.0])   # ties go away from 0
    assert torch.equal(got, want)
    r = torch.from_numpy(np.random.default_rng(0).normal(size=1000)
                         .astype(np.float32))
    assert torch.all((tf32_round(r).view(torch.int32) & 0x1FFF) == 0)
    assert float(((tf32_round(r) - r) / r).abs().max()) <= 2 ** -11


def tf32x3_attention(q, k, v, bias, mask, scale_len):
    """SiLU attention with the kernels' products: bias (B, H, R, C) or None,
    mask (B, R, C)."""
    scores = tf32x3_matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    a = F.silu(scores) / float(scale_len) * mask[:, None].to(scores.dtype)
    return tf32x3_matmul(a, v)


def within_gate(got, plain):
    return bool(torch.all((got - plain).abs() <= 1e-5 + 1e-5 * plain.abs()))


# (B, H, S, Dqk, Dv, n_hist, max_rel): chip_smoke.py's B1 shapes
GATE_SHAPES = {
    "serve B64 S80": (64, 2, 80, 32, 32, 64, 64),
    "ragged S203": (5, 3, 203, 48, 40, 150, 100),
    "wide D128 S160": (3, 2, 160, 128, 128, 140, 128),
}


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("shape", sorted(GATE_SHAPES))
def test_tf32x3_products_hold_the_gate(shape, use_rab):
    b, h, s, dqk, dv, n_hist, max_rel = GATE_SHAPES[shape]
    rng = np.random.default_rng(20)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    q, k = t(rng.normal(size=(b, h, s, dqk))), t(rng.normal(size=(b, h, s, dqk)))
    v = t(rng.normal(size=(b, h, s, dv)))
    rab = t(0.5 * rng.normal(size=(h, 2 * max_rel + 1))) if use_rab else None
    hl = torch.from_numpy(rng.integers(0, n_hist + 1, size=b).astype(np.int32))
    tc = torch.from_numpy(rng.integers(0, s - n_hist + 1, size=b)
                          .astype(np.int32))
    hl[0], tc[0] = n_hist, s - n_hist
    plain = kmod.hstu_attention_plain(q, k, v, rab, n_hist, hl, tc, max_rel)
    pos = torch.arange(s)
    bias = None
    if use_rab:
        delta = torch.clamp(pos[:, None] - pos[None, :], -max_rel,
                            max_rel) + max_rel
        bias = rab[:, delta][None]
    mask = roo_spec(hl, tc, n_hist).dense(s)
    got = tf32x3_attention(q, k, v, bias, mask, s)
    assert within_gate(got, plain), float((got - plain).abs().max())
    # one pass of plain tf32 would not: the split is what holds the gate
    one = lambda a, c: tf32_round(a) @ tf32_round(c)
    s1 = one(q, k.transpose(-1, -2)) / math.sqrt(dqk)
    s1 = s1 + bias if use_rab else s1
    a1 = F.silu(s1) / float(s) * mask[:, None].to(s1.dtype)
    assert not within_gate(one(a1, v), plain)


# (B, H, n_hist, n_new, m, Dqk, Dv, max_rel, scale_len): chip_smoke.py's B4
PREFIX_GATE_SHAPES = {
    "serve n_new=8": (64, 2, 64, 8, 16, 32, 32, 64, 80),
    "ragged": (5, 3, 150, 37, 5, 48, 40, 100, 155),
    "wide D128": (3, 2, 140, 20, 20, 128, 128, 128, 160),
}


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("shape", sorted(PREFIX_GATE_SHAPES))
def test_tf32x3_products_hold_the_gate_prefix(shape, use_rab):
    b, h, n_hist, n_new, m, dqk, dv, max_rel, scale_len = \
        PREFIX_GATE_SHAPES[shape]
    rng = np.random.default_rng(21)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    q = t(rng.normal(size=(b, h, n_new + m, dqk)))
    k = t(rng.normal(size=(b, h, n_hist + m, dqk)))
    v = t(rng.normal(size=(b, h, n_hist + m, dv)))
    rab = t(0.5 * rng.normal(size=(h, 2 * max_rel + 1))) if use_rab else None
    hl = rng.integers(0, n_hist + 1, size=b)
    pfx = (rng.random(b) * (hl + 1)).astype(np.int64)
    i32 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))
    pfx_t, nc, tc = i32(pfx), i32(np.minimum(hl - pfx, n_new)), \
        i32(rng.integers(0, m + 1, size=b))
    plain = hstu_attention_prefix_ref(q, k, v, rab, n_hist, n_new, pfx_t, nc,
                                      tc, scale_len, max_rel)
    r, j = torch.arange(n_new + m), torch.arange(n_hist + m)
    bias = None
    if use_rab:
        row_pos = torch.where((r < n_new)[None, :],
                              pfx_t.long()[:, None] + r[None, :],
                              r[None, :] + (n_hist - n_new))
        delta = torch.clamp(row_pos[:, :, None] - j[None, None, :],
                            -max_rel, max_rel) + max_rel
        bias = rab[:, delta].transpose(0, 1)
    mask = prefix_spec(pfx_t, nc, tc, n_hist, n_new).dense(n_new + m,
                                                           n_hist + m)
    got = tf32x3_attention(q, k, v, bias, mask, scale_len)
    assert within_gate(got, plain), float((got - plain).abs().max())


@pytest.mark.parametrize("source", ["hstu_attention_fwd.cu",
                                    "hstu_attention_prefix_fwd.cu",
                                    "hstu_attention_bwd.cu",
                                    "dot_interaction.cu"])
def test_build_digest_covers_included_headers(tmp_path, source):
    # builds nothing: a copy of the sources, one header byte changed
    import shutil
    csrc = kmod.SOURCE.parent
    for f in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        shutil.copy(f, tmp_path / f.name)
    src = tmp_path / source
    assert b'#include "hstu_fwd_tile.cuh"' in src.read_bytes()
    before = kmod.source_digest(src)
    assert kmod.source_digest(src) == before
    other = kmod.source_digest(tmp_path / "embedding_bag.cu")
    header = tmp_path / "hstu_fwd_tile.cuh"
    text = bytearray(header.read_bytes())
    text[-2] ^= 1
    header.write_bytes(bytes(text))
    assert kmod.source_digest(src) != before
    # a source that does not include the header keeps its digest
    assert kmod.source_digest(tmp_path / "embedding_bag.cu") == other
    assert kmod.source_digest(csrc / source) == before   # the repo's copy


# ---------------------------------------------------------------------------
# B1's tile skip and shared memory, mirrored from the CUDA source
# (csrc/hstu_fwd_tile.cuh: RooMask::live, rab_window, smem_bytes)
# ---------------------------------------------------------------------------

TILE = 16          # B1's row tiles (a warp's 16 q rows) and k tiles


def b1_live(i_lo, i_hi, j_lo, j_hi, n_hist, hist_end, tgt_end):
    """RooMask::live: some q row of [i_lo, i_hi] keeps some k column of
    [j_lo, j_hi]; rows count only up to hist_end - 1 (history) and
    tgt_end - 1 (targets)."""
    hrow_hi = min(i_hi, hist_end - 1)
    trow_lo, trow_hi = max(i_lo, n_hist), min(i_hi, tgt_end - 1)
    if j_lo <= min(j_hi, hist_end - 1) and (
            trow_lo <= trow_hi or (i_lo <= hrow_hi and j_lo <= hrow_hi)):
        return True
    return max(j_lo, n_hist, trow_lo) <= min(j_hi, trow_hi)


def skip_cases():
    """(n_hist, S, hist_lengths, target_counts): padded histories, zero and
    partial targets, hl 0 and n_hist, n_hist on and off the tile grid."""
    rng = np.random.default_rng(37)
    out = []
    for n_hist, m in ((64, 16), (37, 19), (48, 0), (0, 21), (100, 5),
                      (16, 64)):
        hl = [0, n_hist, *rng.integers(0, n_hist + 1, size=4)]
        tc = [m, 0, *rng.integers(0, m + 1, size=4)]
        out.append((n_hist, n_hist + m, hl, tc))
    return out


@pytest.mark.parametrize("n_hist,s,hl,tc", skip_cases())
def test_b1_tile_skip_multiplies_only_kept_tiles(n_hist, s, hl, tc):
    from repro_torch.kernels.hstu_attention_bwd import fwd_tiles
    hl_t = torch.tensor(hl, dtype=torch.int32)
    tc_t = torch.tensor(tc, dtype=torch.int32)
    # the reference's mask, (B, S, S)
    keep = np.asarray(jax_roo_spec(jnp.asarray(hl, dtype=jnp.int32),
                                   jnp.asarray(tc, dtype=jnp.int32),
                                   n_hist).dense(s))
    n_t = -(-s // TILE)
    multiplied = 0
    for b in range(len(hl)):
        hist_end = max(0, min(hl[b], n_hist))
        tgt_end = n_hist + max(0, min(tc[b], s - n_hist))
        for r in range(n_t):
            i_lo, i_hi = r * TILE, min(r * TILE + TILE, s) - 1
            padded = all(hist_end <= i < n_hist or i >= tgt_end
                         for i in range(i_lo, i_hi + 1))
            for c in range(n_t):
                j_lo, j_hi = c * TILE, min(c * TILE + TILE, s) - 1
                live = b1_live(i_lo, i_hi, j_lo, j_hi, n_hist, hist_end,
                               tgt_end)
                kept = bool(keep[b, i_lo:i_hi + 1, j_lo:j_hi + 1].any())
                # a skipped tile holds only cells keep drops, and a tile
                # that holds none is not multiplied
                assert live == kept, (b, r, c)
                # no tile of padded history rows or of target slots past
                # the count
                assert not (live and padded), (b, r, c)
                multiplied += live
    heads = 3
    got = fwd_tiles(n_hist, hl_t, tc_t, heads, s)
    assert got.dim() == 0 and int(got) == heads * multiplied


def b1_smem_bytes(rb, dp, max_rel, es=4):
    """hstu_fwd_tile.cuh's smem_bytes at rab_window(max_rel): the q rows,
    the two-stage ring of 4 / rb k and v tiles, the staged rab bins."""
    ld = dp + 16 // es
    ks = 4 // rb
    return es * (rb * TILE * ld + 2 * ks * 2 * TILE * ld) + 4 * (max_rel + 1)


def test_b1_stages_half_the_rab_row():
    header = (kmod.SOURCE.parent / "hstu_fwd_tile.cuh").read_text()
    assert "return use_rab ? max_rel + 1 : 0;" in header
    assert "load_rab(rab_s, a.rab + a.max_rel, a.max_rel + 1);" in header
    # gr-train-long: D 128, max_rel_pos 8,256; B*H 16 at S 8,256 takes 4
    # row tiles a block
    smem = b1_smem_bytes(4, 128, 8256)
    assert smem == 100612
    per_sm, reserved = 233472, 1024     # an H100 SM; the runtime's per block
    assert 2 * (smem + reserved) <= per_sm < 3 * (smem + reserved)
    whole_row = smem + 4 * 8256         # the 2 * max_rel + 1 bins
    assert whole_row == 133636 and 2 * (whole_row + reserved) > per_sm
    # the wrapper's check, the 4-way split, stays under 227 KB
    assert b1_smem_bytes(1, 128, 8256) <= kmod.MAX_SMEM_BYTES
