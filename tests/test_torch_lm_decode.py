"""The port's KV-cache decode (``repro_torch/models/lm/decode.py``) held
against the JAX reference on the CPU, on a dense GELU arch (starcoder2-15b)
and an MoE arch (granite-moe-3b-a800m) at their smoke configs, with the
reference's params carried across:

  * ``prefill``: the last position's logits and the bf16 cache (``k``,
    ``v``, ``pos``);
  * ``serve_step`` on a carried cache: the reference's cache after its
    prefill and two steps goes into the port (bf16 leaves by their bits),
    and the port's next step's logits and cache are the reference's;
  * in the port, decode against the full forward over the extended
    sequence (the MoE at a capacity that drops no token: a one-token step
    has another capacity than a forward over the whole sequence), and
    ``pos`` stays a device tensor.

Tolerances: f32 compute, logits atol = rtol = 1e-5; bf16 compute 2e-2
(the reference's bf16 tolerance); cache entries, bf16 values, within one
bf16 rounding step (rtol 2**-7) at f32 compute and 2e-2 at bf16. The
reference runs jitted, at bf16 without XLA's excess precision
(``test_torch_lm.strict_jit``).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import decode as ref_decode
from repro_torch.interop import params_from_numpy
from repro_torch.models.lm import decode, transformer

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_lm import (BF16_TOL, F32_TOL, assert_close, smoke,  # noqa: E402
                           strict_jit, tokens)

CASES = [(arch, cdt) for arch in ("starcoder2-15b", "granite-moe-3b-a800m")
         for cdt in ("float32", "bfloat16")]


def run_ref(fn, *args, bf16):
    return strict_jit(fn, *args) if bf16 else jax.jit(fn)(*args)


def cache_tol(bf16):
    return (BF16_TOL, BF16_TOL) if bf16 else (0.0, 2.0 ** -7)


def assert_cache(got, want, bf16):
    atol, rtol = cache_tol(bf16)
    assert got["k"].dtype == got["v"].dtype == torch.bfloat16
    assert got["pos"].dtype == torch.int32 and got["pos"].dim() == 0
    assert int(got["pos"]) == int(want["pos"])
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name].float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("arch,cdt", CASES)
def test_prefill_and_step_on_a_carried_cache(arch, cdt):
    rc, pc, rp, pp = smoke(arch, compute_dtype=cdt)
    bf16 = cdt == "bfloat16"
    tol = BF16_TOL if bf16 else F32_TOL
    toks = tokens(rc.vocab, (2, 19), seed=3)
    prompt, steps = toks[:, :16], toks[:, 16:]
    want_logits, want_cache = run_ref(
        lambda p, t: ref_decode.prefill(p, rc, t, s_max=24), rp,
        jnp.asarray(prompt), bf16=bf16)
    logits, cache = decode.prefill(pp, pc, torch.from_numpy(prompt),
                                   s_max=24)
    assert_close(logits, want_logits, tol)
    assert_cache(cache, want_cache, bf16)

    step = lambda p, c, t: ref_decode.serve_step(p, rc, c, t)   # noqa: E731
    for i in range(2):
        want_logits, want_cache = run_ref(step, rp, want_cache,
                                          jnp.asarray(steps[:, i:i + 1]),
                                          bf16=bf16)
    carried = params_from_numpy(jax.tree.map(np.asarray, want_cache), "cpu")
    want_logits, want_next = run_ref(step, rp, want_cache,
                                     jnp.asarray(steps[:, 2:3]), bf16=bf16)
    logits, nxt = decode.serve_step(pp, pc, carried,
                                    torch.from_numpy(steps[:, 2:3]))
    assert_close(logits, want_logits, tol)
    assert_cache(nxt, want_next, bf16)
    assert int(carried["pos"]) == 18          # the caller's cache unchanged


@pytest.mark.parametrize("arch", ["starcoder2-15b", "granite-moe-3b-a800m"])
def test_decode_matches_full_forward(arch):
    _, pc, _, pp = smoke(arch, compute_dtype="float32")
    if pc.moe is not None:
        pc = dataclasses.replace(pc, moe=dataclasses.replace(
            pc.moe, capacity_factor=pc.moe.n_experts_padded / pc.moe.top_k))
    toks = torch.from_numpy(tokens(pc.vocab, (2, 20), seed=4))
    logits, cache = decode.prefill(pp, pc, toks[:, :16], s_max=20)
    for i in range(16, 20):
        full = transformer.lm_logits(pp, pc, transformer.lm_forward(
            pp, pc, toks[:, :i]))[:, -1]
        # the cache holds bf16 K/V; the full forward keeps them in f32
        assert_close(logits, full, BF16_TOL, f"position {i}")
        logits, cache = decode.serve_step(pp, pc, cache, toks[:, i:i + 1])
        assert cache["pos"].device == toks.device


def test_init_cache_and_the_sharded_cache_refused():
    _, pc, _, pp = smoke("granite-moe-3b-a800m")
    cache = decode.init_cache(pc, 3, 40, device="cpu")
    assert cache["k"].shape == cache["v"].shape == (
        pc.n_layers, 3, 40, pc.n_kv_heads, pc.d_head)
    assert cache["k"].dtype == torch.bfloat16
    assert int(cache["pos"]) == 0 and cache["pos"].dtype == torch.int32
    # a sharded cache on a 1 x 1 plan: prefill and steps equal no plan
    from torch_port_state import world_of_one
    _, pc, _, pp = smoke("granite-moe-3b-a800m", compute_dtype="float32")
    toks = torch.from_numpy(tokens(pc.vocab, (2, 12)))
    want, want_c = decode.prefill(pp, pc, toks[:, :8], s_max=12)
    with world_of_one() as plan:
        for cs in (decode.CacheSpec(("data",), "model"),
                   decode.CacheSpec(None, ("data", "model"))):
            got, got_c = decode.prefill(pp, pc, toks[:, :8], plan=plan,
                                        s_max=12, cs=cs)
            w, wc = want, want_c
            for i in range(8, 12):
                assert_close(got, w, F32_TOL, f"{cs} position {i}")
                got, got_c = decode.serve_step(pp, pc, got_c,
                                               toks[:, i:i + 1], plan=plan,
                                               cs=cs)
                w, wc = decode.serve_step(pp, pc, wc, toks[:, i:i + 1])
            assert got_c["pos"].device == toks.device
