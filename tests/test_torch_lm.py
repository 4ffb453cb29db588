"""The port's LM family (``repro_torch/models/lm/{transformer,moe}.py`` and
the five LM config modules) held against the JAX reference on the CPU.

The same numpy inputs go through both packages, with the reference's
``lm_init`` params carried across by tree path (``interop``):

  * the config modules (CONFIG, smoke_config, the param counts) and the
    init tree's paths, shapes and dtypes; the cells refused naming A10b;
  * the blocks: RMSNorm, RoPE, GQA attention (full, q-chunked, with
    ``kv_valid``), the GELU and SwiGLU MLPs, and a GELU and a SwiGLU layer;
  * every arch's smoke config: the loss and every gradient leaf at
    ``compute_dtype="float32"``, the logits and loss at the default bf16;
  * the q-chunked branch (``full_attn_max_seq`` / ``q_chunk`` replaced)
    against the reference and against the port's unchunked run;
  * the MoE at ``capacity_factor`` 0.5, where tokens are dropped: the same
    ``top_i`` and the same kept slots exactly, the output and gradients;
  * the plan route on a 1 x 1 mesh (a world of one) equal to no plan (the
    2 x 2 runs against the reference's sharded ones are
    ``test_torch_lm_spmd.py``).

Tolerances: f32 compute, the loss and logits atol = rtol = 1e-5 and the
gradients atol = rtol = 1e-4 (the packages sum in other orders); bf16
compute, atol = rtol = 2e-2 (the reference's bf16 tolerance,
``tests/test_kernels.py``). The reference runs under ``jax.jit``; at
bf16 without XLA's excess precision (``strict_jit``).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models.lm import moe as ref_moe
from repro.models.lm import transformer as ref_lm
from repro_torch.configs.registry import get_arch
from repro_torch.interop import params_from_numpy
from repro_torch.models.lm import moe, transformer
from repro_torch.models.lm.moe import MoEConfig
from repro_torch.models.lm.transformer import LMConfig
from repro_torch.tree import flatten_with_path, leaves, unflatten

LM_IDS = ("starcoder2-15b", "deepseek-coder-33b", "phi3-medium-14b",
          "qwen3-moe-235b-a22b", "granite-moe-3b-a800m")
sys.path.insert(0, str(Path(__file__).resolve().parent))

F32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2


def port_config(ref_cfg) -> LMConfig:
    """The port's LMConfig with the reference config's fields."""
    fields = dataclasses.asdict(ref_cfg)
    if ref_cfg.moe is not None:
        fields["moe"] = MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    return LMConfig(**fields)


def carried(ref_params, device="cpu"):
    return params_from_numpy(jax.tree.map(np.asarray, ref_params), device)


def smoke(arch, **changes):
    """(reference cfg, port cfg, reference params, port params)."""
    rc = dataclasses.replace(ref_get_arch(arch).smoke_config(), **changes)
    rp = ref_lm.lm_init(jax.random.PRNGKey(0), rc)
    return rc, port_config(rc), rp, carried(rp)


def tokens(vocab, shape, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def port_value_and_grad(loss_fn, params):
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = loss_fn(unflatten(params, flat))
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, grads)]


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def assert_grads(ref_grads, port_grads, tol=GRAD_TOL):
    for path_leaf, g in zip(jax.tree_util.tree_flatten_with_path(ref_grads)[0],
                            port_grads):
        path, want = path_leaf
        assert_close(g.float().numpy(), want, tol, jax.tree_util.keystr(path))


def rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_IDS)
def test_config_modules_match_reference(arch):
    ref, mod = ref_get_arch(arch), get_arch(arch)
    assert (mod.ARCH_ID, mod.FAMILY) == (ref.ARCH_ID, ref.FAMILY) == (
        arch, "lm")
    for name in ("CONFIG", "smoke_config"):
        rc = getattr(ref, name)
        rc = rc() if callable(rc) else rc
        pc = getattr(mod, name)
        pc = pc() if callable(pc) else pc
        assert port_config(rc) == pc
        assert (pc.n_params(), pc.n_active_params()) == (
            rc.n_params(), rc.n_active_params())
        assert pc.cdtype == torch.bfloat16
        assert pc.pdtype == (torch.bfloat16 if rc.param_dtype == "bfloat16"
                             else torch.float32)
    # the dry-run cells (A10b): the reference's shapes, a Cell per shape
    from repro_torch.configs.base import Cell
    from repro_torch.distributed.sharding import replicated_plan
    assert mod.SHAPES == ref.SHAPES
    for shape in mod.SHAPES:
        cell = mod.build_cell(shape, replicated_plan())
        assert isinstance(cell, Cell) and cell.shape == shape
        assert cell.arch == arch


@pytest.mark.parametrize("arch", LM_IDS)
def test_init_tree_matches_reference(arch):
    rc = ref_get_arch(arch).smoke_config()
    want = jax.eval_shape(lambda: ref_lm.lm_init(jax.random.PRNGKey(0), rc))
    got = transformer.lm_init(torch.Generator().manual_seed(0),
                              port_config(rc), device="cpu")
    ref_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    port_leaves = flatten_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in ref_leaves] == [
        "".join(p) for p, _ in port_leaves]
    for (_, w), (_, g) in zip(ref_leaves, port_leaves):
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}"
    assert float(got["layers"]["attn_norm"].min()) == 1.0


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_and_mlps():
    x = rand((2, 6, 16), 0)
    scale = rand((16,), 1) + 1.0
    assert_close(transformer._rmsnorm(torch.from_numpy(x),
                                      torch.from_numpy(scale)),
                 ref_lm._rmsnorm(jnp.asarray(x), jnp.asarray(scale)),
                 F32_TOL)
    q = rand((2, 6, 3, 8), 2)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32)[None], (2, 6)) + 5
    assert_close(transformer.rope(torch.from_numpy(q),
                                  torch.from_numpy(pos.copy()), 1e5),
                 ref_lm.rope(jnp.asarray(q), jnp.asarray(pos), 1e5), F32_TOL)
    w = {n: rand(s, i, 0.3) for i, (n, s) in enumerate(
        (("w1", (16, 32)), ("w3", (16, 32)), ("w2", (32, 16))))}
    for act in ("gelu", "swiglu"):
        rc = ref_get_arch("starcoder2-15b").smoke_config()
        rc = dataclasses.replace(rc, activation=act, compute_dtype="float32")
        want = ref_lm._mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                            for k, v in w.items()},
                           rc, ref_lm.replicated_plan())
        got = transformer._mlp(torch.from_numpy(x),
                               {k: torch.from_numpy(v) for k, v in w.items()},
                               port_config(rc))
        assert_close(got, want, F32_TOL, act)


@pytest.mark.parametrize("case", ["full", "chunked", "kv_valid"])
def test_attention(case):
    rc = dataclasses.replace(ref_get_arch("phi3-medium-14b").smoke_config(),
                             compute_dtype="float32")
    sq = skv = 24
    if case == "chunked":
        rc = dataclasses.replace(rc, full_attn_max_seq=8, q_chunk=8)
    q, k, v = rand((2, sq, 10, 8), 0), rand((2, skv, 5, 8), 1), \
        rand((2, skv, 5, 8), 2)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32)[None], (2, sq)).copy()
    valid = None
    if case == "kv_valid":
        valid = pos <= np.array([[9], [17]])
    want = ref_lm._attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), rc,
        kv_valid=None if valid is None else jnp.asarray(valid))
    got = transformer._attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), torch.from_numpy(pos), port_config(rc),
        kv_valid=None if valid is None else torch.from_numpy(valid))
    assert_close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", ["starcoder2-15b", "deepseek-coder-33b"])
def test_layer(arch):
    rc, pc, rp, pp = smoke(arch, compute_dtype="float32")
    x = rand((2, 12, rc.d_model), 3)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32)[None], (2, 12)).copy()
    want = jax.jit(lambda x, lyr: ref_lm._layer(
        x, lyr, rc, ref_lm.replicated_plan(), jnp.asarray(pos)))(
            jnp.asarray(x), jax.tree.map(lambda t: t[1], rp["layers"]))
    lyr = transformer.layer_params(pp, torch.float32)[1]
    got = transformer._layer(torch.from_numpy(x), lyr, pc,
                             torch.from_numpy(pos))
    assert_close(got, want, F32_TOL)


# ---------------------------------------------------------------------------
# the model: loss, gradients, logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_IDS)
def test_loss_and_grads_f32(arch):
    rc, pc, rp, pp = smoke(arch, compute_dtype="float32")
    toks = tokens(rc.vocab, (2, 32))
    t = jnp.asarray(toks)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.lm_loss(p, rc, t, t)))(rp)
    tt = torch.from_numpy(toks)
    loss, grads = port_value_and_grad(
        lambda p: transformer.lm_loss(p, pc, tt, tt), pp)
    assert_close(loss, want_loss, F32_TOL)
    assert_grads(want_grads, grads)


def logsumexp_np(x):
    m = x.max(-1, keepdims=True)
    return (m + np.log(np.exp(x - m).sum(-1, keepdims=True)))[..., 0]


def strict_jit(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision: every bf16
    op's result rounded to bf16, as the op-by-op run rounds it. With the
    default, XLA's fusions keep some bf16 intermediates in f32, and a
    jitted MoE run can then route a near-tied token otherwise than the
    same code run op by op (seen on the qwen3 and granite smoke configs).
    The port rounds where the op-by-op run does."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("arch", LM_IDS)
def test_logits_bf16(arch):
    rc, pc, rp, pp = smoke(arch)
    toks = tokens(rc.vocab, (2, 32), seed=1)
    t = jnp.asarray(toks)
    want = strict_jit(lambda p: ref_lm.lm_logits(
        p, rc, ref_lm.lm_forward(p, rc, t)), rp)
    want = np.asarray(want)
    tt = torch.from_numpy(toks)
    hidden = transformer.lm_forward(pp, pc, tt)
    assert hidden.dtype == torch.bfloat16
    got = transformer.lm_logits(pp, pc, hidden)
    assert got.dtype == torch.float32
    assert_close(got.detach(), want, BF16_TOL)
    want_loss = np.mean(logsumexp_np(want) - np.take_along_axis(
        want, toks[..., None], -1)[..., 0])
    assert_close(transformer.lm_loss(pp, pc, tt, tt).detach(), want_loss,
                 BF16_TOL)


def test_q_chunked_branch():
    """Above ``full_attn_max_seq`` (replaced: 16, chunks of 8) the loss and
    gradients are the reference's chunked run's and the port's unchunked
    run's."""
    rc, pc, rp, pp = smoke("granite-moe-3b-a800m", compute_dtype="float32",
                           full_attn_max_seq=16, q_chunk=8)
    toks = tokens(rc.vocab, (2, 32), seed=2)
    t = jnp.asarray(toks)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.lm_loss(p, rc, t, t)))(rp)
    tt = torch.from_numpy(toks)
    loss, grads = port_value_and_grad(
        lambda p: transformer.lm_loss(p, pc, tt, tt), pp)
    assert_close(loss, want_loss, F32_TOL)
    assert_grads(want_grads, grads)
    full = dataclasses.replace(pc, full_attn_max_seq=4096)
    loss_full, grads_full = port_value_and_grad(
        lambda p: transformer.lm_loss(p, full, tt, tt), pp)
    assert_close(loss, loss_full, F32_TOL)
    for g, h in zip(grads, grads_full):
        assert_close(g, h, GRAD_TOL)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "granite-moe-3b-a800m"])
def test_plan_refused_naming_a9b(arch):
    """A 1 x 1 plan (a world of one) runs the plan route of the forward,
    the loss and its gradients (both ``use_spmd_layer`` values) and the
    MoE, and equals the run without a plan."""
    from torch_port_state import world_of_one
    _, pc, _, pp = smoke(arch, compute_dtype="float32")
    toks = torch.from_numpy(tokens(pc.vocab, (2, 8)))
    want, want_g = port_value_and_grad(
        lambda p: transformer.lm_loss(p, pc, toks, toks), pp)
    hidden = transformer.lm_forward(pp, pc, toks)
    with world_of_one() as plan:
        for spmd_layer in (False, True):
            cfg = dataclasses.replace(pc, use_spmd_layer=spmd_layer)
            got, got_g = port_value_and_grad(
                lambda p: transformer.lm_loss(p, cfg, toks, toks, plan), pp)
            assert_close(got, want, F32_TOL)
            for g, w in zip(got_g, want_g):
                assert_close(g, w, GRAD_TOL)
            assert_close(transformer.lm_forward(pp, cfg, toks, plan)
                         .detach(), hidden.detach(), F32_TOL)
        if pc.moe is not None:
            lyr = transformer.layer_params(pp, torch.float32)[0]
            x = torch.from_numpy(rand((2, 8, pc.d_model), 1))
            for seq_sharded in (True, False):
                assert_close(moe.moe_layer(x, lyr, pc.moe, plan, seq_sharded)
                             .detach(), moe.moe_layer(x, lyr, pc.moe)
                             .detach(), F32_TOL)


# ---------------------------------------------------------------------------
# the MoE, with tokens dropped
# ---------------------------------------------------------------------------

def ref_slots(top_i, c, cfg):
    """The reference's dispatch (``moe.py:101-111``) on its routing."""
    t = top_i.shape[0]
    flat_e = top_i.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.bincount(se, length=cfg.n_experts_padded)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    pos = jnp.arange(t * cfg.top_k, dtype=jnp.int32) - starts[se]
    in_cap = pos < c
    return in_cap, jnp.where(in_cap, se * c + pos, cfg.n_experts_padded * c)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_drops_tokens_as_the_reference(arch):
    rcfg = dataclasses.replace(ref_get_arch(arch).smoke_config().moe,
                               capacity_factor=0.5)
    pcfg = MoEConfig(**dataclasses.asdict(rcfg))
    d = ref_get_arch(arch).smoke_config().d_model
    rw = jax.tree.map(lambda a: a[0], ref_moe.moe_init(
        jax.random.PRNGKey(1), rcfg, 1, d, jnp.float32))
    pw = carried(rw)
    xt = rand((64, d), 4)
    c = moe._capacity(64, pcfg)
    assert c == ref_moe._capacity(64, rcfg)
    want_i, _ = ref_moe._route_local(jnp.asarray(xt), rw["router"], rcfg)
    got_i, _ = moe._route_local(torch.from_numpy(xt), pw["router"], pcfg)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    want_in, want_slot = ref_slots(want_i, c, rcfg)
    _, _, got_in, got_slot = moe._dispatch_slots(got_i, c, pcfg)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(want_slot))
    assert 0 < int(got_in.sum()) < got_in.numel()    # tokens really dropped

    names = ("router", "w1e", "w3e", "w2e")

    def ref_fn(x, *ws):
        return ref_moe._dispatch_compute_combine(
            x, *ws, rcfg, model_axis=None, n_model=1, fsdp_axes=None)
    g_out = rand((64, d), 5)
    want, want_grads = jax.jit(lambda x, g, *ws: (lambda o: (
        o[0], o[1](g)))(jax.vjp(ref_fn, x, *ws)))(
            jnp.asarray(xt), jnp.asarray(g_out), *(rw[n] for n in names))
    ins = [torch.from_numpy(xt).requires_grad_(True)] + [
        pw[n].clone().requires_grad_(True) for n in names]
    got = moe._dispatch_compute_combine(*ins, pcfg)
    assert_close(got.detach(), want, F32_TOL)
    grads = torch.autograd.grad(got, ins, torch.from_numpy(g_out))
    for name, g, w in zip(("x",) + names, grads, want_grads):
        assert_close(g, w, GRAD_TOL, name)
