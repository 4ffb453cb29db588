"""The port's hstu-gr training slice held against the JAX reference.

The same numpy inputs (and the reference's ``gr_init`` params, carried
across with ``interop``) go through both packages:

  * the HSTU attention backward: the port's dense oracle
    (``hstu_attention_bwd_ref``) against ``jax.grad`` of the reference's
    dense forward at the reference's 1e-4, and against torch autograd of
    the port's dense and chunked forwards at 1e-5 (incl. a clip case,
    max_rel_pos < S);
  * ``HSTUAttentionFn`` with its two CUDA entry points swapped for their
    plain versions (the kernels themselves run only on the card, in
    ``chip_smoke.py``);
  * ``hstu_apply`` and the GR losses: value and every leaf's gradient;
  * the optimizers over several steps, states carried across;
  * a 20-step hstu-gr ``Trainer`` run on the same ``ROOBatcher`` batches:
    per-step loss, NE and final params; and a state the reference trained
    5 steps, continued in the port.

The reference runs on ``jnp-dense``/``jnp-chunked``: its Pallas-interpret
rab backward raises on this tree (ROADMAP C). Tolerances are fp32
summation-order ones: 1e-5 (rtol) on losses, 1e-4 on gradients.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import roo_models as jax_rm
from repro.core import joiner as jax_joiner
from repro.core.hstu import HSTUConfig as JaxHSTUConfig
from repro.core.hstu import hstu_apply as jax_hstu_apply
from repro.core.hstu import hstu_init as jax_hstu_init
from repro.core.masks import roo_spec as jax_roo_spec
from repro.data import batcher as jax_batcher
from repro.data import events as jax_events
from repro.kernels.ref import hstu_attention_ref as jax_attention_ref
from repro.models import gr as jax_gr
from repro.train import loop as jax_loop
from repro.train import metrics as jax_metrics
from repro.train import optim as jax_optim
from repro_torch import tree
from repro_torch.configs import roo_models as rm
from repro_torch.core import joiner
from repro_torch.core.hstu import HSTUConfig, hstu_apply, hstu_attention_chunked
from repro_torch.core.masks import roo_spec
from repro_torch.data import batcher, events
from repro_torch.interop import (params_from_numpy, params_to_numpy,
                                 train_state_from_numpy)
from repro_torch.kernels import hstu_attention as kmod
from repro_torch.kernels import hstu_attention_bwd as bmod
from repro_torch.kernels.ref import hstu_attention_bwd_ref, hstu_attention_ref
from repro_torch.models import gr
from repro_torch.train import loop, metrics, optim
from repro_torch.train.checkpoint import CheckpointManager

GRAD_TOL = dict(atol=1e-4, rtol=1e-4)      # the reference's own
PORT_TOL = dict(atol=1e-5, rtol=1e-5)      # port vs port, fp32
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
PARAM_TOL = dict(atol=2e-5, rtol=1e-4)     # after 20 Adam steps
STREAM = dict(n_requests=200, n_users=50, n_items=rm.N_ITEMS,
              hist_init_max=48, seed=0)
BATCH = dict(b_ro=16, b_nro=96, hist_len=64)


def attention_case(seed, b, h, s, dqk, dv, n_hist, max_rel):
    """Seeded numpy q/k/v/rab/g and ragged lengths with edge rows."""
    rng = np.random.default_rng(seed)
    x = dict(q=rng.normal(size=(b, h, s, dqk)),
             k=rng.normal(size=(b, h, s, dqk)),
             v=rng.normal(size=(b, h, s, dv)),
             rab=0.3 * rng.normal(size=(h, 2 * max_rel + 1)),
             g=rng.normal(size=(b, h, s, dv)))
    x = {key: val.astype(np.float32) for key, val in x.items()}
    hl = rng.integers(0, n_hist + 1, size=b)
    tc = rng.integers(0, s - n_hist + 1, size=b)
    hl[0], tc[0] = n_hist, s - n_hist
    x.update(hl=hl.astype(np.int32), tc=tc.astype(np.int32), n_hist=n_hist,
             max_rel=max_rel)
    return x


def t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def port_autograd(x, use_rab, forward):
    """(dq, dk, dv, drab) by torch autograd through a port forward."""
    q, k, v = t(x["q"], True), t(x["k"], True), t(x["v"], True)
    rab = t(x["rab"], True) if use_rab else None
    out = forward(q, k, v, rab, x["n_hist"], t(x["hl"]), t(x["tc"]),
                  x["max_rel"])
    grads = torch.autograd.grad(out, [a for a in (q, k, v, rab)
                                      if a is not None], t(x["g"]))
    return tuple(grads) + (() if use_rab else (None,))


def bwd_ref(x, use_rab):
    return hstu_attention_bwd_ref(
        t(x["q"]), t(x["k"]), t(x["v"]), t(x["rab"]) if use_rab else None,
        x["n_hist"], t(x["hl"]), t(x["tc"]), x["max_rel"], t(x["g"]))


def chunked_forward(q, k, v, rab, n_hist, hl, tc, max_rel):
    return hstu_attention_chunked(q, k, v, rab, roo_spec(hl, tc, n_hist),
                                  max_rel_pos=max_rel, chunk=32)


def assert_grads(got, want, tol, names="qkvr"):
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, f"d{name}"
            continue
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=f"d{name}", **tol)


# ---------------------------------------------------------------------------
# The attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("shape", [(2, 2, 128, 32, 32, 96),
                                   (2, 2, 100, 32, 16, 80)],
                         ids=["s128", "s100"])
def test_bwd_ref_matches_jax_grad(shape, use_rab):
    """test_dispatch.py's gradient shapes: the port's dense backward vs
    jax.grad of the reference's dense forward (max_rel_pos 128)."""
    x = attention_case(sum(shape), *shape, max_rel=128)
    argnums = (0, 1, 2, 3) if use_rab else (0, 1, 2)

    def loss(q, k, v, rab=None):
        out = jax_attention_ref(q, k, v, rab, x["n_hist"],
                                jnp.asarray(x["hl"]), jnp.asarray(x["tc"]),
                                max_rel_pos=x["max_rel"])
        return jnp.sum(out * jnp.asarray(x["g"]))

    args = [jnp.asarray(x[n]) for n in "qkv"]
    if use_rab:
        args.append(jnp.asarray(x["rab"]))
    want = list(jax.grad(loss, argnums=argnums)(*args))
    if not use_rab:
        want.append(None)
    assert_grads(bwd_ref(x, use_rab), want, GRAD_TOL)


@pytest.mark.parametrize("forward", [hstu_attention_ref, chunked_forward],
                         ids=["dense", "chunked"])
@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("case", [
    (3, 2, 80, 32, 32, 64, 64),        # hstu-gr's training sequence
    (3, 2, 100, 48, 40, 70, 16),       # ragged, clip: max_rel_pos < S
    (2, 1, 48, 16, 16, 48, 8),         # causal (m = 0), clip
], ids=["gr80", "clip100", "causal48"])
def test_bwd_ref_matches_port_autograd(case, use_rab, forward):
    b, h, s, dqk, dv, n_hist, max_rel = case
    x = attention_case(s + dqk, b, h, s, dqk, dv, n_hist, max_rel)
    if n_hist == s:
        x["tc"][:] = 0
    assert_grads(bwd_ref(x, use_rab), port_autograd(x, use_rab, forward),
                 PORT_TOL)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Both CUDA entry points of the Function swapped for their plain
    versions, so its plumbing runs on CPU tensors."""
    monkeypatch.setattr(kmod, "hstu_attention_cuda",
                        kmod.hstu_attention_plain)
    monkeypatch.setattr(bmod, "hstu_attention_bwd_cuda",
                        bmod.hstu_attention_bwd_plain)


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
def test_function_grads_equal_autograd(plain_kernels, use_rab):
    x = attention_case(5, 3, 2, 80, 32, 24, 64, 16)

    def fn(q, k, v, rab, n_hist, hl, tc, max_rel):
        return bmod.HSTUAttentionFn.apply(q, k, v, rab, n_hist, hl, tc,
                                          max_rel)

    assert_grads(port_autograd(x, use_rab, fn),
                 port_autograd(x, use_rab, hstu_attention_ref), PORT_TOL)


def test_function_backward_outputs(plain_kernels):
    """No gradient for the lengths or the statics, none for an absent rab,
    and a non-contiguous grad_output is taken."""
    x = attention_case(6, 2, 2, 80, 16, 16, 64, 64)
    q, k, v = t(x["q"], True), t(x["k"], True), t(x["v"], True)
    out = bmod.HSTUAttentionFn.apply(q, k, v, None, 64, t(x["hl"]),
                                     t(x["tc"]), 64)
    g = t(x["g"]).transpose(2, 3).contiguous().transpose(2, 3)
    assert not g.is_contiguous()
    with torch.no_grad():                 # as autograd runs a backward
        grads = out.grad_fn.apply(g)
    assert len(grads) == 8
    assert grads[3] is None and all(a is None for a in grads[4:])
    want = hstu_attention_bwd_ref(q.detach(), k.detach(), v.detach(), None,
                                  64, t(x["hl"]), t(x["tc"]), 64,
                                  g.contiguous())
    assert_grads(grads[:3], want[:3], PORT_TOL)


def test_cuda_wrappers_refuse_grad_before_device():
    """The raw kernel wrappers build outputs outside autograd: under grad
    mode an input that requires grad is refused, and that check runs before
    the device check (so it shows on the CPU too)."""
    from repro_torch.core.masks import prefix_spec
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import hstu_attention_prefix as pmod
    x = attention_case(7, 2, 2, 80, 16, 16, 64, 64)
    q, k, v = t(x["q"], True), t(x["k"]), t(x["v"])
    lengths = (t(x["hl"]), t(x["tc"]))
    with pytest.raises(RuntimeError, match="requires grad"):
        kmod.hstu_attention_cuda(q, k, v, None, 64, *lengths, 64)
    with pytest.raises(RuntimeError, match="requires grad"):
        pmod.hstu_attention_prefix_cuda(q, k, v, None, 64, 64,
                                        torch.zeros(2, dtype=torch.int32),
                                        *lengths, 80, 64)
    spec = prefix_spec(torch.zeros(2, dtype=torch.int32), *lengths, 64, 64)
    with pytest.raises(RuntimeError, match="requires grad"):
        dispatch.hstu_attention_prefix(q, k, v, None, spec, backend="cuda",
                                       scale_len=80, max_rel_pos=64)
    # without grad (or under inference_mode) the device check is what fails
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx(), pytest.raises(ValueError, match="CUDA tensors"):
            kmod.hstu_attention_cuda(q, k, v, None, 64, *lengths, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bmod.hstu_attention_bwd_cuda(q.detach(), k, v, None, 64, *lengths,
                                     64, t(x["g"]))


@pytest.mark.parametrize("backend", ["torch-chunked", "torch-dense"])
def test_hstu_apply_value_and_grads(backend):
    """test_dispatch.py's train-step case (jit(value_and_grad) through
    hstu_apply), held against the reference on jnp-dense, on both plain
    rungs of the port's dispatch."""
    jcfg = JaxHSTUConfig(d_model=32, n_heads=2, d_qk=16, d_v=16, n_layers=2,
                         max_rel_pos=72, attn_backend="jnp-dense")
    jparams = jax_hstu_init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).normal(size=(3, 72, 32)).astype(np.float32)
    hl, tc = np.asarray([5, 64, 0]), np.asarray([8, 3, 1])
    jspec = jax_roo_spec(jnp.asarray(hl), jnp.asarray(tc), 64)
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jax_hstu_apply(p, jcfg, jnp.asarray(x), jspec)
                          ** 2)))(jparams)
    cfg = HSTUConfig(d_model=32, n_heads=2, d_qk=16, d_v=16, n_layers=2,
                     max_rel_pos=72)
    spec = roo_spec(t(hl), t(tc), 64)
    vag = loop.value_and_grad(lambda p, b, g: torch.sum(
        hstu_apply(p, cfg, t(x), spec, backend=backend) ** 2))
    got_l, got_g = vag(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"), None, None)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    jleaves = jax.tree.leaves(want_g)
    assert len(jleaves) == len(tree.leaves(got_g))
    for (path, a), b in zip(tree.flatten_with_path(got_g), jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# hstu-gr at gr_config width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gr_setup():
    jcfg = jax_rm.gr_config(attn_backend="jnp-chunked")
    jparams = jax_gr.gr_init(jax.random.PRNGKey(0), jcfg)
    samples = joiner.RequestLevelJoiner().join(list(
        events.EventSimulator(events.EventStreamConfig(**STREAM)).stream()))
    jsamples = jax_joiner.RequestLevelJoiner().join(list(
        jax_events.EventSimulator(
            jax_events.EventStreamConfig(**STREAM)).stream()))
    pb = list(batcher.ROOBatcher(batcher.BatcherConfig(**BATCH),
                                 device="cpu").batches(samples))
    jb = list(jax_batcher.ROOBatcher(
        jax_batcher.BatcherConfig(**BATCH)).batches(jsamples))
    assert len(pb) == len(jb) > 4
    return dict(jcfg=jcfg, cfg=rm.gr_config(), jparams=jparams,
                np_params=jax.tree.map(np.asarray, jparams), pb=pb, jb=jb)


@pytest.mark.parametrize("which", ["ranking", "retrieval"])
def test_gr_loss_value_and_grads(gr_setup, which):
    s = gr_setup
    jloss = {"ranking": jax_gr.gr_ranking_loss,
             "retrieval": jax_gr.gr_retrieval_loss}[which]
    ploss = {"ranking": gr.gr_ranking_loss,
             "retrieval": gr.gr_retrieval_loss}[which]
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, s["jcfg"], s["jb"][1])))(s["jparams"])
    got_l, got_g = loop.value_and_grad(
        lambda p, b, g: ploss(p, s["cfg"], b))(
        params_from_numpy(s["np_params"], "cpu"), s["pb"][1], None)
    np.testing.assert_allclose(float(got_l), float(want_l), **LOSS_TOL)
    jleaves = jax.tree.leaves(want_g)
    assert len(jleaves) == len(tree.leaves(got_g)) == 20
    for (path, a), b in zip(tree.flatten_with_path(got_g), jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-4, err_msg=str(path))


def test_gr_table_ids(gr_setup):
    s = gr_setup
    got = gr.gr_table_ids(s["cfg"], s["pb"][0])
    want = jax_gr.gr_table_ids(s["jcfg"], s["jb"][0])
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_metrics_match_reference():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=64).astype(np.float32)
    labels = (rng.random(64) < 0.3).astype(np.float32)
    w = (rng.random(64) < 0.8).astype(np.float32)
    u, items = rng.normal(size=(8, 4)), rng.normal(size=(20, 4))
    pos = rng.integers(0, 20, size=8)
    pairs = [
        (metrics.bce(t(logits), t(labels), t(w)),
         jax_metrics.bce(logits, labels, w)),
        (metrics.normalized_entropy(t(logits), t(labels), t(w)),
         jax_metrics.normalized_entropy(logits, labels, w)),
        (metrics.normalized_entropy(t(logits), t(labels)),
         jax_metrics.normalized_entropy(logits, labels)),
        (metrics.auc(t(logits), t(labels)), jax_metrics.auc(logits, labels)),
        (metrics.recall_at_k(t(u.astype(np.float32)),
                             t(items.astype(np.float32)), t(pos), k=5),
         jax_metrics.recall_at_k(u.astype(np.float32),
                                 items.astype(np.float32), pos, k=5)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("name", ["adam", "adam_clip_wd", "rowwise_adagrad",
                                  "sgd", "sgd_momentum", "mixed"])
def test_optimizers_match_reference(name):
    """Three updates from the reference's initial state (carried across
    with interop), on the same numpy gradients."""
    make = {
        "adam": lambda o: o.adam(1e-2),
        "adam_clip_wd": lambda o: o.adam(1e-2, weight_decay=0.1,
                                         grad_clip=0.5),
        "rowwise_adagrad": lambda o: o.rowwise_adagrad(0.1),
        "sgd": lambda o: o.sgd(0.1),
        "sgd_momentum": lambda o: o.sgd(0.1, momentum=0.9),
        "mixed": lambda o: o.make_mixed(o.adam(1e-2), o.rowwise_adagrad(0.1),
                                        o.default_is_embedding),
    }[name]
    rng = np.random.default_rng(4)

    def draw():
        return {"item_emb": rng.normal(size=(6, 4)).astype(np.float32),
                "mlp": [{"b": rng.normal(size=(3,)).astype(np.float32),
                         "w": rng.normal(size=(4, 3)).astype(np.float32)}],
                "table_x": rng.normal(size=(5,)).astype(np.float32)}

    jopt, popt = make(jax_optim), make(optim)
    jp = jax.tree.map(jnp.asarray, draw())
    js = jopt.init(jp)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ps = params_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for _ in range(3):
        g = draw()
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        pp, ps = popt.update(params_from_numpy(g, "cpu"), ps, pp)
    for got, want in ((pp, jp), (ps, js)):
        jl = jax.tree.leaves(want)
        assert len(jl) == len(tree.leaves(got))
        for a, b in zip(tree.leaves(got), jl):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-5)


def cycling(batches):
    return lambda start: (batches[i % len(batches)]
                          for i in itertools.count(start))


def jax_trainer(s, steps, log_every=1):
    jcfg = s["jcfg"]
    return jax_loop.Trainer(
        lambda p, b, r: jax_gr.gr_ranking_loss(p, jcfg, b),
        jax_optim.make_mixed(jax_optim.adam(1e-3),
                             jax_optim.rowwise_adagrad(0.05),
                             jax_optim.default_is_embedding),
        jax_loop.TrainLoopConfig(total_steps=steps, log_every=log_every),
        lambda: s["jparams"],
        metrics_fn=jax_metrics.make_ne_metrics(lambda p, b: (
            jax_gr.gr_ranking_logits(p, jcfg, b)[:, 0], b.labels[:, 0],
            b.impression_mask())))


def port_trainer(s, steps, log_every=1, ckpt_dir=None):
    cfg = s["cfg"]
    return loop.Trainer(
        lambda p, b, r: gr.gr_ranking_loss(p, cfg, b),
        optim.make_mixed(optim.adam(1e-3), optim.rowwise_adagrad(0.05),
                         optim.default_is_embedding),
        loop.TrainLoopConfig(total_steps=steps, log_every=log_every,
                             ckpt_dir=ckpt_dir),
        lambda: params_from_numpy(s["np_params"], "cpu"),
        metrics_fn=metrics.make_ne_metrics(lambda p, b: (
            gr.gr_ranking_logits(p, cfg, b)[:, 0], b.labels[:, 0],
            b.impression_mask())), device="cpu")


def assert_params_close(port_params, jax_params):
    jl = jax.tree.leaves(jax_params)
    assert len(jl) == len(tree.leaves(port_params))
    for (path, a), b in zip(tree.flatten_with_path(port_params), jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PARAM_TOL,
                                   err_msg=str(path))


def test_trainer_20_steps_match_reference(gr_setup):
    """The hstu-gr Trainer (the scenario's optimizer: Adam on dense,
    row-wise Adagrad on the tables) for 20 steps on the same batches:
    loss, grad norm and NE at every step, then the final params."""
    s = gr_setup
    jt, pt = jax_trainer(s, 20), port_trainer(s, 20)
    jstate = jt.run(cycling(s["jb"]), jax.random.PRNGKey(0))
    pstate = pt.run(cycling(s["pb"]), 0)
    assert [r["step"] for r in pt.history] == list(range(1, 21))
    for a, b in zip(pt.history, jt.history):
        for key in ("loss", "ne", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], **LOSS_TOL,
                                       err_msg=f"{key} at step {a['step']}")
        assert a["skipped"] == b["skipped"] == 0
    assert int(pstate["step"]) == 20
    assert_params_close(pstate["params"], jstate["params"])
    jl = jax.tree.leaves(jstate["opt"])
    assert len(jl) == len(tree.leaves(pstate["opt"]))


def test_reference_state_continues_in_port(gr_setup, tmp_path):
    """5 steps in the reference, the state carried across (interop) into
    the port's checkpoint dir, 5 more in the port == 10 in the reference."""
    s = gr_setup
    jfull = jax_trainer(s, 10, log_every=10).run(cycling(s["jb"]),
                                                 jax.random.PRNGKey(0))
    jhalf = jax_trainer(s, 5, log_every=10).run(cycling(s["jb"]),
                                                jax.random.PRNGKey(0))
    state = train_state_from_numpy(jax.tree.map(np.asarray, jhalf), "cpu")
    assert int(state["step"]) == 5
    CheckpointManager(str(tmp_path)).save(5, state)
    pt = port_trainer(s, 10, log_every=10, ckpt_dir=str(tmp_path))
    pstate = pt.run(cycling(s["pb"]), 0)
    assert int(pstate["step"]) == 10
    assert_params_close(pstate["params"], jfull["params"])
    back = params_to_numpy(pstate["opt"])
    for a, b in zip(tree.leaves(back), jax.tree.leaves(jfull["opt"])):
        np.testing.assert_allclose(a, np.asarray(b), **PARAM_TOL)
