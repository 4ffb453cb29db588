"""The port's sparse-row training path held against the JAX reference and
against the port's own dense path, as ``tests/test_embeddings.py``'s
``TestSparseRows``, ``TestSparseRowwiseAdagrad``, ``TestSparseGradAccum``
and ``TestSparseTrajectoryParity`` hold the reference:

  * ``make_sparse_value_and_grad`` against the reference's on the same
    params: loss to rtol 1e-6, densified grads to atol 1e-5; a declared
    table under ``SPARSE_MIN_VOCAB`` rows keeps a dense gradient, and no
    ``(V, D)`` gradient is made for the others;
  * the sparse row-wise Adagrad: bit for bit the port's dense apply
    (hypothesis, as the reference's test), duplicates merged before the
    row square, ``make_mixed`` routing ``SparseRows`` whole; against the
    reference's sparse apply at ``test_optimizers_match_reference``'s
    tolerance; the in-place form (``ok`` given) bit for bit the functional
    form, and a non-finite step leaving the rows as they were;
  * two microbatches, sparse against dense (ulp-level, module constant
    ``ULP_TOL``: the reference's own case is red by 1 ulp);
  * 50-step trajectories of lsr ``userarch_hstu``, lsr ``userarch`` and the
    reference's small dlrm: sparse against dense within the port (losses
    to rtol 1e-5); the port's sparse run against the reference's, every
    step's loss on the same params and the free-running losses over the
    first ``FREE_STEPS`` (the runs are chaotic past them);
  * the Trainer with ``value_and_grad_fn``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import joiner as jax_joiner
from repro.core.hstu import HSTUConfig as JaxHSTUConfig
from repro.data import batcher as jax_batcher
from repro.data import events as jax_events
from repro.embeddings import collection as jax_ec
from repro.embeddings import sparse as jax_sp
from repro.models import dlrm as jax_dlrm
from repro.models import lsr as jax_lsr
from repro.train import loop as jax_loop
from repro.train import optim as jax_optim
from repro_torch import tree
from repro_torch.core import joiner
from repro_torch.core.hstu import HSTUConfig
from repro_torch.data import batcher, events
from repro_torch.embeddings import collection as ec
from repro_torch.embeddings import sparse as sp
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import dlrm, lsr
from repro_torch.train import loop, metrics, optim

N_TRAJECTORY_STEPS = 50
# free-running port and reference runs part after ~20 steps: row-wise
# Adagrad's small accumulators amplify 1-ulp differences (lsr
# userarch_hstu's dense runs of the two packages: 1e-7 apart through step
# 20, 6e-5 at 21, 2e-2 at 50), so past these steps each step's loss is held
# on the same params instead
FREE_STEPS = 20
LOSS_TOL = dict(atol=1e-7, rtol=1e-5)
# two microbatches, sparse vs dense: the same sums in another order (a
# concatenation merged, not a running fp32 sum), so a few ulp of the
# parameters (~0.1 x 2**-23 each)
ULP_TOL = dict(atol=4e-8, rtol=1e-6)


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def dense_of(g):
    """A grads leaf of either package as a dense numpy array."""
    sparse = sp.is_sparse(g) or jax_sp.is_sparse(g)
    return np_(g.to_dense()) if sparse else np_(g)


def mixed(lib):
    return lib.make_mixed(lib.adam(1e-3), lib.rowwise_adagrad(0.05),
                          lib.default_is_embedding)


# ---------------------------------------------------------------------------
# make_sparse_value_and_grad
# ---------------------------------------------------------------------------

def bag_problem(seed=3):
    """The reference test's problem: a mean bag over a 64-row table, a
    linear head, plus a 20-row table (under SPARSE_MIN_VOCAB) declared
    too."""
    rng = np.random.default_rng(seed)
    params = {"emb": (rng.normal(size=(64, 8))).astype(np.float32),
              "small_emb": rng.normal(size=(20, 8)).astype(np.float32),
              "w": rng.normal(size=(8,)).astype(np.float32)}
    ids = rng.integers(0, 64, size=(12, 4)).astype(np.int32)
    batch = {"ids": ids, "lens": np.full((12,), 4, np.int32),
             "small": rng.integers(0, 20, size=(12,)).astype(np.int32)}
    return params, batch


def port_bag_loss(p, b, gen):
    e = ec.bag_lookup_dense(p["emb"], b["ids"], b["lens"], "mean")
    e = e + ec.row_lookup(p["small_emb"], b["small"])
    return torch.sum((e @ p["w"]) ** 2)


def jax_bag_loss(p, b, r):
    e = jax_ec.bag_lookup_dense(p["emb"], b["ids"], b["lens"], "mean")
    e = e + jax_ec.row_lookup(p["small_emb"], b["small"])
    return jnp.sum((e @ p["w"]) ** 2)


def bag_ids(b):
    return {"emb": b["ids"], "small_emb": b["small"]}


def test_value_and_grad_matches_reference():
    params, batch = bag_problem()
    pp = params_from_numpy(params, "cpu")
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = sp.make_sparse_value_and_grad(port_bag_loss, bag_ids)(
        pp, pb, None)
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jax_sp.make_sparse_value_and_grad(jax_bag_loss,
                                                      bag_ids)(jp, jb, None)
    dloss, dgrads = loop.value_and_grad(port_bag_loss)(pp, pb, None)
    assert isinstance(grads["emb"], sp.SparseRows) and grads["emb"].unique
    assert grads["emb"].rows.shape == (48, 8)          # one row per id
    assert not sp.is_sparse(grads["small_emb"])        # under 64 rows
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(dloss), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(dense_of(grads[k]), dense_of(jgrads[k]),
                                   atol=1e-5)
        np.testing.assert_allclose(dense_of(grads[k]), np_(dgrads[k]),
                                   atol=1e-5)
    np.testing.assert_array_equal(np_(grads["emb"].ids),
                                  np_(jgrads["emb"].ids))


def test_value_and_grad_never_makes_a_table_gradient(monkeypatch):
    """The declared table is not among the tensors autograd differentiates
    (the reference strips it from the tree): nothing of its (V, D) shape
    comes back, and the loss sees a GatheredTable in its place."""
    params, batch = bag_problem()
    pp = params_from_numpy(params, "cpu")
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    asked = []
    grad = torch.autograd.grad

    def spy(outputs, inputs, **kw):
        asked.extend(tuple(x.shape) for x in inputs)
        return grad(outputs, inputs, **kw)

    seen = {}

    def loss(p, b, gen):
        seen["emb"] = type(p["emb"])
        return port_bag_loss(p, b, gen)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    _, grads = sp.make_sparse_value_and_grad(loss, bag_ids)(pp, pb, None)
    assert seen["emb"] is sp.GatheredTable
    assert (64, 8) not in asked and (48, 8) in asked
    assert all(not isinstance(g, torch.Tensor) or g.shape != (64, 8)
               for g in tree.leaves(grads, is_leaf=sp.is_sparse))


# ---------------------------------------------------------------------------
# the sparse row-wise Adagrad
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(st.integers(1, 30), st.data())
def test_sparse_adagrad_bit_for_bit_dense(n_touched, data):
    v, d = 50, 6
    rng = np.random.RandomState(data.draw(st.integers(0, 2 ** 16)))
    p = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32))
    touched = rng.choice(v, size=min(n_touched, v), replace=False)
    g_dense = np.zeros((v, d), np.float32)
    g_dense[touched] = rng.normal(size=(len(touched), d))
    g_sparse = sp.SparseRows(torch.from_numpy(touched.astype(np.int32)),
                             torch.from_numpy(g_dense[touched]), vocab=v)
    opt = optim.rowwise_adagrad(0.05)
    st_d = st_s = opt.init([p])
    p_d, p_s = [p], [p]
    for _ in range(2):      # two chained steps: the accumulator path too
        p_d, st_d = opt.update([torch.from_numpy(g_dense)], st_d, p_d)
        p_s, st_s = opt.update([g_sparse], st_s, p_s)
    assert torch.equal(p_d[0], p_s[0])
    assert torch.equal(st_d["acc"][0], st_s["acc"][0])


def test_duplicate_ids_merge_before_row_square():
    v, d = 8, 2
    p = torch.ones((v, d))
    half = torch.full((1, d), 0.5)
    g_dup = sp.SparseRows(torch.tensor([3, 3], dtype=torch.int32),
                          torch.cat([half, half]), vocab=v)
    g_dense = torch.zeros((v, d))
    g_dense[3] = 1.0
    opt = optim.rowwise_adagrad(0.1)
    p_a, st_a = opt.update([g_dup], opt.init([p]), [p])
    p_b, st_b = opt.update([g_dense], opt.init([p]), [p])
    assert torch.equal(p_a[0], p_b[0])
    assert torch.equal(st_a["acc"][0], st_b["acc"][0])


def test_mixed_routes_sparse_rows_to_the_embedding_optimizer():
    params = {"item_emb": torch.ones((16, 4)), "w": torch.ones((4, 4))}
    grads = {"item_emb": sp.SparseRows(torch.tensor([1, 2],
                                                    dtype=torch.int32),
                                       torch.ones((2, 4)), vocab=16),
             "w": torch.ones((4, 4)) * 0.1}
    opt = mixed(optim)
    new_p, new_s = opt.update(grads, opt.init(params), params)
    moved = new_p["item_emb"] != params["item_emb"]
    assert moved[1].all() and moved[2].all() and not moved[0].any()
    assert not moved[3:].any()
    assert (new_p["w"] != params["w"]).all()
    assert new_s["emb"]["acc"][0].shape == (16,)


def test_sparse_adagrad_matches_reference():
    """Three updates from the reference's state on the same COO gradients
    (duplicates and padding), at test_optimizers_match_reference's
    tolerance."""
    rng = np.random.default_rng(13)
    p0 = rng.normal(size=(30, 4)).astype(np.float32)
    pp, jp = [torch.from_numpy(p0)], [jnp.asarray(p0)]
    popt, jopt = optim.rowwise_adagrad(0.1), jax_optim.rowwise_adagrad(0.1)
    ps, js = popt.init(pp), jopt.init(jp)
    for _ in range(3):
        ids = rng.integers(0, 31, size=25).astype(np.int32)
        rows = rng.normal(size=(25, 4)).astype(np.float32)
        pp, ps = popt.update([sp.SparseRows(torch.from_numpy(ids),
                                            torch.from_numpy(rows), 30)],
                             ps, pp)
        jp, js = jopt.update([jax_sp.SparseRows(jnp.asarray(ids),
                                                jnp.asarray(rows), 30)],
                             js, jp)
    np.testing.assert_allclose(np_(pp[0]), np_(jp[0]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(np_(ps["acc"][0]), np_(js["acc"][0]),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("finite", [True, False])
@pytest.mark.parametrize("case", ["touched", "padding only", "unmerged"])
def test_in_place_apply_is_the_functional_form(finite, case):
    """``update(..., ok=ok)`` writes the touched rows into the table and
    the accumulator in place, bit for bit the functional form followed by
    the guard's ``torch.where``; with ``ok`` false nothing moves."""
    rng = np.random.default_rng(14)
    v = 40
    ids = {"touched": np.r_[np.sort(rng.choice(v, 9, replace=False)),
                            [v, v]],
           "padding only": np.full(4, v),
           "unmerged": rng.integers(0, v + 1, size=30)}[case]
    unique = case != "unmerged"
    g = sp.SparseRows(torch.from_numpy(ids.astype(np.int32)),
                      torch.from_numpy(rng.normal(size=(len(ids), 3))
                                       .astype(np.float32)), v, unique)
    p0 = torch.from_numpy(rng.normal(size=(v, 3)).astype(np.float32))
    a0 = torch.from_numpy(rng.uniform(size=(v,)).astype(np.float32))
    opt = optim.rowwise_adagrad(0.05)
    ok = torch.tensor(finite)
    f_p, f_s = opt.update([g], {"acc": [a0]}, [p0])
    want_p = torch.where(ok, f_p[0], p0)
    want_a = torch.where(ok, f_s["acc"][0], a0)
    p, a = p0.clone(), a0.clone()
    new_p, new_s = opt.update([g], {"acc": [a]}, [p], ok=ok)
    assert new_p[0] is p and new_s["acc"][0] is a
    assert torch.equal(p, want_p) and torch.equal(a, want_a)
    if not finite or case == "padding only":
        assert torch.equal(p, p0) and torch.equal(a, a0)


# ---------------------------------------------------------------------------
# the train step: microbatches, the guard, the Trainer
# ---------------------------------------------------------------------------

def run_steps(params, batches, vag=None, microbatches=1, n_steps=8,
              loss=port_bag_loss):
    step = loop.make_train_step(loss, mixed(optim), microbatches,
                                value_and_grad_fn=vag)
    params = tree.tree_map(torch.clone, params)
    state = {"params": params, "opt": mixed(optim).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    out = []
    for i in range(n_steps):
        state, m = step(state, batches[i % len(batches)], 7, i)
        out.append(m)
    return out, state


def test_two_microbatches_sparse_match_dense():
    """SparseRows concatenated across microbatches (then merged by the
    optimizer) against dense gradients summed in fp32: the reference's
    TestSparseGradAccum case, at ULP_TOL."""
    params, _ = bag_problem(3)
    pp = params_from_numpy(params, "cpu")
    pp["emb"] = pp["emb"] * 0.1
    rng = np.random.default_rng(5)
    mb = {"ids": torch.from_numpy(rng.integers(0, 64, size=(2, 12, 4))
                                  .astype(np.int32)),
          "lens": torch.full((2, 12), 4, dtype=torch.int32),
          "small": torch.from_numpy(rng.integers(0, 20, size=(2, 12))
                                    .astype(np.int32))}
    vag = sp.make_sparse_value_and_grad(port_bag_loss, bag_ids)
    dense, state_d = run_steps(pp, [mb], None, 2)
    sparse, state_s = run_steps(pp, [mb], vag, 2)
    np.testing.assert_allclose([float(m["loss"]) for m in sparse],
                               [float(m["loss"]) for m in dense], rtol=1e-6)
    for k in ("emb", "small_emb", "w"):
        np.testing.assert_allclose(np_(state_s["params"][k]),
                                   np_(state_d["params"][k]), **ULP_TOL)
    np.testing.assert_allclose(np_(state_s["opt"]["emb"]["acc"][0]),
                               np_(state_d["opt"]["emb"]["acc"][0]),
                               rtol=1e-6)


def test_step_guard_keeps_rows_on_a_non_finite_step():
    """A NaN loss on the sparse path: the in-place rows stay as they were,
    the skip shows in the metrics, and the updated tables are the state's
    own tensors (no copy)."""
    params, batch = bag_problem(4)
    pp = params_from_numpy(params, "cpu")
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def nan_loss(p, b, gen):
        return port_bag_loss(p, b, gen) * float("nan")

    step = loop.make_train_step(
        nan_loss, mixed(optim),
        value_and_grad_fn=sp.make_sparse_value_and_grad(nan_loss, bag_ids))
    state = {"params": tree.tree_map(torch.clone, pp),
             "opt": mixed(optim).init(pp),
             "step": torch.zeros((), dtype=torch.int32)}
    table = state["params"]["emb"]
    new, m = step(state, pb, 0, 0)
    assert int(m["skipped"]) == 1
    assert new["params"]["emb"] is table
    for k in pp:
        assert torch.equal(new["params"][k], pp[k])
    assert not new["opt"]["emb"]["acc"][0].any()


def test_trainer_takes_value_and_grad_fn():
    params, batch = bag_problem(5)
    pp = params_from_numpy(params, "cpu")
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    vag = sp.make_sparse_value_and_grad(port_bag_loss, bag_ids)

    def run(fn):
        t = loop.Trainer(port_bag_loss, mixed(optim),
                         loop.TrainLoopConfig(total_steps=6, log_every=1),
                         lambda: tree.tree_map(torch.clone, pp),
                         value_and_grad_fn=fn, device="cpu")
        return t, t.run(lambda start: itertools.repeat(pb), 0)

    ts, state_s = run(vag)
    td, state_d = run(None)
    assert [r["step"] for r in ts.history] == list(range(1, 7))
    np.testing.assert_allclose([r["loss"] for r in ts.history],
                               [r["loss"] for r in td.history], rtol=1e-6)
    np.testing.assert_allclose([r["grad_norm"] for r in ts.history],
                               [r["grad_norm"] for r in td.history],
                               rtol=1e-5)
    np.testing.assert_allclose(np_(state_s["params"]["emb"]),
                               np_(state_d["params"]["emb"]), atol=1e-6)


# ---------------------------------------------------------------------------
# 50-step trajectories
# ---------------------------------------------------------------------------

STREAM = dict(n_requests=60, n_items=512, hist_init_max=12, seed=0)
BATCH = dict(b_ro=8, b_nro=32, hist_len=16, ro_idlist_capacity=256,
             item_idlist_capacity=512)


def lsr_cfgs(mode):
    kw = dict(n_items=512, n_user_cats=64, n_item_cats=64, embed_dim=32,
              hist_len=16, mode=mode, lce_n_out=4, lce_d_out=32,
              n_cross_layers=2, top_mlp=(64,))
    hk = dict(d_model=32, n_heads=2, d_qk=16, d_v=16, n_layers=1,
              max_rel_pos=16)
    return (lsr.LSRConfig(hstu=HSTUConfig(**hk), **kw),
            jax_lsr.LSRConfig(hstu=JaxHSTUConfig(attn_backend="jnp-dense",
                                                 **hk), **kw))


@pytest.fixture(scope="module")
def lsr_batches():
    ps = joiner.RequestLevelJoiner().join(list(events.EventSimulator(
        events.EventStreamConfig(**STREAM)).stream()))
    js = jax_joiner.RequestLevelJoiner().join(list(jax_events.EventSimulator(
        jax_events.EventStreamConfig(**STREAM)).stream()))
    pb = list(batcher.ROOBatcher(batcher.BatcherConfig(**BATCH),
                                 device="cpu").batches(ps))
    jb = list(jax_batcher.ROOBatcher(jax_batcher.BatcherConfig(
        **BATCH)).batches(js))
    assert len(pb) == len(jb) >= 3
    return pb, jb


def jax_trajectory(loss, params, batches, vag):
    step = jax_loop.make_train_step(loss, mixed(jax_optim),
                                    value_and_grad_fn=vag)
    state = {"params": params, "opt": mixed(jax_optim).init(params),
             "step": jnp.zeros((), jnp.int32)}
    rng = jax.random.PRNGKey(7)
    losses = []
    for i in range(N_TRAJECTORY_STEPS):
        state, m = step(state, batches[i % len(batches)],
                        jax.random.fold_in(rng, i))
        losses.append(float(m["loss"]))
    return np.asarray(losses), state


def port_trajectory(loss, params, batches, vag, shadow=None):
    """The port's run; with ``shadow``, also the reference's sparse loss on
    the params and batch of every step (the port's params carried across
    as numpy)."""
    seen = []

    def recording(p, b, gen):
        # copies: the sparse step updates the tables in place
        seen.append(jax.tree.map(lambda x: jnp.asarray(x.copy()),
                                 params_to_numpy(p)))
        return vag(p, b, gen)

    ms, state = run_steps(params, batches, recording if shadow else vag, 1,
                          N_TRAJECTORY_STEPS, loss)
    losses = np.asarray([float(m["loss"]) for m in ms])
    if shadow is None:
        return losses, state
    jvag, jbatches = shadow
    jvag = jax.jit(jvag)
    ref = np.asarray([float(jvag(p, jbatches[i % len(jbatches)], None)[0])
                      for i, p in enumerate(seen)])
    return losses, state, ref


def check_trajectories(loss, pp, pb, vag, jax_sparse, jvag, jb, table):
    """Within the port, sparse vs dense: losses at LOSS_TOL and the
    ``table(params)`` table at the end. Against the reference: every
    step's sparse loss on the same params (the reference's sparse
    value_and_grad on the port's params and batch), and the free-running
    sparse runs over their first FREE_STEPS steps."""
    d_losses, d_state = port_trajectory(loss, pp, pb, None)
    s_losses, s_state, ref = port_trajectory(loss, pp, pb, vag, (jvag, jb))
    np.testing.assert_allclose(s_losses, d_losses, **LOSS_TOL)
    np.testing.assert_allclose(np_(table(s_state["params"])),
                               np_(table(d_state["params"])),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(s_losses, ref, **LOSS_TOL)
    np.testing.assert_allclose(s_losses[:FREE_STEPS],
                               jax_sparse[0][:FREE_STEPS], **LOSS_TOL)


@pytest.mark.parametrize("mode", ["userarch_hstu", "userarch"])
def test_lsr_50_steps(lsr_batches, mode):
    cfg, jcfg = lsr_cfgs(mode)
    pb, jb = lsr_batches
    jp = jax_lsr.lsr_init(jax.random.PRNGKey(0), jcfg)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    loss = lambda p, b, gen: lsr.lsr_loss(p, cfg, b)       # noqa: E731
    jloss = lambda p, b, r: jax_lsr.lsr_loss(p, jcfg, b)   # noqa: E731
    vag = sp.make_sparse_value_and_grad(
        loss, lambda b: lsr.lsr_table_ids(cfg, b))
    jvag = jax_sp.make_sparse_value_and_grad(
        jloss, lambda b: jax_lsr.lsr_table_ids(jcfg, b))
    _, grads = vag(pp, pb[0], None)
    assert sp.is_sparse(grads["item_emb"])
    assert sp.is_sparse(grads["user_cat_emb"])       # 64 rows
    assert not sp.is_sparse(grads["act_emb"])        # 4 rows
    check_trajectories(loss, pp, pb, vag,
                       jax_trajectory(jloss, jp, jb, jvag), jvag, jb,
                       lambda p: p["item_emb"])


def dlrm_case():
    kw = dict(n_dense=4, embed_dim=16, bot_mlp=(4, 32, 16),
              top_mlp=(64, 32, 1), vocabs=(512, 256, 64, 32),
              n_ro_fields=2, multi_hot=2)
    r = np.random.RandomState(0)
    b_ro, b_nro = 8, 32
    batches = []
    for _ in range(4):
        batches.append({
            "ro_dense": r.normal(size=(b_ro, 4)).astype(np.float32),
            "ro_ids": r.randint(0, 512, (b_ro, 2, 2)).astype(np.int32),
            "ro_len": np.full((b_ro, 2), 2, np.int32),
            "nro_ids": r.randint(0, 32, (b_nro, 2, 2)).astype(np.int32),
            "nro_len": np.full((b_nro, 2), 2, np.int32),
            "seg": np.repeat(np.arange(b_ro, dtype=np.int32), b_nro // b_ro),
            "y": (r.uniform(size=(b_nro,)) < 0.3).astype(np.float32)})
    return kw, batches


def test_dlrm_50_steps():
    kw, batches = dlrm_case()
    cfg, jcfg = dlrm.DLRMConfig(**kw), jax_dlrm.DLRMConfig(**kw)
    jp = jax_dlrm.dlrm_init(jax.random.PRNGKey(0), jcfg)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    args = ("ro_dense", "ro_ids", "ro_len", "nro_ids", "nro_len", "seg")

    def loss(p, b, gen):
        return metrics.bce(dlrm.dlrm_forward_roo(
            p, cfg, *(b[k] for k in args)), b["y"])

    def jloss(p, b, r):
        logits = jax_dlrm.dlrm_forward_roo(p, jcfg, *(b[k] for k in args))
        y = b["y"]
        return jnp.mean(jnp.maximum(logits, 0) - logits * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))

    vag = sp.make_sparse_value_and_grad(
        loss, lambda b: dlrm.dlrm_table_ids(cfg, b["ro_ids"], b["nro_ids"]))
    jvag = jax_sp.make_sparse_value_and_grad(
        jloss, lambda b: jax_dlrm.dlrm_table_ids(jcfg, b["ro_ids"],
                                                 b["nro_ids"]))
    _, grads = vag(pp, pb[0], None)
    assert [sp.is_sparse(grads["tables"][f"t{i}"]) for i in range(4)] == [
        True, True, True, False]                 # vocabs 512, 256, 64, 32
    check_trajectories(loss, pp, pb, vag,
                       jax_trajectory(jloss, jp, jb, jvag), jvag, jb,
                       lambda p: p["tables"]["t0"])
