"""The port's two-tower slice (roo-retrieval and roo-esr) held against the
JAX reference.

At ``tests/conftest.py``'s ``roo_batch`` sizes (16 requests / 128
impression slots, hist 64; the stream's 5,000 items) with the reference's
``two_tower_init`` params carried across (``interop``), in both user-tower
modes (``"hstu"``: B1-B3 on the card; ``"mlp"``: the mean bag, B5/B6):

  * the configs and the init tree;
  * the towers, ESR logits and the retrieval scores (the reference
    scenario's ``_fanout_scores``) to 1e-5; ``two_tower_table_ids``;
  * the retrieval and ESR losses to rtol 1e-5 and their gradients per
    leaf to 1e-4, the mlp tower's bag on its plain path and through
    ``GroupedEmbeddingBagFn`` (CUDA forward swapped for the plain one);
  * a 20-step dense Trainer against the reference's at log_every 1
    (losses to rtol 1e-5);
  * sparse rows: each step's loss of the port's sparse run against the
    reference's sparse value_and_grad on the same params (LOSS_TOL of
    ``test_torch_sparse_train.py``), and sparse against dense in the port;
  * the ESR ``ROOServer`` and user-tower-cache server, and a retrieval
    server on ``retrieval_scores_from_user``, scores to 1e-4.

The reference's attention runs on jnp-dense, the port's on torch-chunked
(CPU auto).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import roo_models as jax_rm
from repro.core import joiner as jax_joiner
from repro.data import batcher as jax_batcher
from repro.data import events as jax_events
from repro.embeddings import sparse as jax_sp
from repro.kernels import dispatch as jax_dispatch
from repro.models import two_tower as jax_tt
from repro.serve import serving as jax_serving
from repro.train import loop as jax_loop
from repro.train import optim as jax_optim
from repro_torch import tree
from repro_torch.configs import roo_models as rm
from repro_torch.core import joiner
from repro_torch.data import batcher, events
from repro_torch.embeddings import collection as ec
from repro_torch.embeddings import sparse as sp
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import embedding_bag as eb
from repro_torch.models import two_tower as tt
from repro_torch.serve import serving
from repro_torch.serve.engine import ScoreError
from repro_torch.train import loop, optim

LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
SPARSE_LOSS_TOL = dict(atol=1e-7, rtol=1e-5)
SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
STREAM = dict(n_requests=120, hist_init_max=40, seed=0)
BATCH = dict(b_ro=16, b_nro=128, hist_len=64)
N_ITEMS = 5000
CASES = [("esr", True), ("esr", False), ("retrieval", True),
         ("retrieval", False)]
IDS = ["esr-hstu", "esr-mlp", "retrieval-hstu", "retrieval-mlp"]


def cfgs(kind, hstu):
    make, jmake = {"esr": (rm.esr_config, jax_rm.esr_config),
                   "retrieval": (rm.retrieval_config,
                                 jax_rm.retrieval_config)}[kind]
    return (dataclasses.replace(make(hstu), n_items=N_ITEMS),
            dataclasses.replace(jmake(hstu, "jnp-dense"), n_items=N_ITEMS))


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def data():
    ps = joiner.RequestLevelJoiner().join(list(events.EventSimulator(
        events.EventStreamConfig(**STREAM)).stream()))
    js = jax_joiner.RequestLevelJoiner().join(list(jax_events.EventSimulator(
        jax_events.EventStreamConfig(**STREAM)).stream()))
    pb = list(batcher.ROOBatcher(batcher.BatcherConfig(**BATCH),
                                 device="cpu").batches(ps))
    jb = list(jax_batcher.ROOBatcher(jax_batcher.BatcherConfig(
        **BATCH)).batches(js))
    assert len(pb) == len(jb) >= 3
    np.testing.assert_array_equal(np_(pb[0].history_ids),
                                  np_(jb[0].history_ids))
    return dict(ps=ps, js=js, pb=pb, jb=jb)


@pytest.fixture(scope="module")
def params():
    """Reference params per (kind, hstu), and the same values in the
    port."""
    out = {}
    for i, (kind, hstu) in enumerate(CASES):
        jp = jax_tt.two_tower_init(jax.random.PRNGKey(i), cfgs(kind, hstu)[1])
        out[kind, hstu] = (params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu"), jp)
    return out


def jax_fanout_scores(jp, jcfg, b, u):
    """The reference scenario's retrieval scorer (``_fanout_scores``)."""
    v = jax_tt.item_tower(jp, jcfg, b.item_ids, b.nro_dense)
    seg = jnp.minimum(b.segment_ids, b.b_ro - 1)
    return jnp.sum(u[seg] * v, axis=-1)


def losses(kind):
    return ((tt.esr_loss_roo, jax_tt.esr_loss_roo) if kind == "esr"
            else (tt.retrieval_loss_roo, jax_tt.retrieval_loss_roo))


@pytest.mark.parametrize("kind,hstu", CASES, ids=IDS)
def test_init_layout_and_config_match_reference(kind, hstu):
    cfg, jcfg = cfgs(kind, hstu)
    jp = jax_tt.two_tower_init(jax.random.PRNGKey(0), jcfg)
    pp = tt.two_tower_init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    paths = [(p, tuple(x.shape)) for p, x in tree.flatten_with_path(pp)]
    jpaths = [(tuple(str(k) for k in p), tuple(x.shape))
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert paths == jpaths
    make, jmake = ((rm.esr_config, jax_rm.esr_config) if kind == "esr"
                   else (rm.retrieval_config, jax_rm.retrieval_config))
    assert dataclasses.asdict(make(hstu)) == dataclasses.asdict(jmake(hstu))


@pytest.mark.parametrize("hstu", [True, False], ids=["hstu", "mlp"])
def test_towers_and_logits_match_reference(data, params, hstu):
    cfg, jcfg = cfgs("esr", hstu)
    pp, jp = params["esr", hstu]
    pb, jb = data["pb"][0], data["jb"][0]
    u = tt.user_tower(pp, cfg, pb)
    ju = jax_tt.user_tower(jp, jcfg, jb)
    assert u.shape == (pb.b_ro, cfg.user_mlp[-1])
    np.testing.assert_allclose(np_(u), np_(ju), **LOGIT_TOL)
    np.testing.assert_allclose(
        np_(tt.item_tower(pp, cfg, pb.item_ids, pb.nro_dense)),
        np_(jax_tt.item_tower(jp, jcfg, jb.item_ids, jb.nro_dense)),
        **LOGIT_TOL)
    logits = tt.esr_logits_roo(pp, cfg, pb)
    np.testing.assert_allclose(np_(logits),
                               np_(jax_tt.esr_logits_roo(jp, jcfg, jb)),
                               **LOGIT_TOL)
    np.testing.assert_array_equal(
        np_(tt.esr_logits_from_user(pp, cfg, pb, u)), np_(logits))
    np.testing.assert_allclose(
        np_(tt.retrieval_scores_from_user(pp, cfg, pb, u)),
        np_(jax_fanout_scores(jp, jcfg, jb, ju)), **LOGIT_TOL)
    got, want = tt.two_tower_table_ids(cfg, pb), \
        jax_tt.two_tower_table_ids(jcfg, jb)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np_(got[k]), np_(want[k]))


def through_function(monkeypatch):
    """Route the port's padded bags through ``GroupedEmbeddingBagFn`` at
    one field on CPU tensors, as ``embedding_bag`` runs it on a CUDA table
    (its CUDA forward swapped for the plain version)."""
    monkeypatch.setattr(eb, "embedding_bag_grouped_fwd_cuda",
                        lambda ts, i, n, p: eb.embedding_bag_grouped_plain(
                            ts, i, n, p))
    monkeypatch.setattr(ec, "embedding_bag",
                        lambda t, i, n, p, backend=None:
                            eb.GroupedEmbeddingBagFn.apply(
                                i[:, None], n[:, None], p, t).squeeze(1))


@pytest.mark.parametrize("kind,hstu,path", [
    ("esr", True, "plain"), ("esr", False, "plain"),
    ("esr", False, "function"), ("retrieval", True, "plain"),
    ("retrieval", False, "function")])
def test_loss_grads_match_reference(data, params, monkeypatch, kind, hstu,
                                    path):
    cfg, jcfg = cfgs(kind, hstu)
    pp, jp = params[kind, hstu]
    fn, jfn = losses(kind)
    if path == "function":
        through_function(monkeypatch)
    loss, grads = loop.value_and_grad(lambda p, b, g: fn(p, cfg, b))(
        pp, data["pb"][1], None)
    with jax_dispatch.use_emb_backend("jnp"):
        jloss, jgrads = jax.value_and_grad(
            lambda p: jfn(p, jcfg, data["jb"][1]))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(tree.leaves(grads))
    for (p, a), b in zip(tree.flatten_with_path(grads), jl):
        np.testing.assert_allclose(np_(a), np_(b), **GRAD_TOL,
                                   err_msg=str(p))
    assert float(np.abs(np_(grads["item_emb"])).sum()) > 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def cycling(batches):
    return lambda start: (batches[i % len(batches)]
                          for i in itertools.count(start))


def mixed(lib):
    return lib.make_mixed(lib.adam(1e-3), lib.rowwise_adagrad(0.05),
                          lib.default_is_embedding)


@pytest.mark.parametrize("kind,hstu", [("esr", True), ("retrieval", False)],
                         ids=["esr-hstu", "retrieval-mlp"])
def test_trainer_20_steps_match_reference(data, params, kind, hstu):
    cfg, jcfg = cfgs(kind, hstu)
    pp, jp = params[kind, hstu]
    fn, jfn = losses(kind)
    jt = jax_loop.Trainer(lambda p, b, r: jfn(p, jcfg, b), mixed(jax_optim),
                          jax_loop.TrainLoopConfig(total_steps=20,
                                                   log_every=1),
                          lambda: jp)
    jt.run(cycling(data["jb"]), jax.random.PRNGKey(0))
    pt = loop.Trainer(lambda p, b, g: fn(p, cfg, b), mixed(optim),
                      loop.TrainLoopConfig(total_steps=20, log_every=1),
                      lambda: pp, device="cpu")
    pt.run(cycling(data["pb"]), 0)
    assert [r["step"] for r in pt.history] == list(range(1, 21))
    for a, b in zip(pt.history, jt.history):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], **LOSS_TOL,
                                       err_msg=f"{key} at step {a['step']}")
        assert a["skipped"] == b["skipped"] == 0


def sparse_run(loss, vag, params, batches, n_steps):
    """The port's sparse run; the params each step saw (copies: the
    sparse step writes rows in place) and its losses."""
    step = loop.make_train_step(loss, mixed(optim), value_and_grad_fn=vag)
    p = tree.tree_map(torch.clone, params)
    state = {"params": p, "opt": mixed(optim).init(p),
             "step": torch.zeros((), dtype=torch.int32)}
    seen, out = [], []
    for i in range(n_steps):
        seen.append(jax.tree.map(np.copy, params_to_numpy(state["params"])))
        state, m = step(state, batches[i % len(batches)], 7, i)
        out.append(float(m["loss"]))
    return np.asarray(out), seen, state


def check_sparse(loss, jloss, table_ids, jtable_ids, pp, data, n_steps):
    """Each step's loss of the port's sparse run against the reference's
    sparse value_and_grad on the params and batch that step saw, and the
    sparse run against the port's dense run (losses)."""
    vag = sp.make_sparse_value_and_grad(loss, table_ids)
    jvag = jax.jit(jax_sp.make_sparse_value_and_grad(jloss, jtable_ids))
    _, grads = vag(pp, data["pb"][0], None)
    assert sp.is_sparse(grads["item_emb"])
    s_losses, seen, _ = sparse_run(loss, vag, pp, data["pb"], n_steps)
    d_losses, _, _ = sparse_run(loss, None, pp, data["pb"], n_steps)
    jb = data["jb"]
    ref = np.asarray([float(jvag(jax.tree.map(jnp.asarray, p),
                                 jb[i % len(jb)], None)[0])
                      for i, p in enumerate(seen)])
    np.testing.assert_allclose(s_losses, ref, **SPARSE_LOSS_TOL)
    np.testing.assert_allclose(s_losses, d_losses, **SPARSE_LOSS_TOL)
    return grads


@pytest.mark.parametrize("kind,hstu", [("esr", True), ("retrieval", False),
                                       ("esr", False)],
                         ids=["esr-hstu", "retrieval-mlp", "esr-mlp"])
def test_sparse_rows_match_reference(data, params, kind, hstu):
    cfg, jcfg = cfgs(kind, hstu)
    fn, jfn = losses(kind)
    grads = check_sparse(
        lambda p, b, g: fn(p, cfg, b), lambda p, b, r: jfn(p, jcfg, b),
        lambda b: tt.two_tower_table_ids(cfg, b),
        lambda b: jax_tt.two_tower_table_ids(jcfg, b),
        params[kind, hstu][0], data, 12)
    assert sp.is_sparse(grads["user_cat_emb"])       # 200 rows
    if hstu:
        assert not sp.is_sparse(grads["act_emb"])    # 4 rows


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def requests(samples, make):
    """The stream's first 40 requests plus a zero-impression one."""
    base = samples[0]
    zero = make(request_id=10_001, user_id=1, ro_dense=base.ro_dense,
                ro_idlist=[3], history_ids=[5, 6], history_actions=[1, 0],
                item_ids=[], item_dense=[], item_idlist=[], labels=[])
    return [zero] + list(samples[:40])


@pytest.mark.parametrize("hstu", [True, False], ids=["hstu", "mlp"])
def test_esr_servers_match_reference(data, params, hstu):
    cfg, jcfg = cfgs("esr", hstu)
    pp, jp = params["esr", hstu]
    preqs = requests(data["ps"], joiner.ROOSample)
    jreqs = requests(data["js"], jax_joiner.ROOSample)
    kw = dict(b_ro=16, b_nro=128, hist_len=64)
    want = jax_serving.ROOServer(
        jp, lambda p, b: jax_tt.esr_logits_roo(p, jcfg, b),
        jax_serving.ServeConfig(**kw)).score_requests(jreqs)
    plain = serving.ROOServer(
        pp, lambda p, b: tt.esr_logits_roo(p, cfg, b),
        serving.ServeConfig(**kw), device="cpu")
    got = plain.score_requests(preqs)
    cached = serving.ROOServer(
        pp, lambda p, b: tt.esr_logits_roo(p, cfg, b),
        serving.ServeConfig(cache_user_tower=True, **kw),
        user_fn=lambda p, b: tt.user_tower(p, cfg, b),
        score_from_user=lambda p, b, u: tt.esr_logits_from_user(p, cfg, b,
                                                                u),
        device="cpu")
    passes = [cached.score_requests(preqs) for _ in range(2)]
    assert plain.stats.n_failed_batches == cached.stats.n_failed_batches == 0
    st = cached.stats
    assert st.n_full_cache_batches == st.n_batches // 2 > 0
    for i, r in enumerate(preqs):
        assert not isinstance(got[i], ScoreError), got[i]
        assert got[i].shape == np.asarray(want[i]).shape == \
            (r.num_impressions,)
        np.testing.assert_allclose(got[i], np.asarray(want[i]), **SCORE_TOL)
        for p in passes:
            np.testing.assert_allclose(p[i], got[i], **SCORE_TOL)
        np.testing.assert_array_equal(passes[1][i], passes[0][i])


def test_retrieval_server_matches_reference(data, params):
    cfg, jcfg = cfgs("retrieval", True)
    pp, jp = params["retrieval", True]
    preqs = requests(data["ps"], joiner.ROOSample)
    jreqs = requests(data["js"], jax_joiner.ROOSample)
    kw = dict(b_ro=16, b_nro=128, hist_len=64)
    want = jax_serving.ROOServer(
        jp, lambda p, b: jax_fanout_scores(
            p, jcfg, b, jax_tt.user_tower(p, jcfg, b)),
        jax_serving.ServeConfig(**kw)).score_requests(jreqs)
    got = serving.ROOServer(
        pp, lambda p, b: tt.retrieval_scores_from_user(
            p, cfg, b, tt.user_tower(p, cfg, b)),
        serving.ServeConfig(**kw), device="cpu").score_requests(preqs)
    for i, r in enumerate(preqs):
        assert got[i].shape == (r.num_impressions,)
        np.testing.assert_allclose(got[i], np.asarray(want[i]), **SCORE_TOL)
