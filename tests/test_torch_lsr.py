"""The port's roo-lsr slice held against the JAX reference.

A small LSR (as ``tests/test_embeddings.py``'s trajectory test sizes it)
with the reference's ``lsr_init`` params carried across (``interop``), on
the same ``ROOBatcher`` batches of the same simulated stream:

  * the bag lookups (``embeddings/bag.py`` and the collection's jagged and
    padded bags), sum / mean / max, and the forced-dedup route, which
    still goes through the embedding-bag entry point;
  * fanout, LCE, ``expand``, DCNv2 (full and low rank), the
    per-impression sequence encoder;
  * LSR logits in all four modes, ROO and impression-level, to 1e-5, with
    the reference's bag on its Pallas-interpret kernel and on jnp;
  * ``lsr_loss`` gradients per leaf to 1e-4, the port's bag on its plain
    path and through ``GroupedEmbeddingBagFn`` at one field (CUDA forward
    swapped for the plain version);
  * a 20-step ``userarch`` Trainer against the reference's at log_every 1
    (losses to rtol 1e-5);
  * the LSR ``ROOServer`` and the user-tower-cache server, scores to 1e-4.

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
from repro.core import expansion as jax_expansion
from repro.core import joiner as jax_joiner
from repro.core.fanout import fanout as jax_fanout
from repro.core import lce as jax_lce
from repro.core import sequence as jax_sequence
from repro.core.hstu import HSTUConfig as JaxHSTUConfig
from repro.data import batcher as jax_batcher
from repro.data import events as jax_events
from repro.data.jagged import JaggedTensor as JaxJagged
from repro.embeddings import bag as jax_bag
from repro.embeddings import collection as jax_ec
from repro.kernels import dispatch as jax_dispatch
from repro.models import interactions as jax_inter
from repro.models import lsr as jax_lsr
from repro.serve import serving as jax_serving
from repro.train import loop as jax_loop
from repro.train import metrics as jax_metrics
from repro.train import optim as jax_optim
from repro_torch import tree
from repro_torch.configs import roo_models as rm
from repro_torch.core import expansion, fanout, joiner, lce, sequence
from repro_torch.core.hstu import HSTUConfig
from repro_torch.data import batcher, events
from repro_torch.data.jagged import JaggedTensor
from repro_torch.embeddings import bag
from repro_torch.embeddings import collection as ec
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import embedding_bag as eb
from repro_torch.models import interactions, lsr
from repro_torch.serve import serving
from repro_torch.serve.engine import ScoreError
from repro_torch.train import loop, metrics, optim

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
MODES = ["baseline", "userarch", "userarch_hstu", "hstu_ranking"]
STREAM = dict(n_requests=60, n_items=512, hist_init_max=12, seed=0)
BATCH = dict(b_ro=8, b_nro=32, hist_len=16, ro_idlist_capacity=256,
             item_idlist_capacity=512)


def small_cfg(mode, make_cfg=lsr.LSRConfig, make_hstu=HSTUConfig, **kw):
    return make_cfg(n_items=512, n_user_cats=64, n_item_cats=64,
                    embed_dim=32, hist_len=16, mode=mode, lce_n_out=4,
                    lce_d_out=32, n_cross_layers=2, top_mlp=(64,),
                    hstu=make_hstu(d_model=32, n_heads=2, d_qk=16, d_v=16,
                                   n_layers=1, max_rel_pos=16, **kw))


def cfgs(mode):
    return (small_cfg(mode),
            small_cfg(mode, jax_lsr.LSRConfig, JaxHSTUConfig,
                      attn_backend="jnp-dense"))


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
    return dict(ps=ps, js=js, pb=pb, jb=jb)


@pytest.fixture(scope="module")
def params():
    """Reference params per mode, and the same values in the port."""
    out = {}
    for i, mode in enumerate(MODES):
        jp = jax_lsr.lsr_init(jax.random.PRNGKey(i), cfgs(mode)[1])
        out[mode] = (params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                     jp)
    return out


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# bag lookups
# ---------------------------------------------------------------------------

def bag_inputs(seed=0, v=40, d=8):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    lens = np.array([3, 0, 5, 1, 4], np.int32)
    values = np.zeros(20, np.int32)                   # capacity 20, 13 used
    values[:13] = rng.integers(-2, v + 3, size=13)
    ids = rng.integers(-2, v + 3, size=(5, 6)).astype(np.int32)
    return table, values, lens, ids


@pytest.mark.parametrize("pooling", ["sum", "mean", "max"])
@pytest.mark.parametrize("fn", ["bag_pool", "bag_lookup", "bag_lookup_dense",
                                "bag_lookup_dense_dedup"])
def test_bag_functions_match_reference(fn, pooling):
    table, values, lens, ids = bag_inputs()
    t = torch.from_numpy
    pj, jj = JaggedTensor(t(values), t(lens)), JaxJagged(jnp.asarray(values),
                                                         jnp.asarray(lens))
    safe = np.clip(values, 0, table.shape[0] - 1)
    if fn == "bag_pool":
        got = bag.bag_pool(t(table[safe]), pj, pooling)
        want = jax_bag.bag_pool(jnp.asarray(table[safe]), jj, pooling)
    elif fn == "bag_lookup":
        got = ec.bag_lookup(t(table), pj, pooling)
        want = jax_ec.bag_lookup(jnp.asarray(table), jj, pooling)
        np.testing.assert_allclose(
            np_(ec.bag_lookup(t(table), pj, pooling, dedup=True)),
            np_(jax_bag.bag_lookup(jnp.asarray(table), jj, pooling)), **TOL)
    else:
        dedup = fn.endswith("dedup") or None
        got = ec.bag_lookup_dense(t(table), t(ids), t(lens), pooling,
                                  dedup=dedup)
        want = jax_ec.bag_lookup_dense(jnp.asarray(table), jnp.asarray(ids),
                                       jnp.asarray(lens), pooling,
                                       dedup=dedup)
        np.testing.assert_allclose(
            np_(got), np_(jax_bag.bag_lookup_dense(
                jnp.asarray(table), jnp.asarray(ids), jnp.asarray(lens),
                pooling)), **TOL)
    np.testing.assert_allclose(np_(got), np_(want), **TOL)
    assert np.all(np_(got)[lens == 0] == 0)


@pytest.mark.parametrize("pooling", ["sum", "mean", "max"])
def test_bag_pool_edges_match_reference(pooling):
    """No padding past the last bag, lengths past the capacity (the packer
    keeps lengths and cuts values: the last bags are cut short, or lose
    every slot), all bags empty, and an empty batch."""
    table, values, _, _ = bag_inputs(2)
    emb = table[np.clip(values, 0, table.shape[0] - 1)]
    for lens in (np.array([7, 0, 13], np.int32),
                 np.array([9, 0, 8, 6], np.int32),
                 np.array([12, 10, 4], np.int32), np.zeros(4, np.int32),
                 np.zeros(0, np.int32)):
        got = bag.bag_pool(torch.from_numpy(emb), JaggedTensor(
            torch.from_numpy(values), torch.from_numpy(lens)), pooling)
        want = jax_bag.bag_pool(jnp.asarray(emb), JaxJagged(
            jnp.asarray(values), jnp.asarray(lens)), pooling)
        assert got.shape == (len(lens), table.shape[1])
        np.testing.assert_allclose(np_(got), np_(want), **TOL)


def test_bag_lookup_dense_routes(monkeypatch):
    """Every call goes to the embedding-bag entry point (the kernel route
    on a CUDA table), forced dedup included: then with the small table of
    distinct rows and the inverse ids, and the same output and table
    gradient as the direct route."""
    table, _, lens, ids = bag_inputs(1)
    t = torch.from_numpy
    calls = []

    def entry(tab, i, ln, pooling, backend=None):
        calls.append((tuple(tab.shape), int(i.max()), backend))
        return eb.embedding_bag(tab, i, ln, pooling, backend=backend)

    monkeypatch.setattr(ec, "embedding_bag", entry)
    outs = []
    for dedup in (None, True, "policy"):
        tab = t(table).requires_grad_(True)
        if dedup == "policy":
            ec.set_dedup_policy("always")
        try:
            out = ec.bag_lookup_dense(tab, t(ids), t(lens), "mean",
                                      dedup=dedup is True or None,
                                      backend="torch")
        finally:
            ec.set_dedup_policy(None)
        (grad,) = torch.autograd.grad(out.sum(), [tab])
        outs.append((out.detach(), grad))
    n_unique = len(np.unique(np.clip(ids, 0, table.shape[0] - 1)))
    assert calls[0] == (table.shape, int(ids.max()), "torch")   # unclipped
    assert calls[1] == calls[2] == ((n_unique, table.shape[1]), n_unique - 1,
                                    "torch")
    for out, grad in outs[1:]:
        np.testing.assert_allclose(np_(out), np_(outs[0][0]), **TOL)
        np.testing.assert_allclose(np_(grad), np_(outs[0][1]), **TOL)


# ---------------------------------------------------------------------------
# ROO core pieces
# ---------------------------------------------------------------------------

def test_fanout_matches_reference(data):
    pb, jb = data["pb"][0], data["jb"][0]
    x = np.random.default_rng(0).normal(size=(pb.b_ro, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        np_(fanout(torch.from_numpy(x), pb.segment_ids)),
        np_(jax_fanout(jnp.asarray(x), jb.segment_ids)))


def test_expand_matches_reference(data):
    got = expansion.expand(data["pb"][1])
    want = jax_expansion.expand(data["jb"][1])
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(np_(getattr(got, f.name)),
                                      np_(getattr(want, f.name)),
                                      err_msg=f.name)
    assert got.batch_size == want.batch_size


def test_lce_matches_reference():
    cfg, jcfg = lce.LCEConfig(3, 16, 4, 8), jax_lce.LCEConfig(3, 16, 4, 8)
    jp = jax_lce.lce_init(jax.random.PRNGKey(0), jcfg)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).normal(size=(5, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np_(lce.lce_apply(pp, torch.from_numpy(x))),
        np_(jax_lce.lce_apply(jp, jnp.asarray(x))), **TOL)
    port_init = lce.lce_init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    assert {k: tuple(v.shape) for k, v in port_init.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


@pytest.mark.parametrize("rank", [0, 6])
def test_dcnv2_matches_reference(rank):
    jp = jax_inter.dcnv2_init(jax.random.PRNGKey(rank), 24, 3, rank=rank)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(rank).normal(size=(7, 24)).astype(np.float32)
    np.testing.assert_allclose(
        np_(interactions.dcnv2_apply(pp, torch.from_numpy(x))),
        np_(jax_inter.dcnv2_apply(jp, jnp.asarray(x))), **TOL)
    port_init = interactions.dcnv2_init(torch.Generator().manual_seed(0), 24,
                                        3, rank=rank, device="cpu")
    assert [sorted(lyr) for lyr in port_init["layers"]] == \
        [sorted(lyr) for lyr in jp["layers"]]


def test_encode_per_impression_matches_reference(data):
    cfg, jcfg = cfgs("hstu_ranking")
    jseq = jax_sequence.ROOSequenceConfig(jcfg.hstu, 16, 16)
    jp = jax_sequence.roo_sequence_init(jax.random.PRNGKey(0), jseq)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    hist = rng.normal(size=(6, 16, 32)).astype(np.float32)
    tgt = rng.normal(size=(6, 32)).astype(np.float32)
    lens = np.array([0, 16, 5, 9, 1, 12], np.int32)
    got = sequence.encode_per_impression(
        pp, sequence.ROOSequenceConfig(cfg.hstu, 16, 16),
        torch.from_numpy(hist), torch.from_numpy(lens), torch.from_numpy(tgt))
    want = jax_sequence.encode_per_impression(
        jp, jseq, jnp.asarray(hist), jnp.asarray(lens), jnp.asarray(tgt))
    np.testing.assert_allclose(np_(got), np_(want), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_init_layout_and_config_match_reference(mode):
    cfg, jcfg = cfgs(mode)
    jp = jax_lsr.lsr_init(jax.random.PRNGKey(0), jcfg)
    pp = lsr.lsr_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    paths = [(p, tuple(x.shape)) for p, x in tree.flatten_with_path(pp)]
    jpaths = [(tuple(str(k) for k in p), tuple(x.shape))
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert paths == jpaths
    full, jfull = rm.lsr_config(mode), jax_rm.lsr_config(mode)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)


# the reference's bag kernel matters only where the mode reaches it
@pytest.mark.parametrize("mode,emb_backend", [
    ("baseline", "pallas-interpret"), ("baseline", "jnp"),
    ("userarch", "pallas-interpret"), ("userarch", "jnp"),
    ("userarch_hstu", "jnp"), ("hstu_ranking", "jnp")])
@pytest.mark.parametrize("roo", [True, False], ids=["roo", "impression"])
def test_lsr_logits_match_reference(data, params, mode, roo, emb_backend):
    cfg, jcfg = cfgs(mode)
    pp, jp = params[mode]
    fn, jfn = ((lsr.lsr_logits_roo, jax_lsr.lsr_logits_roo) if roo else
               (lsr.lsr_logits_impression, jax_lsr.lsr_logits_impression))
    with jax_dispatch.use_emb_backend(emb_backend):
        want = jfn(jp, jcfg, data["jb"][0])
    got = fn(pp, cfg, data["pb"][0])
    np.testing.assert_allclose(np_(got), np_(want), **LOGIT_TOL)


def test_lsr_split_entry_points_and_table_ids(data, params):
    cfg, jcfg = cfgs("userarch")
    pp, jp = params["userarch"]
    pb, jb = data["pb"][0], data["jb"][0]
    user = lsr.lsr_user_repr(pp, cfg, pb)
    assert user.shape == (pb.b_ro, 4 * 32)
    np.testing.assert_allclose(np_(user),
                               np_(jax_lsr.lsr_user_repr(jp, jcfg, jb)),
                               **LOGIT_TOL)
    np.testing.assert_array_equal(
        np_(lsr.lsr_logits_from_user(pp, cfg, pb, user)),
        np_(lsr.lsr_logits_roo(pp, cfg, pb)))
    got, want = lsr.lsr_table_ids(cfg, pb), jax_lsr.lsr_table_ids(jcfg, jb)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np_(got[k]), np_(want[k]))


def port_vag(mode, roo):
    cfg = cfgs(mode)[0]
    return loop.value_and_grad(lambda p, b, g: lsr.lsr_loss(p, cfg, b,
                                                            roo=roo))


def through_function(monkeypatch):
    """Route the port's padded bags through ``GroupedEmbeddingBagFn`` at
    one field on CPU tensors, as ``embedding_bag`` runs it on a CUDA table:
    the collection's entry point runs the Function, with its CUDA forward
    swapped for the plain version."""
    monkeypatch.setattr(eb, "embedding_bag_grouped_fwd_cuda",
                        lambda ts, i, n, p: eb.embedding_bag_grouped_plain(
                            ts, i, n, p))
    monkeypatch.setattr(ec, "embedding_bag",
                        lambda t, i, n, p, backend=None:
                            eb.GroupedEmbeddingBagFn.apply(
                                i[:, None], n[:, None], p, t).squeeze(1))


@pytest.mark.parametrize("mode,roo,path", [
    ("baseline", True, "plain"), ("userarch", True, "function"),
    ("userarch", False, "function"), ("userarch_hstu", True, "plain")])
def test_lsr_loss_grads_match_reference(data, params, monkeypatch, mode, roo,
                                        path):
    jcfg = cfgs(mode)[1]
    pp, jp = params[mode]
    if path == "function":
        through_function(monkeypatch)
    loss, grads = port_vag(mode, roo)(pp, data["pb"][1], None)
    with jax_dispatch.use_emb_backend("pallas-interpret"):
        jloss, jgrads = jax.value_and_grad(
            lambda p: jax_lsr.lsr_loss(p, jcfg, data["jb"][1], roo=roo))(jp)
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


@pytest.fixture(scope="module")
def jax_run(data, params):
    jcfg = cfgs("userarch")[1]
    jt = jax_loop.Trainer(
        lambda p, b, r: jax_lsr.lsr_loss(p, jcfg, b),
        jax_optim.make_mixed(jax_optim.adam(1e-3),
                             jax_optim.rowwise_adagrad(0.05),
                             jax_optim.default_is_embedding),
        jax_loop.TrainLoopConfig(total_steps=20, log_every=1),
        lambda: params["userarch"][1],
        metrics_fn=jax_metrics.make_ne_metrics(lambda p, b: (
            jax_lsr.lsr_logits_roo(p, jcfg, b)[:, 0], b.labels[:, 0],
            b.impression_mask())))
    state = jt.run(cycling(data["jb"]), jax.random.PRNGKey(0))
    return jt.history, state


@pytest.mark.parametrize("path", ["plain", "function"])
def test_trainer_20_steps_match_reference(data, params, jax_run, monkeypatch,
                                          path):
    cfg = cfgs("userarch")[0]
    if path == "function":
        through_function(monkeypatch)
    pt = loop.Trainer(
        lambda p, b, r: lsr.lsr_loss(p, cfg, b),
        optim.make_mixed(optim.adam(1e-3), optim.rowwise_adagrad(0.05),
                         optim.default_is_embedding),
        loop.TrainLoopConfig(total_steps=20, log_every=1),
        lambda: params["userarch"][0],
        metrics_fn=metrics.make_ne_metrics(lambda p, b: (
            lsr.lsr_logits_roo(p, cfg, b)[:, 0], b.labels[:, 0],
            b.impression_mask())), device="cpu")
    pstate = pt.run(cycling(data["pb"]), 0)
    jhist, jstate = jax_run
    assert [r["step"] for r in pt.history] == list(range(1, 21))
    for a, b in zip(pt.history, jhist):
        for key in ("loss", "ne", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], **LOSS_TOL,
                                       err_msg=f"{key} at step {a['step']}")
        assert a["skipped"] == b["skipped"] == 0
    np.testing.assert_allclose(np_(pstate["params"]["item_emb"]),
                               np_(jstate["params"]["item_emb"]),
                               atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def requests(samples, make):
    """The stream's first 30 requests plus a zero-impression one."""
    base = samples[0]
    zero = make(request_id=10_001, user_id=1, ro_dense=base.ro_dense,
                ro_idlist=[3], history_ids=[5, 6], history_actions=[1, 0],
                item_ids=[], item_dense=[], item_idlist=[], labels=[])
    return [zero] + list(samples[:30])


def test_lsr_servers_match_reference(data, params):
    cfg, jcfg = cfgs("userarch")
    pp, jp = params["userarch"]
    preqs = requests(data["ps"], joiner.ROOSample)
    jreqs = requests(data["js"], jax_joiner.ROOSample)
    kw = dict(b_ro=8, b_nro=64, hist_len=16)
    want = jax_serving.ROOServer(
        jp, lambda p, b: jax_lsr.lsr_logits_roo(p, jcfg, b),
        jax_serving.ServeConfig(**kw)).score_requests(jreqs)
    plain = serving.ROOServer(
        pp, lambda p, b: lsr.lsr_logits_roo(p, cfg, b),
        serving.ServeConfig(**kw), device="cpu")
    got = plain.score_requests(preqs)
    cached = serving.ROOServer(
        pp, lambda p, b: lsr.lsr_logits_roo(p, cfg, b),
        serving.ServeConfig(cache_user_tower=True, **kw),
        user_fn=lambda p, b: lsr.lsr_user_repr(p, cfg, b),
        score_from_user=lambda p, b, u: lsr.lsr_logits_from_user(p, cfg, b,
                                                                 u),
        device="cpu")
    passes = [cached.score_requests(preqs) for _ in range(2)]
    assert plain.stats.n_failed_batches == cached.stats.n_failed_batches == 0
    st = cached.stats
    assert st.n_full_cache_batches == st.n_batches // 2 > 0
    for i, r in enumerate(preqs):
        assert not isinstance(got[i], ScoreError), got[i]
        assert got[i].shape == np.asarray(want[i]).shape == \
            (r.num_impressions, 2)
        np.testing.assert_allclose(got[i], np.asarray(want[i]), **SCORE_TOL)
        for p in passes:
            np.testing.assert_allclose(p[i], got[i], **SCORE_TOL)
        np.testing.assert_array_equal(passes[1][i], passes[0][i])
