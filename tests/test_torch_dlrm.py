"""The port's dlrm-mlperf slice held against the JAX reference.

Two reduced configs, each in both packages: 26 fields of 100 rows at D 16
(as ``tests/test_models_smoke.py`` sizes it) and the scenario's (n_dense 4,
vocabs (512, 256, 64, 32), multi_hot 2). The reference's ``dlrm_init``
params are carried across (``interop``) and the same
``synthetic_dlrm_batches`` go through both:

  * the init tree's paths and shapes, the config helpers, the collection;
  * the batches bit for bit;
  * ``dlrm_forward_roo`` / ``_impression`` / ``_from_embs`` logits to
    1e-5, and ROO against impression-level in the port;
  * BCE loss gradients per leaf against ``jax.grad`` (1e-5), the port on
    its plain path and through ``GroupedEmbeddingBagFn`` and
    ``DotInteractionFn`` (their CUDA forwards swapped for the plain
    versions);
  * a 20-step Trainer with the scenario's mixed optimizer against the
    reference's at log_every 1 (losses to rtol 1e-5);
  * the table gradient's densify on both of its paths (a dlrm field at
    B_NRO sends thousands of ids into a few rows);
  * the tree helpers and a Trainer step leave no reference cycle that
    would keep a step's parameter tree alive after it (at dlrm-mlperf's
    7 GB of tables, a few such trees fill the card).
"""
import dataclasses
import gc
import itertools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embeddings import collection as jax_ec
from repro.models import dlrm as jax_dlrm
from repro.scenario.build import synthetic_dlrm_batches as jax_batches
from repro.scenario.spec import (BatcherSpec, DataSpec, ModelSpec,
                                 ScenarioSpec)
from repro.train import loop as jax_loop
from repro.train import optim as jax_optim
from repro_torch import tree
from repro_torch.configs.registry import scenario as port_scenario
from repro_torch.embeddings import collection as ec
from repro_torch.embeddings.sparse import FIXED_ORDER_MAX_IDS, SparseRows
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import dot_interaction as di
from repro_torch.kernels import embedding_bag as eb
from repro_torch.models import dlrm
from repro_torch.scenario.build import synthetic_dlrm_batches
from repro_torch.train import loop, metrics, optim

LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
CONFIGS = {
    "smoke": dict(vocabs=tuple([100] * 26), embed_dim=16,
                  bot_mlp=(13, 32, 16), top_mlp=(64, 32, 1)),
    "scenario": dict(n_dense=4, embed_dim=16, bot_mlp=(4, 32, 16),
                     top_mlp=(64, 32, 1), vocabs=(512, 256, 64, 32),
                     n_ro_fields=2, multi_hot=2),
}
B_RO, B_NRO, SEED = 8, 32, 3


def cfgs(name):
    return dlrm.DLRMConfig(**CONFIGS[name]), \
        jax_dlrm.DLRMConfig(**CONFIGS[name])


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def port_spec():
    return port_scenario("dlrm-mlperf", {"batcher.b_ro": B_RO,
                                         "batcher.b_nro": B_NRO,
                                         "data.seed": SEED})


def jax_spec():
    return ScenarioSpec("dlrm", ModelSpec(arch="dlrm-mlperf"),
                        batcher=BatcherSpec(b_ro=B_RO, b_nro=B_NRO),
                        data=DataSpec(source="synthetic", seed=SEED))


@pytest.fixture(scope="module", params=list(CONFIGS))
def setup(request):
    """Per config: both configs, the reference's params and the same values
    in the port, and both packages' batches."""
    cfg, jcfg = cfgs(request.param)
    jp = jax_dlrm.dlrm_init(jax.random.PRNGKey(0), jcfg)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pb = synthetic_dlrm_batches(port_spec(), cfg, n_batches=4,
                                device="cpu")
    jb = jax_batches(jax_spec(), jcfg, n_batches=4)
    return dict(name=request.param, cfg=cfg, jcfg=jcfg, pp=pp, jp=jp, pb=pb,
                jb=jb)


def roo_args(b):
    return (b["ro_dense"], b["ro_ids"], b["ro_len"], b["nro_ids"],
            b["nro_len"], b["seg"])


def impression_args(b, lib):
    """The ROO batch at impression level: RO features repeated per
    impression, fields in model order."""
    seg = b["seg"]
    dense = b["ro_dense"][seg]
    if lib is torch:
        seg = seg.long()
    ids = lib.concatenate([b["ro_ids"][seg], b["nro_ids"]], axis=1) \
        if lib is jnp else torch.cat([b["ro_ids"][seg], b["nro_ids"]], 1)
    lens = lib.concatenate([b["ro_len"][seg], b["nro_len"]], axis=1) \
        if lib is jnp else torch.cat([b["ro_len"][seg], b["nro_len"]], 1)
    return dense, ids, lens


# ---------------------------------------------------------------------------
# config, init, collection, data
# ---------------------------------------------------------------------------

def test_init_tree_matches_reference(setup):
    port_init = dlrm.dlrm_init(torch.Generator().manual_seed(0),
                               setup["cfg"], device="cpu")
    paths = [(p, tuple(x.shape)) for p, x in tree.flatten_with_path(port_init)]
    jpaths = [(tuple(str(k) for k in p), tuple(x.shape)) for p, x in
              jax.tree_util.tree_flatten_with_path(setup["jp"])[0]]
    assert paths == jpaths
    assert sorted(port_init) == ["bot_mlp", "tables", "top_mlp"]
    assert sorted(port_init["tables"]) == sorted(
        f"t{i}" for i in range(setup["cfg"].n_sparse))
    # tables at N(0, 0.01²), MLPs at the reference's fan scale
    t0 = port_init["tables"]["t0"]
    assert 0.005 < float(t0.std()) < 0.015 and t0.dtype == torch.float32


@pytest.mark.parametrize("name", ["mlperf", "smoke", "scenario"])
def test_config_helpers_match_reference(name):
    cfg, jcfg = ((dlrm.DLRMConfig(), jax_dlrm.DLRMConfig())
                 if name == "mlperf" else cfgs(name))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_sparse == jcfg.n_sparse
    assert cfg.top_in_dim() == jcfg.top_in_dim()
    assert (cfg.SHARD_MIN_ROWS, cfg.ROW_PAD) == (jcfg.SHARD_MIN_ROWS,
                                                 jcfg.ROW_PAD)
    for v in (1, 65535, 65536, 65537, 2 ** 21, 39884406) + cfg.vocabs:
        assert cfg.padded_vocab(v) == jcfg.padded_vocab(v)
    assert [dataclasses.asdict(t) for t in cfg.tables().tables] == \
        [dataclasses.asdict(t) for t in jcfg.tables().tables]
    col, jcol = cfg.collection(), jcfg.collection()
    assert {k: dataclasses.asdict(f) for k, f in col.features.items()} == \
        {k: dataclasses.asdict(f) for k, f in jcol.features.items()}
    assert cfg.tables().table("t3") == col.cfg.table("t3")
    assert dlrm.dlrm_flops_per_example(cfg) == \
        jax_dlrm.dlrm_flops_per_example(jcfg)
    if name == "mlperf":
        assert sum(dlrm.MLPERF_VOCABS) == 187_767_399
        assert cfg.top_in_dim() == 479


def test_collection_routes_and_init():
    tcfg = ec.EmbeddingCollectionConfig((ec.TableConfig("a", 30, 4),
                                         ec.TableConfig("b", 7, 4, "mean",
                                                        "ro")))
    jtcfg = jax_ec.EmbeddingCollectionConfig((jax_ec.TableConfig("a", 30, 4),
                                              jax_ec.TableConfig("b", 7, 4,
                                                                 "mean",
                                                                 "ro")))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jtcfg)
    with pytest.raises(KeyError):
        tcfg.table("c")
    with pytest.raises(KeyError):                # a dangling route
        ec.EmbeddingCollection(tcfg, (ec.FeatureSpec("f", "c"),))
    col = ec.EmbeddingCollection(tcfg, (ec.FeatureSpec("f", "a"),
                                        ec.FeatureSpec("g", "b", "row")))
    tables = col.init(torch.Generator().manual_seed(1), scale=0.5,
                      device="cpu")
    again = ec.init_tables(torch.Generator().manual_seed(1), tcfg, scale=0.5,
                           device="cpu")
    assert {k: tuple(v.shape) for k, v in tables.items()} == \
        {"a": (30, 4), "b": (7, 4)}
    assert all(torch.equal(tables[k], again[k]) for k in tables)
    bf = col.init(torch.Generator().manual_seed(1), torch.bfloat16,
                  device="cpu")
    assert bf["a"].dtype == torch.bfloat16


def test_params_carry_across(setup):
    pp, jp = setup["pp"], setup["jp"]
    flat = tree.flatten_with_path(pp)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [p for p, _ in flat] == [tuple(str(k) for k in p)
                                    for p, _ in jflat]
    for (_, a), (_, b) in zip(flat, jflat):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    back = params_to_numpy(pp)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
        tree.leaves(back), jax.tree.leaves(jp)))


def test_synthetic_batches_bit_equal(setup):
    for pb, jb in zip(setup["pb"], setup["jb"]):
        assert sorted(pb) == sorted(jb)
        for k in pb:
            assert np_(pb[k]).dtype == np.asarray(jb[k]).dtype
            np.testing.assert_array_equal(np_(pb[k]), np.asarray(jb[k]),
                                          err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        synthetic_dlrm_batches(port_scenario(
            "dlrm-mlperf", {"batcher.b_ro": 3, "batcher.b_nro": 8}),
            setup["cfg"], device="cpu")


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["roo", "impression", "from_embs"])
def test_forward_matches_reference(setup, fn):
    cfg, jcfg, pp, jp = setup["cfg"], setup["jcfg"], setup["pp"], setup["jp"]
    pb, jb = setup["pb"][1], setup["jb"][1]
    if fn == "roo":
        got = dlrm.dlrm_forward_roo(pp, cfg, *roo_args(pb))
        want = jax_dlrm.dlrm_forward_roo(jp, jcfg, *roo_args(jb))
    elif fn == "impression":
        got = dlrm.dlrm_forward_impression(pp, cfg,
                                           *impression_args(pb, torch))
        want = jax_dlrm.dlrm_forward_impression(jp, jcfg,
                                                *impression_args(jb, jnp))
    else:
        rng = np.random.default_rng(7)
        n_nro = cfg.n_sparse - cfg.n_ro_fields
        ro = rng.normal(size=(B_RO, cfg.n_ro_fields, 16)).astype(np.float32)
        nro = rng.normal(size=(B_NRO, n_nro, 16)).astype(np.float32)
        got = dlrm.dlrm_forward_from_embs(pp, cfg, pb["ro_dense"],
                                          torch.from_numpy(ro),
                                          torch.from_numpy(nro), pb["seg"])
        want = jax_dlrm.dlrm_forward_from_embs(
            jp, jcfg, jb["ro_dense"], jnp.asarray(ro), jnp.asarray(nro),
            jb["seg"])
    assert got.shape == (B_NRO,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(np_(got), np_(want), **LOGIT_TOL)


def test_roo_equals_impression_level(setup):
    cfg, pp, pb = setup["cfg"], setup["pp"], setup["pb"][2]
    roo = dlrm.dlrm_forward_roo(pp, cfg, *roo_args(pb))
    imp = dlrm.dlrm_forward_impression(pp, cfg, *impression_args(pb, torch))
    np.testing.assert_allclose(np_(roo), np_(imp), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# gradients and training
# ---------------------------------------------------------------------------

def port_loss(cfg):
    return lambda p, b, gen: metrics.bce(
        dlrm.dlrm_forward_roo(p, cfg, *roo_args(b)), b["y"])


def jax_loss(jcfg):
    def loss(p, b, r=None):
        logits = jax_dlrm.dlrm_forward_roo(p, jcfg, *roo_args(b))
        y = b["y"]
        return jnp.mean(jnp.maximum(logits, 0) - logits * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))
    return loss


def through_functions(monkeypatch):
    """Route the port's bags and interaction through
    ``GroupedEmbeddingBagFn`` (dlrm's fields, one group a side; one table a
    group of one field) and ``DotInteractionFn`` on CPU tensors, their CUDA
    forwards swapped for the plain versions."""
    monkeypatch.setattr(eb, "embedding_bag_grouped_fwd_cuda",
                        lambda ts, i, n, p: eb.embedding_bag_grouped_plain(
                            ts, i, n, p))
    monkeypatch.setattr(ec, "embedding_bag",
                        lambda t, i, n, p, backend=None:
                            eb.GroupedEmbeddingBagFn.apply(
                                i[:, None], n[:, None], p, t).squeeze(1))
    monkeypatch.setattr(ec, "embedding_bag_grouped",
                        lambda ts, i, n, p, backend=None:
                            eb.GroupedEmbeddingBagFn.apply(i, n, p, *ts))
    monkeypatch.setattr(di, "dot_interaction_cuda",
                        lambda d, s, self_interaction=False:
                            di.dot_interaction_plain(d, s, self_interaction))
    monkeypatch.setattr(di, "dot_interaction",
                        lambda d, s, self_interaction=False, backend=None:
                            di.DotInteractionFn.apply(d, s,
                                                      self_interaction))


@pytest.mark.parametrize("path", ["plain", "function"])
def test_loss_grads_match_reference(setup, monkeypatch, path):
    if path == "function":
        through_functions(monkeypatch)
    loss, grads = loop.value_and_grad(port_loss(setup["cfg"]))(
        setup["pp"], setup["pb"][0], None)
    jloss, jgrads = jax.value_and_grad(jax_loss(setup["jcfg"]))(
        setup["jp"], setup["jb"][0])
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(tree.leaves(grads))
    for (p, a), b in zip(tree.flatten_with_path(grads), jl):
        np.testing.assert_allclose(np_(a), np_(b), **GRAD_TOL,
                                   err_msg=str(p))
    assert float(np.abs(np_(grads["tables"]["t0"])).sum()) > 0


def cycling(batches):
    return lambda start: (batches[i % len(batches)]
                          for i in itertools.count(start))


@pytest.fixture(scope="module")
def jax_run(setup):
    jt = jax_loop.Trainer(
        jax_loss(setup["jcfg"]),
        jax_optim.make_mixed(jax_optim.adam(1e-3),
                             jax_optim.rowwise_adagrad(0.05),
                             jax_optim.default_is_embedding),
        jax_loop.TrainLoopConfig(total_steps=20, log_every=1),
        lambda: setup["jp"])
    state = jt.run(cycling(setup["jb"]), jax.random.PRNGKey(0))
    return jt.history, state


@pytest.mark.parametrize("path", ["plain", "function"])
def test_trainer_20_steps_match_reference(setup, jax_run, monkeypatch, path):
    if path == "function":
        through_functions(monkeypatch)
    pt = loop.Trainer(
        port_loss(setup["cfg"]),
        optim.make_mixed(optim.adam(1e-3), optim.rowwise_adagrad(0.05),
                         optim.default_is_embedding),
        loop.TrainLoopConfig(total_steps=20, log_every=1),
        lambda: setup["pp"], device="cpu")
    pstate = pt.run(cycling(setup["pb"]), 0)
    jhist, jstate = jax_run
    assert [r["step"] for r in pt.history] == list(range(1, 21))
    for a, b in zip(pt.history, jhist):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], **LOSS_TOL,
                                       err_msg=f"{key} at step {a['step']}")
        assert a["skipped"] == b["skipped"] == 0
    np.testing.assert_allclose(np_(pstate["params"]["tables"]["t0"]),
                               np_(jstate["params"]["tables"]["t0"]),
                               atol=2e-5, rtol=1e-4)


@pytest.fixture
def no_cyclic_gc():
    was = gc.isenabled()
    gc.disable()
    yield
    if was:
        gc.enable()


def test_tree_helpers_leave_no_cycles(no_cyclic_gc):
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    t = {"b": [leaf, (torch.ones(1), None)], "a": {"x": torch.ones(2)}}
    assert [p for p, _ in tree.flatten_with_path(t)] == [
        ("['a']", "['x']"), ("['b']", "[0]"), ("['b']", "[1]", "[0]")]
    doubled = tree.tree_map(lambda x: x * 2, t)
    assert torch.equal(doubled["b"][0], leaf * 2)
    del t, leaf, doubled
    assert ref() is None           # freed by reference counting alone


def test_trainer_step_frees_old_params(setup, no_cyclic_gc):
    refs = []

    def loss(p, b, gen):
        refs.append(weakref.ref(p["tables"]["t0"]))
        return port_loss(setup["cfg"])(p, b, gen)

    pt = loop.Trainer(
        loss, optim.make_mixed(optim.adam(1e-3), optim.rowwise_adagrad(0.05),
                               optim.default_is_embedding),
        loop.TrainLoopConfig(total_steps=3, log_every=1),
        lambda: tree.tree_map(torch.clone, setup["pp"]), device="cpu")
    state = pt.run(cycling(setup["pb"]), 0)
    # each step read a parameter tree that no one holds any more: the
    # state holds the tree after the last update
    assert len(refs) == 3 and all(r() is None for r in refs)
    assert int(state["step"]) == 3


@pytest.mark.parametrize("n", [FIXED_ORDER_MAX_IDS, FIXED_ORDER_MAX_IDS + 1,
                               8192])
def test_densify_paths_match_scatter_add(n):
    rng = np.random.default_rng(n)
    vocab = 4
    ids = rng.integers(0, vocab + 1, size=n).astype(np.int32)  # + sentinel
    rows = rng.normal(size=(n, 8)).astype(np.float32)
    want = np.zeros((vocab + 1, 8), np.float64)
    np.add.at(want, ids, rows.astype(np.float64))
    got = SparseRows(torch.from_numpy(ids), torch.from_numpy(rows),
                     vocab).to_dense()
    assert got.shape == (vocab, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(np_(got), want[:vocab], rtol=1e-5, atol=1e-4)
