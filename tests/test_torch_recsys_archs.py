"""The port's MIND and DIEN held against the JAX reference (BERT4Rec:
``tests/test_torch_bert4rec.py``, on this module's ``check_*`` helpers).

At ``tests/conftest.py``'s ``roo_batch`` sizes (16 requests / 128
impression slots, hist 64, the stream's 5,000 items) and the reference's
smoke configs (``tests/test_models_smoke.py``: MIND at its defaults, DIEN
at seq_len 64, BERT4Rec at seq_len 65), with the reference's params carried
across (``interop``):

  * the init trees and configs; MIND's routing and DIEN's GRU and AUGRU
    scans, and the scores / logits to 1e-5;
  * the losses to rtol 1e-5 and their gradients per leaf to 1e-4;
  * a 20-step dense Trainer against the reference's at log_every 1
    (losses to rtol 1e-5; BERT4Rec's cloze draws handed over step by step
    from the reference's step keys);
  * sparse rows: each step's loss of the port's sparse run against the
    reference's sparse value_and_grad on the same params;
  * each arch's ``ROOServer`` against the reference's, scores to 1e-4.

None of these reaches a kernel: plain torch on both sides of the card.
"""
import dataclasses
import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import joiner as jax_joiner
from repro.data import batcher as jax_batcher
from repro.data import events as jax_events
from repro.models import bert4rec as jax_b4r
from repro.models import din_dien as jax_dien
from repro.models import mind as jax_mind
from repro.serve import serving as jax_serving
from repro.train import loop as jax_loop
from repro.train import optim as jax_optim
from repro_torch import tree
from repro_torch.core import joiner
from repro_torch.data import batcher, events
from repro_torch.interop import params_from_numpy
from repro_torch.models import bert4rec as b4r
from repro_torch.models import din_dien as dien
from repro_torch.models import mind
from repro_torch.serve import serving
from repro_torch.train import loop, optim

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_two_tower import check_sparse  # noqa: E402

LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)
SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
STREAM = dict(n_requests=120, hist_init_max=40, seed=0)
BATCH = dict(b_ro=16, b_nro=128, hist_len=64)
N_ITEMS = 5000
ARCHS = ["mind", "dien"]      # bert4rec: tests/test_torch_bert4rec.py


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@dataclasses.dataclass
class Arch:
    cfg: object
    jcfg: object
    init: object
    jinit: object
    score: object          # (p, cfg, batch) -> (B_NRO,)
    jscore: object
    loss: object           # (p, cfg, batch, gen) -> loss
    jloss: object
    table_ids: object = None
    jtable_ids: object = None


def arch(name) -> Arch:
    if name == "mind":
        return Arch(mind.MINDConfig(n_items=N_ITEMS),
                    jax_mind.MINDConfig(n_items=N_ITEMS), mind.mind_init,
                    jax_mind.mind_init, mind.score_candidates_roo,
                    jax_mind.score_candidates_roo,
                    lambda p, c, b, g: mind.mind_loss(p, c, b),
                    lambda p, c, b, r: jax_mind.mind_loss(p, c, b),
                    mind.mind_table_ids, jax_mind.mind_table_ids)
    if name == "dien":
        return Arch(dien.DIENConfig(n_items=N_ITEMS, seq_len=64),
                    jax_dien.DIENConfig(n_items=N_ITEMS, seq_len=64),
                    dien.dien_init, jax_dien.dien_init,
                    dien.dien_logits_roo, jax_dien.dien_logits_roo,
                    lambda p, c, b, g: dien.dien_loss(p, c, b),
                    lambda p, c, b, r: jax_dien.dien_loss(p, c, b),
                    dien.dien_table_ids, jax_dien.dien_table_ids)
    return Arch(b4r.BERT4RecConfig(n_items=N_ITEMS, seq_len=65),
                jax_b4r.BERT4RecConfig(n_items=N_ITEMS, seq_len=65),
                b4r.bert4rec_init, jax_b4r.bert4rec_init,
                b4r.score_candidates_roo, jax_b4r.score_candidates_roo,
                b4r.bert4rec_loss, jax_b4r.bert4rec_loss)


def cloze_draws(key, batch, cfg):
    """The reference's cloze draws for ``key`` (``cloze_loss``'s
    ``jax.random.uniform(rng, (b, s))``), as numpy."""
    s = min(batch.history_ids.shape[1], cfg.seq_len)
    return np.array(jax.random.uniform(key, (batch.b_ro, s)))


def make_data():
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


def make_params(names):
    """Reference params per arch, and the same values in the port."""
    out = {}
    for name in names:
        a = arch(name)
        jp = a.jinit(jax.random.PRNGKey(10 + len(name)), a.jcfg)
        out[name] = (params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                     jp)
    return out


@pytest.fixture(scope="module")
def data():
    return make_data()


@pytest.fixture(scope="module")
def params():
    return make_params(ARCHS)


@pytest.mark.parametrize("name", ARCHS)
def test_init_layout_matches_reference(name):
    check_init(name)


def check_init(name):
    a = arch(name)
    jp = a.jinit(jax.random.PRNGKey(0), a.jcfg)
    pp = a.init(torch.Generator().manual_seed(0), a.cfg, device="cpu")
    paths = [(p, tuple(x.shape)) for p, x in tree.flatten_with_path(pp)]
    jpaths = [(tuple(str(k) for k in p), tuple(x.shape))
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert paths == jpaths
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(a.jcfg)


@pytest.mark.parametrize("name", ARCHS)
def test_scores_match_reference(data, params, name):
    check_scores(data, params, name)


def check_scores(data, params, name):
    a = arch(name)
    pp, jp = params[name]
    for pb, jb in zip(data["pb"][:2], data["jb"][:2]):
        got = a.score(pp, a.cfg, pb)
        assert got.shape == (pb.b_nro,)
        np.testing.assert_allclose(np_(got), np_(a.jscore(jp, a.jcfg, jb)),
                                   **LOGIT_TOL)


def test_mind_capsules_match_reference(data, params):
    a = arch("mind")
    pp, jp = params["mind"]
    pb, jb = data["pb"][0], data["jb"][0]
    got = mind.interest_capsules(pp, a.cfg, pb.history_ids,
                                 pb.history_lengths)
    assert got.shape == (pb.b_ro, 4, 64)
    np.testing.assert_allclose(
        np_(got), np_(jax_mind.interest_capsules(jp, a.jcfg, jb.history_ids,
                                                 jb.history_lengths)),
        **LOGIT_TOL)
    x = np.random.default_rng(0).normal(size=(5, 3, 7)).astype(np.float32)
    np.testing.assert_allclose(np_(mind._squash(torch.from_numpy(x))),
                               np_(jax_mind._squash(jnp.asarray(x))),
                               **LOGIT_TOL)


def test_dien_scans_match_reference(params):
    pp, jp = params["dien"]
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(6, 9, 18)).astype(np.float32)
    lens = np.array([0, 9, 4, 1, 7, 3], np.int32)
    att = rng.uniform(size=(6, 9)).astype(np.float32)
    t = torch.from_numpy
    hs = dien.gru_scan(pp["gru"], t(xs), t(lens))
    jhs = jax_dien.gru_scan(jp["gru"], jnp.asarray(xs), jnp.asarray(lens))
    np.testing.assert_allclose(np_(hs), np_(jhs), **LOGIT_TOL)
    assert not np_(hs)[0].any()                 # length 0: h stays 0
    np.testing.assert_array_equal(np_(hs)[2, 4:], np_(hs)[2, 3:4].repeat(5,
                                                                         0))
    np.testing.assert_allclose(
        np_(dien.augru_scan(pp["augru"], hs, t(att), t(lens))),
        np_(jax_dien.augru_scan(jp["augru"], jhs, jnp.asarray(att),
                                jnp.asarray(lens))), **LOGIT_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_grads_match_reference(data, params, name):
    check_loss_grads(data, params, name)


def check_loss_grads(data, params, name):
    a = arch(name)
    pp, jp = params[name]
    pb, jb = data["pb"][1], data["jb"][1]
    key = jax.random.PRNGKey(3)
    if name == "bert4rec":
        u = torch.from_numpy(cloze_draws(key, pb, a.cfg))
        fn = lambda p, b, g: b4r.bert4rec_loss(p, a.cfg, b,  # noqa: E731
                                               uniform=u)
    else:
        fn = lambda p, b, g: a.loss(p, a.cfg, b, g)           # noqa: E731
    loss, grads = loop.value_and_grad(fn)(pp, pb, None)
    jloss, jgrads = jax.value_and_grad(
        lambda p: a.jloss(p, a.jcfg, jb, key))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(tree.leaves(grads))
    for (p, x), y in zip(tree.flatten_with_path(grads), jl):
        np.testing.assert_allclose(np_(x), np_(y), **GRAD_TOL,
                                   err_msg=str(p))
    assert float(np.abs(np_(grads["item_emb"])).sum()) > 0


def cycling(batches):
    return lambda start: (batches[i % len(batches)]
                          for i in itertools.count(start))


def mixed(lib):
    return lib.make_mixed(lib.adam(1e-3), lib.rowwise_adagrad(0.05),
                          lib.default_is_embedding)


@pytest.mark.parametrize("name", ARCHS)
def test_trainer_20_steps_match_reference(data, params, name):
    check_trainer(data, params, name)


def check_trainer(data, params, name):
    a = arch(name)
    pp, jp = params[name]
    jt = jax_loop.Trainer(lambda p, b, r: a.jloss(p, a.jcfg, b, r),
                          mixed(jax_optim),
                          jax_loop.TrainLoopConfig(total_steps=20,
                                                   log_every=1),
                          lambda: jp)
    base = jax.random.PRNGKey(0)
    jt.run(cycling(data["jb"]), base)
    if name == "bert4rec":
        # the step's cloze draws from the reference's step key
        # (fold_in(base, step)), handed over in call order
        draws = iter(torch.from_numpy(cloze_draws(
            jax.random.fold_in(base, i), data["pb"][i % len(data["pb"])],
            a.cfg)) for i in range(20))
        fn = lambda p, b, g: b4r.bert4rec_loss(      # noqa: E731
            p, a.cfg, b, uniform=next(draws))
    else:
        fn = lambda p, b, g: a.loss(p, a.cfg, b, g)  # noqa: E731
    pt = loop.Trainer(fn, mixed(optim),
                      loop.TrainLoopConfig(total_steps=20, log_every=1),
                      lambda: pp, device="cpu")
    pt.run(cycling(data["pb"]), 0)
    assert [r["step"] for r in pt.history] == list(range(1, 21))
    for x, y in zip(pt.history, jt.history):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(x[k], y[k], **LOSS_TOL,
                                       err_msg=f"{k} at step {x['step']}")
        assert x["skipped"] == y["skipped"] == 0


@pytest.mark.parametrize("name", ["mind", "dien"])
def test_sparse_rows_match_reference(data, params, name):
    a = arch(name)
    check_sparse(lambda p, b, g: a.loss(p, a.cfg, b, g),
                 lambda p, b, r: a.jloss(p, a.jcfg, b, r),
                 lambda b: a.table_ids(a.cfg, b),
                 lambda b: a.jtable_ids(a.jcfg, b), params[name][0], data,
                 12)


@pytest.mark.parametrize("name", ARCHS)
def test_servers_match_reference(data, params, name):
    check_server(data, params, name)


def check_server(data, params, name):
    a = arch(name)
    pp, jp = params[name]
    kw = dict(b_ro=16, b_nro=128, hist_len=64)
    preqs, jreqs = data["ps"][:40], data["js"][:40]
    want = jax_serving.ROOServer(
        jp, lambda p, b: a.jscore(p, a.jcfg, b),
        jax_serving.ServeConfig(**kw)).score_requests(jreqs)
    server = serving.ROOServer(pp, lambda p, b: a.score(p, a.cfg, b),
                               serving.ServeConfig(**kw), device="cpu")
    got = server.score_requests(preqs)
    assert server.stats.n_failed_batches == 0
    for i, r in enumerate(preqs):
        assert got[i].shape == (r.num_impressions,)
        np.testing.assert_allclose(got[i], np.asarray(want[i]), **SCORE_TOL)
