"""The port's hstu-gr serving slice held against the JAX reference.

  * events and request-level samples: equal, sample for sample, per seed;
  * ROOBatcher tensors: equal, element for element;
  * HSTU encoder and GR ranking logits, with the reference's ``gr_init``
    params carried across (interop): atol 1e-5, rtol 1e-4;
  * ROOServer: the same ~40 requests (incl. zero-impression and oversize
    ones) scored by both servers — same per-request shapes, scores within
    1e-4, no ScoreError.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import roo_models as jax_rm
from repro.core import joiner as jax_joiner
from repro.core.hstu import hstu_apply as jax_hstu_apply
from repro.core.masks import roo_spec as jax_roo_spec
from repro.data import batcher as jax_batcher
from repro.data import events as jax_events
from repro.models import gr as jax_gr
from repro.serve import serving as jax_serving
from repro.serve.engine import ScoreError as JaxScoreError
from repro_torch.configs import roo_models as rm
from repro_torch.core import joiner
from repro_torch.core.hstu import hstu_apply
from repro_torch.core.masks import roo_spec
from repro_torch.data import batcher
from repro_torch.data import events
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import gr
from repro_torch.serve import serving
from repro_torch.serve.engine import ScoreError

LOGIT_TOL = dict(atol=1e-5, rtol=1e-4)
STREAM = dict(n_requests=48, n_items=rm.N_ITEMS, hist_init_max=40, seed=3)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_rm.gr_config(attn_backend="jnp-chunked")
    return jax_gr.gr_init(jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")


@pytest.fixture(scope="module")
def samples():
    evs = list(events.EventSimulator(
        events.EventStreamConfig(**STREAM)).stream())
    return joiner.RequestLevelJoiner().join(evs)


@pytest.fixture(scope="module")
def jax_samples():
    evs = list(jax_events.EventSimulator(
        jax_events.EventStreamConfig(**STREAM)).stream())
    return jax_joiner.RequestLevelJoiner().join(evs)


def assert_same_record(a, b):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for key in fa:
        va, vb = fa[key], fb[key]
        if isinstance(va, np.ndarray) or (
                isinstance(va, list) and va and isinstance(va[0], np.ndarray)):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=key)
        else:
            assert va == vb, key


def test_event_stream_equals_reference():
    cfg = dict(STREAM, late_fraction=0.1, item_zipf=0.5)
    port_evs = list(events.EventSimulator(
        events.EventStreamConfig(**cfg)).stream())
    ref_evs = list(jax_events.EventSimulator(
        jax_events.EventStreamConfig(**cfg)).stream())
    assert len(port_evs) == len(ref_evs) > 0
    for a, b in zip(port_evs, ref_evs):
        assert type(a).__name__ == type(b).__name__
        assert_same_record(a, b)


def test_samples_equal_reference(samples, jax_samples):
    assert len(samples) == len(jax_samples) > 0
    assert sum(s.num_impressions for s in samples) > 0
    for a, b in zip(samples, jax_samples):
        assert_same_record(a, b)


@pytest.mark.parametrize("shape", [(8, 64), (16, 48), (4, 32)],
                         ids=["8x64", "16x48", "4x32"])
def test_batches_equal_reference(samples, jax_samples, shape):
    b_ro, b_nro = shape
    kw = dict(b_ro=b_ro, b_nro=b_nro, hist_len=64)
    port_it = batcher.ROOBatcher(batcher.BatcherConfig(**kw),
                                 device="cpu").batches_with_plan(samples)
    ref_it = jax_batcher.ROOBatcher(
        jax_batcher.BatcherConfig(**kw)).batches_with_plan(jax_samples)
    n = 0
    for (pb, pplan), (rb, rplan) in zip(port_it, ref_it):
        n += 1
        assert [dataclasses.astuple(p) for p in pplan.requests] == \
            [dataclasses.astuple(p) for p in rplan.requests]
        for f in ("ro_dense", "history_ids", "history_actions",
                  "history_lengths", "nro_dense", "item_ids", "labels",
                  "num_impressions", "segment_ids"):
            got, want = getattr(pb, f), np.asarray(getattr(rb, f))
            assert got.device.type == "cpu"
            assert got.numpy().dtype == want.dtype, f
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
        for kj_name, key in (("ro_sparse", "user_ids"),
                             ("nro_sparse", "item_cats")):
            pj, rj = getattr(pb, kj_name)[key], getattr(rb, kj_name)[key]
            np.testing.assert_array_equal(pj.values.numpy(),
                                          np.asarray(rj.values))
            np.testing.assert_array_equal(pj.lengths.numpy(),
                                          np.asarray(rj.lengths))
    assert n > 1


def test_roo_batch_helpers_match_reference(samples, jax_samples):
    from repro.core.roo_batch import segment_ids_from_counts as jax_seg
    from repro_torch.core.roo_batch import segment_ids_from_counts
    kw = dict(b_ro=8, b_nro=64, hist_len=64)
    pb = next(batcher.ROOBatcher(batcher.BatcherConfig(**kw),
                                 device="cpu").batches(samples))
    rb = next(jax_batcher.ROOBatcher(
        jax_batcher.BatcherConfig(**kw)).batches(jax_samples))
    assert (pb.b_ro, pb.b_nro) == (rb.b_ro, rb.b_nro)
    for name in ("impression_mask", "request_mask", "num_valid_impressions"):
        np.testing.assert_array_equal(getattr(pb, name)().numpy(),
                                      np.asarray(getattr(rb, name)()))
    np.testing.assert_array_equal(
        segment_ids_from_counts(pb.num_impressions, 64).numpy(),
        np.asarray(jax_seg(rb.num_impressions, 64)))
    np.testing.assert_array_equal(pb.segment_ids.numpy(),
                                  np.asarray(rb.segment_ids))


def test_lookups_and_dedup_match_reference(jax_params, port_params):
    from repro.embeddings import collection as jax_ec
    from repro_torch.embeddings import collection as ec
    rng = np.random.default_rng(0)
    ids = rng.integers(-5, rm.N_ITEMS + 5, size=(6, 40)).astype(np.int32)
    ids[:, 20:] = ids[:, :20]                      # duplicates across slots
    table = port_params["item_emb"]
    want = np.asarray(jax_ec.seq_lookup(jax_params["item_emb"],
                                        jnp.asarray(ids)))
    t_ids = torch.from_numpy(ids)
    direct = ec.seq_lookup(table, t_ids, dedup=False)
    np.testing.assert_array_equal(direct.numpy(), want)
    assert torch.equal(ec.seq_lookup(table, t_ids, dedup=True), direct)
    ec.set_dedup_policy("always")
    try:
        assert ec._want_dedup(None)
        assert torch.equal(ec.seq_lookup(table, t_ids), direct)
    finally:
        ec.set_dedup_policy(None)
    assert not ec._want_dedup(None)                # auto: no dedup
    np.testing.assert_array_equal(
        ec.row_lookup(table, t_ids[:, 0]).numpy(), want[:, 0])


def test_flops_and_retrieval_match_reference():
    from repro.core.hstu import hstu_flops as jax_hstu_flops
    from repro.models.mlp import mlp_flops as jax_mlp_flops
    from repro_torch.core.hstu import hstu_flops
    from repro_torch.models.mlp import mlp_flops
    cfg, jcfg = rm.gr_config(), jax_rm.gr_config()
    assert hstu_flops(cfg.hstu, 64, 80) == jax_hstu_flops(jcfg.hstu, 64, 80)
    assert mlp_flops((64, 128, 2), 512) == jax_mlp_flops((64, 128, 2), 512)
    rng = np.random.default_rng(1)
    user = rng.normal(size=(16,)).astype(np.float32)
    cands = rng.normal(size=(500, 16)).astype(np.float32)
    got_s, got_i = serving.retrieval_scoring(torch.from_numpy(user),
                                             torch.from_numpy(cands), k=10)
    want_s, want_i = jax_serving.retrieval_scoring(jnp.asarray(user),
                                                   jnp.asarray(cands), k=10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-6)


def test_params_roundtrip(jax_params, port_params):
    back = params_to_numpy(port_params)
    flat_ref = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_port_init_matches_reference_layout(jax_params):
    gen = torch.Generator().manual_seed(0)
    mine = params_to_numpy(gr.gr_init(gen, rm.gr_config(), device="cpu"))
    ref_leaves = jax.tree_util.tree_leaves_with_path(jax_params)
    my_leaves = jax.tree_util.tree_leaves_with_path(mine)
    assert [(p, a.shape, np.dtype(a.dtype)) for p, a in ref_leaves] == \
        [(p, a.shape, a.dtype) for p, a in my_leaves]


def test_hstu_encoder_matches_reference(jax_params, port_params):
    cfg, jcfg = rm.gr_config(), jax_rm.gr_config(attn_backend="jnp-chunked")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 80, 64)).astype(np.float32)
    hl = np.asarray([64, 0, 17, 40], np.int32)
    tc = np.asarray([16, 3, 0, 9], np.int32)
    want = jax_hstu_apply(jax_params["hstu"], jcfg.hstu, jnp.asarray(x),
                          jax_roo_spec(jnp.asarray(hl), jnp.asarray(tc), 64))
    for backend in ("torch-chunked", "torch-dense"):
        got = hstu_apply(port_params["hstu"], cfg.hstu, torch.from_numpy(x),
                         roo_spec(torch.from_numpy(hl), torch.from_numpy(tc),
                                  64), backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL, err_msg=backend)


def test_gr_ranking_logits_match_reference(samples, jax_samples, jax_params,
                                           port_params):
    cfg, jcfg = rm.gr_config(), jax_rm.gr_config(attn_backend="jnp-chunked")
    kw = dict(b_ro=8, b_nro=64, hist_len=64)
    pb = next(batcher.ROOBatcher(batcher.BatcherConfig(**kw),
                                 device="cpu").batches(samples))
    rb = next(jax_batcher.ROOBatcher(
        jax_batcher.BatcherConfig(**kw)).batches(jax_samples))
    want = np.asarray(jax_gr.gr_ranking_logits(jax_params, jcfg, rb))
    got = gr.gr_ranking_logits(port_params, cfg, pb).numpy()
    assert got.shape == want.shape == (64, 2)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def make_requests(samples, make):
    """~40 requests: joined samples plus zero-impression and oversize ones
    (more impressions than the top bucket's 64 slots)."""
    base = samples[0]
    reqs = list(samples[:36])
    zero = make(request_id=10_001, user_id=1, ro_dense=base.ro_dense,
                ro_idlist=[3], history_ids=[5, 6], history_actions=[1, 0],
                item_ids=[], item_dense=[], item_idlist=[], labels=[])
    n_big = 150
    big = make(request_id=10_002, user_id=2, ro_dense=base.ro_dense,
               ro_idlist=[4], history_ids=list(range(1, 90)),
               history_actions=[i % 2 for i in range(89)],
               item_ids=[(977 * i) % rm.N_ITEMS for i in range(n_big)],
               item_dense=[np.full((8,), i, np.float32)
                           for i in range(n_big)],
               item_idlist=[[1 + i % 7] for i in range(n_big)],
               labels=[{"click": 0.0, "view_sec": 0.0}] * n_big)
    reqs.insert(0, zero)
    reqs.insert(5, big)
    reqs.insert(20, dataclasses.replace(zero, request_id=10_003))
    reqs.append(dataclasses.replace(big, request_id=10_004,
                                    item_ids=big.item_ids[:70],
                                    item_dense=big.item_dense[:70],
                                    item_idlist=big.item_idlist[:70],
                                    labels=big.labels[:70]))
    return reqs


def test_roo_server_matches_reference(samples, jax_samples, jax_params,
                                      port_params):
    cfg, jcfg = rm.gr_config(), jax_rm.gr_config(attn_backend="jnp-chunked")
    port_reqs = make_requests(samples, joiner.ROOSample)
    ref_reqs = make_requests(jax_samples, jax_joiner.ROOSample)
    assert len(port_reqs) == 40

    ref_server = jax_serving.ROOServer(
        jax_params, lambda p, b: jax_gr.gr_ranking_logits(p, jcfg, b),
        jax_serving.ServeConfig(b_ro=8, b_nro=64, attn_backend="jnp-chunked"))
    want = ref_server.score_requests(ref_reqs)

    port_server = serving.ROOServer(
        port_params, lambda p, b: gr.gr_ranking_logits(p, cfg, b),
        serving.ServeConfig(b_ro=8, b_nro=64), device="cpu")
    got = port_server.score_requests(port_reqs)

    assert len(got) == len(want) == len(port_reqs)
    for r, g, w in zip(port_reqs, got, want):
        assert not isinstance(g, ScoreError), g
        assert not isinstance(w, JaxScoreError), w
        assert g.shape == np.asarray(w).shape == (r.num_impressions, 2)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)
    st = port_server.stats
    assert st.n_failed_batches == 0 and st.n_failed_requests == 0
    assert st.n_split_requests == 2
    assert st.n_batches == ref_server.stats.n_batches
