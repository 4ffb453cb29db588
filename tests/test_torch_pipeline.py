"""The port's request-log pipeline (``repro_torch/pipeline``) held against
the reference's (``repro/pipeline``) on the CPU:

  * ``WatermarkJoiner`` samples and ``JoinStats`` equal the reference's
    (late conversions at 0.2), every simulated request joined; events of
    another package are refused, not skipped;
  * shard files and manifests byte for byte the reference's, and each
    package's ``read_all`` reads the other's directory;
  * the ``PrefetchLoader`` batch stream (leaves as numpy) and its cursors
    equal the reference's, prefetch on and off, over epochs, and from a
    cursor in the middle;
  * ``CursorStore`` save / load / prune / fingerprint refusal, cursor
    files read across packages, and ``dataset_fingerprint`` equal to the
    reference's (its hash covers the reference's BatcherConfig fields);
  * a Trainer killed and restarted from the cursor ends bit for bit at
    the uninterrupted run's params, prefetch on or off (the reference's
    ``TestTrainerKillAndRestart``), and at the reference's run's within
    float rounding.

Every prefetching loader here is closed (its threads joined) and waits
on its queue with a deadline of its own (``stall_timeout_s``).
"""
import dataclasses
import json
import os
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import joiner as jax_core_joiner
from repro.data import batcher as jax_batcher
from repro.data import events as jax_events
from repro import pipeline as jax_pipeline
from repro.pipeline import resume as jax_resume
from repro_torch import pipeline
from repro_torch.core import joiner as core_joiner
from repro_torch.data import batcher, events
from repro_torch.pipeline import resume
from repro_torch.tree import leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_storage import (STREAM, assert_same_samples,  # noqa: E402
                                both_samples)

DEADLINE_S = 30.0       # no queue wait in these tests outlives it
BCFG = dict(b_ro=16, b_nro=128, hist_len=64)


def bcfg(**kw):
    return batcher.BatcherConfig(**dict(BCFG, **kw))


def jax_bcfg(**kw):
    return jax_batcher.BatcherConfig(**dict(BCFG, **kw))


def loader(shard_dir, prefetch=True, **kw):
    cfg = kw.pop("cfg", None) or bcfg()
    return pipeline.PrefetchLoader(
        pipeline.ShardDataset(shard_dir, cfg), prefetch=prefetch,
        device="cpu", stall_timeout_s=DEADLINE_S, **kw)


def jax_stream(shard_dir, epochs=1, start=None):
    with jax_pipeline.PrefetchLoader(jax_pipeline.ShardDataset(
            shard_dir, jax_bcfg()), prefetch=False, epochs=epochs) as ld:
        it = ld.batches() if start is None else ld.batches(
            jax_pipeline.Cursor(**start.to_json()))
        return [(jax.tree.map(np.asarray, b), c) for b, c in it]


def assert_same_stream(ours, theirs):
    """(batch, cursor) streams of either package: cursors and every leaf
    (dtype, shape, values) equal."""
    assert len(ours) == len(theirs) > 1
    for (b1, c1), (b2, c2) in zip(ours, theirs):
        assert c1.to_json() == c2.to_json()
        l1 = [np.asarray(x) for x in leaves(b1)] \
            if isinstance(b1, pipeline.prefetch.ROOBatch) \
            else jax.tree.leaves(b1)
        l2 = [np.asarray(x) for x in leaves(b2)] \
            if isinstance(b2, pipeline.prefetch.ROOBatch) \
            else jax.tree.leaves(b2)
        assert len(l1) == len(l2) == 13
        for x, y in zip(l1, l2):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def no_prefetch_threads():
    return not [t for t in threading.enumerate()
                if t.name.startswith("roo-prefetch-") and t.is_alive()]


@pytest.fixture(scope="module")
def joined():
    ours, theirs, _, _ = both_samples()
    return ours, theirs


@pytest.fixture(scope="module")
def dirs(joined, tmp_path_factory):
    """The joined samples written by each package (40 requests a shard)."""
    ours, theirs = joined
    root = tmp_path_factory.mktemp("pipeline")
    prov = {"stream": "test", "requests_per_shard": 40}
    pipeline.write_samples(str(root / "port"), ours, requests_per_shard=40,
                           provenance=prov)
    jax_pipeline.write_samples(str(root / "ref"), theirs,
                               requests_per_shard=40, provenance=prov)
    return str(root / "port"), str(root / "ref")


# ---------------------------------------------------------------------------
# the online join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label_wait_s", [120.0, 600.0])
def test_watermark_joiner_matches_the_reference(label_wait_s):
    cfg = dict(STREAM, n_requests=200)
    pj = pipeline.WatermarkJoiner(pipeline.OnlineJoinConfig(
        label_wait_s=label_wait_s))
    rj = jax_pipeline.WatermarkJoiner(jax_pipeline.OnlineJoinConfig(
        label_wait_s=label_wait_s))
    ours = pj.join(events.EventSimulator(
        events.EventStreamConfig(**cfg)).stream())
    theirs = rj.join(jax_events.EventSimulator(
        jax_events.EventStreamConfig(**cfg)).stream())
    assert len(ours) == cfg["n_requests"] == pj.stats.requests_emitted
    assert_same_samples(ours, theirs)
    assert pj.stats.snapshot() == rj.stats.snapshot()
    assert pj.stats.conversions_late > 0 and pj.stats.conversions_joined > 0


def test_joiner_refuses_events_of_another_package():
    ev = next(iter(jax_events.EventSimulator(
        jax_events.EventStreamConfig(n_requests=2)).stream()))
    with pytest.raises(TypeError, match="repro_torch.data.events"):
        list(pipeline.WatermarkJoiner().process(ev))


def test_no_request_lost_vs_the_core_joiner():
    evs = list(events.EventSimulator(events.EventStreamConfig(
        n_requests=200, hist_init_max=30, seed=1)).stream())
    wm = pipeline.WatermarkJoiner().join(evs)
    core = core_joiner.RequestLevelJoiner().join(evs)
    assert {(s.user_id, s.request_id) for s in wm} == \
        {(s.user_id, s.request_id) for s in core}
    assert sum(s.num_impressions for s in wm) == \
        sum(s.num_impressions for s in core)
    jcore = jax_core_joiner.RequestLevelJoiner().join(list(
        jax_events.EventSimulator(jax_events.EventStreamConfig(
            n_requests=200, hist_init_max=30, seed=1)).stream()))
    assert_same_samples(core, jcore)


# ---------------------------------------------------------------------------
# shard files and manifests
# ---------------------------------------------------------------------------

def test_shard_files_and_manifest_equal_byte_for_byte(dirs):
    port, ref = dirs
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref))
    assert "manifest.json" in names and len(names) == 4
    for name in names:
        assert Path(port, name).read_bytes() == Path(ref, name).read_bytes()
    m = pipeline.load_manifest(port)
    assert m.to_json() == jax_pipeline.load_manifest(ref).to_json()
    assert m.n_requests == STREAM["n_requests"]
    assert all(s.ro_dedup_saved > 0 for s in m.shards)


def test_read_all_across_packages(dirs, joined):
    port, ref = dirs
    ours, theirs = joined
    from_ref = pipeline.read_all(ref)
    assert_same_samples(from_ref, jax_pipeline.read_all(port))
    assert_same_samples(from_ref, pipeline.read_all(port))
    assert len(from_ref) == len(ours)


def test_missing_or_newer_manifest_refused(tmp_path, dirs):
    with pytest.raises(FileNotFoundError):
        pipeline.load_manifest(str(tmp_path))
    obj = json.loads(Path(dirs[0], "manifest.json").read_text())
    obj["schema_version"] += 1
    (tmp_path / "manifest.json").write_text(json.dumps(obj))
    with pytest.raises(ValueError, match="newer"):
        pipeline.load_manifest(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        pipeline.ShardDataset(str(tmp_path / "none"), bcfg())


# ---------------------------------------------------------------------------
# the prefetching loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "sync"])
def test_stream_and_cursors_equal_the_reference(dirs, prefetch):
    port, ref = dirs
    with loader(ref, prefetch, epochs=2) as ld:
        ours = list(ld.batches())
    theirs = jax_stream(port, epochs=2)
    assert_same_stream(ours, theirs)
    n = len(ours) // 2
    assert ours[n - 1][1] == pipeline.Cursor(epoch=1, shard=0, batch=0)
    assert ours[-1][1] == pipeline.Cursor(epoch=2, shard=0, batch=0)
    assert all(b.ro_dense.device.type == "cpu" for b, _ in ours)
    assert no_prefetch_threads()


def test_resume_from_a_cursor_in_the_middle(dirs):
    port, _ = dirs
    with loader(port, False, epochs=1) as ld:
        full = list(ld.batches())
    for k in (1, len(full) // 2, len(full) - 1):
        at = full[k - 1][1]
        with loader(port, True, epochs=1) as ld:
            tail = list(ld.batches(at))
        assert_same_stream(full[k:] + [full[0]], tail + [full[0]])
        assert_same_stream(tail + [full[0]],
                           jax_stream(port, 1, at) + [full[0]])
    with loader(port, True, epochs=1) as ld:
        skipped = list(ld.batches(skip_batches=3))
    assert_same_stream(full[3:], skipped)
    assert no_prefetch_threads()


def test_loader_places_batches_on_its_device(dirs):
    with loader(dirs[0], False, epochs=1) as ld:
        assert ld.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        pipeline.PrefetchLoader(pipeline.ShardDataset(dirs[0], bcfg()),
                                sharding=object())
    cuda = pipeline.PrefetchLoader(pipeline.ShardDataset(dirs[0], bcfg()),
                                   prefetch=False, epochs=1)
    assert cuda.device == torch.device("cuda")   # the card by default
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            next(cuda.batches())


def test_out_of_range_cursor_raises(dirs):
    with loader(dirs[0], False, epochs=1) as ld:
        with pytest.raises(ValueError, match="out of range"):
            next(ld.batches(pipeline.Cursor(epoch=0, shard=0, batch=999)))


# ---------------------------------------------------------------------------
# cursors and fingerprints
# ---------------------------------------------------------------------------

def test_cursor_store_save_load_prune(tmp_path):
    store = pipeline.CursorStore(str(tmp_path), keep_last=2)
    assert store.load(4) is None
    store.save(4, pipeline.Cursor(1, 2, 3), fingerprint="aaaa")
    assert store.load(4, fingerprint="aaaa") == pipeline.Cursor(1, 2, 3)
    with pytest.raises(ValueError, match="different batch stream"):
        store.load(4, fingerprint="bbbb")
    for s in (10, 20, 30):
        store.save(s, pipeline.Cursor(0, 0, s))
    assert store.steps() == [20, 30]
    # the reference's store writes and reads the same files
    jstore = jax_pipeline.CursorStore(str(tmp_path), keep_last=2)
    assert jstore.load(30) == jax_pipeline.Cursor(0, 0, 30)
    jstore.save(40, jax_pipeline.Cursor(2, 1, 0), fingerprint="cccc")
    assert store.load(40, fingerprint="cccc") == pipeline.Cursor(2, 1, 0)
    assert store.steps() == jstore.steps() == [30, 40]


@pytest.mark.parametrize("kw", [{}, {"b_nro": 64}, {"hist_len": 32}])
def test_dataset_fingerprint_equals_the_reference(dirs, kw):
    port, ref = dirs
    ours = resume.dataset_fingerprint(
        pipeline.ShardDataset(port, bcfg(**kw)))
    theirs = jax_resume.dataset_fingerprint(
        jax_pipeline.ShardDataset(ref, jax_bcfg(**kw)))
    assert ours == theirs
    assert set(resume._UNSHARDED_BATCHER_FIELDS) | {
        f.name for f in dataclasses.fields(batcher.BatcherConfig)} == \
        {f.name for f in dataclasses.fields(jax_batcher.BatcherConfig)}


def test_source_rejects_a_changed_batcher_cfg(dirs, tmp_path):
    src = pipeline.PipelineDataSource(loader(dirs[0], False),
                                      pipeline.CursorStore(str(tmp_path)))
    it = src.batch_iter_fn(0)
    for _ in range(3):
        next(it)
    src.on_checkpoint(2)
    src.close()
    other = pipeline.PipelineDataSource(
        loader(dirs[0], False, cfg=bcfg(b_nro=64)),
        pipeline.CursorStore(str(tmp_path)))
    with pytest.raises(ValueError, match="different batch stream"):
        other.batch_iter_fn(2)
    # a cursor the port saved resumes the reference's source
    jsrc = jax_pipeline.PipelineDataSource(
        jax_pipeline.PrefetchLoader(jax_pipeline.ShardDataset(
            dirs[1], jax_bcfg()), prefetch=False),
        jax_pipeline.CursorStore(str(tmp_path)))
    got = jax.tree.map(np.asarray, next(jsrc.batch_iter_fn(2)))
    with loader(dirs[0], False, epochs=1) as ld:
        want = list(ld.batches())[2][0]
    for x, y in zip(leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(x), y)


def test_replay_without_a_cursor(dirs, tmp_path):
    full = pipeline.PipelineDataSource(loader(dirs[0], False),
                                       pipeline.CursorStore(str(tmp_path)))
    it = full.batch_iter_fn(0)
    want = [next(it) for _ in range(6)]
    with pipeline.PipelineDataSource(
            loader(dirs[0], True),
            pipeline.CursorStore(str(tmp_path / "other"))) as src:
        it = src.batch_iter_fn(3)
        got = [next(it) for _ in range(3)]
        it.close()
    for a, b in zip(want[3:], got):
        assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert no_prefetch_threads()


# ---------------------------------------------------------------------------
# kill and restart through the Trainer
# ---------------------------------------------------------------------------

def _port_trainer(ckpt_dir, total=12):
    from repro_torch.train.loop import Trainer, TrainLoopConfig
    from repro_torch.train.optim import sgd

    def loss_fn(params, batch, gen):
        pred = batch.ro_dense @ params["w"]
        tgt = torch.zeros(batch.b_ro + 1).index_add_(
            0, batch.segment_ids.long(), batch.labels[:, 0])[:-1]
        return torch.mean((pred[:, 0] - tgt) ** 2)

    cfg = TrainLoopConfig(total_steps=total, ckpt_every=4, log_every=100,
                          ckpt_dir=ckpt_dir)
    return Trainer(loss_fn, sgd(lr=0.01), cfg,
                   lambda: {"w": torch.ones((16, 1))}, device="cpu")


def _jax_final_w(shard_dir, tmp_path, total=12):
    from repro.train.loop import Trainer, TrainLoopConfig
    from repro.train.optim import sgd

    def loss_fn(params, batch, rng):
        pred = batch.ro_dense @ params["w"]
        tgt = jax.ops.segment_sum(batch.labels[:, 0], batch.segment_ids,
                                  num_segments=batch.b_ro + 1)[:-1]
        return jnp.mean((pred[:, 0] - tgt) ** 2)

    tr = Trainer(loss_fn, sgd(lr=0.01),
                 TrainLoopConfig(total_steps=total, ckpt_every=4,
                                 log_every=100),
                 lambda: {"w": jnp.ones((16, 1))})
    with jax_pipeline.PipelineDataSource(
            jax_pipeline.PrefetchLoader(jax_pipeline.ShardDataset(
                shard_dir, jax_bcfg()), prefetch=False),
            jax_pipeline.CursorStore(str(tmp_path / "jcur"))) as src:
        state = tr.run(src.batch_iter_fn, jax.random.PRNGKey(0))
    return np.asarray(state["params"]["w"])


@pytest.mark.parametrize("resume_prefetch", [True, False],
                         ids=["resume-prefetch", "resume-sync"])
def test_kill_and_restart_bit_for_bit(dirs, tmp_path, resume_prefetch):
    port, ref = dirs

    def source(cursor_dir, prefetch=True):
        return pipeline.PipelineDataSource(
            loader(port, prefetch), pipeline.CursorStore(cursor_dir))

    with source(str(tmp_path / "cur_full")) as src:
        s_full = _port_trainer(str(tmp_path / "full")).run(
            src.batch_iter_fn, 0, on_checkpoint=src.on_checkpoint)
    with source(str(tmp_path / "cur")) as src:
        _port_trainer(str(tmp_path / "pre")).run(
            src.batch_iter_fn, 0, stop_after=6,
            on_checkpoint=src.on_checkpoint)
    assert pipeline.CursorStore(str(tmp_path / "cur")).steps() == [4]
    with source(str(tmp_path / "cur"), resume_prefetch) as src:
        s_res = _port_trainer(str(tmp_path / "pre")).run(
            src.batch_iter_fn, 0, on_checkpoint=src.on_checkpoint)
    assert int(s_res["step"]) == 12
    assert torch.equal(s_full["params"]["w"], s_res["params"]["w"])
    np.testing.assert_allclose(s_full["params"]["w"].numpy(),
                               _jax_final_w(ref, tmp_path),
                               rtol=1e-6, atol=1e-6)
    assert no_prefetch_threads()
