"""The disk pipeline's four fault sites in the port (``shard.read``,
``shard.write``, ``prefetch.io``, ``prefetch.stall``) and the degradation
they exercise, held against the reference's ``tests/test_reliability.py``
cases: CRC quarantine and strict mode, a torn shard write swept by the
next writer, transient read errors retried with the stream unchanged, the
retry budget surfacing, the stall watchdog restarting one producer, every
producer thread joined at close, and a kill-and-restart under transient
faults ending bit for bit. One seeded plan fires on the same visits in
both packages.

Each prefetching loader waits on its queue with a deadline of its own:
the watchdog cases at ``stall_timeout_s`` 0.3, the rest at 30 s.
"""
import os
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import pipeline as jax_pipeline
from repro.data import batcher as jax_batcher
from repro.pipeline.shards import ShardWriter as JaxShardWriter
from repro.reliability import faults as jax_faults
from repro_torch import pipeline
from repro_torch.data import batcher, storage
from repro_torch.obs.log import reset_warn_once
from repro_torch.pipeline.shards import ShardWriter
from repro_torch.reliability import (FaultPlan, FaultSpec, InjectedFault,
                                     TransientFault, use_plan)
from repro_torch.tree import leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_storage import both_samples  # noqa: E402
from torch_port_state import port_state  # noqa: E402,F401

BCFG = dict(b_ro=16, b_nro=128, hist_len=64)


def bcfg():
    return batcher.BatcherConfig(**BCFG)


def loader(shard_dir, prefetch=True, stall_timeout_s=30.0, **kw):
    return pipeline.PrefetchLoader(
        pipeline.ShardDataset(shard_dir, bcfg()), prefetch=prefetch,
        epochs=1, device="cpu", stall_timeout_s=stall_timeout_s, **kw)


def flip_byte(path, offset_from_end=16):
    blob = bytearray(Path(path).read_bytes())
    blob[len(blob) - offset_from_end] ^= 0xFF
    Path(path).write_bytes(bytes(blob))


def same_stream(a, b):
    return len(a) == len(b) > 1 and all(
        c1 == c2 and all(torch.equal(x, y)
                         for x, y in zip(leaves(b1), leaves(b2)))
        for (b1, c1), (b2, c2) in zip(a, b))


def alive_producers():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("roo-prefetch-") and t.is_alive()]


@pytest.fixture(scope="module")
def joined():
    ours, theirs, _, _ = both_samples()
    return ours, theirs


@pytest.fixture(scope="module")
def shard_dir(joined, tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    pipeline.write_samples(str(d), joined[0], requests_per_shard=40)
    return str(d)


@pytest.fixture(scope="module")
def baseline(shard_dir):
    with loader(shard_dir, prefetch=False) as ld:
        return list(ld.batches())


# ---------------------------------------------------------------------------
# shard.read: CRC quarantine
# ---------------------------------------------------------------------------

def test_quarantine_keeps_training_alive(joined, tmp_path):
    d = str(tmp_path / "shards")
    manifest = pipeline.write_samples(d, joined[0], requests_per_shard=40)
    bad = manifest.shards[0].filename
    flip_byte(os.path.join(d, bad))
    reset_warn_once(os.path.join(d, bad))
    ds = pipeline.ShardDataset(d, bcfg())
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert ds.shard_batches(0) == []
    assert ds.stats.snapshot() == {"shards_quarantined": 1,
                                   "quarantined_files": [bad]}
    assert len(ds.shard_batches(1)) > 0
    # the reference quarantines the same shard of the same directory
    jds = jax_pipeline.ShardDataset(d, jax_batcher.BatcherConfig(**BCFG))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert jds.shard_batches(0) == []
    strict = pipeline.ShardDataset(d, bcfg(), strict=True)
    with pytest.raises(storage.ShardCorruptionError, match=bad):
        strict.shard_batches(0)


def test_injected_read_corruption_quarantines_the_fired_shard(shard_dir):
    text = "seed=2;shard.read:corrupt@0.5x1"
    plan = FaultPlan.parse(text)
    with use_plan(plan):
        with loader(shard_dir, prefetch=True) as ld:
            out = list(ld.batches())
            stats = ld.dataset.stats.snapshot()
    replay = FaultPlan.parse(text)
    fired = [replay.fire("shard.read") is not None for _ in range(3)]
    assert stats["quarantined_files"] == [
        f"shard_{fired.index(True):06d}.roos"]
    assert plan.stats.fires == {"shard.read": 1}
    assert 0 < len(out) < 12 and not alive_producers()


def test_injected_read_error_is_transient(shard_dir, baseline):
    plan = FaultPlan([FaultSpec("shard.read", "error", max_fires=1)])
    with use_plan(plan):
        with loader(shard_dir, retry_backoff_s=0.001) as ld:
            out = list(ld.batches())
    assert ld.stats.read_retries == 1 and same_stream(out, baseline)


# ---------------------------------------------------------------------------
# shard.write: a torn write never reaches the manifest
# ---------------------------------------------------------------------------

def test_torn_write_never_reaches_manifest(joined, tmp_path):
    d = str(tmp_path / "shards")
    plan = FaultPlan([FaultSpec("shard.write", "torn", max_fires=1)])
    with use_plan(plan):
        writer = ShardWriter(d, requests_per_shard=40)
        with pytest.raises(InjectedFault):
            writer.extend(joined[0])
    assert sorted(os.listdir(d)) == ["shard_000000.roos.tmp"]
    # the reference's writer sweeps the port's torn tmp too
    JaxShardWriter(str(tmp_path / "ref"), requests_per_shard=40)
    (tmp_path / "ref" / "x.tmp").write_bytes(b"torn")
    JaxShardWriter(str(tmp_path / "ref"), requests_per_shard=40)
    assert os.listdir(tmp_path / "ref") == []
    writer = ShardWriter(d, requests_per_shard=40)
    assert os.listdir(d) == []
    writer.extend(joined[0])
    manifest = writer.close()
    assert [s.filename for s in manifest.shards] == [
        f"shard_{i:06d}.roos" for i in range(3)]
    assert len(pipeline.read_all(d)) == len(joined[0])


# ---------------------------------------------------------------------------
# prefetch.io / prefetch.stall / shutdown
# ---------------------------------------------------------------------------

def test_transient_errors_retried_stream_identical(shard_dir, baseline):
    plan = FaultPlan([FaultSpec("prefetch.io", "error", max_fires=2)])
    with use_plan(plan):
        with loader(shard_dir, retry_backoff_s=0.001) as ld:
            out = list(ld.batches())
    assert ld.stats.snapshot() == {"read_retries": 2, "read_failures": 0,
                                   "producer_restarts": 0}
    assert same_stream(out, baseline)


def test_retry_budget_exhausted_surfaces(shard_dir):
    with use_plan(FaultPlan([FaultSpec("prefetch.io", "error")])):
        with loader(shard_dir, max_retries=1, retry_backoff_s=0.001) as ld:
            with pytest.raises(TransientFault):
                list(ld.batches())
    assert ld.stats.read_failures == 1 and not alive_producers()


def test_stall_watchdog_restarts_producer(shard_dir, baseline):
    plan = FaultPlan([FaultSpec("prefetch.stall", "stall", max_fires=1)])
    with use_plan(plan):
        with loader(shard_dir, stall_timeout_s=0.3) as ld:
            out = list(ld.batches())
    assert ld.stats.producer_restarts == 1
    assert same_stream(out, baseline) and not alive_producers()


def test_close_joins_producer_threads(shard_dir):
    ld = loader(shard_dir)
    it = ld.batches()
    next(it)                                   # the producer is running
    assert alive_producers()
    it.close()
    ld.close()
    ld.close()                                 # safe twice
    assert not alive_producers()


def test_stats_lose_no_update_across_threads():
    """``LoaderStats`` / ``DatasetStats`` are written by producer threads
    and read by the training thread: 16 threads incrementing at a short
    switch interval lose no update."""
    stats, ds = pipeline.LoaderStats(), pipeline.DatasetStats()

    def hammer():
        for _ in range(500):
            stats.inc("read_retries")
            ds.quarantine("x")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert stats.snapshot()["read_retries"] == 16 * 500
    assert ds.snapshot()["shards_quarantined"] == 16 * 500
    assert len(ds.snapshot()["quarantined_files"]) == 16 * 500
    with pytest.raises(ValueError, match="prefetch_depth"):
        pipeline.PrefetchLoader(None, prefetch_depth=0)


def test_one_plan_fires_on_the_same_visits_in_both_packages(
        shard_dir, joined, tmp_path):
    """The same plan over the same shard directory: the port's and the
    reference's loaders visit and fire each site alike, retry alike, and
    yield the same stream."""
    jdir = str(tmp_path / "ref")
    jax_pipeline.write_samples(jdir, joined[1], requests_per_shard=40)
    text = "seed=7;prefetch.io:error@0.3;shard.read:error@0.2"
    plan, jplan = FaultPlan.parse(text), jax_faults.FaultPlan.parse(text)
    with use_plan(plan):
        with loader(jdir, prefetch=False, max_retries=8,
                    retry_backoff_s=0.001, retry_seed=1) as ld:
            ours = list(ld.batches())
    with jax_faults.use_plan(jplan):
        with jax_pipeline.PrefetchLoader(
                jax_pipeline.ShardDataset(
                    shard_dir, jax_batcher.BatcherConfig(**BCFG)),
                prefetch=False, epochs=1, max_retries=8,
                retry_backoff_s=0.001, retry_seed=1) as jld:
            theirs = list(jld.batches())
    assert plan.stats.visits == jplan.stats.visits
    assert plan.stats.fires == jplan.stats.fires
    assert set(plan.stats.fires) == {"prefetch.io", "shard.read"}
    assert ld.stats.snapshot() == jld.stats.snapshot()
    assert len(ours) == len(theirs)
    for (b1, c1), (b2, c2) in zip(ours, theirs):
        assert c1.to_json() == c2.to_json()
        for x, y in zip(leaves(b1), jax.tree.leaves(b2)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# kill and restart under transient faults
# ---------------------------------------------------------------------------

def test_resume_bit_identical_under_transient_faults(shard_dir, tmp_path):
    from test_torch_pipeline import _port_trainer

    def source(cursor_dir):
        return pipeline.PipelineDataSource(
            pipeline.PrefetchLoader(
                pipeline.ShardDataset(shard_dir, bcfg()), device="cpu",
                max_retries=6, retry_backoff_s=0.001, stall_timeout_s=30.0),
            pipeline.CursorStore(cursor_dir))

    def chaos():      # a fresh plan per simulated process: the same draws
        return FaultPlan([FaultSpec("prefetch.io", "error", p=0.3),
                          FaultSpec("shard.read", "error", p=0.2)], seed=3)

    with source(str(tmp_path / "cur_full")) as src:
        s_full = _port_trainer(str(tmp_path / "full")).run(
            src.batch_iter_fn, 0, on_checkpoint=src.on_checkpoint)
    with use_plan(chaos()) as plan:
        with source(str(tmp_path / "cur")) as src:
            _port_trainer(str(tmp_path / "pre")).run(
                src.batch_iter_fn, 0, stop_after=6,
                on_checkpoint=src.on_checkpoint)
    assert sum(plan.stats.fires.values()) > 0
    assert pipeline.CursorStore(str(tmp_path / "cur")).steps() == [4]
    with use_plan(chaos()):
        with source(str(tmp_path / "cur")) as src:
            s_res = _port_trainer(str(tmp_path / "pre")).run(
                src.batch_iter_fn, 0, on_checkpoint=src.on_checkpoint)
    assert int(s_res["step"]) == 12
    assert torch.equal(s_full["params"]["w"], s_res["params"]["w"])
    assert not alive_producers()
