"""``data.source="disk"`` through the port's scenario layer
(``repro_torch/scenario/build.py``: ``build_shards``, ``_train_disk``,
``cursor_fingerprint``) held against the reference's
(``repro/scenario/build.py``) on the CPU:

  * ``train_from_scenario`` builds shards, reuses them (files untouched)
    and refuses a directory of other data, by provenance; the directory it
    builds is byte for byte the reference's for the same spec;
  * the batches ``_train_disk`` feeds the Trainer equal the reference's;
  * each step's loss on the reference's params carried across (the
    ``bundle`` seam) within 1e-5 of the reference's own disk run, for
    hstu-gr and roo-lsr ``userarch``;
  * a run killed after a checkpoint and resumed ends bit for bit at the
    uninterrupted run, prefetch on or off;
  * ``cursor_fingerprint`` equal across packages.

Sizes are small: 2,000 items, an 80-request stream in shards of 32,
batches of 8 / 48.
"""
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.pipeline import load_manifest as jax_load_manifest
from repro.scenario import build as jax_build
from repro_torch.configs.registry import scenario
from repro_torch.interop import params_from_numpy
from repro_torch.pipeline import load_manifest
from repro_torch.scenario import build
from repro_torch.scenario.spec import ScenarioValidationError
from repro_torch.tree import leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_state import one_thread, port_state  # noqa: E402,F401

SMALL = {"model.n_items": 2000, "data.n_requests": 80,
         "data.requests_per_shard": 32, "batcher.b_ro": 8,
         "batcher.b_nro": 48, "data.source": "disk"}
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)


def specs(arch="hstu-gr", extra=None):
    over = dict(SMALL, **(extra or {}))
    return scenario(arch, over), jax_registry.scenario(arch, over)


def files(d) -> dict:
    return {p.name: (p.read_bytes(), p.stat().st_mtime_ns)
            for p in sorted(Path(d).iterdir()) if p.is_file()}


def capture_batches(monkeypatch, trainer_cls, n, to_numpy):
    """Replace ``trainer_cls.run`` with one that takes the first ``n``
    batches of the data source it is handed and trains nothing."""
    seen = []

    def run(self, batch_iter_fn, seed=0, stop_after=None,
            on_checkpoint=None):
        it = batch_iter_fn(0)
        seen.extend(to_numpy(next(it)) for _ in range(n))
        it.close()
        return {"step": 0}
    monkeypatch.setattr(trainer_cls, "run", run)
    return seen


def test_builds_reuses_and_refuses_by_provenance(tmp_path):
    spec, jspec = specs(extra={"train.steps": 2, "train.ckpt_every": 2})
    shards = str(tmp_path / "shards")
    trainer, state = build.train_from_scenario(
        spec, shard_dir=shards, ckpt_dir=str(tmp_path / "ckpt"),
        prints=False, device="cpu")
    built = files(shards)
    manifest = load_manifest(shards)
    assert [s.n_requests for s in manifest.shards] == [32, 32, 16]
    assert build.provenance_matches(manifest.provenance, spec)
    assert jax_build.provenance_matches(manifest.provenance, jspec)
    assert manifest.provenance == jax_build.shard_provenance(jspec)
    assert os.listdir(tmp_path / "ckpt" / "cursors") == [
        "cursor_000000000002.json"]
    # more steps: same data, the shards reused untouched
    build.train_from_scenario(spec.with_overrides({"train.steps": 3}),
                              shard_dir=shards, prints=False, device="cpu")
    assert files(shards) == built
    with pytest.raises(ScenarioValidationError, match="different settings"):
        build.train_from_scenario(spec.with_overrides({"data.seed": 1}),
                                  shard_dir=shards, prints=False,
                                  device="cpu")
    with pytest.raises(ScenarioValidationError, match="needs a shard_dir"):
        build.train_from_scenario(spec, prints=False, device="cpu")
    # the reference builds the same directory, byte for byte
    jdir = str(tmp_path / "ref")
    jax_build.train_from_scenario(jspec, shard_dir=jdir, prints=False)
    ref = files(jdir)
    assert sorted(ref) == sorted(built)
    assert all(ref[k][0] == built[k][0] for k in ref)


def test_fed_batches_equal_the_references(tmp_path, monkeypatch):
    from repro.train.loop import Trainer as JaxTrainer
    from repro_torch.train.loop import Trainer
    spec, jspec = specs()
    ours = capture_batches(monkeypatch, Trainer, 14,
                           lambda b: [x.numpy() for x in leaves(b)])
    theirs = capture_batches(monkeypatch, JaxTrainer, 14,
                             lambda b: [np.asarray(x)
                                        for x in jax.tree.leaves(b)])
    build.train_from_scenario(spec, shard_dir=str(tmp_path / "p"),
                              prints=False, device="cpu")
    jax_build.train_from_scenario(jspec, shard_dir=str(tmp_path / "j"),
                                  prints=False)
    n_batches = len(ours)
    assert n_batches == len(theirs) == 14     # across an epoch boundary
    for a, b in zip(ours, theirs):
        assert len(a) == len(b) == 13
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch,variant", [("hstu-gr", None),
                                          ("roo-lsr", "userarch")])
def test_losses_match_the_reference_on_carried_params(arch, variant,
                                                      tmp_path):
    extra = {"train.steps": 3, "train.log_every": 1}
    if variant:
        extra["model.variant"] = variant
    spec, jspec = specs(arch, extra)
    jbundle = jax_build.build_model(jspec, jax.random.PRNGKey(0))
    jtrainer, _ = jax_build.train_from_scenario(
        jspec, shard_dir=str(tmp_path / "j"), prints=False)
    bundle = build.build_model(spec, torch.Generator().manual_seed(0),
                               device="cpu")
    bundle = bundle._replace(params=params_from_numpy(
        jax.tree.map(np.asarray, jbundle.params), "cpu"))
    trainer, state = build._train_from_scenario(
        spec.validate().apply(), ckpt_dir=None, rng_seed=0, prints=False,
        device="cpu", shard_dir=str(tmp_path / "p"), bundle=bundle)
    assert int(state["step"]) == 3
    assert [r["step"] for r in trainer.history] == \
        [r["step"] for r in jtrainer.history] == [1, 2, 3]
    for row, jrow in zip(trainer.history, jtrainer.history):
        np.testing.assert_allclose(row["loss"], jrow["loss"], **LOSS_TOL)


@pytest.mark.parametrize("prefetch", [True, False],
                         ids=["prefetch", "sync"])
def test_kill_and_resume_bit_for_bit(prefetch, tmp_path, one_thread):
    spec, _ = specs("roo-lsr", {
        "model.variant": "userarch", "train.steps": 8, "train.ckpt_every": 4,
        "train.log_every": 1, "data.prefetch": prefetch})
    shards = str(tmp_path / "shards")
    full, s_full = build.train_from_scenario(
        spec, shard_dir=shards, ckpt_dir=str(tmp_path / "full"),
        prints=False, device="cpu")
    build.train_from_scenario(   # killed after step 6: last commit at 4
        spec.with_overrides({"train.steps": 6}), shard_dir=shards,
        ckpt_dir=str(tmp_path / "kill"), prints=False, device="cpu")
    assert sorted(os.listdir(tmp_path / "kill" / "cursors")) == [
        "cursor_000000000004.json"]
    resumed, s_res = build.train_from_scenario(
        spec, shard_dir=shards, ckpt_dir=str(tmp_path / "kill"),
        prints=False, device="cpu")
    assert [r["loss"] for r in resumed.history] == \
        [r["loss"] for r in full.history][4:]
    assert all(torch.equal(a, b) for a, b in zip(leaves(s_full["params"]),
                                                 leaves(s_res["params"])))


def test_cursor_fingerprint_equal_across_packages(tmp_path):
    spec, jspec = specs()
    manifest = build.build_shards(spec, str(tmp_path / "p"))
    jmanifest = jax_load_manifest(str(tmp_path / "p"))   # the same file
    fp = build.cursor_fingerprint(spec, manifest)
    assert fp == jax_build.cursor_fingerprint(jspec, jmanifest)
    assert fp == build.cursor_fingerprint(
        spec.with_overrides({"train.steps": 9}), manifest)
    assert fp != build.cursor_fingerprint(
        spec.with_overrides({"batcher.b_nro": 64}), manifest)
    assert build.build_shards(spec, str(tmp_path / "p")) == manifest
