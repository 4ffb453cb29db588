"""The port's training loop and checkpoints against their own contracts
(the port-internal mirror of ``tests/test_train.py``'s checkpoint,
preemption-resume, accumulation-rng and non-finite-guard cases).

Cross-package rng parity is impossible: the port draws from
``torch.Generator``s seeded from (base seed, step[, microbatch]), the
reference from JAX's PRNG. So these cases check each contract inside the
port; the cross-package trajectory tests (tests/test_torch_train.py) use a
loss that draws nothing.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.train.checkpoint import (CheckpointCorruptionError,
                                          CheckpointManager)
from repro_torch.train.loop import (NonFiniteLossError, Trainer,
                                    TrainLoopConfig, make_train_step,
                                    step_generator)
from repro_torch.train.optim import sgd


class TestCheckpoint:
    def test_atomic_save_restore(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=2)
        state = {"w": torch.arange(6.0).reshape(2, 3),
                 "opt": {"m": [torch.ones(2)], "empty": {}},
                 "step": torch.tensor(7, dtype=torch.int32)}
        mgr.save(7, state)
        assert sorted(os.listdir(tmp_path)) == ["step_000000000007"]
        out = mgr.restore()
        assert out.keys() == state.keys() and out["opt"]["empty"] == {}
        np.testing.assert_array_equal(out["w"].numpy(), state["w"].numpy())
        np.testing.assert_array_equal(out["opt"]["m"][0].numpy(), np.ones(2))
        assert out["step"].dtype == torch.int32 and int(out["step"]) == 7

    def test_keep_last_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"x": torch.tensor(s)})
        assert mgr.all_steps() == [3, 4]

    def test_partial_write_ignored_and_swept(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=3)
        mgr.save(5, {"x": torch.tensor(5)})
        torn = tmp_path / "step_000000000009.tmp"
        os.makedirs(torn)
        assert mgr.latest_step() == 5
        CheckpointManager(str(tmp_path))        # a restart sweeps it
        assert not torn.exists()

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.ones((128, 128))}, blocking=False)
        mgr.wait()
        assert mgr.latest_step() == 1

    def test_digest_and_meta(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), meta={"scenario": "gr"})
        mgr.save(1, {"x": torch.tensor(1.0)})
        mgr.save(2, {"x": torch.tensor(2.0)})
        with open(tmp_path / "step_000000000002" / "meta.json") as f:
            meta = json.load(f)
        assert meta["scenario"] == "gr" and meta["step"] == 2
        assert set(meta["digests"]) == {"arrays.npz", "structure.json"}
        path = tmp_path / "step_000000000002" / "arrays.npz"
        blob = bytearray(path.read_bytes())
        blob[-10] ^= 0xFF                       # bit rot after commit
        path.write_bytes(bytes(blob))
        assert not mgr.verify(2) and mgr.verify(1)
        assert float(mgr.restore()["x"]) == 1.0  # falls back to step 1
        with pytest.raises(CheckpointCorruptionError):
            mgr.restore(2)


def _batches(start_step):
    step = start_step
    while True:
        rng = np.random.RandomState(step)       # deterministic per step
        x = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
        yield {"x": x, "y": x.sum(1, keepdim=True)}
        step += 1


def _trainer(ckpt_dir, use_rng=False, **cfg):
    def loss_fn(params, batch, gen):
        loss = torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
        if use_rng:       # the per-step generator scales the loss
            loss = loss * (0.5 + torch.rand((), generator=gen))
        return loss

    cfg = TrainLoopConfig(**{**dict(total_steps=40, ckpt_every=10,
                                    log_every=100, ckpt_dir=ckpt_dir), **cfg})
    return Trainer(loss_fn, sgd(lr=0.05), cfg,
                   lambda: {"w": torch.zeros((4, 1))}, device="cpu")


class TestPreemptionResume:
    """Kill training mid-run, restart, and the resumed run ends exactly
    where an uninterrupted one does."""

    def test_resume_bit_continuation(self, tmp_path):
        full = _trainer(str(tmp_path / "full")).run(_batches, 0)
        _trainer(str(tmp_path / "pre")).run(_batches, 0, stop_after=25)
        resumed_trainer = _trainer(str(tmp_path / "pre"))
        resumed = resumed_trainer.run(_batches, 0)
        assert int(resumed["step"]) == 40
        np.testing.assert_array_equal(full["params"]["w"].numpy(),
                                      resumed["params"]["w"].numpy())

    def test_rng_is_checkpointed_state(self, tmp_path):
        """state = {params, opt, step, rng}: the base seed is part of the
        checkpoint, so a resume given a DIFFERENT seed still continues the
        original run bit for bit."""
        full = _trainer(str(tmp_path / "full"), use_rng=True).run(_batches, 0)
        assert int(full["rng"]) == 0
        _trainer(str(tmp_path / "pre"), use_rng=True).run(
            _batches, 0, stop_after=25)
        resumed = _trainer(str(tmp_path / "pre"), use_rng=True).run(
            _batches, 12345)
        np.testing.assert_array_equal(full["params"]["w"].numpy(),
                                      resumed["params"]["w"].numpy())
        assert int(resumed["rng"]) == 0
        other = _trainer(str(tmp_path / "other"), use_rng=True).run(
            _batches, 12345)
        assert not np.array_equal(full["params"]["w"].numpy(),
                                  other["params"]["w"].numpy())


class TestGradAccumRng:
    def test_microbatches_see_distinct_rng(self):
        """Each microbatch of an accumulated step draws from its own
        generator: the gradient w.r.t. w IS the mean of the draws."""
        def loss_fn(params, batch, gen):
            return params["w"] * torch.rand((), generator=gen)

        m = 4
        step = make_train_step(loss_fn, sgd(lr=0.0), microbatches=m)
        params = {"w": torch.tensor(1.0)}
        state = {"params": params, "opt": sgd(lr=0.0).init(params),
                 "step": torch.tensor(0)}
        _, metrics = step(state, {"x": torch.zeros((m, 1))}, 123, 0)
        draws = np.array([float(torch.rand((), generator=step_generator(
            123, 0, i))) for i in range(m)])
        assert len(set(draws.tolist())) == m
        assert abs(float(metrics["grad_norm"]) - draws.mean()) < 1e-6
        assert abs(float(metrics["loss"]) - draws.mean()) < 1e-6

    def test_accumulation_averages_gradients(self):
        """Four microbatches of one batch each == the step on their mean."""
        def loss_fn(params, batch, gen):
            return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

        it = _batches(0)
        mbs = [next(it) for _ in range(4)]
        params = {"w": torch.ones((4, 1))}
        acc = make_train_step(loss_fn, sgd(lr=0.1), microbatches=4)
        stacked = {k: torch.stack([b[k] for b in mbs]) for k in ("x", "y")}
        state = {"params": params, "opt": {}, "step": torch.tensor(0)}
        got, _ = acc(state, stacked, 0, 0)
        one = make_train_step(loss_fn, sgd(lr=0.1))
        whole = {k: torch.cat([b[k] for b in mbs]) for k in ("x", "y")}
        want, _ = one(state, whole, 0, 0)
        np.testing.assert_allclose(got["params"]["w"].numpy(),
                                   want["params"]["w"].numpy(), rtol=1e-6)


class TestNonFiniteGuard:
    def _poisoned(self, bad_steps):
        def gen(start):
            for step, batch in enumerate(_batches(start), start):
                if step in bad_steps:
                    batch = {**batch, "x": torch.full_like(batch["x"],
                                                           float("nan"))}
                yield batch
        return gen

    def test_skips_keep_params_and_state(self):
        tr = _trainer(None, total_steps=6, log_every=1)
        clean = _trainer(None, total_steps=3, log_every=1).run(_batches, 0)
        state = tr.run(self._poisoned({3, 4, 5}), 0)
        assert [r["skipped"] for r in tr.history] == [0, 0, 0, 1, 1, 1]
        assert int(state["step"]) == 6
        np.testing.assert_array_equal(state["params"]["w"].numpy(),
                                      clean["params"]["w"].numpy())
        assert tr.skipped_steps == 0           # passive guard: no host sync

    def test_halts_after_consecutive_skips(self):
        tr = _trainer(None, total_steps=10, halt_after_skips=2)
        with pytest.raises(NonFiniteLossError, match="2 consecutive"):
            tr.run(self._poisoned({3, 5, 6}), 0)
        assert tr.skipped_steps == 3

    def test_checkpoint_meta_and_log_rows(self, tmp_path):
        tr = _trainer(str(tmp_path), total_steps=10, ckpt_every=5,
                      log_every=5, ckpt_meta={"arch": "toy"})
        tr.run(_batches, 0)
        assert [r["step"] for r in tr.history] == [5, 10]
        assert {"loss", "grad_norm", "skipped", "steps_per_s"} <= \
            set(tr.history[0])
        with open(tmp_path / "step_000000000010" / "meta.json") as f:
            assert json.load(f)["arch"] == "toy"
