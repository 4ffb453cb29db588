"""The port's fault injection (``repro_torch.reliability.faults``) and the
degradation it exercises, held to the reference's contracts
(``tests/test_reliability.py``): the plan grammar, its round trip and bad
clauses; one plan string firing at the same visits in both packages (the
per-site ``SeedSequence([seed, crc32(site)])``); the engine's failure
isolation and circuit breaker (``engine.score``); the Trainer's
non-finite guard under poisoned batches (``train.batch``); checkpoint
torn and corrupt writes caught by commit and digest (``ckpt.write``).
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.reliability import faults as jax_faults
from repro_torch.core.joiner import ROOSample
from repro_torch.reliability import (ENV_VAR, FaultPlan, FaultSpec,
                                     InjectedFault, TransientFault, use_plan)
from repro_torch.reliability import faults
from repro_torch.serve.engine import EnginePolicy, ScoreError, ScoringEngine
from repro_torch.train.checkpoint import (CheckpointCorruptionError,
                                          CheckpointManager)
from repro_torch.train.loop import (NonFiniteLossError, Trainer,
                                    TrainLoopConfig, make_train_step)
from repro_torch.train.optim import sgd

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_state import port_state  # noqa: E402,F401


# ---------------------------------------------------------------------------
# the fault plan itself
# ---------------------------------------------------------------------------

class TestFaultPlan:
    def test_parse_roundtrip(self):
        text = "seed=7;shard.read:corrupt@0.05;engine.score:error@0.3x5"
        plan = FaultPlan.parse(text)
        assert plan.seed == 7
        assert plan.specs["shard.read"].kind == "corrupt"
        assert plan.specs["engine.score"].max_fires == 5
        again = FaultPlan.parse(plan.to_env())
        assert again.seed == plan.seed and again.specs == plan.specs
        # the same text in the reference: the same clauses, the same env
        ref = jax_faults.FaultPlan.parse(text)
        assert ref.to_env() == plan.to_env()

    def test_comma_separator_and_defaults(self):
        plan = FaultPlan.parse("prefetch.io:error@1")
        assert plan.seed == 0
        assert plan.specs["prefetch.io"].p == 1.0
        assert plan.specs["prefetch.io"].max_fires is None
        plan2 = FaultPlan.parse("seed=1,ckpt.write:torn@0.5")
        assert plan2.seed == 1 and "ckpt.write" in plan2.specs

    @pytest.mark.parametrize("text", ["shard.read:bogus@0.5", "nonsense",
                                      "engine.score:error@x", "a:nan@2",
                                      "seed=1;x:error@0.1;x:nan@0.2"])
    def test_bad_clauses_raise(self, text):
        with pytest.raises(ValueError):
            FaultPlan.parse(text)

    def test_bad_spec_raises(self):
        with pytest.raises(ValueError):
            FaultSpec("s", "error", p=1.5)             # p out of range
        with pytest.raises(ValueError):
            FaultSpec("s", "melt")                     # unknown kind

    def test_seeded_determinism(self):
        def fires(seed):
            plan = FaultPlan([FaultSpec("x", "error", p=0.3)], seed=seed)
            return [plan.fire("x") is not None for _ in range(200)]
        assert fires(11) == fires(11)
        assert fires(11) != fires(12)

    def test_sites_independent(self):
        """Extra draws at one site never perturb another site's sequence."""
        a = FaultPlan([FaultSpec("x", "error", p=0.3),
                       FaultSpec("y", "error", p=0.3)], seed=5)
        b = FaultPlan([FaultSpec("x", "error", p=0.3),
                       FaultSpec("y", "error", p=0.3)], seed=5)
        for _ in range(50):
            a.fire("x")                               # a drains x first
        seq_a = [a.fire("y") is not None for _ in range(50)]
        seq_b = [b.fire("y") is not None for _ in range(50)]
        assert seq_a == seq_b

    def test_max_fires_and_stats(self):
        plan = FaultPlan([FaultSpec("x", "error", p=1.0, max_fires=3)])
        hits = sum(plan.fire("x") is not None for _ in range(10))
        assert hits == 3
        assert plan.stats.visits["x"] == 10
        assert plan.stats.fires["x"] == 3

    def test_use_plan_restores_previous(self):
        before = faults.active_plan()
        with use_plan(FaultPlan([FaultSpec("x", "error")])) as plan:
            assert faults.active_plan() is plan
        assert faults.active_plan() is before

    def test_env_var_is_the_ports_own(self, monkeypatch):
        assert ENV_VAR == "REPRO_TORCH_FAULTS"
        faults.PLAN_KNOB.restore((faults.PLAN_KNOB._default, None, False))
        monkeypatch.setenv("REPRO_FAULTS", "engine.score:error@1")
        assert faults.active_plan() is None
        faults.PLAN_KNOB.restore((faults.PLAN_KNOB._default, None, False))
        monkeypatch.setenv(ENV_VAR, "seed=3;train.batch:nan@0.5x2")
        plan = faults.active_plan()
        assert plan.seed == 3 and plan.specs["train.batch"].max_fires == 2
        assert faults.active_plan() is plan            # parsed once

    def test_maybe_fail_and_corrupt_bytes(self):
        with use_plan(FaultPlan([FaultSpec("s", "error", max_fires=1)])):
            with pytest.raises(TransientFault):
                faults.maybe_fail("s")
            faults.maybe_fail("s")                     # fires exhausted
        assert issubclass(TransientFault, InjectedFault)
        assert issubclass(TransientFault, OSError)
        blob = bytes(range(200))
        spec = FaultSpec("ckpt.write", "corrupt")
        with use_plan(FaultPlan([spec], seed=4)):
            out = faults.corrupt_bytes("ckpt.write", blob, spec)
        with jax_faults.use_plan(jax_faults.FaultPlan(
                [jax_faults.FaultSpec("ckpt.write", "corrupt")], seed=4)):
            ref = jax_faults.corrupt_bytes(
                "ckpt.write", blob, jax_faults.FaultSpec("ckpt.write",
                                                         "corrupt"))
        assert out == ref and out != blob


PLANS = ["seed=7;engine.score:error@0.25",
         "seed=0;train.batch:nan@0.2x2",
         "seed=123,ckpt.write:corrupt@0.5;engine.score:error@0.1x4",
         "seed=99;shard.read:corrupt@0.05;prefetch.io:error@0.3"]


@pytest.mark.parametrize("text", PLANS)
def test_same_plan_fires_at_the_same_visits_as_the_reference(text):
    """Both packages parse the string to the same plan and, visit for
    visit and site by site, fire at the same visits, with the same
    per-site accounting and the same ``rand_index`` draws after."""
    ours, theirs = FaultPlan.parse(text), jax_faults.FaultPlan.parse(text)
    sites = sorted(ours.specs) + ["not.a.site"]
    rng = np.random.default_rng(0)
    order = [sites[i] for i in rng.integers(0, len(sites), 400)]
    got = [ours.fire(s) is not None for s in order]
    want = [theirs.fire(s) is not None for s in order]
    assert got == want and any(got)
    assert ours.stats.visits == theirs.stats.visits
    assert ours.stats.fires == theirs.stats.fires
    for s in sorted(ours.specs):
        assert ours.rand_index(s, 1000) == theirs.rand_index(s, 1000)


def test_obs_collector_reports_the_active_plan():
    from repro_torch.obs import metrics as obs_metrics
    assert obs_metrics.snapshot()["components"]["reliability.faults"] == \
        {"active": False}
    with use_plan(FaultPlan.parse("seed=2;engine.score:error@1x1")) as plan:
        plan.fire("engine.score")
        comp = obs_metrics.snapshot()["components"]["reliability.faults"]
    assert comp == {"active": True, "seed": 2, "sites": ["engine.score"],
                    "visits": {"engine.score": 1},
                    "fires": {"engine.score": 1}}


# ---------------------------------------------------------------------------
# checkpoints: verify-on-restore, torn and corrupt writes
# ---------------------------------------------------------------------------

def _state(v: float):
    return {"w": torch.full((4, 2), v), "step": torch.tensor(int(v),
                                                             dtype=torch.int32)}


def _flip_byte(path: str, offset_from_end: int = 16) -> None:
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        pos = f.tell() - offset_from_end
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


class TestCheckpointReliability:
    def test_verify_and_fallback_to_latest_valid(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=4)
        mgr.save(1, _state(1.0))
        mgr.save(2, _state(2.0))
        _flip_byte(str(tmp_path / "step_000000000002" / "arrays.npz"), 8)
        assert mgr.verify(1) and not mgr.verify(2)
        assert mgr.all_steps() == [1, 2]        # 2 is committed but rotten
        assert mgr.latest_valid_step() == 1
        restored = mgr.restore()                # silently skips step 2
        torch.testing.assert_close(restored["w"], _state(1.0)["w"])
        with pytest.raises(CheckpointCorruptionError):
            mgr.restore(2)                      # explicit ask fails loudly

    def test_tmp_dirs_swept_on_init(self, tmp_path):
        junk = tmp_path / "step_000000000005.tmp"
        junk.mkdir()
        (junk / "arrays.npz").write_bytes(b"partial")
        CheckpointManager(str(tmp_path))
        assert not junk.exists()

    def test_injected_torn_write(self, tmp_path):
        plan = FaultPlan([FaultSpec("ckpt.write", "torn", max_fires=1)])
        with use_plan(plan):
            mgr = CheckpointManager(str(tmp_path))
            mgr.save(1, _state(1.0))            # torn: never committed
            assert mgr.all_steps() == []
            assert (tmp_path / "step_000000000001.tmp").exists()
            mgr.save(2, _state(2.0))            # fires exhausted: commits
        assert mgr.all_steps() == [2]
        # the second save's _gc swept the torn step_1 tmp dir
        assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
        torch.testing.assert_close(mgr.restore()["w"], _state(2.0)["w"])

    def test_injected_corrupt_write_caught_by_digest(self, tmp_path):
        plan = FaultPlan([FaultSpec("ckpt.write", "corrupt", max_fires=1)])
        with use_plan(plan):
            mgr = CheckpointManager(str(tmp_path), keep_last=4)
            mgr.save(1, _state(1.0))            # committed, then bit-rotted
            assert mgr.all_steps() == [1] and not mgr.verify(1)
            mgr.save(2, _state(2.0))
        assert mgr.latest_valid_step() == 2
        torch.testing.assert_close(mgr.restore()["w"], _state(2.0)["w"])

    def test_trainer_restarts_past_a_corrupt_commit(self, tmp_path):
        """A run whose newest checkpoint rotted resumes from the last valid
        one and, replaying the same batches, ends where a clean run ends;
        ``on_checkpoint`` sees every save."""
        saves = []
        cfg = TrainLoopConfig(total_steps=6, log_every=100, ckpt_every=2,
                              ckpt_dir=str(tmp_path / "a"), keep_last=5)
        plan = FaultPlan.parse("seed=0;ckpt.write:corrupt@1x1")
        tr = Trainer(_toy_loss, sgd(lr=0.1), cfg, _toy_init, device="cpu")
        with use_plan(FaultPlan([])):
            tr.run(_toy_batches, 0, stop_after=2, on_checkpoint=saves.append)
        with use_plan(plan):                    # step 4's commit rots
            tr.run(_toy_batches, 0, stop_after=2, on_checkpoint=saves.append)
        assert tr.ckpt.all_steps() == [2, 4]
        assert tr.ckpt.latest_valid_step() == 2
        state = tr.run(_toy_batches, 0, on_checkpoint=saves.append)
        assert saves == [2, 4, 4, 6]            # 4 saved again on replay
        clean = Trainer(_toy_loss, sgd(lr=0.1), TrainLoopConfig(
            total_steps=6, log_every=100), _toy_init, device="cpu").run(
            _toy_batches, 0)
        torch.testing.assert_close(state["params"]["w"],
                                   clean["params"]["w"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the engine: failure isolation + circuit breaker
# ---------------------------------------------------------------------------

def mk_request(uid: int, item_ids) -> ROOSample:
    return ROOSample(
        request_id=uid, user_id=uid,
        ro_dense=np.full((4,), float(uid), np.float32),
        ro_idlist=[uid % 7 + 1],
        history_ids=[1 + uid % 3, 2, 3], history_actions=[1, 0, 1],
        item_ids=[int(i) for i in item_ids],
        item_dense=[np.full((4,), float(i), np.float32) for i in item_ids],
        item_idlist=[[int(i) % 5 + 1] for i in item_ids],
        labels=[{"click": 0.0, "view_sec": 0.0} for _ in item_ids])


def echo_score_fn(params, batch):
    return batch.item_ids.to(torch.float32)


def small_engine(**kw):
    return ScoringEngine(None, echo_score_fn,
                         policy=EnginePolicy(max_requests=4,
                                             max_impressions=16, **kw),
                         device="cpu")


class TestEngineIsolation:
    def test_failed_batch_is_isolated(self):
        reqs = [mk_request(i, [10 * i, 10 * i + 1]) for i in range(8)]
        plan = FaultPlan([FaultSpec("engine.score", "error", max_fires=1)])
        with use_plan(plan):
            engine = small_engine()
            out = engine.score_requests(reqs)
        assert len(out) == 8
        failed = [i for i, s in enumerate(out) if isinstance(s, ScoreError)]
        healthy = [i for i in range(8) if i not in failed]
        assert failed and healthy                # blast radius = one batch
        for i in healthy:                        # survivors stay aligned
            np.testing.assert_array_equal(
                out[i], np.asarray(reqs[i].item_ids, np.float32))
        assert engine.stats.n_failed_batches == 1
        assert engine.stats.n_failed_requests == len(failed)

    def test_split_request_poisoned_not_truncated(self):
        # the failing piece poisons the whole request: a partial score
        # array misaligned with item_ids must never escape
        big = mk_request(1, list(range(40)))     # splits across batches
        plan = FaultPlan([FaultSpec("engine.score", "error", max_fires=1)])
        with use_plan(plan):
            (out,) = small_engine().score_requests([big])
        assert isinstance(out, ScoreError)

    def test_breaker_opens_sheds_and_recovers(self):
        t = [0.0]
        plan = FaultPlan([FaultSpec("engine.score", "error", max_fires=2)])
        with use_plan(plan):
            engine = ScoringEngine(
                None, echo_score_fn,
                policy=EnginePolicy(max_requests=4, max_impressions=16,
                                    breaker_threshold=2,
                                    breaker_cooldown_s=5.0),
                clock=lambda: t[0], device="cpu")
            r1 = engine.score_requests([mk_request(1, [1, 2])])[0]
            r2 = engine.score_requests([mk_request(2, [3, 4])])[0]
            assert isinstance(r1, ScoreError) and not r1.shed
            assert isinstance(r2, ScoreError) and not r2.shed
            assert engine.stats.n_breaker_opens == 1
            # open: work is shed without touching the model
            r3 = engine.score_requests([mk_request(3, [5, 6])])[0]
            assert isinstance(r3, ScoreError) and r3.shed
            assert engine.stats.n_shed_requests == 1
            assert plan.stats.visits["engine.score"] == 2   # batch 3 skipped
            # cooldown elapsed: half-open trial succeeds, breaker closes
            t[0] = 6.0
            r4 = engine.score_requests([mk_request(4, [7, 8])])[0]
            np.testing.assert_array_equal(r4, np.asarray([7., 8.],
                                                         np.float32))
            r5 = engine.score_requests([mk_request(5, [9])])[0]
            np.testing.assert_array_equal(r5, np.asarray([9.], np.float32))
        assert engine.stats.n_failed_batches == 2
        assert engine.stats.n_batches == 2

    def test_seeded_stream_fails_the_reference_engines_batches(self):
        """One plan string over the same stream: the port's engine and the
        reference's fail the same batches, so the same requests resolve
        to errors and every other score is equal."""
        import jax.numpy as jnp

        from repro.core.joiner import ROOSample as JaxSample
        from repro.serve.engine import EnginePolicy as JaxPolicy
        from repro.serve.engine import ScoreError as JaxError
        from repro.serve.engine import ScoringEngine as JaxEngine
        text = "seed=7;engine.score:error@0.25"
        reqs = [mk_request(i, range(i % 5 + 1)) for i in range(60)]
        with use_plan(FaultPlan.parse(text)):
            ours = small_engine(breaker_threshold=0).score_requests(reqs)
        with jax_faults.use_plan(jax_faults.FaultPlan.parse(text)):
            theirs = JaxEngine(
                None, lambda p, b: b.item_ids.astype(jnp.float32),
                policy=JaxPolicy(max_requests=4, max_impressions=16,
                                 breaker_threshold=0)).score_requests(
                [JaxSample(**vars(r)) for r in reqs])
        failed = [isinstance(s, ScoreError) for s in ours]
        assert failed == [isinstance(s, JaxError) for s in theirs]
        assert any(failed) and not all(failed)
        for s, t in zip(ours, theirs):
            if not isinstance(s, ScoreError):
                np.testing.assert_array_equal(s, np.asarray(t))


# ---------------------------------------------------------------------------
# trainer non-finite guard
# ---------------------------------------------------------------------------

def _toy_batches(start):
    for step in range(start, 10_000):
        yield torch.full((4,), 1.0 + 0.1 * step)


def _toy_loss(params, batch, gen):
    return torch.mean((params["w"] * batch - 1.0) ** 2)


def _toy_init():
    return {"w": torch.ones(4)}


class TestTrainerGuard:
    def test_nan_batches_skipped_params_unpoisoned(self):
        cfg = TrainLoopConfig(total_steps=6, log_every=100,
                              halt_after_skips=10)
        plan = FaultPlan([FaultSpec("train.batch", "nan", max_fires=2)])
        with use_plan(plan):
            tr = Trainer(_toy_loss, sgd(lr=0.1), cfg, _toy_init,
                         device="cpu")
            state = tr.run(_toy_batches, 0)
        assert tr.skipped_steps == 2
        w = state["params"]["w"]
        assert torch.isfinite(w).all()
        # steps 0 and 1 were frozen, so the final params equal applying
        # only steps 2..5 (same batches, same step seeds)
        opt = sgd(lr=0.1)
        step_fn = make_train_step(_toy_loss, opt)
        params = _toy_init()
        ref = {"params": params, "opt": opt.init(params),
               "step": torch.zeros((), dtype=torch.int32)}
        batches = list(b for _, b in zip(range(6), _toy_batches(0)))
        for step in range(2, 6):
            ref, _ = step_fn(ref, batches[step], 0, step)
        torch.testing.assert_close(w, ref["params"]["w"], rtol=0, atol=0)

    def test_consecutive_skips_halt(self):
        cfg = TrainLoopConfig(total_steps=50, log_every=100,
                              halt_after_skips=3)
        plan = FaultPlan([FaultSpec("train.batch", "nan")])   # every step
        with use_plan(plan):
            tr = Trainer(_toy_loss, sgd(lr=0.1), cfg, _toy_init,
                         device="cpu")
            with pytest.raises(NonFiniteLossError):
                tr.run(_toy_batches, 0)
        assert tr.skipped_steps == 3

    def test_guard_passive_by_default(self):
        cfg = TrainLoopConfig(total_steps=4, log_every=2)
        plan = FaultPlan([FaultSpec("train.batch", "nan", max_fires=1)])
        with use_plan(plan):
            tr = Trainer(_toy_loss, sgd(lr=0.1), cfg, _toy_init,
                         device="cpu")
            state = tr.run(_toy_batches, 0)
        assert torch.isfinite(state["params"]["w"]).all()
        assert tr.skipped_steps == 0            # counted only when halting
        assert [row["skipped"] for row in tr.history] == [0.0, 0.0]

    def test_poison_hits_the_first_float_leaf(self):
        """As the reference's ``_poison_batch``: the first float leaf in
        flatten order (dict keys sorted) turns to NaN, ints stay."""
        from repro_torch.train.loop import _poison_batch
        batch = {"y": torch.ones(3), "ids": torch.arange(3),
                 "dense": torch.zeros(2)}
        out = _poison_batch(batch)
        assert torch.isnan(out["dense"]).all()
        assert torch.equal(out["y"], batch["y"])
        assert torch.equal(out["ids"], batch["ids"])
