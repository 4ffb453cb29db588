"""The port's stateless scoring engine held against the reference's engine.

Both engines get the same requests, the same admission policy and the same
fake clock; an item-id echo model makes any misalignment visible exactly.
Checked: aligned results of the online front end (submit / poll / flush /
take) and the bulk front end, flush and bucket counters, oversize splits,
failure isolation with ``ScoreError`` and the circuit breaker, the
``use_backend`` scope around each batch, and the adapter entry point.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import joiner as jax_joiner
from repro.serve import engine as jax_engine
from repro_torch.core import joiner
from repro_torch.kernels import dispatch
from repro_torch.serve import engine
from repro_torch.serve.adapter import ServeAdapter
from repro_torch.serve.bucketing import BucketLadder


def mk_request(make, uid, item_ids):
    return make(
        request_id=uid, user_id=uid,
        ro_dense=np.full((4,), float(uid), np.float32), ro_idlist=[uid % 7 + 1],
        history_ids=[1 + uid % 3, 2, 3], history_actions=[1, 0, 1],
        item_ids=[int(i) for i in item_ids],
        item_dense=[np.full((4,), float(i), np.float32) for i in item_ids],
        item_idlist=[[int(i) % 5 + 1] for i in item_ids],
        labels=[{"click": 0.0, "view_sec": 0.0} for _ in item_ids])


ITEMS = [[5, 6, 7], [], [11], list(range(20, 45)), [30, 31], [], [9] * 4,
         list(range(100, 107))]


def requests(make):
    return [mk_request(make, uid, ids) for uid, ids in enumerate(ITEMS)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def port_echo(params, batch):
    ids = batch.item_ids.to(torch.float32)
    return torch.stack([ids, -ids], dim=-1)


def jax_echo(params, batch):
    ids = batch.item_ids.astype(jnp.float32)
    return jnp.stack([ids, -ids], axis=-1)


def engines(port_fn=port_echo, jax_fn=jax_echo, **policy):
    kw = dict(max_requests=4, max_impressions=16, max_delay_ms=5.0,
              hist_len=8, **policy)
    ladder = dict(min_b_ro=2, min_b_nro=8, max_b_ro=4, max_b_nro=16)
    pc, jc = FakeClock(), FakeClock()
    port = engine.ScoringEngine(
        None, port_fn, policy=engine.EnginePolicy(**kw),
        ladder=BucketLadder.geometric(**ladder), device="cpu", clock=pc)
    ref = jax_engine.ScoringEngine(
        None, jax_fn, policy=jax_engine.EnginePolicy(**kw),
        ladder=jax_engine.BucketLadder.geometric(**ladder), clock=jc)
    return port, pc, ref, jc


def stats(eng):
    snap = eng.stats.snapshot()
    return {k: snap[k] for k in (
        "n_requests", "n_impressions", "n_batches", "n_split_requests",
        "n_size_flushes", "n_deadline_flushes", "n_forced_flushes",
        "n_failed_batches", "n_failed_requests", "n_shed_requests",
        "n_breaker_opens", "buckets")}


def outcome(x):
    if isinstance(x, (engine.ScoreError, jax_engine.ScoreError)):
        return ("error", x.shed)
    return ("scores", np.asarray(x).tolist())


def test_bulk_scoring_matches_reference():
    port, _, ref, _ = engines()
    got = port.score_requests(requests(joiner.ROOSample))
    want = ref.score_requests(requests(jax_joiner.ROOSample))
    for ids, g, w in zip(ITEMS, got, want):
        assert g.shape == (len(ids), 2)
        np.testing.assert_array_equal(g[:, 0], np.asarray(ids, np.float32))
        np.testing.assert_array_equal(g, np.asarray(w))
    assert stats(port) == stats(ref)
    assert port.stats.n_split_requests == 1          # 25 items > 16 slots


def test_online_front_end_matches_reference():
    port, pc, ref, jc = engines()
    trace = []
    for eng, clock, make in ((port, pc, joiner.ROOSample),
                             (ref, jc, jax_joiner.ROOSample)):
        reqs = requests(make)
        tickets = [eng.submit(r) for r in reqs[:2]]
        polled = [eng.poll()]                     # under size and deadline
        clock.t = 0.010                           # past the 5 ms deadline
        polled.append(eng.poll())
        tickets += [eng.submit(r) for r in reqs[2:7]]   # 5 >= max_requests
        polled.append(eng.poll())
        tickets += [eng.submit(r) for r in reqs[7:]]
        polled.append(eng.poll())
        eng.flush()
        results = [outcome(eng.take(t)) for t in tickets]
        assert eng.take(tickets[0]) is None       # a ticket redeems once
        trace.append((polled, results, stats(eng)))
    assert trace[0] == trace[1]
    polled, results, st = trace[0]
    assert polled == [False, True, True, False]
    assert st["n_deadline_flushes"] == st["n_size_flushes"] == 1
    assert st["n_forced_flushes"] == 1
    assert results[3] == ("scores", [[float(i), -float(i)]
                                     for i in ITEMS[3]])


def test_failures_isolate_and_breaker_matches_reference():
    def failing(fn, n_fail):
        calls = {"n": 0}

        def score(params, batch):
            calls["n"] += 1
            if calls["n"] <= n_fail:
                raise RuntimeError("injected")
            return fn(params, batch)
        return score

    port, pc, ref, jc = engines(failing(port_echo, 3), failing(jax_echo, 3),
                                breaker_threshold=2, breaker_cooldown_s=1.0)
    trace = []
    for eng, clock, make in ((port, pc, joiner.ROOSample),
                             (ref, jc, jax_joiner.ROOSample)):
        first = [outcome(x) for x in eng.score_requests(requests(make))]
        clock.t = 5.0               # cooldown over: the trial batch fails
        second = [outcome(x) for x in eng.score_requests(requests(make))]
        clock.t = 10.0              # next trial succeeds and closes it
        third = [outcome(x) for x in eng.score_requests(requests(make))]
        trace.append((first, second, third, stats(eng)))
    assert trace[0] == trace[1]
    first, second, third, st = trace[0]
    assert ("error", False) in first and ("error", True) in first
    assert ("error", False) in second and ("error", True) in second
    assert st["n_failed_batches"] == 3 and st["n_breaker_opens"] == 2
    assert st["n_shed_requests"] > 0
    assert all(kind == "scores" for kind, _ in third)


def test_backend_scope_wraps_each_batch(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    seen = []

    def score(params, batch):
        seen.append(dispatch.resolve_backend(None, batch.item_ids.device))
        return port_echo(params, batch)

    for backend, want in (("torch-dense", "torch-dense"),
                          (None, "torch-chunked")):
        seen.clear()
        eng = engine.ScoringEngine(None, score, attn_backend=backend,
                                   device="cpu")
        eng.score_requests(requests(joiner.ROOSample))
        assert seen and set(seen) == {want}
    assert dispatch.resolve_backend(None, torch.device("cpu")) != \
        "torch-dense"                              # the scope was left


def test_adapter_entry_point():
    eng = engine.ScoringEngine(None, adapter=ServeAdapter(score=port_echo),
                               device="cpu")
    out = eng.score_requests(requests(joiner.ROOSample))
    assert [o.shape[0] for o in out] == [len(ids) for ids in ITEMS]
    assert not ServeAdapter(score=port_echo).supports_incremental
    with pytest.raises(ValueError):
        engine.ScoringEngine(None, device="cpu")


@pytest.mark.parametrize("cap", [1, 4, 25, 100])
def test_split_oversize_matches_reference(cap):
    big = requests(joiner.ROOSample)[3]
    jbig = requests(jax_joiner.ROOSample)[3]
    got = engine.split_oversize(big, cap)
    want = jax_engine.split_oversize(jbig, cap)
    assert [p.item_ids for p in got] == [p.item_ids for p in want]
    assert sum(p.num_impressions for p in got) == big.num_impressions
