"""The port's observability layer (``repro_torch.obs``) held to the
reference's contracts (``tests/test_obs.py``): registry correctness, the
disabled mode as a no-op, Chrome trace JSON and nesting, trace ids through
a real ``ScoringEngine.score_stream``, one snapshot over the engine, the
stores, the Trainer and the fault plan, the JSONL emitter and the
structured logger. Two checks cross packages: the same records give the
same histogram buckets and quantiles in both, and the reference's report
reads a JSONL file the port wrote and prints what the port's prints.
"""
import importlib.util
import io
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import export as jax_export
from repro.obs import metrics as jax_metrics
from repro_torch.core.joiner import ROOSample
from repro_torch.obs import export as obs_export
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import OBS_KNOB, MetricsRegistry

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_state import port_state  # noqa: E402,F401

REFERENCE_REPORT = (Path(__file__).resolve().parents[1] / "src" / "repro"
                    / "obs" / "report.py")


def reference_report():
    """A private copy of the reference's ``repro/obs/report.py`` (standard
    library only), loaded from its file under another name: importing
    ``repro.obs.report`` itself would bind its ``summarize``'s default
    stream to this moment's ``sys.stdout``, which the reference's own
    test later expects to be the one it captures."""
    spec = importlib.util.spec_from_file_location("reference_obs_report",
                                                  REFERENCE_REPORT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def registry():
    return MetricsRegistry()


# the process-default rung, not OBS_KNOB.scoped: a ContextVar scope is
# invisible to worker threads (the concurrency test); port_state restores
@pytest.fixture
def metrics_on():
    OBS_KNOB.set_default("metrics")


@pytest.fixture
def trace_on():
    OBS_KNOB.set_default("trace")


class TestRegistry:
    def test_counter_and_labeled_series(self, registry, metrics_on):
        c = registry.counter("reqs")
        c.inc()
        c.inc(2)
        c.inc(5, site="a")
        c.inc(1, site="b")
        assert c.value() == 3
        assert c.value(site="a") == 5
        snap = registry.snapshot()["metrics"]["counters"]
        assert snap == {"reqs": 3, "reqs{site=a}": 5, "reqs{site=b}": 1}

    def test_gauge_last_write_wins(self, registry, metrics_on):
        g = registry.gauge("depth")
        g.set(3)
        g.set(7)
        assert g.value() == 7

    def test_histogram_bucketing(self, registry, metrics_on):
        h = registry.histogram("lat", buckets=(1.0, 10.0, 100.0))
        for v in (0.5, 0.9, 5.0, 50.0, 1e6):
            h.observe(v)
        snap = registry.snapshot()["metrics"]["histograms"]["lat"]
        assert snap["count"] == 5
        assert snap["buckets"] == {"le_1": 2, "le_10": 1, "le_100": 1}
        assert snap["overflow"] == 1
        assert snap["min"] == 0.5 and snap["max"] == 1e6
        assert h.quantile(0.5) == 10.0     # 3rd of 5 lands in the 10-bucket
        assert h.quantile(0.99) == 100.0   # overflow reports the ladder top

    def test_metric_type_collision_raises(self, registry):
        registry.counter("x")
        with pytest.raises(TypeError, match="already registered"):
            registry.gauge("x")

    def test_concurrent_increments_lose_nothing(self, registry, metrics_on):
        c = registry.counter("n")
        h = registry.histogram("h")

        def work():
            for _ in range(2000):
                c.inc()
                h.observe(1.0)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value() == 8 * 2000
        snap = registry.snapshot()["metrics"]["histograms"]["h"]
        assert snap["count"] == 8 * 2000
        assert snap["sum"] == pytest.approx(8 * 2000.0)

    def test_disabled_mode_records_nothing(self, registry):
        # default mode is off: gated records are dropped, ungated kept
        assert obs_metrics.mode() == "off"
        registry.counter("gated").inc(5)
        registry.histogram("lat").observe(1.0)
        registry.counter("always", gated=False).inc(2)
        m = registry.snapshot()["metrics"]
        assert m["counters"] == {"always": 2}
        assert m["histograms"] == {}

    def test_env_var_is_the_ports_own(self, monkeypatch):
        monkeypatch.setenv("REPRO_OBS", "trace")
        assert obs_metrics.mode() == "off"
        monkeypatch.setenv("REPRO_TORCH_OBS", "metrics")
        assert obs_metrics.mode() == "metrics"
        assert obs_metrics.metrics_enabled()

    def test_register_stats_weakref_lifetime(self, registry, metrics_on):
        class Stats:
            def snapshot(self):
                return {"n": 1}

        s = Stats()
        registry.register_stats("comp", s)
        assert registry.snapshot()["components"]["comp"] == {"n": 1}
        del s
        assert "comp" not in registry.snapshot()["components"]
        # callables are held strongly
        registry.register_stats("fn", lambda: {"k": 2})
        assert registry.snapshot()["components"]["fn"] == {"k": 2}

    def test_broken_mirror_does_not_kill_snapshot(self, registry):
        registry.register_stats("bad", lambda: 1 / 0)
        registry.counter("ok", gated=False).inc()
        snap = registry.snapshot()
        assert "error" in snap["components"]["bad"]
        assert snap["metrics"]["counters"]["ok"] == 1


# values on and between the default ladder's edges, under and over it
RECORDS = [0.0005, 0.001, 0.003, 0.0041, 0.016, 0.2, 0.25, 0.9, 1.0, 3.3,
           4.0, 15.0, 63.0, 64.0, 64.5, 249.0, 999.0, 3999.0, 15999.0,
           99999.0, 2e5, 7.0, 7.0, 0.05]


@pytest.mark.parametrize("n", [1, 5, len(RECORDS)])
def test_histograms_agree_with_the_reference(n):
    """The same records give the same snapshot (buckets, overflow, count,
    sum, min, max) and the same quantiles in both packages."""
    ours = MetricsRegistry().histogram("lat", gated=False)
    theirs = jax_metrics.MetricsRegistry().histogram("lat", gated=False)
    for v in RECORDS[:n]:
        ours.observe(v)
        theirs.observe(v)
    assert ours.buckets == theirs.buckets
    assert ours._snapshot() == theirs._snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)


class TestTrace:
    def test_disabled_span_is_shared_noop(self):
        assert obs_metrics.mode() == "off"
        s1, s2 = obs_trace.span("a"), obs_trace.span("b")
        assert s1 is s2                       # no allocation when off
        with s1:
            s1.set(k=1)                        # and args are swallowed
        obs_trace.instant("marker")
        assert obs_trace.get_tracer().events() == []

    def test_chrome_json_schema_and_nesting(self, trace_on, tmp_path):
        with obs_trace.span("outer", phase=1):
            with obs_trace.span("inner"):
                pass
            obs_trace.instant("mark", k="v")
        path = tmp_path / "trace.json"
        n = obs_trace.get_tracer().save(str(path))
        assert n == 3
        doc = json.loads(path.read_text())
        assert doc["displayTimeUnit"] == "ms"
        evs = {e["name"]: e for e in doc["traceEvents"]}
        assert evs["process_name"]["ph"] == "M"
        outer, inner, mark = evs["outer"], evs["inner"], evs["mark"]
        for e in (outer, inner):
            assert e["ph"] == "X"
            assert isinstance(e["ts"], int) and isinstance(e["dur"], int)
            assert e["dur"] >= 1
        assert mark["ph"] == "i" and mark["args"] == {"k": "v"}
        # nesting = time containment on one tid (how Perfetto renders it)
        assert inner["tid"] == outer["tid"]
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
        assert outer["args"] == {"phase": 1}

    def test_span_feeds_duration_histogram(self, trace_on):
        with obs_trace.span("phase.x"):
            pass
        h = obs_metrics.REGISTRY.histogram("span.phase.x")
        assert h._series[()].count >= 1

    def test_buffer_overflow_counts_drops(self):
        tracer = obs_trace.Tracer(max_events=2)
        before = obs_metrics.REGISTRY.counter(
            "trace.dropped_events", gated=False).value()
        with OBS_KNOB.scoped("trace"):
            for _ in range(5):
                tracer.instant("e")
        assert len(tracer.events()) == 2
        after = obs_metrics.REGISTRY.counter(
            "trace.dropped_events", gated=False).value()
        assert after - before == 3

    def test_traced_decorator(self, trace_on):
        @obs_trace.traced("deco.fn")
        def f(x):
            return x + 1

        assert f(1) == 2
        assert any(e["name"] == "deco.fn"
                   for e in obs_trace.get_tracer().events())

    def test_device_trace(self, tmp_path, trace_on):
        """``logdir=None`` is a no-op; with a directory the region's
        ``torch.profiler`` trace lands there as Chrome JSON (CPU ops
        here; the card's kernels on the card, chip_smoke.py), with the
        program's spans of the region beside them; a profiler already
        running makes it raise instead of yielding None."""
        with obs_trace.device_trace(None) as path:
            assert path is None
        with obs_trace.device_trace(str(tmp_path / "dev")) as path:
            with obs_trace.span("dev.region"):
                torch.ones(8).add_(1).sum()
        doc = json.loads(Path(path).read_text())
        assert Path(path).parent == tmp_path / "dev"
        assert doc["traceEvents"]
        assert [e["name"] for e in doc["traceEvents"]].count("dev.region") \
            == 1
        with pytest.raises(RuntimeError):
            with obs_trace.device_trace(str(tmp_path / "a")):
                with obs_trace.device_trace(str(tmp_path / "b")):
                    pass


def mk_request(uid, item_ids):
    return ROOSample(
        request_id=uid, user_id=uid,
        ro_dense=np.full((4,), float(uid), np.float32),
        ro_idlist=[uid % 7 + 1],
        history_ids=[1 + uid % 3, 2, 3], history_actions=[1, 0, 1],
        item_ids=[int(i) for i in item_ids],
        item_dense=[np.full((4,), float(i), np.float32) for i in item_ids],
        item_idlist=[[int(i) % 5 + 1] for i in item_ids],
        labels=[{"click": 0.0} for _ in item_ids])


def echo_score_fn(params, batch):
    return batch.item_ids.to(torch.float32)


class TestEngineTracePropagation:
    def test_trace_ids_thread_through_score_stream(self, trace_on):
        from repro_torch.serve.engine import EnginePolicy, ScoringEngine
        engine = ScoringEngine(
            None, echo_score_fn,
            policy=EnginePolicy(max_requests=4, max_impressions=16),
            device="cpu")
        reqs = [mk_request(i, list(range(1, 2 + i))) for i in range(6)]
        out = dict(engine.score_stream(reqs))
        assert len(out) == 6

        by_name = {}
        for e in obs_trace.get_tracer().events():
            by_name.setdefault(e["name"], []).append(e)
        admits = by_name["engine.admit"]
        assert len(admits) == 6
        admitted_ids = {e["args"]["trace_id"] for e in admits}
        assert len(admitted_ids) == 6          # unique id per request
        # every admitted id is carried by some scoring span ...
        scored_ids = set()
        for e in by_name["engine.score"]:
            scored_ids.update(e["args"]["trace_ids"])
        assert scored_ids == admitted_ids
        # ... and resolved exactly once at reassembly
        reassembled = [e["args"]["trace_id"]
                       for e in by_name["engine.reassemble"]]
        assert sorted(reassembled) == sorted(admitted_ids)
        # score spans nest inside their flush span, the bucket span too
        flush = by_name["engine.flush"][0]
        for name in ("engine.score", "engine.bucket"):
            inner = by_name[name][0]
            assert flush["ts"] <= inner["ts"]
            assert inner["ts"] + inner["dur"] <= flush["ts"] + flush["dur"]
        assert {"b_ro", "b_nro"} <= set(by_name["engine.bucket"][0]["args"])

    def test_one_snapshot_sees_the_whole_stack(self, metrics_on):
        """Serving (engine and both stores), training and the fault plan
        all hang off one ``obs.snapshot()`` call."""
        from repro_torch.serve.engine import ScoringEngine
        from repro_torch.serve.user_cache import (UserStateStore,
                                                  UserTowerCache)
        from repro_torch.train.loop import Trainer, TrainLoopConfig
        from repro_torch.train.optim import adam

        engine = ScoringEngine(None, echo_score_fn, device="cpu")
        ticket = engine.submit(mk_request(0, [1, 2, 3]))
        engine.flush()
        assert engine.take(ticket) is not None
        cache, store = UserTowerCache(8), UserStateStore(4)
        trainer = Trainer(
            lambda p, b, g: torch.sum(p["w"] * b),
            adam(1e-2), TrainLoopConfig(total_steps=1, log_every=1),
            lambda: {"w": torch.ones(2)}, device="cpu")
        trainer.run(lambda s: iter([torch.ones(2)]), 0)

        snap = obs_metrics.snapshot()
        comps = snap["components"]
        assert comps["serve.engine"]["stats"]["n_requests"] == 1
        assert comps["serve.user_cache"]["capacity"] == 8
        assert comps["serve.user_state"]["capacity"] == 4
        assert comps["train"]["last_step"] == 1
        assert comps["train"]["last_log"]["step"] == 1
        assert comps["reliability.faults"] == {"active": False}
        assert snap["metrics"]["histograms"][
            "engine.request_ms"]["count"] == 1
        del cache, store

    def test_train_spans_nest_without_a_sync(self, trace_on, monkeypatch):
        """train.step holds train.data and train.compute, which holds
        train.forward, train.backward and train.optimizer; logging and
        checkpoint steps add train.log / train.checkpoint. No span reads
        the device: the loop never calls ``torch.cuda.synchronize``."""
        from repro_torch.train.loop import Trainer, TrainLoopConfig
        from repro_torch.train.optim import sgd

        def no_sync(*a, **k):
            raise AssertionError("a span synchronized the card")
        monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
        trainer = Trainer(
            lambda p, b, g: torch.sum(p["w"] * b), sgd(0.1),
            TrainLoopConfig(total_steps=4, log_every=2, ckpt_every=4),
            lambda: {"w": torch.ones(2)}, device="cpu")
        trainer.run(lambda s: iter([torch.ones(2)] * 8), 0)
        names = [e["name"] for e in obs_trace.get_tracer().events()]
        assert names.count("train.step") == 4
        assert names.count("train.data") == names.count("train.compute") == 4
        assert names.count("train.log") == 2
        assert "train.checkpoint" not in names      # no ckpt_dir
        steps = [e for e in obs_trace.get_tracer().events()
                 if e["name"] == "train.step"]
        assert [e["args"]["step"] for e in steps] == [1, 2, 3, 4]
        assert_phases_nest(obs_trace.get_tracer().events(), 4, 1)

    @pytest.mark.parametrize("sparse", [False, True])
    @pytest.mark.parametrize("microbatches", [1, 2])
    def test_train_phase_spans(self, trace_on, monkeypatch, sparse,
                               microbatches):
        """Dense and sparse ``value_and_grad``, with and without
        microbatches: a forward and a backward span a microbatch and one
        optimizer span a step, all inside the step's train.compute, and
        no wait on the card or on an event."""
        from repro_torch.embeddings import collection as ec
        from repro_torch.embeddings.sparse import make_sparse_value_and_grad
        from repro_torch.train.loop import Trainer, TrainLoopConfig
        from repro_torch.train.optim import (adam, default_is_embedding,
                                             make_mixed, rowwise_adagrad)

        def no_wait(*a, **k):
            raise AssertionError("a span waited on the card")
        monkeypatch.setattr(torch.cuda, "synchronize", no_wait)
        monkeypatch.setattr(torch.cuda.Event, "synchronize", no_wait)

        def loss(p, b, g):
            e = ec.bag_lookup_dense(p["emb"], b["ids"], b["lens"], "sum")
            return torch.sum((e @ p["w"]) ** 2)
        gen = torch.Generator().manual_seed(0)
        mb = (microbatches,) if microbatches > 1 else ()
        batch = {"ids": torch.randint(0, 64, mb + (6, 3), generator=gen),
                 "lens": torch.full(mb + (6,), 3)}
        vag = make_sparse_value_and_grad(
            loss, lambda b: {"emb": b["ids"]}) if sparse else None
        trainer = Trainer(
            loss, make_mixed(adam(1e-2), rowwise_adagrad(1e-2),
                             default_is_embedding),
            TrainLoopConfig(total_steps=3, log_every=100,
                            microbatches=microbatches),
            lambda: {"emb": torch.randn(64, 4, generator=gen),
                     "w": torch.randn(4, generator=gen)},
            value_and_grad_fn=vag, device="cpu")
        trainer.run(lambda s: iter([batch] * 3), 0)
        assert_phases_nest(obs_trace.get_tracer().events(), 3, microbatches)


def assert_phases_nest(events, n_steps, microbatches):
    """Each train.compute holds ``microbatches`` train.forward /
    train.backward pairs, in that order, then one train.optimizer."""
    computes = [e for e in events if e["name"] == "train.compute"]
    assert len(computes) == n_steps
    for c in computes:
        inside = sorted((e for e in events
                         if e["name"] in ("train.forward", "train.backward",
                                          "train.optimizer")
                         and c["ts"] <= e["ts"]
                         and e["ts"] + e["dur"] <= c["ts"] + c["dur"]),
                        key=lambda e: e["ts"])
        assert [e["name"] for e in inside] == \
            ["train.forward", "train.backward"] * microbatches + \
            ["train.optimizer"]
        assert all("device_ms" not in e["args"] for e in inside)  # no card


class TestEmitter:
    def test_jsonl_round_trip(self, metrics_on, tmp_path):
        obs_metrics.counter("emit.test").inc(3)
        path = tmp_path / "t.jsonl"
        with obs_export.TelemetryEmitter(str(path),
                                         scenario_hash="abc123") as em:
            assert em.maybe_emit("unit")
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert len(lines) == 2                  # unit + shutdown
        assert [x["source"] for x in lines] == ["unit", "shutdown"]
        for x in lines:
            assert x["scenario_hash"] == "abc123"
            assert x["elapsed_s"] >= 0
            assert x["snapshot"]["metrics"]["counters"][
                "emit.test"] == 3

    def test_rate_limit(self, tmp_path):
        t = [0.0]
        em = obs_export.TelemetryEmitter(str(tmp_path / "t.jsonl"),
                                         every_s=10.0, clock=lambda: t[0])
        assert em.maybe_emit("a")
        t[0] = 5.0
        assert not em.maybe_emit("b")           # inside the window
        t[0] = 10.0
        assert em.maybe_emit("c")
        em.close(final_source=None)
        assert em.n_emitted == 2

    def test_module_install_point(self, tmp_path):
        assert not obs_export.maybe_emit("x")   # no emitter: cheap no-op
        em = obs_export.TelemetryEmitter(str(tmp_path / "t.jsonl"))
        prev = obs_export.install(em)
        try:
            assert prev is None
            assert obs_export.maybe_emit("x")
        finally:
            obs_export.install(prev)
            em.close()

    def test_report_summarizes(self, metrics_on, tmp_path, capsys):
        obs_metrics.histogram("span.demo").observe(2.0)
        path = tmp_path / "t.jsonl"
        with obs_export.TelemetryEmitter(str(path)) as em:
            em.emit("a")
        report.main([str(path)])
        out = capsys.readouterr().out
        assert "span.demo" in out and "p99" in out

    def test_reference_report_reads_the_ports_file(self, metrics_on,
                                                   tmp_path):
        """A JSONL file the port wrote (counters, gauges, span histograms,
        mirrors) reads in the reference's report and prints what the
        port's report prints; the line keys are the reference's."""
        path = tmp_path / "t.jsonl"
        with obs_export.TelemetryEmitter(str(path), scenario_hash="h") as em:
            obs_metrics.counter("reqs").inc(3, site="a")
            obs_metrics.gauge("depth").set(2)
            for v in (0.5, 2.0, 40.0):
                obs_metrics.histogram("span.engine.score").observe(v)
            em.emit("serve.flush")
            obs_metrics.counter("reqs").inc(4, site="a")
        theirs, ours = io.StringIO(), io.StringIO()
        jax_report = reference_report()
        assert "repro.obs.report" not in sys.modules
        jax_report.summarize(jax_report.load_lines(str(path)), out=theirs)
        report.summarize(report.load_lines(str(path)), out=ours)
        assert ours.getvalue() == theirs.getvalue()
        assert "span.engine.score" in ours.getvalue()
        line = json.loads(path.read_text().splitlines()[0])
        ref = jax_export.TelemetryEmitter(str(tmp_path / "ref.jsonl"))
        ref.close()
        ref_line = json.loads((tmp_path / "ref.jsonl").read_text())
        assert sorted(line) == sorted(ref_line)
        assert sorted(line["snapshot"]) == sorted(ref_line["snapshot"])


class TestLogging:
    def test_structured_line(self, capsys):
        log = obs_log.get_logger("demo")
        log.info("event", step=3, loss=0.5, msg="two words")
        assert capsys.readouterr().out == \
            "[demo] event step=3 loss=0.5 msg='two words'\n"

    def test_disabled_logger_keeps_errors(self, capsys):
        log = obs_log.get_logger("quiet", enabled=False)
        log.info("hidden")
        log.error("boom", code=1)
        cap = capsys.readouterr()
        assert cap.out == ""
        assert "[quiet] boom code=1" in cap.err

    def test_verbosity_gates_debug(self, capsys, monkeypatch):
        log = obs_log.get_logger("v")
        log.debug("nope")                       # default verbosity 1 < DEBUG
        assert capsys.readouterr().out == ""
        with obs_log.VERBOSITY_KNOB.scoped(2):
            log.debug("yes")
        assert "[v] yes" in capsys.readouterr().out
        monkeypatch.setenv("REPRO_TORCH_VERBOSITY", "0")
        log.info("silenced")
        assert capsys.readouterr().out == ""

    def test_warn_once_suppresses_and_counts(self):
        key = "test_torch_obs.warn_once.unit"
        obs_log.reset_warn_once(key)
        c = obs_metrics.REGISTRY.counter("warnings_suppressed", gated=False)
        before = c.value(key=key)
        with pytest.warns(UserWarning, match="first"):
            assert obs_log.warn_once(key, "first time")
        assert not obs_log.warn_once(key, "second time")   # no warning
        assert c.value(key=key) - before == 1

    def test_batcher_counts_dropped_impressions_ungated(self):
        from repro_torch.data.batcher import BatcherConfig, ROOBatcher
        assert obs_metrics.mode() == "off"
        batcher = ROOBatcher(BatcherConfig(b_ro=2, b_nro=4, hist_len=8),
                             device="cpu")
        with pytest.warns(UserWarning, match="dropped 3"):
            list(batcher.batches([mk_request(1, range(7))]))
        assert obs_metrics.REGISTRY.counter(
            "batcher.impressions_dropped", gated=False).value() == 3
