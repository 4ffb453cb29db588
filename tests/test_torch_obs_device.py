"""Device-timed spans, the sync counter and the profiler's clock
(``repro_torch.obs.trace``), and the benchmark's readers of them
(``roobench/metrics``).

On the CPU a fake card stands in for ``torch.cuda``: its events complete
when a test says so, and anything that would wait on it raises. The test
marked ``chip`` runs dlrm sparse-row steps traced on a CUDA card and skips
without one; this file imports no JAX, so it runs there as

    PYTHONPATH=src python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_obs_device.py -m chip
"""
import json
import statistics
import sys
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import OBS_KNOB

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_state import port_state  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from roobench import harness  # noqa: E402
from roobench.trace import DeviceTrace  # noqa: E402


def no_wait(*a, **k):
    raise AssertionError("the tracer waited on the card")


class FakeCard:
    """``torch.cuda`` as the tracer uses it: timing events that complete
    when ``finish`` says, a sync debug mode, and no wait of any kind."""

    def __init__(self):
        self.clock = 0.0                # the card's time, ms
        self.made = 0
        self.recorded = []
        self.mode = 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                card.made += 1
                self.at, self.done = None, True

            def record(self, stream=None):
                self.at, self.done = card.clock, False
                card.recorded.append(self)

            def query(self):
                return self.done

            def elapsed_time(self, end):
                assert self.done and end.done, "elapsed_time on a pending event"
                return end.at - self.at

            synchronize = no_wait

        self.Event = Event

    def finish(self, n=None):
        """The card reaches the first ``n`` recorded events (all of them by
        default)."""
        n = len(self.recorded) if n is None else n
        for ev in self.recorded[:n]:
            ev.done = True
        self.recorded = self.recorded[n:]

    def get_sync_debug_mode(self):
        return self.mode

    def set_sync_debug_mode(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)

    synchronize = no_wait


@pytest.fixture
def trace_on():
    OBS_KNOB.set_default("trace")


@pytest.fixture
def card(monkeypatch):
    fake = FakeCard()
    tracer = obs_trace.get_tracer()
    tracer._pool.clear()                 # another fake card's events
    monkeypatch.setattr(obs_trace, "_card", lambda: fake)
    monkeypatch.setattr(torch.cuda, "synchronize", no_wait)
    yield fake
    tracer._stop_syncs()
    tracer.clear()
    tracer._pool.clear()


def named(name):
    return [e for e in obs_trace.get_tracer().events() if e["name"] == name]


# ---------------------------------------------------------------------------
# device_ms
# ---------------------------------------------------------------------------

def test_device_ms_fills_in_once_the_card_gets_there(card, trace_on):
    with obs_trace.span("phase", device=True, k=1):
        card.clock += 2.5
    assert "device_ms" not in named("phase")[0]["args"]      # still pending
    card.finish()
    (ev,) = named("phase")
    assert ev["args"] == {"k": 1, "device_ms": 2.5}
    assert ev["dur"] >= 1


def test_a_pending_span_stays_pending(card, trace_on, tmp_path):
    for ms in (1.0, 3.0):
        with obs_trace.span("phase", device=True):
            card.clock += ms
    card.finish(2)                       # the first span's pair only
    first, second = named("phase")
    assert first["args"]["device_ms"] == 1.0
    assert "device_ms" not in second["args"]
    tracer = obs_trace.get_tracer()
    doc = tracer.to_chrome()
    assert tracer.save(str(tmp_path / "t.json")) == 2
    assert "device_ms" not in doc["traceEvents"][-1]["args"]
    card.finish()
    assert named("phase")[1]["args"]["device_ms"] == 3.0


def test_spans_reuse_the_pools_events(card, trace_on):
    for _ in range(20):
        with obs_trace.span("phase", device=True):
            card.clock += 1.0
        card.finish()
        obs_trace.get_tracer().events()
    assert card.made == 2
    # without a reader, closing spans resolve what the card has reached
    for _ in range(3 * obs_trace.RESOLVE_EVERY):
        with obs_trace.span("phase", device=True):
            pass
        card.finish()
    assert card.made <= 2 * obs_trace.RESOLVE_EVERY + 2


def test_a_full_buffer_drops_the_span_and_hands_back_its_events(card,
                                                                trace_on):
    tracer = obs_trace.Tracer(max_events=2)
    dropped = obs_metrics.REGISTRY.counter("trace.dropped_events",
                                           gated=False)
    before = dropped.value()
    for _ in range(5):
        with tracer.span("phase", device=True):
            pass
    assert dropped.value() - before == 3
    assert len(tracer._pending) == 2 and len(tracer._pool) == 2
    card.finish()
    assert all("device_ms" in e["args"] for e in tracer.events())


@pytest.mark.parametrize("mode", ["off", "metrics"])
def test_out_of_trace_mode_a_device_span_is_the_shared_no_op(monkeypatch,
                                                             mode):
    OBS_KNOB.set_default(mode)

    def no_card():
        raise AssertionError("a CUDA call out of trace mode")
    monkeypatch.setattr(obs_trace, "_card", no_card)
    monkeypatch.setattr(torch.cuda, "Event", no_card)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", no_card)
    span = obs_trace.span("phase", device=True, k=1)
    assert span is obs_trace._NULL_SPAN
    with span:
        pass
    assert obs_trace.get_tracer().events() == []
    assert not obs_trace.get_tracer().counting_syncs


def test_leaving_trace_mode_restores_the_sync_debug_mode(card):
    show, filters = warnings.showwarning, list(warnings.filters)
    card.mode = 2
    OBS_KNOB.set_default("trace")
    with obs_trace.span("phase"):
        assert card.mode == 1            # warn
    assert obs_trace.get_tracer().counting_syncs
    OBS_KNOB.set_default("off")
    obs_trace.span("phase")
    assert card.mode == 2
    assert not obs_trace.get_tracer().counting_syncs
    assert warnings.showwarning is show and warnings.filters == filters


# ---------------------------------------------------------------------------
# syncs
# ---------------------------------------------------------------------------

def sync_warning():
    warnings.warn(obs_trace.SYNC_WARNING + " (Triggered internally at "
                  "CUDAFunctions.cpp:1)", UserWarning)


def test_syncs_count_on_the_innermost_open_span(card, trace_on, recwarn):
    with obs_trace.span("outer"):
        sync_warning()
        with obs_trace.span("inner", device=True):
            for _ in range(2):
                sync_warning()           # the same line counts each time
            warnings.warn("something else", UserWarning)
        with obs_trace.span("quiet"):
            pass
    assert named("outer")[0]["args"] == {"syncs": 1}
    assert named("inner")[0]["args"] == {"syncs": 2}
    assert named("quiet")[0]["args"] == {}
    assert obs_metrics.REGISTRY.counter("cuda.syncs").value() == 3
    # other warnings pass through, the counted ones are not shown
    assert [str(w.message) for w in recwarn] == ["something else"]


def test_a_sync_after_trace_mode_ends_restores_and_is_not_counted(card,
                                                                  recwarn):
    OBS_KNOB.set_default("trace")
    with obs_trace.span("phase"):
        pass
    OBS_KNOB.set_default("off")
    sync_warning()
    assert card.mode == 0 and not obs_trace.get_tracer().counting_syncs
    assert obs_metrics.REGISTRY.counter("cuda.syncs").value() == 0
    assert len(recwarn) == 0


# ---------------------------------------------------------------------------
# the profiler's clock
# ---------------------------------------------------------------------------

def test_span_times_land_on_the_profilers_clock(trace_on):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs_trace.span("clock"):
            with record_function("clock-inside"):
                torch.ones(256).cumsum(0).sum()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "clock-inside"]
    (sp,) = named("clock")
    tracer = obs_trace.get_tracer()
    start = tracer.profiler_ns(sp["ts"])
    end = tracer.profiler_ns(sp["ts"] + sp["dur"])
    assert abs(start - ev.start_ns()) < 1e6
    assert abs(end - (ev.start_ns() + ev.duration_ns())) < 1e6
    assert start <= end


def test_the_chrome_trace_carries_the_clock_anchors(trace_on):
    with obs_trace.span("phase"):
        pass
    anchors = obs_trace.get_tracer().to_chrome()["otherData"][
        "clock_anchors"]
    assert anchors and all(len(a) == 2 for a in anchors)
    perf_ns, unix_ns = anchors[-1]
    assert unix_ns > 1.5e18 and perf_ns < unix_ns


def test_device_trace_puts_the_programs_spans_beside_the_profilers(
        trace_on, tmp_path):
    with obs_trace.device_trace(str(tmp_path)) as path:
        with obs_trace.span("region.phase", k=3):
            with record_function("region-inside"):
                torch.ones(256).cumsum(0).sum()
    events = json.loads(Path(path).read_text())["traceEvents"]
    (inside,) = [e for e in events if e.get("name") == "region-inside"]
    (phase,) = [e for e in events if e.get("name") == "region.phase"]
    assert phase["args"] == {"k": 3}
    assert abs(phase["ts"] - inside["ts"]) < 1e3                 # us
    assert abs(phase["ts"] + phase["dur"]
               - inside["ts"] - inside["dur"]) < 1e3


def test_device_trace_fails_loudly(monkeypatch, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="already running"):
            with obs_trace.device_trace(str(tmp_path / "a")):
                pass

    class SilentProfiler:
        """A profiler on a card that saw nothing of it."""

        def __init__(self, activities):
            assert ProfilerActivity.CUDA in activities
            self.profiler = type("R", (), {"kineto_results": type(
                "K", (), {"events": staticmethod(lambda: [])})()})()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            Path(path).write_text('{"traceEvents": []}')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "profile", SilentProfiler)
    with pytest.raises(RuntimeError, match="no device activity"):
        with obs_trace.device_trace(str(tmp_path / "b")):
            pass


# ---------------------------------------------------------------------------
# the readers, on hand-built layers
# ---------------------------------------------------------------------------

def ev(name, ts, dur, **args):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "args": args}


def two_steps():
    """Two steps of 1,000 us; the second's backward holds a merge whose
    span carries another thread's id, and a span the card has not timed
    sits in a third step."""
    spans = []
    for k, (fwd, bwd, opt, merge) in enumerate([(2.0, 5.0, 1.0, 3.0),
                                                (4.0, 7.0, 1.5, 4.0)]):
        t = 10_000 * (k + 1)
        spans += [ev("train.step", t, 1000),
                  ev("train.data", t, 100),
                  ev("train.compute", t + 100, 800, syncs=1),
                  ev("train.forward", t + 110, 200, device_ms=fwd / 2),
                  ev("train.forward", t + 320, 100, device_ms=fwd / 2,
                     syncs=2),
                  ev("train.backward", t + 450, 300, device_ms=bwd),
                  {**ev("sparse.to_dense", t + 460, 50, device_ms=merge,
                        route="index_put", n_ids=8192), "tid": 7},
                  ev("train.optimizer", t + 760, 100, device_ms=opt)]
    spans += [ev("train.step", 30_000, 1000),
              ev("train.forward", 30_010, 100),
              ev("train.forward", 40_010, 100, device_ms=9.0, syncs=5)]
    return spans


def read(metric, **layer):
    return harness.load_reader(metric).read(harness.Layer(
        trace=layer.get("trace"), spans=layer.get("spans", []),
        counts={}))


@pytest.mark.parametrize("metric,want", [
    ("forward_ms.train", 3.0), ("backward_ms.train", 6.0),
    ("optimizer_ms.train", 1.25), ("to_dense_ms.train", 3.5)])
def test_phase_readers_take_the_median_step(metric, want):
    assert read(metric, spans=two_steps()) == want
    assert read(metric, spans=[ev("train.forward", 0, 10, device_ms=1.0)]) \
        is None                          # no step around it


def test_host_syncs_reader_counts_inside_the_steps(card, trace_on):
    spans = two_steps()
    # no sync count from a program that does not count them
    assert read("host_syncs.train", spans=spans) is None
    with obs_trace.span("phase"):        # the counter starts
        pass
    # 3 syncs a step in the first two, none in the third; the span past
    # every step is not counted
    assert read("host_syncs.train", spans=spans) == 2.0


def test_host_dispatch_reader_takes_the_runtime_out(trace_on):
    tracer = obs_trace.get_tracer()
    with obs_trace.span("phase"):        # an anchor
        pass
    spans = two_steps()
    to_prof = tracer.profiler_ns
    calls = []
    for k, blocked_us in ((1, 300), (2, 500)):
        lo = to_prof(10_000 * k + 100)
        calls += [("cudaStreamSynchronize", lo + 10_000,
                   lo + 10_000 + blocked_us * 1000),
                  ("aten::index", lo, lo + 700_000),             # not runtime
                  ("cudaLaunchKernel", lo + 600_000, lo + 605_000)]
    trace = DeviceTrace([("kernel", 0, 1)], calls, 1.0)
    # 0.8 ms of train.compute less 0.305 and 0.505 ms of runtime calls
    got = read("host_dispatch_ms.train", spans=spans, trace=trace)
    assert got == pytest.approx(statistics.median([0.495, 0.295]))
    assert read("host_dispatch_ms.train", spans=spans) is None


def test_interaction_reader_keeps_the_window_spans(card, trace_on):
    tracer = obs_trace.get_tracer()
    for ms in (1.0, 2.0, 4.0, 8.0):
        with obs_trace.span("dlrm.interaction", device=True):
            card.clock += ms
    card.finish()
    spans = named("dlrm.interaction")
    to_prof = tracer.profiler_ns
    # the window's host ops cover the last three spans only
    lo = to_prof(spans[1]["ts"]) - 1000
    hi = to_prof(spans[-1]["ts"] + spans[-1]["dur"]) + 1000
    trace = DeviceTrace([("kernel", lo, hi)], [("aten::mm", lo, hi)], 1.0)
    assert read("interaction_ms.score", trace=trace) == 4.0
    assert read("interaction_ms.score") is None


def test_train_phase_readers_on_a_traced_cpu_run(card, trace_on):
    """A few dlrm sparse-row steps through the Trainer with the fake card
    timing: every trainer reader finds its spans in the window."""
    from repro_torch.configs.registry import scenario
    from repro_torch.embeddings.sparse import make_sparse_value_and_grad
    from repro_torch.models import dlrm
    from repro_torch.scenario.build import synthetic_dlrm_batches
    from repro_torch.train import loop, metrics, optim

    cfg = dlrm.DLRMConfig(n_dense=4, embed_dim=16, bot_mlp=(4, 32, 16),
                          top_mlp=(64, 32, 1), vocabs=(512, 256, 64, 32),
                          n_ro_fields=2, multi_hot=2)
    spec = scenario("dlrm-mlperf", {"data.seed": 0, "batcher.b_ro": 8,
                                    "batcher.b_nro": 32})
    batches = synthetic_dlrm_batches(spec, cfg, 2, "cpu")

    def loss(p, b, g):
        return metrics.bce(dlrm.dlrm_forward_roo(
            p, cfg, b["ro_dense"], b["ro_ids"], b["ro_len"], b["nro_ids"],
            b["nro_len"], b["seg"]), b["y"])

    def feed(start):
        for k in range(start, 4):
            card.clock += 10.0
            card.finish()
            yield batches[k % 2]
    trainer = loop.Trainer(
        loss, optim.make_mixed(optim.adam(1e-3), optim.rowwise_adagrad(1e-2),
                               optim.default_is_embedding),
        loop.TrainLoopConfig(total_steps=4, log_every=100),
        lambda: dlrm.dlrm_init(torch.Generator().manual_seed(0), cfg,
                               device="cpu"),
        value_and_grad_fn=make_sparse_value_and_grad(
            loss, lambda b: dlrm.dlrm_table_ids(cfg, b["ro_ids"],
                                                b["nro_ids"])),
        device="cpu")
    trainer.run(feed, 0)
    card.finish()
    spans = [e for e in obs_trace.get_tracer().events() if e["ph"] == "X"]
    for metric in ("forward_ms.train", "backward_ms.train",
                   "optimizer_ms.train"):
        assert read(metric, spans=spans) == 0.0       # the clock stood
    assert read("host_syncs.train", spans=spans) == 0.0
    assert len([s for s in spans if s["name"] == "dlrm.forward"]) == 4


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# CUDA runtime calls that block the host until the card is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
def test_host_syncs_match_the_profilers_sync_calls(cuda_card, trace_on):
    """dlrm sparse-row steps traced on the card: ``host_syncs.train`` equals
    the synchronising CUDA runtime calls the profiler saw inside the steps,
    and the phases' device time fits in the steps."""
    from repro_torch.configs.registry import scenario
    from repro_torch.embeddings.sparse import make_sparse_value_and_grad
    from repro_torch.models import dlrm
    from repro_torch.scenario.build import synthetic_dlrm_batches
    from repro_torch.train import loop, metrics, optim

    cfg = dlrm.DLRMConfig(n_dense=13, embed_dim=64, bot_mlp=(13, 128, 64),
                          top_mlp=(256, 128, 1),
                          vocabs=(4096, 100_000, 50, 100_000),
                          n_ro_fields=2, multi_hot=1)
    spec = scenario("dlrm-mlperf", {"data.seed": 0, "batcher.b_ro": 1024,
                                    "batcher.b_nro": 8192})
    batches = synthetic_dlrm_batches(spec, cfg, 2, "cuda")

    def loss(p, b, g):
        return metrics.bce(dlrm.dlrm_forward_roo(
            p, cfg, b["ro_dense"], b["ro_ids"], b["ro_len"], b["nro_ids"],
            b["nro_len"], b["seg"]), b["y"])
    trainer = loop.Trainer(
        loss, optim.make_mixed(optim.adam(1e-3), optim.rowwise_adagrad(1e-2),
                               optim.default_is_embedding),
        # logging steps read the step's metrics back: syncs to count
        loop.TrainLoopConfig(total_steps=8, log_every=2),
        lambda: dlrm.dlrm_init(torch.Generator("cuda").manual_seed(0), cfg,
                               device="cuda"),
        value_and_grad_fn=make_sparse_value_and_grad(
            loss, lambda b: dlrm.dlrm_table_ids(cfg, b["ro_ids"],
                                                b["nro_ids"])),
        device="cuda")

    def feed(start):
        yield from (batches[k % 2] for k in range(start, 8))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(feed, 0)
        torch.cuda.synchronize()
    from roobench.trace import read_profile
    trace = read_profile(prof, 1.0)
    tracer = obs_trace.get_tracer()
    spans = [e for e in tracer.events() if e["ph"] == "X"]
    steps = [s for s in spans if s["name"] == "train.step"][2:]   # warm
    inside = [s for s in spans if any(
        st["ts"] <= s["ts"] and s["ts"] + s["dur"] <= st["ts"] + st["dur"]
        for st in steps)]
    calls = []
    for st in steps:
        lo = tracer.profiler_ns(st["ts"])
        hi = tracer.profiler_ns(st["ts"] + st["dur"])
        calls += [n for n, s, e in trace.host_ops
                  if n in SYNC_CALLS and lo <= s and e <= hi]
    counted = sum(s["args"].get("syncs", 0) for s in inside)
    print(f"syncs counted {counted}, profiler's sync calls {len(calls)} "
          f"({sorted(set(calls))}) over {len(steps)} steps; per span: "
          f"{sorted({(s['name'], s['args']['syncs']) for s in inside if 'syncs' in s['args']})}")
    layer = harness.Layer(trace=trace, spans=[s for s in spans
                                              if s in steps or s in inside],
                          counts={})
    got = harness.load_reader("host_syncs.train").read(layer)
    assert got == counted / len(steps)
    assert counted == len(calls) and counted >= len(steps) // 2
    phases = [harness.load_reader(m).read(layer) for m in (
        "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
        "to_dense_ms.train")]
    step_ms = statistics.median(s["dur"] / 1e3 for s in steps)
    print(f"phases (forward, backward, optimizer, to_dense) ms {phases}; "
          f"step {step_ms} ms")
    assert all(p is not None and p > 0 for p in phases)
    assert phases[3] <= phases[1]
