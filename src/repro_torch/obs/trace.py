"""Span tracing on monotonic clocks, exported as Chrome trace-event JSON
(torch port of ``repro/obs/trace.py``).

A *span* is one timed phase — ``with span("engine.score", trace_id=7):``
or ``@traced("train.step")`` — recorded as a Chrome *complete* event
(``ph: "X"``) with microsecond ``ts``/``dur`` from ``perf_counter_ns``.
Spans on the same thread nest by time containment, which is exactly how
Perfetto / chrome://tracing renders call trees, so the engine's
``engine.flush > engine.bucket / engine.score`` and the trainer's
``train.step > train.data / train.compute`` show up as nested bars with
no parent-pointer bookkeeping on the record path.

Trace IDs: the engine stamps every admitted request with an id from
:func:`new_trace_id` and threads it through the span ``args`` of every
phase that touches the request (admission -> bucket -> score ->
reassembly), so a p99 request found in the trace can be followed across
batches — including requests split over several batches.

Every closed span also feeds the metrics histogram ``span.<name>``
(milliseconds), which is what ``repro_torch.obs.report`` derives per-phase
rates/p50/p99 from without re-parsing trace JSON.

Cost: when the obs mode is not ``trace`` (knob ladder, see
``repro_torch.obs.metrics``), :func:`span` returns a shared no-op context
manager — one knob resolve, no allocation. The event buffer is bounded
(``max_events``); overflow drops new events and counts them in the
``trace.dropped_events`` counter instead of growing without bound.

Spans time the host only: none synchronizes the card, so a span around
a training step's dispatch (``train.compute``) measures dispatch, as the
reference's does. ``device_trace`` brackets a region with
``torch.profiler`` (the CUDA activity when a card is present) and writes
its Chrome trace into a directory, so the card's kernels land beside the
host spans.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs import metrics

# process-unique, thread-safe request/trace id source (itertools.count is
# atomic under the GIL)
_TRACE_IDS = itertools.count(1)


def new_trace_id() -> int:
    return next(_TRACE_IDS)


def tracing_enabled() -> bool:
    return metrics.mode() == "trace"


class _NullSpan:
    """Shared no-op context manager — the disabled-mode fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args) -> None:
        """Attach/overwrite args while the span is open."""
        self.args.update(args)

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0
        self._tracer._record_complete(self.name, self.cat, self._t0,
                                      dur_ns, self.args)
        metrics.histogram("span." + self.name).observe(dur_ns / 1e6)
        return False


class Tracer:
    """Bounded, thread-safe buffer of Chrome trace events."""

    def __init__(self, max_events: int = 200_000):
        self.max_events = max_events
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()

    # -- recording --------------------------------------------------------------
    def span(self, name: str, cat: str = "repro", **args):
        """Context manager timing one phase; no-op unless mode=trace."""
        if not tracing_enabled():
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        """Zero-duration marker (e.g. per-request admission)."""
        if not tracing_enabled():
            return
        self._push({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": time.perf_counter_ns() // 1000,
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": args})

    def _record_complete(self, name: str, cat: str, t0_ns: int,
                         dur_ns: int, args: Dict[str, Any]) -> None:
        self._push({"name": name, "cat": cat, "ph": "X",
                    "ts": t0_ns // 1000, "dur": max(dur_ns // 1000, 1),
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": args})

    def _push(self, event: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                metrics.counter("trace.dropped_events", gated=False).inc()
                return
            self._events.append(event)

    # -- export -----------------------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": "repro"}}]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> int:
        """Write the trace; returns the number of (non-meta) events."""
        events = self.to_chrome()
        with open(path, "w") as f:
            json.dump(events, f)
        return len(events["traceEvents"]) - 1


# the process tracer every instrumented module records into
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, cat: str = "repro", **args):
    return _TRACER.span(name, cat, **args)


def instant(name: str, cat: str = "repro", **args) -> None:
    _TRACER.instant(name, cat, **args)


def traced(name: Optional[str] = None, cat: str = "repro"):
    """Decorator form: time every call of ``fn`` as a span."""
    def deco(fn):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with _TRACER.span(span_name, cat):
                return fn(*a, **kw)
        return wrapper
    return deco


_DEVICE_TRACES = itertools.count(1)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Bracket a region with ``torch.profiler`` and write its Chrome trace
    to ``<logdir>/device_trace_<pid>_<n>.json`` when the region ends.

    Yields the path the trace will be written to, or None. ``logdir=None``
    (or a profiler that cannot start, e.g. one already active) degrades to
    a no-op that yields None — host-side spans keep working either way.
    """
    prof = None
    path = None
    if logdir:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(logdir, exist_ok=True)
            path = os.path.join(logdir, f"device_trace_{os.getpid()}_"
                                        f"{next(_DEVICE_TRACES)}.json")
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception:
            prof = path = None
    try:
        yield path
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(path)
