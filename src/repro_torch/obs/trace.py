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
manager — one knob resolve, no allocation, no CUDA call. The event buffer is bounded
(``max_events``); overflow drops new events and counts them in the
``trace.dropped_events`` counter instead of growing without bound.

No span synchronizes the card. A span's ``dur`` is host time: around a
training step's dispatch (``train.compute``) it holds the dispatch and
whatever syncs the step makes, as the reference's does.

**Device time.** ``span(name, device=True)`` also records a timing
``torch.cuda.Event`` on the current stream as it opens and another as it
closes, when the process runs on a card (its CUDA runtime started). Once
both have completed, the closed event gets ``args["device_ms"]``: the
card's time between the two. :meth:`Tracer.events`, ``to_chrome`` and
``save`` fill it in, asking each pair with ``Event.query()`` only, so a
span the card has not reached stays pending, without it. Events come
from a pool; a pending pair belongs to an event of the buffer, so the
buffer's bound is theirs, and a span the full buffer drops (counted in
``trace.dropped_events``) hands its events back. Spans opened inside
autograd's backward run on its device thread: group spans into steps by
time, not by ``tid``. ``span.set_later(key, tensor, counter)`` gives such a
span an arg the card computes (a count that depends on the data, say)
without a sync: the value is copied to pinned host memory on the stream
inside the span and read, and added to ``counter``, when ``device_ms`` is.

**Syncs.** On a card in ``trace`` mode the tracer turns on
``torch.cuda.set_sync_debug_mode("warn")`` and counts each
"synchronizing CUDA operation" warning, unprinted, into the counter
``cuda.syncs`` and into ``args["syncs"]`` of the innermost span open on
the warning's thread; other warnings pass through. (A sync inside
autograd's backward is warned on the thread that called the backward,
when it returns.) Out of ``trace`` mode the sync debug mode is as the
tracer found it.

**Clocks.** ``ts`` is ``perf_counter`` time; ``torch.profiler``'s event
times (``start_ns()``) are Unix-epoch nanoseconds. The tracer keeps anchor
pairs ``(perf_counter_ns, time_ns)``, one as tracing starts and at most
one a second after (taken as a span opens); :meth:`Tracer.profiler_ns`
maps a span time onto the profiler's clock through the nearest, and
``to_chrome`` carries them (``otherData.clock_anchors``).
``device_trace`` brackets a region with ``torch.profiler`` and writes one
Chrome trace of the card's kernels, the host's ops and the program's
spans on that clock.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import itertools
import json
import os
import re
import sys
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

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

    def set_later(self, key: str, value, counter: Optional[str] = None
                  ) -> None:
        pass


_NULL_SPAN = _NullSpan()

# the text of the warning torch's sync debug mode gives at each sync
SYNC_WARNING = "called a synchronizing CUDA operation"
# at most one clock anchor in this many nanoseconds of perf_counter
ANCHOR_EVERY_NS = 1_000_000_000
# a closing device span resolves the pending ones once this many more wait,
# so the pool recycles events during a run
RESOLVE_EVERY = 256


def _card():
    """``torch.cuda`` when this process runs on a card (its CUDA runtime is
    started), else None; asking makes no CUDA call."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "device", "_t0",
                 "_start", "_later")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any], device: bool):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.device = device
        self._start = None         # the opening timing event, on a card
        self._later = []           # (key, pinned host copy, counter)

    def set(self, **args) -> None:
        """Attach/overwrite args while the span is open."""
        self.args.update(args)

    def set_later(self, key: str, value, counter: Optional[str] = None
                  ) -> None:
        """``args[key]``: the integer a one-element tensor holds, read
        without a wait. A tensor on a card of a span timed there is copied
        to pinned host memory on the current stream and read when the
        span's device time is (module note); any other is read now.
        ``counter``, if named, gets the value added when it is read."""
        if self._start is not None and value.is_cuda:
            import torch
            host = torch.empty(value.shape, dtype=value.dtype,
                               pin_memory=True)
            host.copy_(value, non_blocking=True)
            self._later.append((key, host, counter))
        else:
            _fill(self.args, key, value, counter)

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._enter(self)
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self._tracer._exit(self, t1)
        metrics.histogram("span." + self.name).observe(
            (t1 - self._t0) / 1e6)
        return False


def _fill(args: Dict[str, Any], key: str, value, counter: Optional[str]
          ) -> None:
    args[key] = int(value)
    if counter is not None:
        metrics.counter(counter).inc(args[key])


class _SyncCounter:
    """While installed: the sync debug mode ``warn``, an ``always`` filter
    for its warning, and a ``warnings.showwarning`` that counts that
    warning instead of printing it and hands every other one to the hook
    it replaced. ``stop`` puts back what it changed."""

    def __init__(self, tracer: "Tracer", cuda):
        self._tracer = tracer
        self._cuda = cuda
        self._mode = cuda.get_sync_debug_mode()
        self._show = warnings.showwarning
        self._hook = self._showwarning
        warnings.filterwarnings("always", message=re.escape(SYNC_WARNING))
        self._filter = warnings.filters[0]
        warnings.showwarning = self._hook
        cuda.set_sync_debug_mode("warn")

    def installed(self) -> bool:
        """False once something else (a ``warnings.catch_warnings`` that
        ended, say) has put back the hook or the filters."""
        return (warnings.showwarning is self._hook
                and self._filter in warnings.filters)

    def stop(self) -> None:
        if warnings.showwarning is self._hook:
            warnings.showwarning = self._show
        if self._filter in warnings.filters:
            warnings.filters.remove(self._filter)
        self._cuda.set_sync_debug_mode(self._mode)

    def _showwarning(self, message, category, filename, lineno, file=None,
                     line=None):
        if issubclass(category, UserWarning) and \
                str(message).startswith(SYNC_WARNING):
            if tracing_enabled():
                self._tracer._count_sync()
            else:                   # the mode changed: the tracer steps out
                self._tracer._stop_syncs()
            return
        self._show(message, category, filename, lineno, file, line)


class Tracer:
    """Bounded, thread-safe buffer of Chrome trace events."""

    def __init__(self, max_events: int = 200_000):
        self.max_events = max_events
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._local = threading.local()        # .stack: open spans, trace mode
        self._anchors: List[Tuple[int, int]] = []   # (perf_counter_ns, time_ns)
        # (event, start, end, later) the card has not reached: each holds
        # an event of the buffer, so the buffer's bound is theirs
        self._pending: List[tuple] = []
        self._resolve_at = RESOLVE_EVERY
        self._pool: list = []                  # timing events to reuse
        self._sync: Optional[_SyncCounter] = None

    # -- recording --------------------------------------------------------------
    def span(self, name: str, cat: str = "repro", device: bool = False,
             **args):
        """Context manager timing one phase; no-op unless mode=trace.
        ``device=True`` also times it on the card (module note)."""
        if not tracing_enabled():
            if self._sync is not None:
                self._stop_syncs()
            return _NULL_SPAN
        return _Span(self, name, cat, args, device)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        """Zero-duration marker (e.g. per-request admission)."""
        if not tracing_enabled():
            return
        self._push({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": time.perf_counter_ns() // 1000,
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": args})

    def _enter(self, span: _Span) -> int:
        t0 = time.perf_counter_ns()
        if not self._anchors or \
                t0 - self._anchors[-1][0] >= ANCHOR_EVERY_NS:
            self._anchor()
        cuda = _card()
        if cuda is not None:
            if self._sync is None or not self._sync.installed():
                self._start_syncs(cuda)
            if span.device:
                span._start = self._timing_event(cuda)
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(span)
        return t0

    def _exit(self, span: _Span, t1: int) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:         # closed out of order
            stack.remove(span)
        timing = None
        if span._start is not None:
            timing = (span._start, self._timing_event(_card()), span._later)
        t0 = span._t0
        # ts and end both floored to microseconds: a span inside another
        # never ends after it
        self._push({"name": span.name, "cat": span.cat, "ph": "X",
                    "ts": t0 // 1000, "dur": max(t1 // 1000 - t0 // 1000, 1),
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": span.args}, timing)

    def _timing_event(self, cuda):
        """A timing event recorded on the current stream, from the pool or
        new."""
        with self._lock:
            ev = self._pool.pop() if self._pool else None
        if ev is None:
            ev = cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _push(self, event: dict, timing: Optional[tuple] = None) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                metrics.counter("trace.dropped_events", gated=False).inc()
                if timing is not None:
                    self._pool.extend(timing[:2])
                return
            self._events.append(event)
            if timing is not None:
                self._pending.append((event, *timing))
                if len(self._pending) >= self._resolve_at:
                    self._resolve()
                    self._resolve_at = len(self._pending) + RESOLVE_EVERY

    def _resolve(self) -> None:
        """``device_ms``, and the values ``set_later`` left, into each
        pending span whose events have both completed; never waits. Under
        the lock."""
        still = []
        for pending in self._pending:
            event, start, end, later = pending
            if end.query() and start.query():
                event["args"]["device_ms"] = start.elapsed_time(end)
                for key, host, counter in later:
                    _fill(event["args"], key, host, counter)
                self._pool += (start, end)
            else:
                still.append(pending)
        self._pending = still

    # -- syncs ------------------------------------------------------------------
    @property
    def counting_syncs(self) -> bool:
        """Whether the card's syncs are being counted (``trace`` mode on a
        card, once a span has opened)."""
        return self._sync is not None

    def _start_syncs(self, cuda) -> None:
        self._stop_syncs()
        self._sync = _SyncCounter(self, cuda)

    def _stop_syncs(self) -> None:
        sync, self._sync = self._sync, None
        if sync is not None:
            sync.stop()

    def _count_sync(self) -> None:
        metrics.counter("cuda.syncs").inc()
        stack = getattr(self._local, "stack", None)
        if stack:
            args = stack[-1].args
            args["syncs"] = args.get("syncs", 0) + 1

    # -- clocks -----------------------------------------------------------------
    def _anchor(self) -> None:
        p0 = time.perf_counter_ns()
        unix = time.time_ns()
        p1 = time.perf_counter_ns()
        self._anchors.append(((p0 + p1) // 2, unix))

    def profiler_ns(self, ts_us: float) -> int:
        """A span time (``ts``: perf_counter microseconds) on the clock of
        ``torch.profiler``'s event times (Unix-epoch nanoseconds), through
        the nearest anchor."""
        if not self._anchors:
            self._anchor()
        ns = int(ts_us * 1000)
        anchors = self._anchors
        i = bisect.bisect_left(anchors, (ns,))
        p, unix = min(anchors[max(i - 1, 0):i + 1],
                      key=lambda a: abs(a[0] - ns))
        return ns + unix - p

    # -- export -----------------------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            if self._pending:
                self._resolve()
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            for _, start, end, _ in self._pending:
                self._pool += (start, end)
            self._pending = []
            self._resolve_at = RESOLVE_EVERY

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": "repro"}}]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"clock_anchors": [list(a)
                                                for a in self._anchors]}}

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


def span(name: str, cat: str = "repro", device: bool = False, **args):
    return _TRACER.span(name, cat, device, **args)


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
    """Bracket a region with ``torch.profiler`` (the CUDA activity too on a
    card) and write one Chrome trace to
    ``<logdir>/device_trace_<pid>_<n>.json`` when the region ends: the
    profiler's events and the program's spans of the region, moved onto
    the profiler's clock (``Tracer.profiler_ns``), so Perfetto shows them
    on one timeline.

    Yields that path; ``logdir=None`` is a no-op that yields None. With a
    directory it raises when the profiler cannot start (one already
    running, say) and, on a card, when the region recorded no device
    activity: such a trace cannot show the card.
    """
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"device_trace_{os.getpid()}_"
                                f"{next(_DEVICE_TRACES)}.json")
    if torch.autograd._profiler_enabled():
        raise RuntimeError("device_trace cannot start: a profiler is already "
                           "running in this process")
    prof = profile(activities=activities)
    prof.__enter__()
    t0 = time.perf_counter_ns()
    try:
        yield path
    finally:
        t1 = time.perf_counter_ns()
        prof.__exit__(None, None, None)
        _export(prof, path, t0, t1)
    if on_card and not _has_device_activity(prof):
        raise RuntimeError(f"device_trace recorded no device activity in "
                           f"its region ({path})")


def _has_device_activity(prof) -> bool:
    from torch._C._autograd import DeviceType
    return any(ev.device_type() == DeviceType.CUDA
               for ev in prof.profiler.kineto_results.events())


def _export(prof, path: str, t0_ns: int, t1_ns: int) -> None:
    """The profiler's Chrome trace with the program's spans of [t0, t1]
    added: their ``ts`` moved to the profiler's file clock (microseconds
    after its ``baseTimeNanoseconds``)."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    lo, hi = t0_ns // 1000, t1_ns // 1000
    doc["traceEvents"].extend(
        {**e, "ts": (_TRACER.profiler_ns(e["ts"]) - base) / 1000}
        for e in _TRACER.events()
        if e.get("ph") == "X" and lo <= e["ts"] and e["ts"] + e["dur"] <= hi)
    with open(path, "w") as f:
        json.dump(doc, f)
