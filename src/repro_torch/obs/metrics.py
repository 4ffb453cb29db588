"""Process-wide metrics registry: counters, gauges, histograms, mirrors
(torch port of ``repro/obs/metrics.py``; framework-free, a copy kept here
so the port imports nothing of the reference).

One :class:`MetricsRegistry` (the module-level :data:`REGISTRY`) holds
every metric in the process. Three primitives:

  * :class:`Counter` — monotonically increasing (requests served, bytes
    read, warnings suppressed);
  * :class:`Gauge` — last-write-wins level (queue depth, cache size);
  * :class:`Histogram` — fixed bucket ladder + count/sum, for latency
    distributions (span durations land here automatically, which is what
    ``repro_torch.obs.report`` computes p50/p99 per phase from).

Each primitive supports **labeled series**: ``counter.inc(1, site="x")``
records into an independent child keyed by the sorted label items.

Record-path cost: every record first checks :func:`metrics_enabled` (one
knob resolve — a ContextVar read and two attribute checks) and returns
immediately when obs is off, with no allocation. Metrics created with
``gated=False`` (e.g. the suppressed-warnings counter) record regardless
of the mode. When recording, the increment happens under the registry
lock, so concurrent threads never lose updates.

**Mirrors**: :func:`register_stats` attaches an existing ``*Stats`` object
(or a zero-arg callable returning a dict) under a component name, held by
weakref so instances stay GC-able. :func:`snapshot` returns one plain
dict — ``{"mode", "metrics": {counters, gauges, histograms},
"components": {...}}``; components that expose a ``snapshot()`` method
(``EngineStats``, the stores, the Trainer) are read through it.

The mode knob ``obs`` lives on the port's own knob registry and reads
``REPRO_TORCH_OBS``, never the reference's ``REPRO_OBS``.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.scenario.knobs import UNSET, Knob

# the enablement knob on the shared ladder: explicit arg >
# ScenarioSpec.obs.mode (process default) > REPRO_TORCH_OBS env > auto(off).
# "trace" implies "metrics".
OBS_MODES = ("off", "metrics", "trace")
OBS_KNOB = Knob("obs", "REPRO_TORCH_OBS", choices=OBS_MODES, auto=lambda: "off")


def mode(arg=UNSET) -> str:
    """Resolve the observability mode through the shared knob ladder."""
    return OBS_KNOB.resolve(arg)


def metrics_enabled() -> bool:
    return OBS_KNOB.resolve() != "off"


# default latency ladder (milliseconds): ~1us .. ~100s, x4 per rung —
# fixed so histograms from different runs are mergeable/comparable
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.001, 0.004, 0.016, 0.064, 0.25, 1.0, 4.0, 16.0, 64.0, 250.0,
    1000.0, 4000.0, 16000.0, 100000.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _series_name(name: str, key: LabelKey) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class _Metric:
    """Shared plumbing: name, gating, label-keyed children."""

    def __init__(self, name: str, registry: "MetricsRegistry",
                 gated: bool = True):
        self.name = name
        self.gated = gated
        self._registry = registry
        self._lock = registry._lock

    def _on(self) -> bool:
        return not self.gated or metrics_enabled()


class Counter(_Metric):
    def __init__(self, name, registry, gated=True):
        super().__init__(name, registry, gated)
        self._series: Dict[LabelKey, int] = {}

    def inc(self, n: int = 1, **labels) -> None:
        if not self._on():
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> int:
        with self._lock:
            return self._series.get(_label_key(labels), 0)

    def _snapshot(self) -> Dict[str, int]:
        return {_series_name(self.name, k): v
                for k, v in self._series.items()}


class Gauge(_Metric):
    def __init__(self, name, registry, gated=True):
        super().__init__(name, registry, gated)
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        if not self._on():
            return
        with self._lock:
            self._series[_label_key(labels)] = value

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._series.get(_label_key(labels))

    def _snapshot(self) -> Dict[str, float]:
        return {_series_name(self.name, k): v
                for k, v in self._series.items()}


class _HistSeries:
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1 = overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")


class Histogram(_Metric):
    """Fixed-ladder histogram; ``observe`` is O(log buckets)."""

    def __init__(self, name, registry, gated=True,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS_MS):
        super().__init__(name, registry, gated)
        self.buckets = tuple(buckets)
        assert list(self.buckets) == sorted(self.buckets)
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels) -> None:
        if not self._on():
            return
        key = _label_key(labels)
        i = bisect_left(self.buckets, value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            s.counts[i] += 1
            s.count += 1
            s.sum += value
            s.min = value if value < s.min else s.min
            s.max = value if value > s.max else s.max

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Ladder-resolution quantile estimate (upper bucket edge)."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or s.count == 0:
                return None
            counts, total = list(s.counts), s.count
        return _bucket_quantile(self.buckets, counts, total, q)

    def _snapshot(self) -> Dict[str, dict]:
        out = {}
        for key, s in self._series.items():
            out[_series_name(self.name, key)] = {
                "count": s.count, "sum": round(s.sum, 6),
                "min": s.min, "max": s.max,
                "buckets": {("le_%g" % b): c
                            for b, c in zip(self.buckets, s.counts) if c},
                "overflow": s.counts[-1],
            }
        return out


def _bucket_quantile(buckets: Tuple[float, ...], counts: List[int],
                     total: int, q: float) -> float:
    """Quantile from cumulative bucket counts: the upper edge of the
    bucket containing the q-th observation (overflow reports the ladder
    top — good enough for a fixed ladder with x4 rungs)."""
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c:
            return buckets[i] if i < len(buckets) else buckets[-1]
    return buckets[-1]


class MetricsRegistry:
    """Name -> metric, plus weakly-referenced component mirrors."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        # component -> weakref to a *Stats object or a strong callable
        self._mirrors: Dict[str, Any] = {}

    # -- create-or-get ----------------------------------------------------------
    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, self, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name: str, gated: bool = True) -> Counter:
        return self._get(name, Counter, gated=gated)

    def gauge(self, name: str, gated: bool = True) -> Gauge:
        return self._get(name, Gauge, gated=gated)

    def histogram(self, name: str, gated: bool = True,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS_MS
                  ) -> Histogram:
        return self._get(name, Histogram, gated=gated, buckets=buckets)

    # -- mirrors ----------------------------------------------------------------
    def register_stats(self, component: str, source) -> None:
        """Mirror ``source`` into snapshots under ``component``.

        ``source`` is a ``*Stats``-style object (held by weakref; newest
        registration wins, dead instances are pruned at snapshot) or a
        zero-arg callable returning a dict (held strongly).
        """
        with self._lock:
            if callable(source):
                self._mirrors[component] = source
            else:
                self._mirrors[component] = weakref.ref(source)

    def _component_snapshot(self) -> Dict[str, dict]:
        with self._lock:
            mirrors = dict(self._mirrors)
        out, dead = {}, []
        for component, ref in mirrors.items():
            obj = ref() if isinstance(ref, weakref.ref) else ref
            if obj is None:
                dead.append(component)
                continue
            try:
                out[component] = stats_dict(obj)
            except Exception as e:   # a broken mirror must not kill snapshot
                out[component] = {"error": repr(e)}
        if dead:
            with self._lock:
                for component in dead:
                    self._mirrors.pop(component, None)
        return out

    # -- the one read path ------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time view of everything: direct metrics (read under
        the registry lock) + every live component mirror (each read via
        its own ``snapshot()``, so per-component reads are consistent)."""
        with self._lock:
            counters = {}
            gauges = {}
            histograms = {}
            for m in self._metrics.values():
                if isinstance(m, Counter):
                    counters.update(m._snapshot())
                elif isinstance(m, Gauge):
                    gauges.update(m._snapshot())
                elif isinstance(m, Histogram):
                    histograms.update(m._snapshot())
        return {"mode": mode(),
                "metrics": {"counters": counters, "gauges": gauges,
                            "histograms": histograms},
                "components": self._component_snapshot()}

    def reset(self) -> None:
        """Drop every metric and mirror (tests/benchmarks)."""
        with self._lock:
            self._metrics.clear()
            self._mirrors.clear()


def stats_dict(obj) -> dict:
    """Plain-dict view of a stats source.

    Callables are called; objects with a ``snapshot()`` method are read
    through it (the consistent path); bare dataclasses are read field by
    field (nested dataclasses recurse). Non-JSON-serializable leaves are
    ``str()``-ed by the emitter, not here.
    """
    if callable(obj) and not dataclasses.is_dataclass(obj):
        return dict(obj())
    snap = getattr(obj, "snapshot", None)
    if callable(snap):
        return dict(snap())
    if dataclasses.is_dataclass(obj):
        return {f.name: (stats_dict(v) if dataclasses.is_dataclass(
                    v := getattr(obj, f.name)) else v)
                for f in dataclasses.fields(obj)}
    return dict(obj)


# ---------------------------------------------------------------------------
# The process-wide registry + module-level conveniences
# ---------------------------------------------------------------------------

REGISTRY = MetricsRegistry()

counter: Callable[..., Counter] = REGISTRY.counter
gauge: Callable[..., Gauge] = REGISTRY.gauge
histogram: Callable[..., Histogram] = REGISTRY.histogram
register_stats = REGISTRY.register_stats
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset
