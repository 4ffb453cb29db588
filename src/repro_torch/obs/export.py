"""Periodic JSONL telemetry export of the obs snapshot (torch port of
``repro/obs/export.py``, framework-free).

A :class:`TelemetryEmitter` appends one JSON line per emission:

    {"t_wall": <unix s>, "elapsed_s": <s since emitter start>,
     "source": "train.log" | "serve.flush" | ...,
     "scenario_hash": "<ScenarioSpec.content_hash() or null>",
     "snapshot": <repro_torch.obs.metrics.snapshot()>}

Emissions are pulled from cadence points that already exist — Trainer
logging steps, each engine flush — via :func:`maybe_emit`, a no-op until
an emitter is installed (:func:`install`), rate-limited to ``every_s``.
``python -m repro_torch.obs.report <file.jsonl>`` turns a run file into a
rates/p50/p99-per-phase table. The line format is the reference's, so
either package's report reads either package's file.

The file is append-mode and flushed per line, so a killed run leaves a
readable file.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

from repro_torch.obs import metrics


class TelemetryEmitter:
    """Appends registry snapshots to a JSONL file, at most every ``every_s``."""

    def __init__(self, path: str, every_s: float = 0.0,
                 scenario_hash: Optional[str] = None,
                 clock=time.monotonic):
        self.path = path
        self.every_s = float(every_s)
        self.scenario_hash = scenario_hash
        self._clock = clock
        self._t_start = clock()
        self._last_emit: Optional[float] = None
        self._lock = threading.Lock()
        self._file = open(path, "a")
        self.n_emitted = 0

    def maybe_emit(self, source: str) -> bool:
        """Emit if at least ``every_s`` has passed since the last line."""
        with self._lock:
            now = self._clock()
            if (self._last_emit is not None
                    and now - self._last_emit < self.every_s):
                return False
            self._emit_locked(source, now)
            return True

    def emit(self, source: str) -> None:
        """Unconditional emission (e.g. a final line at shutdown)."""
        with self._lock:
            self._emit_locked(source, self._clock())

    def _emit_locked(self, source: str, now: float) -> None:
        if self._file.closed:
            return
        line = {"t_wall": time.time(),
                "elapsed_s": round(now - self._t_start, 6),
                "source": source,
                "scenario_hash": self.scenario_hash,
                "snapshot": metrics.snapshot()}
        # default=str: snapshots may carry non-JSON leaves (e.g. a dtype
        # in a mirrored dataclass); telemetry must not crash the run
        self._file.write(json.dumps(line, default=str) + "\n")
        self._file.flush()
        self._last_emit = now
        self.n_emitted += 1

    def close(self, final_source: Optional[str] = "shutdown") -> None:
        with self._lock:
            if self._file.closed:
                return
            if final_source is not None:
                self._emit_locked(final_source, self._clock())
            self._file.close()

    def __enter__(self) -> "TelemetryEmitter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# ---------------------------------------------------------------------------
# Process-wide install point. Instrumented modules call obs.export.maybe_emit
# at their cadence points; it is a cheap no-op until an emitter is installed.
# ---------------------------------------------------------------------------

_EMITTER: Optional[TelemetryEmitter] = None


def install(emitter: Optional[TelemetryEmitter]) -> Optional[TelemetryEmitter]:
    """Install (or, with ``None``, uninstall) the process emitter.

    Returns the previously installed emitter, which the caller should
    ``close()`` if it owned it.
    """
    global _EMITTER
    prev, _EMITTER = _EMITTER, emitter
    return prev


def installed() -> Optional[TelemetryEmitter]:
    return _EMITTER


def maybe_emit(source: str) -> bool:
    em = _EMITTER
    if em is None:
        return False
    return em.maybe_emit(source)
