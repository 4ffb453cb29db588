"""Shared structured logger + rate-limited warnings (torch port of
``repro/obs/log.py``, framework-free).

Every user-facing line the port prints goes through :func:`get_logger`,
which emits exactly one parseable line per event:

    [train] step step=200/600 loss=0.6931 ne=0.9983 steps_per_s=12.4

i.e. ``[component] event key=value ...``. Verbosity is a knob on the
port's ladder (``REPRO_TORCH_VERBOSITY``, ``--set obs.verbosity=``):
0 = errors only, 1 = progress (default), 2 = debug. A logger constructed
with ``enabled=False`` only ever emits errors.

:func:`warn_once` tames repeated ``warnings.warn`` sites: the first
occurrence per key warns through the normal ``warnings`` machinery, and
every repeat is counted in the ungated ``warnings_suppressed`` counter.
"""
from __future__ import annotations

import sys
import threading
import warnings
from typing import Optional, Set

from repro_torch.obs import metrics
from repro_torch.scenario.knobs import UNSET, Knob

VERBOSITY_KNOB = Knob("obs_verbosity", "REPRO_TORCH_VERBOSITY", parse=int,
                      auto=lambda: 1)

ERROR, INFO, DEBUG = 0, 1, 2


def verbosity(arg=UNSET) -> int:
    return VERBOSITY_KNOB.resolve(arg)


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return "%.6g" % v
    if isinstance(v, str) and (" " in v or not v):
        return repr(v)
    return str(v)


class Logger:
    """Per-component structured logger; construction is cheap, keep none."""

    def __init__(self, component: str, enabled: bool = True,
                 stream=None):
        self.component = component
        self.enabled = enabled
        self._stream = stream

    def _emit(self, level: int, event: str, kv) -> None:
        if not self.enabled and level > ERROR:
            return
        if verbosity() < level:
            return
        parts = [f"[{self.component}]", event]
        parts += [f"{k}={_fmt_value(v)}" for k, v in kv.items()]
        stream = self._stream or (sys.stderr if level == ERROR
                                  else sys.stdout)
        print(" ".join(parts), file=stream, flush=True)

    def error(self, event: str, **kv) -> None:
        self._emit(ERROR, event, kv)

    def info(self, event: str, **kv) -> None:
        self._emit(INFO, event, kv)

    def debug(self, event: str, **kv) -> None:
        self._emit(DEBUG, event, kv)


def get_logger(component: str, enabled: bool = True,
               stream=None) -> Logger:
    return Logger(component, enabled=enabled, stream=stream)


# ---------------------------------------------------------------------------
# warn once per source, count the rest
# ---------------------------------------------------------------------------

_WARNED: Set[str] = set()
_WARN_LOCK = threading.Lock()


def warn_once(key: str, message: str, category=UserWarning,
              stacklevel: int = 2) -> bool:
    """Warn on the first call per ``key``; count repeats in the registry.

    Returns True when the warning was actually issued. The counter is
    ungated (records even with obs off) — suppressed warnings must never
    be lost.
    """
    with _WARN_LOCK:
        first = key not in _WARNED
        if first:
            _WARNED.add(key)
    if first:
        warnings.warn(message, category, stacklevel=stacklevel + 1)
    else:
        metrics.counter("warnings_suppressed", gated=False).inc(key=key)
    return first


def reset_warn_once(key: Optional[str] = None) -> None:
    """Forget warned keys (tests); ``None`` clears everything."""
    with _WARN_LOCK:
        if key is None:
            _WARNED.clear()
        else:
            _WARNED.discard(key)
