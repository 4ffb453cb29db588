"""The one precedence ladder for every runtime knob in the port.

A copy of the JAX package's ``scenario/knobs.py`` (framework-free, kept
here so the port imports nothing of the reference). A :class:`Knob` is:

    explicit argument            (per call)
  > scoped override              (``with knob.scoped(v):`` — ContextVar,
                                  so concurrent callers can't leak)
  > process default              (set by a CLI flag or a config)
  > environment variable         (``REPRO_TORCH_*`` debug overrides)
  > auto                         (hardware-aware fallback)

Explicitly configured knobs beat the ambient env var so an exported debug
override can never silently win over a pinned ServeConfig. ``None`` is a
*real value* on knobs that allow it; absence is the internal ``UNSET``
sentinel, which ``resolve`` skips.

Knobs register themselves by name at construction in this module's own
``REGISTRY``, separate from the reference's, so the two packages' knobs
never collide in one process.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Any, Callable, Dict, Optional, Tuple


class _Unset:
    """Sentinel for "no value at this rung" (repr aids debugging)."""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<UNSET>"


UNSET = _Unset()

# name -> Knob; the enumerable surface
REGISTRY: Dict[str, "Knob"] = {}


class Knob:
    """One configurable value with the shared precedence ladder.

    ``choices`` restricts values to a fixed set (backends, policies);
    ``parse`` maps raw env-var text to a value (defaults to identity);
    ``auto`` is a zero-arg callable producing the hardware-aware fallback
    when every explicit rung is unset; ``cache_env`` reads the env var
    once and memoizes (hot-path knobs consulted per call) instead of on
    every resolve.
    """

    def __init__(self, name: str, env_var: Optional[str] = None, *,
                 choices: Optional[Tuple[str, ...]] = None,
                 parse: Optional[Callable[[str], Any]] = None,
                 auto: Optional[Callable[[], Any]] = None,
                 cache_env: bool = False,
                 kind: str = "knob"):
        if name in REGISTRY:
            raise ValueError(f"duplicate knob {name!r}")
        self.name = name
        self.env_var = env_var
        self.choices = choices
        self.parse = parse or (lambda text: text)
        self.auto = auto
        self.cache_env = cache_env
        self.kind = kind
        self._default: Any = UNSET
        self._env_cache: Any = UNSET   # memoized env value (cache_env only)
        self._env_cached = False
        self._scope: contextvars.ContextVar = contextvars.ContextVar(
            f"repro_torch_knob_{name}", default=UNSET)
        REGISTRY[name] = self

    # -- validation -------------------------------------------------------------
    def check(self, value):
        if self.choices is not None and value not in self.choices:
            raise ValueError(f"unknown {self.name} {value!r}; "
                             f"expected one of {self.choices}")
        return value

    # -- process default (CLI flag / config apply) ------------------------------
    def set_default(self, value) -> None:
        """Install the process-wide default; ``UNSET`` clears it."""
        self._default = value if value is UNSET else self.check(value)

    def get_default(self):
        return None if self._default is UNSET else self._default

    # -- scoped override --------------------------------------------------------
    @contextlib.contextmanager
    def scoped(self, value):
        """Scoped override (ContextVar — safe across threads); ``UNSET`` is
        a no-op so callers can thread optional knobs."""
        if value is UNSET:
            yield
            return
        token = self._scope.set(self.check(value))
        try:
            yield
        finally:
            self._scope.reset(token)

    # -- env rung ---------------------------------------------------------------
    def _env(self):
        if self.cache_env and self._env_cached:
            return self._env_cache
        value: Any = UNSET
        if self.env_var:
            text = os.environ.get(self.env_var, "").strip()
            if text:
                value = self.check(self.parse(text))
        if self.cache_env:
            self._env_cache, self._env_cached = value, True
        return value

    # -- the ladder -------------------------------------------------------------
    def resolve(self, arg=UNSET):
        """Walk the ladder; raises on an invalid explicit value."""
        if arg is not UNSET:
            return self.check(arg)
        for rung in (self._scope.get(), self._default, self._env()):
            if rung is not UNSET:
                return rung
        return self.auto() if self.auto is not None else None

    # -- state save/restore (tests, scoped context managers) --------------------
    def snapshot(self) -> tuple:
        return (self._default, self._env_cache, self._env_cached)

    def restore(self, state: tuple) -> None:
        self._default, self._env_cache, self._env_cached = state


def get_knob(name: str) -> Knob:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown knob {name!r}; registered: "
                       f"{sorted(REGISTRY)}") from None


def resolve_knob(name: str, arg=UNSET):
    """Resolve a registered knob through the shared precedence ladder;
    ``arg`` is the highest rung (explicit per-call value)."""
    return get_knob(name).resolve(arg)


def set_knob_default(name: str, value) -> None:
    """Process-wide default for a registered knob (pass ``UNSET`` to
    clear)."""
    get_knob(name).set_default(value)
