"""Deterministic, seeded, site-addressed fault injection (torch port of
``repro/reliability/faults.py``; numpy and the standard library only).

Component failure is an input, not an exception: checkpoint writers get
preempted mid-write, scorers throw, batches arrive poisoned. This module
gives every such failure a **site** — a short dotted name at the code
location where the real fault would surface — and a ``FaultPlan`` that
decides, with a seeded per-site RNG, whether the fault fires on each
visit. The same plan and the same call sequence fire the same faults, in
this package and in the reference alike: each site draws from
``np.random.SeedSequence([seed, crc32(site)])``.

The parser accepts all seven sites of the reference. Wired in the port:

    ckpt.write      CheckpointManager     torn | corrupt (bit-flip on disk)
    engine.score    ScoringEngine         error (scorer raises)
    train.batch     Trainer.run           nan   (poison batch floats)

(``shard.read``, ``shard.write``, ``prefetch.io`` and ``prefetch.stall``
belong to the disk pipeline, which the port does not have yet.)

A plan is built explicitly (tests) or from the ``REPRO_TORCH_FAULTS`` env
var (the reference's ``REPRO_FAULTS`` never reaches the port)::

    REPRO_TORCH_FAULTS="seed=7;engine.score:error@0.3x5"

grammar: ``seed=<int>`` (optional, default 0) and one or more
``<site>:<kind>@<p>[x<max_fires>]`` clauses, ``;``/``,`` separated.
``p`` is the per-visit fire probability; ``x<N>`` caps total fires.

Injection hooks are no-ops when no plan is installed: ``fire()`` returns
None after one knob resolve.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import zlib
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.obs import metrics as _obs_metrics

ENV_VAR = "REPRO_TORCH_FAULTS"

KINDS = ("error", "corrupt", "torn", "stall", "nan")


class InjectedFault(Exception):
    """Base class for every injected failure (so tests can tell injected
    faults from genuine bugs)."""


class TransientFault(InjectedFault, OSError):
    """An injected *transient* I/O failure — subclasses OSError so retry
    paths written for real I/O errors handle it identically."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault clause: fire ``kind`` at ``site`` with probability ``p``
    per visit, at most ``max_fires`` times (None = unlimited)."""
    site: str
    kind: str
    p: float = 1.0
    max_fires: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault probability must be in [0,1], "
                             f"got {self.p}")


@dataclasses.dataclass
class FaultStats:
    """Per-site visit/fire accounting (chaos-run observability)."""
    visits: Dict[str, int] = dataclasses.field(default_factory=dict)
    fires: Dict[str, int] = dataclasses.field(default_factory=dict)

    def total_fires(self) -> int:
        return sum(self.fires.values())


class FaultPlan:
    """Site -> FaultSpec with a seeded, independent RNG per site.

    Per-site RNGs (seeded by ``(seed, site)``) keep sites independent: a
    retry loop drawing extra samples at ``prefetch.io`` never perturbs what
    ``ckpt.write`` does later. Draws are lock-protected — the prefetch
    producer and the training thread may both consult the plan.
    """

    def __init__(self, specs: Iterable[FaultSpec] = (), seed: int = 0):
        self.seed = int(seed)
        self.specs: Dict[str, FaultSpec] = {}
        for s in specs:
            if s.site in self.specs:
                raise ValueError(f"duplicate fault site {s.site!r}")
            self.specs[s.site] = s
        self.stats = FaultStats()
        self._rngs: Dict[str, np.random.Generator] = {}
        self._lock = threading.Lock()

    def _rng(self, site: str) -> np.random.Generator:
        rng = self._rngs.get(site)
        if rng is None:
            # crc32, not hash(): str hashing is salted per process and
            # would break cross-run chaos reproducibility
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed,
                                        zlib.crc32(site.encode("utf-8"))]))
            self._rngs[site] = rng
        return rng

    def fire(self, site: str) -> Optional[FaultSpec]:
        """One visit to ``site``: returns the spec when the fault fires."""
        spec = self.specs.get(site)
        if spec is None:
            return None
        with self._lock:
            self.stats.visits[site] = self.stats.visits.get(site, 0) + 1
            fired = self.stats.fires.get(site, 0)
            if spec.max_fires is not None and fired >= spec.max_fires:
                return None
            if spec.p < 1.0 and self._rng(site).random() >= spec.p:
                return None
            self.stats.fires[site] = fired + 1
        return spec

    def rand_index(self, site: str, n: int) -> int:
        """Deterministic index draw for a firing site (e.g. which byte of a
        blob to flip) — same seed, same corruption."""
        with self._lock:
            return int(self._rng(site).integers(0, max(n, 1)))

    def to_env(self) -> str:
        parts = [f"seed={self.seed}"]
        for s in self.specs.values():
            clause = f"{s.site}:{s.kind}@{s.p:g}"
            if s.max_fires is not None:
                clause += f"x{s.max_fires}"
            parts.append(clause)
        return ";".join(parts)

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the REPRO_TORCH_FAULTS grammar (module docstring)."""
        seed = 0
        specs = []
        for clause in text.replace(",", ";").split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                seed = int(clause[len("seed="):])
                continue
            try:
                site, rest = clause.split(":", 1)
                kind, rest = rest.split("@", 1)
                if "x" in rest:
                    p_str, n_str = rest.split("x", 1)
                    max_fires: Optional[int] = int(n_str)
                else:
                    p_str, max_fires = rest, None
                specs.append(FaultSpec(site=site.strip(), kind=kind.strip(),
                                       p=float(p_str), max_fires=max_fires))
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"bad {ENV_VAR} clause {clause!r} (expected "
                    f"<site>:<kind>@<p>[x<max_fires>]): {e}") from e
        return cls(specs, seed=seed)

    @classmethod
    def from_env(cls, environ=None) -> Optional["FaultPlan"]:
        text = (environ or os.environ).get(ENV_VAR, "").strip()
        return cls.parse(text) if text else None


# ---------------------------------------------------------------------------
# Global plan: installed explicitly or lazily from REPRO_TORCH_FAULTS.
#
# The plan rides the port's knob ladder (scenario/knobs.py). Unlike the
# backend knobs, None here is a REAL value — install(None) means
# "explicitly no plan" and beats the env var — and the env rung is parsed
# once and memoized (cache_env=True) because fire() sits on production
# hot paths and must stay one attribute check when no plan is active.
# ---------------------------------------------------------------------------

from repro_torch.scenario.knobs import Knob as _Knob  # noqa: E402

PLAN_KNOB = _Knob("faults", ENV_VAR, parse=lambda text: FaultPlan.parse(text),
                  cache_env=True, kind="plan")


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or with None, clear) the process-global fault plan.
    Returns the previous plan so tests can restore it."""
    prev = PLAN_KNOB.get_default()
    PLAN_KNOB.set_default(plan)      # explicit install wins over the env var
    return prev


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else one parsed from REPRO_TORCH_FAULTS (checked once)."""
    return PLAN_KNOB.resolve()


def fire(site: str) -> Optional[FaultSpec]:
    """Module-level injection hook — None (fast) when no plan is active."""
    plan = active_plan()
    return plan.fire(site) if plan is not None else None


def maybe_fail(site: str, exc=TransientFault) -> None:
    """Raise ``exc`` if an ``error``-kind fault fires at ``site``."""
    spec = fire(site)
    if spec is not None and spec.kind == "error":
        raise exc(f"injected fault at {site}")


def corrupt_bytes(site: str, blob: bytes, spec: FaultSpec,
                  lo_frac: float = 0.2) -> bytes:
    """Flip one byte of ``blob`` at a plan-deterministic position in the
    tail ``1 - lo_frac`` of the blob (past the header region, so the
    corruption lands in a data block, not the frame magic)."""
    plan = active_plan()
    lo = int(len(blob) * lo_frac)
    pos = (plan.rand_index(site, len(blob) - lo) + lo if plan is not None
           else lo)
    out = bytearray(blob)
    out[pos] ^= 0xFF
    return bytes(out)


class use_plan:
    """Context manager: install a plan for a ``with`` block (tests)."""

    def __init__(self, plan: Optional[FaultPlan]):
        self.plan = plan
        self._prev: Tuple = ()

    def __enter__(self) -> Optional[FaultPlan]:
        self._prev = PLAN_KNOB.snapshot()
        install(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        PLAN_KNOB.restore(self._prev)


def _obs_snapshot() -> dict:
    """Collector for ``repro_torch.obs``: the active plan's per-site accounting."""
    plan = active_plan()
    if plan is None:
        return {"active": False}
    with plan._lock:
        return {"active": True, "seed": plan.seed,
                "sites": sorted(plan.specs),
                "visits": dict(plan.stats.visits),
                "fires": dict(plan.stats.fires)}


_obs_metrics.register_stats("reliability.faults", _obs_snapshot)
