"""Fault injection (torch port of ``repro/reliability``).

``faults`` is the deterministic, seeded injection layer; the degradation
behaviours it proves out live in the subsystems themselves:

  * train/checkpoint.py  — verify-on-restore digests, fallback to last valid
  * train/loop.py        — non-finite loss/grad skip-step guard
  * serve/engine.py      — per-batch failure isolation + circuit breaker
"""
from repro_torch.reliability.faults import (ENV_VAR, FaultPlan, FaultSpec,
                                            FaultStats, InjectedFault,
                                            TransientFault, active_plan,
                                            fire, install, maybe_fail,
                                            use_plan)

__all__ = [
    "ENV_VAR", "FaultPlan", "FaultSpec", "FaultStats", "InjectedFault",
    "TransientFault", "active_plan", "fire", "install", "maybe_fail",
    "use_plan",
]
