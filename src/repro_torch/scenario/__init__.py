"""repro_torch.scenario — the declarative config surface (spec + knob
ladder) and, in ``build``, the one construction path from a spec to
running objects (torch port of ``repro/scenario``).

Lazy exports (PEP 562): ``kernels/dispatch.py`` and
``reliability/faults.py`` import :mod:`repro_torch.scenario.knobs` at
module level, while :mod:`repro_torch.scenario.spec` validates fault
strings via ``reliability.faults`` — eager imports here would close that
cycle.
"""
from repro_torch.scenario.knobs import (UNSET, Knob, get_knob, resolve_knob,
                                        set_knob_default)

_LAZY = {
    "ScenarioSpec": "repro_torch.scenario.spec",
    "ScenarioValidationError": "repro_torch.scenario.spec",
    "ModelSpec": "repro_torch.scenario.spec",
    "BatcherSpec": "repro_torch.scenario.spec",
    "DataSpec": "repro_torch.scenario.spec",
    "TrainSpec": "repro_torch.scenario.spec",
    "ServeSpec": "repro_torch.scenario.spec",
    "KnobsSpec": "repro_torch.scenario.spec",
    "ObsSpec": "repro_torch.scenario.spec",
    "SCHEMA_VERSION": "repro_torch.scenario.spec",
    "parse_set_args": "repro_torch.scenario.spec",
}

__all__ = ["UNSET", "Knob", "get_knob", "resolve_knob",
           "set_knob_default"] + sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
