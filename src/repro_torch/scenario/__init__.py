"""repro_torch.scenario — the runtime knob ladder and, in ``build``, the
dlrm-mlperf batch source (the spec layer is not ported yet)."""
from repro_torch.scenario.knobs import (UNSET, Knob, get_knob, resolve_knob,
                                        set_knob_default)

__all__ = ["UNSET", "Knob", "get_knob", "resolve_knob", "set_knob_default"]
