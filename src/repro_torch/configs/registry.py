"""Architecture registry: ``--arch <id>`` resolution plus the declarative
ScenarioSpec factory for every recsys arch (torch port of
``repro/configs/registry.py``).

:func:`scenario` / :func:`all_scenarios` give the same specs as the
reference's: the same JSON bytes and hashes. The dry-run cells and the LM
and MACE archs are not ported yet (ROADMAP A10): :func:`get_arch` and
:func:`all_cells` raise ``NotImplementedError`` for them instead of
importing a module that does not exist.
"""
from __future__ import annotations

import importlib
from typing import List, Mapping, Optional

# the port's config modules by arch id; None = not ported yet (A10)
_MODULES = {
    "starcoder2-15b": None,
    "deepseek-coder-33b": None,
    "phi3-medium-14b": None,
    "qwen3-moe-235b-a22b": None,
    "granite-moe-3b-a800m": None,
    "mace": None,
    "mind": None,
    "bert4rec": None,
    "dlrm-mlperf": None,
    "dien": None,
    # the paper's own ROO models (selectable for train/bench, not dry-run cells)
    "roo-lsr": "repro_torch.configs.roo_models",
    "roo-esr": "repro_torch.configs.roo_models",
    "roo-retrieval": "repro_torch.configs.roo_models",
    "hstu-gr": "repro_torch.configs.roo_models",
}

NOT_PORTED = ("the LM, MACE and dry-run cell configs are not ported yet "
              "(ROADMAP A10)")


def get_arch(arch_id: str):
    """The arch's config module; raises ``NotImplementedError`` (A10) for
    the LM, MACE and dry-run cell archs."""
    module = _MODULES[arch_id]
    if module is None:
        raise NotImplementedError(f"{arch_id}: {NOT_PORTED}")
    return importlib.import_module(module)


def all_cells() -> List[tuple]:
    """All (arch, shape) dry-run cells — none in the port yet (A10)."""
    raise NotImplementedError(f"dry-run cells: {NOT_PORTED}")


# ---------------------------------------------------------------------------
# Declarative scenarios (the recsys zoo as ScenarioSpecs)
# ---------------------------------------------------------------------------

# every trainable recsys arch
SCENARIO_ARCHS = ("roo-lsr", "roo-esr", "roo-retrieval", "hstu-gr",
                  "dien", "mind", "bert4rec", "dlrm-mlperf")


def scenario(arch_id: str, overrides: Optional[Mapping] = None):
    """The registered ScenarioSpec for ``arch_id``, optionally with dotted
    ``--set``-style overrides (e.g. ``{"train.steps": 20}``) applied."""
    from repro_torch.scenario.spec import (BatcherSpec, DataSpec, ModelSpec,
                                           ScenarioSpec)
    if arch_id not in SCENARIO_ARCHS:
        raise KeyError(f"no registered scenario {arch_id!r}; "
                       f"known: {SCENARIO_ARCHS}")
    model = ModelSpec(arch=arch_id)
    batcher = BatcherSpec()
    data = DataSpec(hist_init_max=48, n_requests=800)
    if arch_id == "bert4rec":
        model = ModelSpec(arch=arch_id, seq_len=65)
    elif arch_id == "dien":
        model = ModelSpec(arch=arch_id, seq_len=64)
    elif arch_id == "dlrm-mlperf":
        # MLPerf-shaped at reduced scale; field-dict batches come from the
        # synthetic generator, not the ROO event stream
        model = ModelSpec(arch=arch_id, n_items=0, embed_dim=16)
        batcher = BatcherSpec(b_ro=8, b_nro=32)
        data = DataSpec(source="synthetic")
    spec = ScenarioSpec(name=arch_id, model=model, batcher=batcher,
                        data=data).validate()
    return spec.with_overrides(overrides) if overrides else spec


def all_scenarios() -> List:
    """Every registered recsys scenario."""
    return [scenario(a) for a in SCENARIO_ARCHS]
