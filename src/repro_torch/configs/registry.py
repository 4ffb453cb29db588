"""Architecture registry: ``--arch <id>`` resolution plus the declarative
ScenarioSpec factory for every recsys arch (torch port of
``repro/configs/registry.py``).

:func:`scenario` / :func:`all_scenarios` give the same specs as the
reference's: the same JSON bytes and hashes. :func:`get_arch` resolves the
five LM archs, ``mace`` and the paper's four ROO models to their config
modules. The dry-run cells are not ported yet (ROADMAP A10b):
:func:`all_cells`, the LM and MACE modules' ``SHAPES`` / ``build_cell``,
and :func:`get_arch` for the four recsys cell wrappers (``mind``,
``bert4rec``, ``dlrm-mlperf``, ``dien``, whose models live in
``models/``) raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import importlib
from typing import List, Mapping, Optional

# the port's config modules by arch id; None = not ported yet (A10b)
_MODULES = {
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "mace": "repro_torch.configs.mace",
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

CELLS_NOT_PORTED = ("the dry-run cells and the recsys cell wrappers are not "
                    "ported yet (ROADMAP A10b)")


def get_arch(arch_id: str):
    """The arch's config module; raises ``NotImplementedError`` (A10b) for
    the recsys cell wrappers."""
    module = _MODULES[arch_id]
    if module is None:
        raise NotImplementedError(f"{arch_id}: {CELLS_NOT_PORTED}")
    return importlib.import_module(module)


def all_cells() -> List[tuple]:
    """All (arch, shape) dry-run cells — none in the port yet (A10b)."""
    raise NotImplementedError(f"dry-run cells: {CELLS_NOT_PORTED}")


def refuse_cells(arch_id: str):
    """``(build_cell, module __getattr__)`` for a config module whose cells
    are not ported: both raise naming A10b, the latter for ``SHAPES``."""
    def build_cell(shape_name, plan, opt_level="baseline"):
        raise NotImplementedError(f"{arch_id}.build_cell: {CELLS_NOT_PORTED}")

    def module_getattr(name):
        if name == "SHAPES":
            raise NotImplementedError(f"{arch_id}.SHAPES: {CELLS_NOT_PORTED}")
        raise AttributeError(f"module of {arch_id!r} has no attribute "
                             f"{name!r}")
    return build_cell, module_getattr


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
