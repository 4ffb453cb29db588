"""MACE (arXiv:2206.07697) — E(3)-equivariant higher-order message passing.
n_layers=2, d_hidden=128, l_max=2, correlation=3, n_rbf=8 (the defaults of
``models.gnn.mace.MACEConfig``).

Torch port of ``repro/configs/mace.py``.
"""
from repro_torch.configs.mace_cells import MACE_SHAPES, build_mace_cell

ARCH_ID = "mace"
FAMILY = "gnn"
SHAPES = MACE_SHAPES


def build_cell(shape_name, plan, opt_level="baseline"):
    return build_mace_cell(shape_name, plan, opt_level)
