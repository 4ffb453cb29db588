"""MACE (arXiv:2206.07697) — E(3)-equivariant higher-order message passing.
n_layers=2, d_hidden=128, l_max=2, correlation=3, n_rbf=8 (the defaults of
``models.gnn.mace.MACEConfig``).

Torch port of ``repro/configs/mace.py``; the dry-run cells (SHAPES,
build_cell) are ROADMAP A10b.
"""
from repro_torch.configs.registry import refuse_cells

ARCH_ID = "mace"
FAMILY = "gnn"

build_cell, __getattr__ = refuse_cells(ARCH_ID)
