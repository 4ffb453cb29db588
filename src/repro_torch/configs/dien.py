"""DIEN (arXiv:1809.03672) — embed_dim=18, seq_len=100, gru_dim=108,
MLP 200-80, AUGRU.

Torch port of ``repro/configs/dien.py``.
"""
from repro_torch.configs.recsys_cells import RECSYS_SHAPES, build_dien_cell

ARCH_ID = "dien"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def build_cell(shape_name, plan):
    return build_dien_cell(shape_name, plan)
