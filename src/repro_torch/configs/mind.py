"""MIND (arXiv:1904.08030) — multi-interest retrieval. embed_dim=64,
n_interests=4, capsule_iters=3.

Torch port of ``repro/configs/mind.py``.
"""
from repro_torch.configs.recsys_cells import RECSYS_SHAPES, build_mind_cell

ARCH_ID = "mind"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def build_cell(shape_name, plan):
    return build_mind_cell(shape_name, plan)
