"""BERT4Rec (arXiv:1904.06690) — bidirectional sequential. embed_dim=64,
n_blocks=2, n_heads=2, seq_len=200.

Torch port of ``repro/configs/bert4rec.py``.
"""
from repro_torch.configs.recsys_cells import RECSYS_SHAPES, build_bert4rec_cell

ARCH_ID = "bert4rec"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def build_cell(shape_name, plan):
    return build_bert4rec_cell(shape_name, plan)
