"""DLRM MLPerf config (arXiv:1906.00091) — Criteo 1TB: 13 dense, 26 sparse,
embed_dim=128, bot 13-512-256-128, top 1024-1024-512-256-1, dot interaction.

Torch port of ``repro/configs/dlrm_mlperf.py``.
"""
from repro_torch.configs.recsys_cells import RECSYS_SHAPES, build_dlrm_cell

ARCH_ID = "dlrm-mlperf"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def build_cell(shape_name, plan, opt_level="baseline"):
    return build_dlrm_cell(shape_name, plan, opt_level)
