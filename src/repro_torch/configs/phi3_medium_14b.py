"""Phi-3-medium-14B (arXiv:2404.14219; unverified) — RoPE SwiGLU GQA.
40L d_model=5120 40H (GQA kv=10, d_head=128) d_ff=17920 vocab=100352.

Torch port of ``repro/configs/phi3_medium_14b.py``: the same CONFIG and
smoke_config(); the dry-run cells (SHAPES, build_cell) are ROADMAP A10b.
"""
from repro_torch.configs.registry import refuse_cells
from repro_torch.models.lm.transformer import LMConfig

ARCH_ID = "phi3-medium-14b"
FAMILY = "lm"
CONFIG = LMConfig(name=ARCH_ID, n_layers=40, d_model=5120, n_heads=40,
                  n_kv_heads=10, d_head=128, d_ff=17920, vocab=100352,
                  activation="swiglu")

build_cell, __getattr__ = refuse_cells(ARCH_ID)


def smoke_config():
    return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=80,
                    n_heads=10, n_kv_heads=5, d_head=8, d_ff=128, vocab=512)
