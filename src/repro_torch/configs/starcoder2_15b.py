"""StarCoder2-15B (arXiv:2402.19173; hf) — dense GQA, RoPE.
40L d_model=6144 48H (GQA kv=4, d_head=128) d_ff=24576 vocab=49152.

Torch port of ``repro/configs/starcoder2_15b.py``: the same CONFIG and
smoke_config(); the dry-run cells (SHAPES, build_cell) are ROADMAP A10b.
"""
from repro_torch.configs.registry import refuse_cells
from repro_torch.models.lm.transformer import LMConfig

ARCH_ID = "starcoder2-15b"
FAMILY = "lm"
CONFIG = LMConfig(name=ARCH_ID, n_layers=40, d_model=6144, n_heads=48,
                  n_kv_heads=4, d_head=128, d_ff=24576, vocab=49152,
                  activation="gelu", rope_theta=1e5)

build_cell, __getattr__ = refuse_cells(ARCH_ID)


def smoke_config():
    return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=64,
                    n_heads=8, n_kv_heads=2, d_head=8, d_ff=128, vocab=512,
                    activation="gelu")
