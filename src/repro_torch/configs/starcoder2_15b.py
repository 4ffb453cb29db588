"""StarCoder2-15B (arXiv:2402.19173; hf) — dense GQA, RoPE.
40L d_model=6144 48H (GQA kv=4, d_head=128) d_ff=24576 vocab=49152.

Torch port of ``repro/configs/starcoder2_15b.py``: the same CONFIG and
smoke_config(), SHAPES and build_cell().
"""
from repro_torch.configs.lm_cells import LM_SHAPES, build_lm_cell
from repro_torch.models.lm.transformer import LMConfig

ARCH_ID = "starcoder2-15b"
FAMILY = "lm"
SHAPES = LM_SHAPES
CONFIG = LMConfig(name=ARCH_ID, n_layers=40, d_model=6144, n_heads=48,
                  n_kv_heads=4, d_head=128, d_ff=24576, vocab=49152,
                  activation="gelu", rope_theta=1e5)


def build_cell(shape_name, plan):
    return build_lm_cell(CONFIG, shape_name, plan)


def smoke_config():
    return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=64,
                    n_heads=8, n_kv_heads=2, d_head=8, d_ff=128, vocab=512,
                    activation="gelu")
