"""DeepSeek-Coder-33B (arXiv:2401.14196; hf) — llama-arch dense GQA.
62L d_model=7168 56H (GQA kv=8, d_head=128) d_ff=19200 vocab=32256.

Torch port of ``repro/configs/deepseek_coder_33b.py``: the same CONFIG and
smoke_config(), SHAPES and build_cell().
"""
from repro_torch.configs.lm_cells import LM_SHAPES, build_lm_cell
from repro_torch.models.lm.transformer import LMConfig

ARCH_ID = "deepseek-coder-33b"
FAMILY = "lm"
SHAPES = LM_SHAPES
CONFIG = LMConfig(name=ARCH_ID, n_layers=62, d_model=7168, n_heads=56,
                  n_kv_heads=8, d_head=128, d_ff=19200, vocab=32256,
                  activation="swiglu", rope_theta=1e5)


def build_cell(shape_name, plan, opt_level="baseline"):
    return build_lm_cell(CONFIG, shape_name, plan, opt_level)


def smoke_config():
    return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=64,
                    n_heads=8, n_kv_heads=4, d_head=8, d_ff=96, vocab=512)
