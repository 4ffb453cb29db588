"""Granite-3.0 MoE 3B-A800M (hf:ibm-granite; hf) — 40 experts top-8.
32L d_model=1536 24H (GQA kv=8, d_head=64) expert d_ff=512 vocab=49155.
vocab padded 49155 -> 49184 (divisible by 32-way vocab sharding).

Torch port of ``repro/configs/granite_moe_3b_a800m.py``: the same CONFIG and
smoke_config(), SHAPES and build_cell().
"""
from repro_torch.configs.lm_cells import LM_SHAPES, build_lm_cell
from repro_torch.models.lm.moe import MoEConfig
from repro_torch.models.lm.transformer import LMConfig

ARCH_ID = "granite-moe-3b-a800m"
FAMILY = "lm"
SHAPES = LM_SHAPES
CONFIG = LMConfig(name=ARCH_ID, n_layers=32, d_model=1536, n_heads=24,
                  n_kv_heads=8, d_head=64, d_ff=0, vocab=49184,
                  activation="swiglu",
                  moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                                capacity_factor=1.25, pad_to=16))


def build_cell(shape_name, plan):
    return build_lm_cell(CONFIG, shape_name, plan)


def smoke_config():
    return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=48,
                    n_heads=6, n_kv_heads=2, d_head=8, d_ff=0, vocab=512,
                    moe=MoEConfig(n_experts=5, top_k=2, d_ff_expert=32,
                                  pad_to=4))
