"""Qwen3-MoE 235B-A22B (hf:Qwen/Qwen3-30B-A3B family; hf) — 128 experts top-8.
94L d_model=4096 64H (GQA kv=4, d_head=64) expert d_ff=1536 vocab=151936.

Torch port of ``repro/configs/qwen3_moe_235b_a22b.py``: the same CONFIG and
smoke_config(); the dry-run cells (SHAPES, build_cell) are ROADMAP A10b.
"""
from repro_torch.configs.registry import refuse_cells
from repro_torch.models.lm.moe import MoEConfig
from repro_torch.models.lm.transformer import LMConfig

ARCH_ID = "qwen3-moe-235b-a22b"
FAMILY = "lm"
CONFIG = LMConfig(name=ARCH_ID, n_layers=94, d_model=4096, n_heads=64,
                  n_kv_heads=4, d_head=64, d_ff=0, vocab=151936,
                  activation="swiglu", param_dtype="bfloat16",
                  moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536,
                                capacity_factor=1.25, pad_to=16))

build_cell, __getattr__ = refuse_cells(ARCH_ID)


def smoke_config():
    return LMConfig(name=ARCH_ID + "-smoke", n_layers=2, d_model=64,
                    n_heads=8, n_kv_heads=2, d_head=8, d_ff=0, vocab=512,
                    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                                  pad_to=4))
