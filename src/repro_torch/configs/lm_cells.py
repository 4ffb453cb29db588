"""Cell builders for the LM-family architectures (train / prefill / decode);
torch port of ``repro/configs/lm_cells.py``.

Shapes (assigned):
  train_4k     seq 4096,   global_batch 256   -> train_step (loss+grad+adam)
  prefill_32k  seq 32768,  global_batch 32    -> prefill (forward + KV cache)
  decode_32k   seq 32768,  global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524288, global_batch 1     -> serve_step (1 new token)

The specs are the reference's. The LM's plan route takes the global tokens
on every rank (``models/lm/transformer.py``), so a step first all-gathers
its rank's block of the tokens over the batch axes (``base.whole_batch``;
int32: 4 MiB a step at train_4k).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import (Cell, abstract, cell_train_step,
                                      ids_below, sds, whole_batch)
from repro_torch.distributed.sharding import ShardingPlan
from repro_torch.models.lm.decode import (CacheSpec, cache_specs, init_cache,
                                          prefill, serve_step)
from repro_torch.models.lm.transformer import (LMConfig, lm_block_specs,
                                               lm_grad_axes, lm_init, lm_loss,
                                               lm_param_specs)
from repro_torch.train.optim import adam

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}
LM_OPT_LEVELS = ("baseline", "flash", "flash_bf16", "megatron_sp")


def _attn_flops(cfg: LMConfig, b: int, s: int, causal: bool = True) -> float:
    f = 4.0 * b * s * s * cfg.n_heads * cfg.d_head * cfg.n_layers
    return f * (0.5 if causal else 1.0)


def _opt():
    return adam(lr=1e-4, b1=0.9, b2=0.95)


def build_lm_cell(cfg: LMConfig, shape_name: str, plan: ShardingPlan,
                  opt_level: str = "baseline") -> Cell:
    """opt_level:
      flash       — q-chunked attention for training seqs (no (S,S) score
                    materialization in memory);
      flash_bf16  — + bf16 parameter storage (halves FSDP all-gather bytes;
                    fp32 Adam moments retained);
      megatron_sp — the explicit SP<->TP schedule (``use_spmd_layer``), the
                    head count padded to the TP degree as the reference
                    pads it (zero-padded projections), bf16 params."""
    if opt_level not in LM_OPT_LEVELS:
        raise ValueError(f"{cfg.name} has no opt level {opt_level!r}")
    if opt_level in ("flash", "flash_bf16"):
        cfg = dataclasses.replace(cfg, full_attn_max_seq=1024, q_chunk=1024)
    if opt_level == "flash_bf16":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if opt_level == "megatron_sp":
        tp = 16
        h_pad = ((cfg.n_heads + tp - 1) // tp) * tp
        cfg = dataclasses.replace(cfg, use_spmd_layer=True, n_heads=h_pad,
                                  param_dtype="bfloat16")
    sh = LM_SHAPES[shape_name]
    b, s = sh["batch"], sh["seq"]
    kind = sh["kind"]
    opt = _opt()
    tokens = ids_below(cfg.vocab)

    def abstract_params():
        return abstract(lambda: lm_init(torch.Generator(), cfg,
                                        device="meta"))

    pspecs = lm_param_specs(cfg, plan)

    if kind == "train":
        def abstract_state():
            params = abstract_params()
            return {"params": params, "opt": abstract(lambda: opt.init(
                params)), "step": sds((), torch.int32)}

        def state_pspecs(plan):
            return {"params": pspecs,
                    "opt": {"m": pspecs, "v": pspecs, "t": ()},
                    "step": ()}

        def input_specs():
            return {"tokens": sds((b, s), torch.int32),
                    "labels": sds((b, s), torch.int32)}

        def input_pspecs(plan):
            ba = plan.batch_axes
            return {"tokens": (ba, None), "labels": (ba, None)}

        def loss(p, inputs):
            return lm_loss(p, cfg, whole_batch(inputs["tokens"], b, plan),
                           whole_batch(inputs["labels"], b, plan), plan)

        step = cell_train_step(
            loss, opt, plan, lambda: lm_block_specs(cfg, plan),
            lm_grad_axes(cfg, plan) if plan.enabled else None)
        flops = (6.0 * cfg.n_active_params() * b * s
                 + 3 * _attn_flops(cfg, b, s))
        return Cell(cfg.name, shape_name, "train", step, abstract_state,
                    state_pspecs, input_specs, input_pspecs, flops,
                    fill={"tokens": tokens, "labels": tokens})

    # ---- serving cells --------------------------------------------------------
    if shape_name == "long_500k":
        cs = CacheSpec(batch_axes=None,
                       seq_axes=tuple(plan.batch_axes) + (plan.model_axis,))
    else:
        cs = CacheSpec(batch_axes=plan.batch_axes, seq_axes=plan.model_axis)

    def abstract_state():
        return {"params": abstract_params()}

    def state_pspecs(plan):
        return {"params": pspecs}

    if kind == "prefill":
        def step(state, inputs):
            tokens = whole_batch(inputs["tokens"], b, plan)
            with torch.no_grad():
                return prefill(state["params"], cfg, tokens, plan, s_max=s,
                               cs=cs)

        def input_specs():
            return {"tokens": sds((b, s), torch.int32)}

        def input_pspecs(plan):
            return {"tokens": (plan.batch_axes, None)}

        flops = 2.0 * cfg.n_active_params() * b * s + _attn_flops(cfg, b, s)
        return Cell(cfg.name, shape_name, "serve", step, abstract_state,
                    state_pspecs, input_specs, input_pspecs, flops,
                    fill={"tokens": tokens})

    # decode
    def step(state, inputs):
        tokens = whole_batch(inputs["tokens"], b, plan)
        with torch.no_grad():
            return serve_step(state["params"], cfg, inputs["cache"], tokens,
                              plan, cs=cs)

    def input_specs():
        cache = abstract(functools.partial(init_cache, cfg, b, s,
                                           torch.bfloat16, "meta"))
        return {"cache": cache, "tokens": sds((b, 1), torch.int32)}

    def input_pspecs(plan):
        return {"cache": cache_specs(cfg, plan, cs),
                "tokens": (cs.batch_axes, None)}

    flops = (2.0 * cfg.n_active_params() * b
             + 4.0 * b * s * cfg.n_heads * cfg.d_head * cfg.n_layers)
    def empty_cache(spec, gen, device):
        return init_cache(cfg, b, s, torch.bfloat16, device)

    return Cell(cfg.name, shape_name, "serve", step, abstract_state,
                state_pspecs, input_specs, input_pspecs, flops,
                notes="long-context decode is O(S*d)/step; 500k prefill "
                      "(quadratic) intentionally not lowered" if s > 100000
                else "", fill={"cache": empty_cache, "tokens": tokens})
