"""KV-cache prefill + decode for the LM family (torch port of
``repro/models/lm/decode.py``).

Cache layout: (L, B, S_max, KV, dh) per K and V, in bf16 whatever the
compute dtype, and ``pos``, the next position, a 0-d int32 tensor on the
cache's device. :func:`serve_step` never reads ``pos`` back to the host:
the new K/V go in with ``index_copy`` at ``pos`` (clamped to the last slot,
as ``dynamic_update_slice`` clamps) and the causal + filled mask compares
positions on the device. Each step returns a new cache, as the reference's
functional update does; the caller's stays as it was.

Per-step decode attention is O(S·d): one new token against the filled
cache. :class:`CacheSpec` is the reference's record of how a cache shards;
a plan or a ``CacheSpec`` is refused (the LM under a plan is ROADMAP A9b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.embeddings.sparse import gather_rows
from repro_torch.models.lm.transformer import (LMConfig, _attention, _ffn,
                                               _qkv, _rmsnorm, layer_params,
                                               lm_forward, lm_logits,
                                               refuse_plan)


def _refuse(plan, cs) -> None:
    refuse_plan(plan)
    if cs is not None:
        raise NotImplementedError(
            "a sharded KV cache (CacheSpec) is not ported yet (ROADMAP A9b)")


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """How the KV cache shards: seq axis entries + batch axis entries."""
    batch_axes: object        # e.g. ("data",) or None (replicated)
    seq_axes: object          # e.g. "model" or ("data", "model")


def init_cache(cfg: LMConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device="cuda") -> Dict:
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(params: Dict, cfg: LMConfig, tokens: torch.Tensor,
            plan=None, s_max: Optional[int] = None,
            cs: Optional[CacheSpec] = None) -> Tuple[torch.Tensor, Dict]:
    """Full forward over the prompt; returns (last-position logits (B, V)
    f32, the cache filled to the prompt's length)."""
    _refuse(plan, cs)
    b, s = tokens.shape
    s_max = s_max or s
    hidden, (k, v) = lm_forward(params, cfg, tokens, collect_kv=True)
    logits = lm_logits(params, cfg, hidden[:, -1:, :])[:, 0]
    pad = (0, 0, 0, 0, 0, s_max - s)          # the S axis, from the back
    return logits, {"k": F.pad(k.to(torch.bfloat16), pad),
                    "v": F.pad(v.to(torch.bfloat16), pad),
                    "pos": torch.tensor(s, dtype=torch.int32,
                                        device=tokens.device)}


def serve_step(params: Dict, cfg: LMConfig, cache: Dict,
               tokens: torch.Tensor, plan=None,
               cs: Optional[CacheSpec] = None) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B, 1) -> (logits (B, V) f32, the updated
    cache: the new K/V at ``pos``, ``pos + 1``)."""
    _refuse(plan, cs)
    b = tokens.shape[0]
    cdt = cfg.cdtype
    s_max = cache["k"].shape[2]
    pos = cache["pos"]
    dev = tokens.device
    x = gather_rows(params["embed"], tokens).to(cdt)              # (B, 1, d)
    positions = pos.reshape(1, 1).expand(b, 1).to(torch.int32)
    kv_pos = torch.arange(s_max, dtype=torch.int32, device=dev)[None].expand(
        b, s_max)
    kv_valid = kv_pos <= pos                                       # causal+filled
    at = torch.clamp(pos, max=s_max - 1).reshape(1).long()
    new_k, new_v = [], []
    for lyr, k_c, v_c in zip(layer_params(params, cdt), cache["k"],
                             cache["v"]):
        q, k_new, v_new = _qkv(_rmsnorm(x, lyr["attn_norm"]), lyr, cfg,
                               positions)
        k_c = k_c.index_copy(1, at, k_new.to(k_c.dtype))
        v_c = v_c.index_copy(1, at, v_new.to(v_c.dtype))
        attn = _attention(q, k_c.to(cdt), v_c.to(cdt), positions, kv_pos,
                          cfg, kv_valid=kv_valid)
        x = _ffn(x + attn.reshape(b, 1, -1) @ lyr["wo"], lyr, cfg)
        new_k.append(k_c)
        new_v.append(v_c)
    x = _rmsnorm(x, params["final_norm"])
    logits = lm_logits(params, cfg, x)[:, 0]
    return logits, {"k": torch.stack(new_k), "v": torch.stack(new_v),
                    "pos": pos + 1}
