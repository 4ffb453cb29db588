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
cache.

Under an SPMD plan :class:`CacheSpec` says how the cache shards
(:func:`cache_specs`): its batch over ``batch_axes`` (None: whole) and its
sequence over ``seq_axes`` (``lm_cells``: ``model``, or ``(data, model)``
for the batch-1 long context). The tokens are the global batch on every
rank and the logits come back whole; each rank holds its block of the
cache. :func:`prefill` runs the plan forward (the batch split over the
batch axes where they divide it, as the reference lays it out), gathers
the batch back where the cache holds it whole, and cuts the padded
sequence to this rank's slots. :func:`serve_step` embeds through the
vocab-parallel table, runs the attention's weights whole, writes the new
K/V on the rank that owns ``pos`` (a ``torch.where`` on the device: no
host read), attends over its local slots and merges the partial max, sum
and weighted V over the sequence axes exactly (log-sum-exp); the dense
FFN runs its d_ff slice and sums over ``model``, the MoE its
replicated-token route (``seq_sharded=False``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingPlan, replicated_plan)
from repro_torch.embeddings.sparse import gather_rows
from repro_torch.models.lm.moe import moe_layer
from repro_torch.models.lm.transformer import (LMConfig, _attention, _ffn,
                                               _forward_plan, _local_ids,
                                               _qkv, _rmsnorm, _Route,
                                               _vocab_logits, layer_params,
                                               lm_forward, lm_logits, rope)


def _enabled(plan) -> bool:
    return plan is not None and plan.enabled


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """How the KV cache shards: seq axis entries + batch axis entries."""
    batch_axes: object        # e.g. ("data",) or None (replicated)
    seq_axes: object          # e.g. "model" or ("data", "model")


def cache_specs(cfg: LMConfig, plan, cs: CacheSpec) -> Dict:
    """The cache's specs (reference ``decode.py:43-47``)."""
    return {"k": (None, cs.batch_axes, cs.seq_axes, None, None),
            "v": (None, cs.batch_axes, cs.seq_axes, None, None),
            "pos": ()}


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
    f32, the cache filled to the prompt's length; under a plan this
    rank's block of it by ``cs``)."""
    if _enabled(plan):
        return _prefill_plan(params, cfg, tokens, plan, s_max, cs)
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
    cache: the new K/V at ``pos``, ``pos + 1``). Under a plan ``cache`` is
    this rank's block by ``cs`` (module note)."""
    if _enabled(plan):
        return _serve_step_plan(params, cfg, cache, tokens, plan, cs)
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


# ---------------------------------------------------------------------------
# under a plan (module note)
# ---------------------------------------------------------------------------

class _Layout:
    """A ``CacheSpec`` on a plan: the batch and sequence axes, this rank's
    coordinates along them."""

    def __init__(self, plan, cs: Optional[CacheSpec]):
        from repro_torch.distributed import spmd
        cs = cs or CacheSpec(None, None)
        self.b_names = spmd.entry_axes(cs.batch_axes)
        self.s_names = spmd.entry_axes(cs.seq_axes)
        self.b_axes = spmd.plan_axes(plan, self.b_names)
        self.s_axes = spmd.plan_axes(plan, self.s_names)
        self.s_groups = [plan.mesh.group(a) for a in self.s_names]


def _prefill_plan(params, cfg: LMConfig, tokens, plan, s_max, cs):
    from repro_torch.distributed import collectives as coll
    lay = _Layout(plan, cs)
    r = _Route(cfg, plan)
    b, s = tokens.shape
    s_max = s_max or s
    n_b, n_s = coll.axes_size(lay.b_axes), coll.axes_size(lay.s_axes)
    if b % n_b or s_max % n_s:
        raise ValueError(f"batch {b} / s_max {s_max} do not split over the "
                         f"cache's {lay.b_names} / {lay.s_names}")
    hidden, (k, v) = _forward_plan(params, cfg, tokens, r, True)
    last = coll.gather_dim(hidden, r.m_axes, 1)[:, -1:, :]
    logits = coll.gather_dim(_vocab_logits(params, cfg, last, r)[:, 0],
                             r.m_axes, 1)
    if r.batch_split(b):
        logits = coll.gather_dim(logits, r.b_axes, 0)
        k, v = (coll.gather_dim(t, r.b_axes, 1) for t in (k, v))
    pad = (0, 0, 0, 0, 0, s_max - s)
    cache = {}
    for name, t in (("k", k), ("v", v)):
        t = F.pad(t.to(torch.bfloat16), pad)
        t = coll.chunk_dim(t, lay.b_axes, 1) if lay.b_axes else t
        cache[name] = (coll.chunk_dim(t, lay.s_axes, 2) if lay.s_axes
                       else t).contiguous()
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return logits, cache


def _attention_merged(q, k_c, v_c, positions, kv_pos, kv_valid, lay,
                      cfg: LMConfig):
    """One new token's attention over this rank's cache slots, merged
    over the sequence axes: the partial max, sum and weighted V of each
    rank combine exactly (log-sum-exp). q: (B, 1, H, dh); k_c, v_c: (B,
    S_loc, KV, dh); kv_pos: (B, S_loc) global slot positions."""
    from repro_torch.distributed import collectives as coll
    b, _, h, dh = q.shape
    kvh = k_c.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, dh).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_c.float()) * dh ** -0.5
    mask = (kv_pos <= positions) & kv_valid                  # (B, S_loc)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    mx = coll.all_reduce_max(scores.amax(-1), lay.s_groups)  # (B, KV, G)
    p = torch.exp(scores - mx[..., None])
    l_sum = p.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_c.float())
    if lay.s_groups:
        l_sum = coll.all_reduce_sum(l_sum, lay.s_groups)
        o = coll.all_reduce_sum(o, lay.s_groups)
    return (o / l_sum[..., None]).reshape(b, 1, h, dh).to(q.dtype)


def _serve_step_plan(params, cfg: LMConfig, cache, tokens, plan, cs):
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import spmd
    lay = _Layout(plan, cs)
    r = _Route(cfg, plan)
    cdt = cfg.cdtype
    dev = tokens.device
    if lay.b_axes:
        tokens = coll.chunk_dim(tokens, lay.b_axes, 0)
    b = tokens.shape[0]
    s_loc = cache["k"].shape[2]
    s_max = s_loc * coll.axes_size(lay.s_axes)
    lo = coll.axes_index(lay.s_axes) * s_loc
    pos = cache["pos"]
    m_groups = [spmd.model_group(plan)]
    # the vocab-parallel lookup, summed over model: x whole on every rank
    emb = r.vocab_rows(params, "embed")
    local, ok = _local_ids(tokens, emb.shape[0], r.k_model)
    x = coll.all_reduce_sum(gather_rows(emb, local)
                            * ok[..., None].to(emb.dtype), m_groups).to(cdt)
    positions = pos.reshape(1, 1).expand(b, 1).to(torch.int32)
    kv_pos = (lo + torch.arange(s_loc, dtype=torch.int32, device=dev)
              )[None].expand(b, s_loc)
    kv_valid = kv_pos <= pos
    at = torch.clamp(pos, max=s_max - 1) - lo
    own = (at >= 0) & (at < s_loc)                  # this rank holds pos
    at = torch.clamp(at, 0, s_loc - 1).reshape(1).long()
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    new_k, new_v = [], []
    for lyr, k_c, v_c in zip(layer_params(params, cdt), cache["k"],
                             cache["v"]):
        wq = r.weight(lyr, "wq", model_too=True)
        wo = r.weight(lyr, "wo", model_too=True)
        xn = _rmsnorm(x, lyr["attn_norm"])
        q = rope((xn @ wq).reshape(b, 1, h, dh), positions, cfg.rope_theta)
        kvp = (xn @ r.weight(lyr, "wkv")).reshape(b, 1, 2, kvh, dh)
        k_new = rope(kvp[:, :, 0], positions, cfg.rope_theta)
        k_c = torch.where(own, k_c.index_copy(1, at, k_new.to(k_c.dtype)),
                          k_c)
        v_c = torch.where(own, v_c.index_copy(
            1, at, kvp[:, :, 1].to(v_c.dtype)), v_c)
        attn = _attention_merged(q, k_c.to(cdt), v_c.to(cdt), positions,
                                 kv_pos, kv_valid, lay, cfg)
        x = x + attn.reshape(b, 1, -1) @ wo
        xn = _rmsnorm(x, lyr["mlp_norm"])
        if cfg.moe is not None:
            y = moe_layer(xn, lyr, cfg.moe, plan, seq_sharded=False,
                          batch_whole=not lay.b_axes)
        else:
            w1 = r.weight(lyr, "w1")
            if cfg.activation == "swiglu":
                hh = F.silu(xn @ w1) * (xn @ r.weight(lyr, "w3"))
            else:
                hh = F.gelu(xn @ w1, approximate="tanh")
            y = coll.all_reduce_sum(hh @ r.weight(lyr, "w2"), m_groups)
        x = x + y
        new_k.append(k_c)
        new_v.append(v_c)
    x = _rmsnorm(x, params["final_norm"])
    logits = coll.gather_dim(_vocab_logits(params, cfg, x, r)[:, 0],
                             r.m_axes, 1)
    if lay.b_axes:
        logits = coll.gather_dim(logits, lay.b_axes, 0)
    return logits, {"k": torch.stack(new_k), "v": torch.stack(new_v),
                    "pos": pos + 1}
