"""Generative Recommender (GR) ranking on HSTU (paper §3.3), torch port of
``repro/models/gr.py``.

One autoregressive HSTU stack over the user's interleaved (item, action)
history, used two ways:

  * ranking    — the request's m targets appended under the ROO mask
    (core.sequence), multi-task logits read from the target positions;
    trained with :func:`gr_ranking_loss` (masked multi-task BCE);
  * retrieval  — next-item prediction over the history alone (a causal
    mask: targets NOT in the sequence), trained with
    :func:`gr_retrieval_loss` (in-batch sampled softmax).

Both losses are differentiable end to end; on the card the attention's
gradient comes from the backward kernels (kernels/hstu_attention_bwd.py).
The per-user state functions (``GRUserState``, ``gr_score_from_state``,
``gr_extend_user_state``) serve the same ranking incrementally from a
per-user K/V cache (forward only).

Every function takes the reference's ``plan=`` (``distributed/
sharding.py``): under an SPMD plan the item table is this rank's row
block and its lookups run through the collection's sharded route (one
B_RO-sized sum over ``model`` for the history), the batch is this rank's
data block, and each loss's batch sums are summed over the batch axes
(``spmd.data_sum``), which is what GSPMD makes of the reference's
``jnp.sum``. The retrieval loss's in-batch candidates are the whole
batch's: their ids are gathered over the batch axes first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.hstu import (HSTUConfig, hstu_apply, hstu_init,
                                   hstu_prefix_apply, normal_init)
from repro_torch.core.masks import causal_spec, prefix_spec
from repro_torch.core.roo_batch import ROOBatch
from repro_torch.core.sequence import (ROOSequenceConfig, encode_roo,
                                       gather_targets_to_ro,
                                       scatter_targets_to_nro)
from repro_torch.distributed import spmd
from repro_torch.embeddings import collection as ec
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.train.metrics import bce_terms


@dataclasses.dataclass(frozen=True)
class GRConfig:
    n_items: int
    hstu: HSTUConfig = None
    hist_len: int = 256
    m_targets: int = 16
    n_tasks: int = 2
    mode: str = "ranking"        # "ranking" | "retrieval"

    def seq_cfg(self) -> ROOSequenceConfig:
        return ROOSequenceConfig(self.hstu, self.hist_len, self.m_targets)


def gr_init(gen: torch.Generator, cfg: GRConfig, dtype=torch.float32,
            device="cuda") -> Dict:
    """Random params in the reference's layout, drawn from ``gen``."""
    d = cfg.hstu.d_model
    return {
        "item_emb": normal_init(gen, (cfg.n_items, d), 0.02, dtype, device),
        "act_emb": normal_init(gen, (4, d), 0.02, dtype, device),
        "hstu": hstu_init(gen, cfg.hstu, dtype, device),
        "task_head": mlp_init(gen, (d, 2 * d, cfg.n_tasks), dtype, device),
    }


def gr_history_repr(params: Dict, cfg: GRConfig, batch: ROOBatch,
                    plan=None) -> torch.Tensor:
    """Request-only half of GR ranking: embedded (item+action) history,
    (B_RO, hist_len, d)."""
    ids = batch.history_ids[:, :cfg.hist_len]
    acts = batch.history_actions[:, :cfg.hist_len]
    # item table row-sharded under a plan: one B_RO-sized sum over model
    e = ec.seq_lookup(params["item_emb"], ids, vocab=cfg.n_items, plan=plan)
    a = ec.seq_lookup(params["act_emb"], acts, vocab=4)
    return e + a


def gr_ranking_logits_from_history(params: Dict, cfg: GRConfig,
                                   batch: ROOBatch, hist: torch.Tensor,
                                   plan=None) -> torch.Tensor:
    """GR ranking logits given a precomputed history embedding."""
    lengths = torch.clamp(batch.history_lengths, max=cfg.hist_len)
    tgt_nro = ec.row_lookup(params["item_emb"], batch.item_ids,
                            vocab=cfg.n_items, plan=plan)
    tgt_ro = gather_targets_to_ro(tgt_nro, batch, cfg.m_targets)
    enc = encode_roo({"hstu": params["hstu"]}, cfg.seq_cfg(), hist, lengths,
                     tgt_ro, batch.num_impressions)          # (B_RO, m, d)
    feats = scatter_targets_to_nro(enc, batch, cfg.m_targets)
    return mlp_apply(params["task_head"], feats)


def gr_ranking_logits(params: Dict, cfg: GRConfig, batch: ROOBatch,
                      plan=None) -> torch.Tensor:
    """ROO ranking: encode [history | m targets] once per request;
    (B_NRO, n_tasks) logits."""
    return gr_ranking_logits_from_history(
        params, cfg, batch, gr_history_repr(params, cfg, batch, plan=plan),
        plan=plan)


class GRUserState(NamedTuple):
    """Per-user incremental serving state: the per-layer history K/V cache.

    Unbatched (as stored per user): k (n_layers, hist_len, H, dqk),
    v (n_layers, hist_len, H, dv), length () int32 — how many history
    events are resident. The serving store stacks these along a leading
    batch axis.
    """
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def gr_state_init(cfg: GRConfig, dtype=torch.float32,
                  device="cuda") -> GRUserState:
    """Empty (zero-length) user state — extend-from-empty through the prefix
    path computes exactly the full-recompute forward."""
    h = cfg.hstu
    return GRUserState(
        k=torch.zeros((h.n_layers, cfg.hist_len, h.n_heads, h.d_qk),
                      dtype=dtype, device=device),
        v=torch.zeros((h.n_layers, cfg.hist_len, h.n_heads, h.d_v),
                      dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


def _gr_new_event_emb(params: Dict, cfg: GRConfig, batch: ROOBatch,
                      prefix: torch.Tensor, n_new: int, plan=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed the n_new not-yet-cached history events of each request (row r
    of request b is history slot ``prefix[b] + r``). Returns
    (emb (B_RO, n_new, d), new_counts (B_RO,) int32), both on the batch's
    device."""
    n_hist = cfg.hist_len
    ids = batch.history_ids[:, :n_hist]
    acts = batch.history_actions[:, :n_hist]
    lengths = torch.clamp(batch.history_lengths, max=n_hist).to(torch.int32)
    new_counts = torch.clamp(lengths - prefix, min=0)
    rows = torch.arange(n_new, device=prefix.device)
    ridx = torch.clamp(prefix[:, None].long() + rows[None, :],
                       max=ids.shape[1] - 1)
    e = ec.seq_lookup(params["item_emb"], torch.gather(ids, 1, ridx),
                      vocab=cfg.n_items, plan=plan)
    a = ec.seq_lookup(params["act_emb"], torch.gather(acts, 1, ridx), vocab=4)
    return e + a, new_counts


def gr_score_from_state(params: Dict, cfg: GRConfig, batch: ROOBatch,
                        state: GRUserState, *, n_new: int, plan=None
                        ) -> Tuple[torch.Tensor, GRUserState]:
    """Incremental GR ranking: score the request's targets by attending
    [new events | targets] against the per-user K/V cache.

    ``state`` is a batched :class:`GRUserState` (leading B_RO axis) on the
    batch's device; ``n_new`` is the new-event row budget (>= every
    request's uncached-event count; extra rows are masked). With zero-length
    state and ``n_new == cfg.hist_len`` this computes exactly
    :func:`gr_ranking_logits` — the unified fallback path. Returns
    ``(logits (B_NRO, n_tasks), new_state)``.
    """
    prefix = state.length.to(torch.int32)
    emb, new_counts = _gr_new_event_emb(params, cfg, batch, prefix, n_new,
                                        plan=plan)
    tgt_nro = ec.row_lookup(params["item_emb"], batch.item_ids,
                            vocab=cfg.n_items, plan=plan)
    tgt_ro = gather_targets_to_ro(tgt_nro, batch, cfg.m_targets)
    x = torch.cat([emb, tgt_ro], dim=1)             # (B_RO, n_new + m, d)
    spec = prefix_spec(prefix, new_counts, batch.num_impressions,
                       cfg.hist_len, n_new)
    scale_len = cfg.hist_len + cfg.m_targets
    x, ks, vs = hstu_prefix_apply(params["hstu"], cfg.hstu, x, state.k,
                                  state.v, spec, scale_len)
    feats = scatter_targets_to_nro(x[:, n_new:, :], batch, cfg.m_targets)
    logits = mlp_apply(params["task_head"], feats)
    return logits, GRUserState(ks, vs, prefix + new_counts)


def gr_extend_user_state(params: Dict, cfg: GRConfig, batch: ROOBatch,
                         state: GRUserState, *, n_new: int,
                         plan=None) -> GRUserState:
    """Extend the per-user K/V cache with the request's new events without
    scoring any targets (prewarm / write-only traffic). The 1/n scale stays
    pinned to ``hist_len + m_targets``, so the resulting cache equals the
    one :func:`gr_score_from_state` would have produced."""
    prefix = state.length.to(torch.int32)
    emb, new_counts = _gr_new_event_emb(params, cfg, batch, prefix, n_new,
                                        plan=plan)
    spec = prefix_spec(prefix, new_counts, torch.zeros_like(new_counts),
                       cfg.hist_len, n_new)
    scale_len = cfg.hist_len + cfg.m_targets
    _, ks, vs = hstu_prefix_apply(params["hstu"], cfg.hstu, emb, state.k,
                                  state.v, spec, scale_len)
    return GRUserState(ks, vs, prefix + new_counts)


def gr_table_ids(cfg: GRConfig, batch: ROOBatch) -> Dict:
    """Per-table id declaration for sparse-gradient training (ranking
    path; retrieval adds the shifted next-item targets, already covered by
    the history slice)."""
    return {"item_emb": torch.cat([
                batch.history_ids[:, :cfg.hist_len].reshape(-1),
                batch.item_ids.reshape(-1)]),
            "act_emb": batch.history_actions[:, :cfg.hist_len].reshape(-1)}


def gr_ranking_loss(params: Dict, cfg: GRConfig, batch: ROOBatch,
                    plan=None) -> torch.Tensor:
    """Mean BCE over the real impressions and the n_tasks heads (task 0:
    label 0; task 1: label 1 > 0)."""
    logits = gr_ranking_logits(params, cfg, batch, plan=plan)
    labels = batch.labels
    y = torch.stack([labels[:, 0],
                     (labels[:, min(1, labels.shape[1] - 1)] > 0
                      ).to(logits.dtype)], -1)[:, :cfg.n_tasks]
    w = batch.impression_mask().to(logits.dtype)[:, None]
    bce = bce_terms(logits, y)
    return spmd.data_sum(torch.sum(bce * w), plan) / torch.clamp(
        spmd.data_sum(torch.sum(w), plan) * cfg.n_tasks, min=1.0)


def gr_retrieval_loss(params: Dict, cfg: GRConfig, batch: ROOBatch,
                      temperature: float = 0.05, plan=None) -> torch.Tensor:
    """Autoregressive next-item prediction over the history (RO-only) plus
    in-batch candidate softmax — the GR retrieval objective. The encoder
    runs under a causal mask (n_hist == S, no target slots)."""
    hist = gr_history_repr(params, cfg, batch, plan=plan)
    lengths = torch.clamp(batch.history_lengths, max=cfg.hist_len)
    spec = causal_spec(lengths, cfg.hist_len)
    enc = hstu_apply(params["hstu"], cfg.hstu, hist, spec)   # (B_RO, n, d)
    # position t predicts item t+1
    q = enc[:, :-1, :]
    nxt = batch.history_ids[:, 1:cfg.hist_len]
    valid = (torch.arange(cfg.hist_len - 1, device=q.device)[None]
             < (lengths - 1)[:, None])
    # sampled softmax against the in-batch item candidates
    cand = ec.row_lookup(params["item_emb"],
                         spmd.gather_batch(batch.item_ids, plan),
                         vocab=cfg.n_items, plan=plan)
    logits = torch.einsum("bnd,cd->bnc", q, cand) / temperature
    tgt_emb = ec.seq_lookup(params["item_emb"], nxt, vocab=cfg.n_items,
                            plan=plan)
    pos = torch.sum(q * tgt_emb, dim=-1) / temperature      # (B_RO, n-1)
    lse = torch.logaddexp(torch.logsumexp(logits, dim=-1), pos)
    nll = lse - pos
    w = valid.to(nll.dtype)
    return spmd.data_sum(torch.sum(nll * w), plan) / torch.clamp(
        spmd.data_sum(torch.sum(w), plan), min=1.0)
