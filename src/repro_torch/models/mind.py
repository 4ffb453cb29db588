"""MIND (Li et al. 2019, arXiv:1904.08030), torch port of
``repro/models/mind.py``.

Config: embed_dim=64, n_interests=4, capsule_iters=3, multi-interest.

Behavior-to-Interest (B2I) dynamic routing extracts K interest capsules from
the user's behavior sequence; label-aware attention picks the capsule for a
target at training time.

ROO applicability: the capsule routing is 100 % RO — it runs once per
request and the K interest vectors fan out to the request's candidates.
No kernel of its own: plain torch, as the reference is plain jnp.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.fanout import fanout
from repro_torch.core.hstu import normal_init
from repro_torch.core.roo_batch import ROOBatch
from repro_torch.embeddings import collection as ec


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    n_items: int
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 64
    pow_p: float = 2.0       # label-aware attention sharpness


def mind_init(gen: torch.Generator, cfg: MINDConfig, dtype=torch.float32,
              device="cuda") -> Dict:
    """Random params in the reference's layout, drawn from ``gen``."""
    d = cfg.embed_dim
    return {
        "item_emb": normal_init(gen, (cfg.n_items, d), 0.02, dtype, device),
        # shared bilinear routing map S (d, d): B2I routing uses one map
        "S": normal_init(gen, (d, d), d ** -0.5, dtype, device),
    }


def _squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x * torch.rsqrt(n2 + 1e-9)


def interest_capsules(params: Dict, cfg: MINDConfig, hist_ids: torch.Tensor,
                      lengths: torch.Tensor, plan=None) -> torch.Tensor:
    """B2I dynamic routing. hist_ids: (B, T) -> capsules (B, K, d).

    Routing logits are not trained (no gradient flows through them, as in
    the paper); the routing loop is unrolled (capsule_iters=3). Under an
    SPMD ``plan`` the histories are this rank's batch block and
    ``item_emb`` its row block when the plan row-shards it: the lookup is
    ``embeddings/sharded.py``'s (a local partial summed over ``model``).
    """
    b, t = hist_ids.shape
    kk = cfg.n_interests
    e = ec.seq_lookup(params["item_emb"], hist_ids, vocab=cfg.n_items,
                      plan=plan)                             # (B,T,d)
    eh = e @ params["S"]                                     # low-level caps
    dev = eh.device
    valid = torch.arange(t, device=dev)[None] < lengths[:, None]
    # a fixed pseudo-random pattern of initial routing logits keeps steps
    # reproducible (the paper draws them at random)
    binit = torch.sin(torch.arange(t, dtype=torch.float32, device=dev)[:, None]
                      * (1.0 + torch.arange(kk, dtype=torch.float32,
                                            device=dev))[None, :])
    blog = binit[None].expand(b, t, kk)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(valid[..., None], blog, -1e9), dim=-1)
        cand = torch.einsum("btk,btd->bkd", w, eh)
        caps = _squash(cand)
        blog = blog + torch.einsum("bkd,btd->btk", caps.detach(), eh)
    return caps                                              # (B,K,d)


def _capsules(params: Dict, cfg: MINDConfig, batch: ROOBatch) -> torch.Tensor:
    return interest_capsules(
        params, cfg, batch.history_ids[:, :cfg.hist_len],
        torch.clamp(batch.history_lengths, max=cfg.hist_len))


def score_candidates_roo(params: Dict, cfg: MINDConfig,
                         batch: ROOBatch) -> torch.Tensor:
    """ROO path: capsules at B_RO; the max over interests at B_NRO."""
    caps_nro = fanout(_capsules(params, cfg, batch),
                      batch.segment_ids)                     # (B_NRO,K,d)
    tgt = ec.row_lookup(params["item_emb"], batch.item_ids, vocab=cfg.n_items)
    scores = torch.einsum("bkd,bd->bk", caps_nro, tgt)       # (B_NRO,K)
    return torch.amax(scores, dim=-1)                        # serving rule


def mind_table_ids(cfg: MINDConfig,
                   batch: ROOBatch) -> Dict[str, torch.Tensor]:
    """Per-table id declaration for sparse-row training."""
    return {"item_emb": torch.cat([
        batch.history_ids[:, :cfg.hist_len].reshape(-1),
        batch.item_ids.reshape(-1)])}


def mind_loss(params: Dict, cfg: MINDConfig, batch: ROOBatch,
              temperature: float = 0.1) -> torch.Tensor:
    """In-batch softmax over the batch's items with label-aware
    attention."""
    caps = _capsules(params, cfg, batch)
    tgt = ec.row_lookup(params["item_emb"], batch.item_ids, vocab=cfg.n_items)
    caps_nro = fanout(caps, batch.segment_ids)               # (B_NRO,K,d)
    att = torch.softmax(
        cfg.pow_p * torch.einsum("bkd,bd->bk", caps_nro, tgt), dim=-1)
    u = torch.einsum("bk,bkd->bd", att, caps_nro)            # label-aware user
    logits = (u @ tgt.T) / temperature                       # (B_NRO, B_NRO)
    valid = batch.impression_mask()
    logits = torch.where(valid[None, :], logits, -1e9)
    pos_logp = torch.diagonal(torch.log_softmax(logits, dim=-1))
    w = ((batch.labels[:, 0] > 0.5) & valid).to(logits.dtype)
    return -torch.sum(pos_logp * w) / torch.clamp(torch.sum(w), min=1.0)
