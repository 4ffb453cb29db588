"""Two-tower retrieval and early-stage ranking (ESR) models (paper §3.1,
Fig 4), torch port of ``repro/models/two_tower.py``.

The user tower consumes only RO features, so under ROO it runs at B_RO and
its output is fanned out once per request. The item tower runs at B_NRO.
Retrieval trains with an in-batch softmax over the batch's items; ESR adds
a lightweight user-item interaction head (BCE).

``user_tower_mode``: "mlp" (baseline: a mean bag over the history,
``collection.bag_lookup_dense``, on the card the embedding-bag kernels B5
forward and B6 backward) or "hstu" (the paper's scaled-up tower: the
history encoded by an HSTU stack under a causal mask, on the card the
attention kernels B1 forward and B2/B3 backward). The item tower is a row
gather. Every embedding read routes through ``embeddings/collection.py``,
so a ``GatheredTable`` (sparse-row training) takes a table's place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.fanout import fanout
from repro_torch.core.hstu import HSTUConfig, hstu_apply, hstu_init, normal_init
from repro_torch.core.masks import causal_spec
from repro_torch.core.roo_batch import ROOBatch
from repro_torch.embeddings import collection as ec
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.train.metrics import bce


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    n_items: int
    n_user_cats: int = 200
    embed_dim: int = 64
    n_ro_dense: int = 16
    n_item_dense: int = 8
    hist_len: int = 64
    user_mlp: Tuple[int, ...] = (256, 128, 64)
    item_mlp: Tuple[int, ...] = (128, 64)
    user_tower_mode: str = "mlp"          # "mlp" | "hstu"
    hstu: Optional[HSTUConfig] = None
    esr_head: bool = False                 # adds interaction MLP head (ESR)
    esr_mlp: Tuple[int, ...] = (128, 64, 1)


def two_tower_init(gen: torch.Generator, cfg: TwoTowerConfig,
                   dtype=torch.float32, device="cuda") -> Dict:
    """Random params in the reference's layout, drawn from ``gen``."""
    d = cfg.embed_dim
    params = {
        "item_emb": normal_init(gen, (cfg.n_items, d), 0.02, dtype, device),
        "user_cat_emb": normal_init(gen, (cfg.n_user_cats, d), 0.02, dtype,
                                    device),
        "user_mlp": mlp_init(gen, (cfg.n_ro_dense + 2 * d,) + cfg.user_mlp,
                             dtype, device),
        "item_mlp": mlp_init(gen, (cfg.n_item_dense + d,) + cfg.item_mlp,
                             dtype, device),
    }
    if cfg.user_tower_mode == "hstu":
        assert cfg.hstu is not None
        params["hstu"] = hstu_init(gen, cfg.hstu, dtype, device)
        params["act_emb"] = normal_init(gen, (4, d), 0.02, dtype, device)
    if cfg.esr_head:
        params["esr_mlp"] = mlp_init(
            gen, (cfg.user_mlp[-1] + cfg.item_mlp[-1] + 1,) + cfg.esr_mlp,
            dtype, device)
    return params


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


def user_tower(params: Dict, cfg: TwoTowerConfig,
               batch: ROOBatch) -> torch.Tensor:
    """RO-only computation -> (B_RO, d_user), L2-normalised."""
    if cfg.user_tower_mode == "hstu":
        hist_emb = ec.seq_lookup(params["item_emb"], batch.history_ids,
                                 vocab=cfg.n_items)
        act_emb = ec.seq_lookup(params["act_emb"], batch.history_actions,
                                vocab=4)
        spec = causal_spec(batch.history_lengths, cfg.hist_len)
        enc = hstu_apply(params["hstu"], cfg.hstu, hist_emb + act_emb, spec)
        # mean-pool valid positions as the user interest summary
        valid = (torch.arange(cfg.hist_len, device=enc.device)[None]
                 < batch.history_lengths[:, None])
        pooled = torch.sum(enc * valid[..., None], 1) / torch.clamp(
            batch.history_lengths, min=1).to(enc.dtype)[:, None]
    else:
        pooled = ec.bag_lookup_dense(params["item_emb"], batch.history_ids,
                                     batch.history_lengths, pooling="mean",
                                     vocab=cfg.n_items)
    if batch.ro_sparse is not None:
        cats = ec.bag_lookup(params["user_cat_emb"],
                             batch.ro_sparse["user_ids"], pooling="mean")
    else:
        cats = torch.zeros((batch.b_ro, cfg.embed_dim), dtype=pooled.dtype,
                           device=pooled.device)
    x = torch.cat([batch.ro_dense, pooled, cats], dim=-1)
    return _l2_normalize(mlp_apply(params["user_mlp"], x))


def item_tower(params: Dict, cfg: TwoTowerConfig, item_ids: torch.Tensor,
               item_dense: torch.Tensor) -> torch.Tensor:
    """(B_NRO,) ids + (B_NRO, n_item_dense) -> (B_NRO, d_item),
    L2-normalised."""
    emb = ec.row_lookup(params["item_emb"], item_ids, vocab=cfg.n_items)
    x = torch.cat([item_dense, emb], dim=-1)
    return _l2_normalize(mlp_apply(params["item_mlp"], x))


def two_tower_table_ids(cfg: TwoTowerConfig,
                        batch: ROOBatch) -> Dict[str, torch.Tensor]:
    """Every id the ROO forward looks up, per embedding table (the
    declaration the sparse-row training path gathers): ``item_emb`` serves
    the history and the item tower."""
    ids = {"item_emb": torch.cat([batch.history_ids.reshape(-1),
                                  batch.item_ids.reshape(-1)])}
    if cfg.user_tower_mode == "hstu":
        ids["act_emb"] = batch.history_actions.reshape(-1)
    if batch.ro_sparse is not None:
        ids["user_cat_emb"] = batch.ro_sparse["user_ids"].values.reshape(-1)
    return ids


def retrieval_loss_roo(params: Dict, cfg: TwoTowerConfig, batch: ROOBatch,
                       temperature: float = 0.05) -> torch.Tensor:
    """In-batch softmax over all B_NRO items; positives = clicked
    impressions. The user tower runs at B_RO (ROO dedup); the logits are
    one (B_RO, B_NRO) product."""
    u = user_tower(params, cfg, batch)                       # (B_RO, d)
    v = item_tower(params, cfg, batch.item_ids, batch.nro_dense)
    logits = (u @ v.T) / temperature                         # (B_RO, B_NRO)
    imp_valid = batch.impression_mask()
    logits = torch.where(imp_valid[None, :], logits, -1e9)
    pos = batch.labels[:, 0] > 0.5                           # clicked
    seg = torch.clamp(batch.segment_ids.long(), max=batch.b_ro - 1)
    logp = torch.log_softmax(logits, dim=-1)
    nro_idx = torch.arange(batch.b_nro, device=logits.device)
    pos_logp = logp[seg, nro_idx]                            # (B_NRO,)
    w = (pos & imp_valid).to(logits.dtype)
    return -torch.sum(pos_logp * w) / torch.clamp(torch.sum(w), min=1.0)


def retrieval_scores_from_user(params: Dict, cfg: TwoTowerConfig,
                               batch: ROOBatch,
                               u: torch.Tensor) -> torch.Tensor:
    """(B_NRO,) retrieval scores of the batch's items, given the (B_RO, d)
    user representation (from ``user_tower`` or a serving cache): the dot
    of each item's vector with its request's user vector (the reference
    scenario's ``_fanout_scores``)."""
    v = item_tower(params, cfg, batch.item_ids, batch.nro_dense)
    seg = torch.clamp(batch.segment_ids.long(), max=batch.b_ro - 1)
    return torch.sum(u[seg] * v, dim=-1)


def esr_logits_from_user(params: Dict, cfg: TwoTowerConfig, batch: ROOBatch,
                         u: torch.Tensor) -> torch.Tensor:
    """ESR NRO half, given a precomputed (B_RO, d) user representation
    (from ``user_tower`` or a serving cache)."""
    u_at_nro = fanout(u, batch.segment_ids)
    v = item_tower(params, cfg, batch.item_ids, batch.nro_dense)
    dot = torch.sum(u_at_nro * v, dim=-1, keepdim=True)
    x = torch.cat([u_at_nro, v, dot], dim=-1)
    return mlp_apply(params["esr_mlp"], x)[:, 0]


def esr_logits_roo(params: Dict, cfg: TwoTowerConfig,
                   batch: ROOBatch) -> torch.Tensor:
    """ESR: fanned-out user repr + item repr -> interaction MLP -> logit."""
    return esr_logits_from_user(params, cfg, batch,
                                user_tower(params, cfg, batch))


def esr_loss_roo(params: Dict, cfg: TwoTowerConfig,
                 batch: ROOBatch) -> torch.Tensor:
    """Mean BCE of the ESR logit over the real impressions."""
    logits = esr_logits_roo(params, cfg, batch)
    return bce(logits, batch.labels[:, 0],
               batch.impression_mask().to(logits.dtype))
