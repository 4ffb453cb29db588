"""Late-stage ranking (LSR) model — the paper's Fig. 6 architecture, torch
port of ``repro/models/lsr.py``.

Pipeline:   RO side (B_RO):  dense MLP + sparse bags + history summary
                             -> UserArch (LCE compress)          [§3.2]
            fanout once      (the ROO amortization point)
            NRO side (B_NRO): item embeddings + dense
            interaction:      DCNv2 over flattened features
            top MLP:          multi-task logits (engagement, consumption)

Modes reproduce the paper's LSR ablation rows (Table 7):
  baseline      — no UserArch, no HSTU (plain DLRM-ish)
  userarch      — + LCE UserArch
  userarch_hstu — + HSTU history encoder feeding UserArch ("+HSTU" row)
  hstu_ranking  — + ROO sequential targets (core.sequence; GR-style ranking)

In ``baseline`` and ``userarch`` the history summary is a mean bag over the
item table (``collection.bag_lookup_dense``): on the card the embedding-bag
kernel, forward B5 and backward B6. ``userarch_hstu`` and ``hstu_ranking``
encode the history with HSTU instead (B1–B3 on the card) and never reach
the bag kernel. Every embedding read routes through
``embeddings/collection.py``. Under the reference's ``plan=`` (an SPMD
``ShardingPlan``) the item and user-category tables are this rank's row
blocks, read through the collection's sharded routes (each a B_RO-sized
sum over ``model`` on the user side), the batch is this rank's data block,
and the loss's batch sums are summed over the batch axes
(``spmd.data_sum``). The impression-level forward takes no plan, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.expansion import expand
from repro_torch.core.fanout import fanout
from repro_torch.core.hstu import HSTUConfig, hstu_apply, hstu_init, normal_init
from repro_torch.core.lce import LCEConfig, lce_apply, lce_init
from repro_torch.core.masks import causal_spec
from repro_torch.core.roo_batch import ROOBatch
from repro_torch.core.sequence import (ROOSequenceConfig,
                                       encode_per_impression, encode_roo,
                                       gather_targets_to_ro,
                                       roo_sequence_init,
                                       scatter_targets_to_nro)
from repro_torch.distributed import spmd
from repro_torch.embeddings import collection as ec
from repro_torch.models.interactions import dcnv2_apply, dcnv2_init
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.train.metrics import bce_terms


@dataclasses.dataclass(frozen=True)
class LSRConfig:
    n_items: int
    n_user_cats: int = 200
    n_item_cats: int = 200
    embed_dim: int = 64
    n_ro_dense: int = 16
    n_item_dense: int = 8
    hist_len: int = 64
    m_targets: int = 16
    mode: str = "userarch_hstu"   # baseline|userarch|userarch_hstu|hstu_ranking
    lce_n_out: int = 8
    lce_d_out: int = 64
    n_cross_layers: int = 3
    top_mlp: Tuple[int, ...] = (512, 256,)
    n_tasks: int = 2
    hstu: Optional[HSTUConfig] = None
    attn_backend: Optional[str] = None   # kernels/dispatch.py backend knob


def _hstu_cfg(cfg: LSRConfig) -> HSTUConfig:
    return cfg.hstu or HSTUConfig(d_model=cfg.embed_dim, n_heads=2,
                                  d_qk=32, d_v=32, n_layers=2,
                                  max_rel_pos=cfg.hist_len,
                                  attn_backend=cfg.attn_backend)


def lsr_init(gen: torch.Generator, cfg: LSRConfig, dtype=torch.float32,
             device="cuda") -> Dict:
    """Random params in the reference's layout, drawn from ``gen``."""
    d = cfg.embed_dim
    # user features entering UserArch: dense proj + cat bag + hist summary
    n_user_feats = 3
    params = {
        "item_emb": normal_init(gen, (cfg.n_items, d), 0.02, dtype, device),
        "user_cat_emb": normal_init(gen, (cfg.n_user_cats, d), 0.02, dtype,
                                    device),
        "item_cat_emb": normal_init(gen, (cfg.n_item_cats, d), 0.02, dtype,
                                    device),
        "dense_proj": mlp_init(gen, (cfg.n_ro_dense, d), dtype, device),
        "item_dense_proj": mlp_init(gen, (cfg.n_item_dense, d), dtype,
                                    device),
        "act_emb": normal_init(gen, (4, d), 0.02, dtype, device),
    }
    if cfg.mode in ("userarch", "userarch_hstu", "hstu_ranking"):
        params["lce"] = lce_init(
            gen, LCEConfig(n_in=n_user_feats, d_in=d, n_out=cfg.lce_n_out,
                           d_out=cfg.lce_d_out), dtype, device)
        user_width = cfg.lce_n_out * cfg.lce_d_out
    else:
        user_width = n_user_feats * d
    if cfg.mode in ("userarch_hstu", "hstu_ranking"):
        params["hstu"] = hstu_init(gen, _hstu_cfg(cfg), dtype, device)
    if cfg.mode == "hstu_ranking":
        params["seq"] = roo_sequence_init(
            gen, ROOSequenceConfig(_hstu_cfg(cfg), cfg.hist_len,
                                   cfg.m_targets), dtype, device)
        item_width = 3 * d
    else:
        item_width = 2 * d
    inter_dim = user_width + item_width
    params["cross"] = dcnv2_init(gen, inter_dim, cfg.n_cross_layers,
                                 dtype=dtype, device=device)
    params["top_mlp"] = mlp_init(
        gen, (inter_dim,) + tuple(cfg.top_mlp) + (cfg.n_tasks,), dtype,
        device)
    return params


def _user_side(params: Dict, cfg: LSRConfig, batch: ROOBatch,
               cats_override: Optional[torch.Tensor] = None,
               plan=None) -> torch.Tensor:
    """All RO computation -> (B_RO, user_width). Runs at B_RO under ROO."""
    dense = mlp_apply(params["dense_proj"], batch.ro_dense)          # (B_RO,d)
    if cats_override is not None:
        cats = cats_override
    elif batch.ro_sparse is not None:
        cats = ec.bag_lookup(params["user_cat_emb"],
                             batch.ro_sparse["user_ids"], pooling="mean",
                             vocab=cfg.n_user_cats, plan=plan)
    else:
        cats = torch.zeros_like(dense)
    if cfg.mode in ("userarch_hstu", "hstu_ranking"):
        hist_emb = ec.seq_lookup(params["item_emb"], batch.history_ids,
                                 vocab=cfg.n_items, plan=plan)
        act = ec.seq_lookup(params["act_emb"], batch.history_actions, vocab=4)
        spec = causal_spec(batch.history_lengths, cfg.hist_len)
        enc = hstu_apply(params["hstu"], _hstu_cfg(cfg), hist_emb + act, spec)
        valid = (torch.arange(cfg.hist_len, device=enc.device)[None]
                 < batch.history_lengths[:, None])
        hist = torch.sum(enc * valid[..., None], 1) / torch.clamp(
            batch.history_lengths, min=1).to(enc.dtype)[:, None]
    else:
        hist = ec.bag_lookup_dense(params["item_emb"], batch.history_ids,
                                   batch.history_lengths, pooling="mean",
                                   vocab=cfg.n_items, plan=plan)
    feats = torch.stack([dense, cats, hist], dim=1)                  # (B_RO,3,d)
    if "lce" in params:
        out = lce_apply(params["lce"], feats.transpose(1, 2))
        return out.reshape(out.shape[0], -1)                         # LCE flat
    return feats.reshape(feats.shape[0], -1)


def _item_side(params: Dict, cfg: LSRConfig, batch: ROOBatch,
               plan=None) -> torch.Tensor:
    emb = ec.row_lookup(params["item_emb"], batch.item_ids,
                        vocab=cfg.n_items, plan=plan)
    dense = mlp_apply(params["item_dense_proj"], batch.nro_dense)
    return torch.cat([emb, dense], dim=-1)                           # (B_NRO,2d)


def lsr_user_repr(params: Dict, cfg: LSRConfig, batch: ROOBatch,
                  plan=None) -> torch.Tensor:
    """Request-only half of the LSR forward: (B_RO, user_width). Split out
    so serving can run it once per unique request and memoize the result
    across repeat candidates (serve/user_cache.py)."""
    return _user_side(params, cfg, batch, plan=plan)


def lsr_logits_from_user(params: Dict, cfg: LSRConfig, batch: ROOBatch,
                         user: torch.Tensor, plan=None) -> torch.Tensor:
    """NRO half of the LSR forward, given a precomputed (B_RO, user_width)
    RO representation (from ``lsr_user_repr`` or a serving cache)."""
    user_at_nro = fanout(user, batch.segment_ids)
    item = _item_side(params, cfg, batch, plan=plan)
    if cfg.mode == "hstu_ranking":
        # ROO sequential targets: encode [history | m targets] once/request
        hist_emb = ec.seq_lookup(params["item_emb"], batch.history_ids,
                                 vocab=cfg.n_items, plan=plan)
        act = ec.seq_lookup(params["act_emb"], batch.history_actions, vocab=4)
        tgt_nro = ec.row_lookup(params["item_emb"], batch.item_ids,
                                vocab=cfg.n_items, plan=plan)
        tgt_ro = gather_targets_to_ro(tgt_nro, batch, cfg.m_targets)
        seq_cfg = ROOSequenceConfig(_hstu_cfg(cfg), cfg.hist_len,
                                    cfg.m_targets)
        enc = encode_roo(params["seq"], seq_cfg, hist_emb + act,
                         batch.history_lengths, tgt_ro, batch.num_impressions)
        item = torch.cat([item, scatter_targets_to_nro(enc, batch,
                                                       cfg.m_targets)], -1)
    x = torch.cat([user_at_nro, item], dim=-1)
    x = dcnv2_apply(params["cross"], x)
    return mlp_apply(params["top_mlp"], x)


def lsr_logits_roo(params: Dict, cfg: LSRConfig, batch: ROOBatch,
                   plan=None) -> torch.Tensor:
    """(B_NRO, n_tasks) multi-task logits, ROO path."""
    return lsr_logits_from_user(params, cfg, batch,
                                lsr_user_repr(params, cfg, batch, plan=plan),
                                plan=plan)


def lsr_logits_impression(params: Dict, cfg: LSRConfig,
                          batch: ROOBatch) -> torch.Tensor:
    """Impression-level baseline: RO features pre-expanded to B_NRO, user
    side computed B_NRO times (what ROO training eliminates)."""
    eb = expand(batch)
    fake = ROOBatch(
        ro_dense=eb.ro_dense, ro_sparse=None, history_ids=eb.history_ids,
        history_actions=eb.history_actions,
        history_lengths=eb.history_lengths, nro_dense=eb.nro_dense,
        nro_sparse=batch.nro_sparse, item_ids=eb.item_ids, labels=eb.labels,
        num_impressions=torch.ones((batch.b_nro,), dtype=torch.int32,
                                   device=batch.nro_dense.device),
        segment_ids=torch.arange(batch.b_nro, dtype=torch.int32,
                                 device=batch.nro_dense.device))
    # the jagged user-cat bag cannot be row-duplicated without re-packing;
    # expand its pooled result instead (identical math per impression)
    cats_nro = None
    if batch.ro_sparse is not None:
        cats_nro = fanout(ec.bag_lookup(params["user_cat_emb"],
                                        batch.ro_sparse["user_ids"],
                                        pooling="mean"), batch.segment_ids)
    user = _user_side(params, cfg, fake, cats_override=cats_nro)  # at B_NRO
    item = _item_side(params, cfg, fake)
    if cfg.mode == "hstu_ranking":
        tgt = ec.row_lookup(params["item_emb"], fake.item_ids,
                            vocab=cfg.n_items)
        hist_emb = ec.seq_lookup(params["item_emb"], fake.history_ids,
                                 vocab=cfg.n_items)
        act = ec.seq_lookup(params["act_emb"], fake.history_actions, vocab=4)
        seq_cfg = ROOSequenceConfig(_hstu_cfg(cfg), cfg.hist_len,
                                    cfg.m_targets)
        seq_feat = encode_per_impression(params["seq"], seq_cfg,
                                         hist_emb + act, fake.history_lengths,
                                         tgt)
        item = torch.cat([item, seq_feat], dim=-1)
    x = torch.cat([user, item], dim=-1)
    x = dcnv2_apply(params["cross"], x)
    return mlp_apply(params["top_mlp"], x)


def lsr_table_ids(cfg: LSRConfig, batch: ROOBatch) -> Dict[str, torch.Tensor]:
    """Every id the ROO forward looks up, per embedding table (the
    declaration the sparse-row training path gathers)."""
    ids = {
        "item_emb": torch.cat([batch.history_ids.reshape(-1),
                               batch.item_ids.reshape(-1)]),
        "act_emb": batch.history_actions.reshape(-1),
    }
    if batch.ro_sparse is not None:
        ids["user_cat_emb"] = batch.ro_sparse["user_ids"].values.reshape(-1)
    return ids


def lsr_loss(params: Dict, cfg: LSRConfig, batch: ROOBatch,
             roo: bool = True, plan=None) -> torch.Tensor:
    """Mean BCE over the real impressions and the two task heads (task 0:
    label 0; task 1: label 1 > 0), on the ROO or the impression-level
    forward."""
    logits = (lsr_logits_roo(params, cfg, batch, plan=plan) if roo
              else lsr_logits_impression(params, cfg, batch))
    y = batch.labels[:, :cfg.n_tasks]
    if y.shape[1] < cfg.n_tasks:
        y = torch.nn.functional.pad(y, (0, cfg.n_tasks - y.shape[1]))
    # task 1 (view_sec) binarized as consumption label
    y = torch.stack([y[:, 0], (y[:, min(1, y.shape[1] - 1)] > 0).to(y.dtype)],
                    -1)
    w = batch.impression_mask().to(logits.dtype)[:, None]
    bce = bce_terms(logits, y)
    return spmd.data_sum(torch.sum(bce * w), plan) / torch.clamp(
        spmd.data_sum(torch.sum(w), plan) * cfg.n_tasks, min=1.0)
