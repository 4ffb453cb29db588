"""Generative Recommender (GR) ranking on HSTU (paper §3.3), torch port of
``repro/models/gr.py``.

Ranking appends the request's m targets to the user's interleaved (item,
action) history under the ROO mask (core.sequence) and reads multi-task
logits from the target positions. The per-user state functions
(incremental serving), the losses and retrieval are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.hstu import HSTUConfig, hstu_init, normal_init
from repro_torch.core.roo_batch import ROOBatch
from repro_torch.core.sequence import (ROOSequenceConfig, encode_roo,
                                       gather_targets_to_ro,
                                       scatter_targets_to_nro)
from repro_torch.embeddings import collection as ec
from repro_torch.models.mlp import mlp_apply, mlp_init


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


def gr_history_repr(params: Dict, cfg: GRConfig,
                    batch: ROOBatch) -> torch.Tensor:
    """Request-only half of GR ranking: embedded (item+action) history,
    (B_RO, hist_len, d)."""
    ids = batch.history_ids[:, :cfg.hist_len]
    acts = batch.history_actions[:, :cfg.hist_len]
    e = ec.seq_lookup(params["item_emb"], ids, vocab=cfg.n_items)
    a = ec.seq_lookup(params["act_emb"], acts, vocab=4)
    return e + a


def gr_ranking_logits_from_history(params: Dict, cfg: GRConfig,
                                   batch: ROOBatch,
                                   hist: torch.Tensor) -> torch.Tensor:
    """GR ranking logits given a precomputed history embedding."""
    lengths = torch.clamp(batch.history_lengths, max=cfg.hist_len)
    tgt_nro = ec.row_lookup(params["item_emb"], batch.item_ids,
                            vocab=cfg.n_items)
    tgt_ro = gather_targets_to_ro(tgt_nro, batch, cfg.m_targets)
    enc = encode_roo({"hstu": params["hstu"]}, cfg.seq_cfg(), hist, lengths,
                     tgt_ro, batch.num_impressions)          # (B_RO, m, d)
    feats = scatter_targets_to_nro(enc, batch, cfg.m_targets)
    return mlp_apply(params["task_head"], feats)


def gr_ranking_logits(params: Dict, cfg: GRConfig,
                      batch: ROOBatch) -> torch.Tensor:
    """ROO ranking: encode [history | m targets] once per request;
    (B_NRO, n_tasks) logits."""
    return gr_ranking_logits_from_history(
        params, cfg, batch, gr_history_repr(params, cfg, batch))
