"""DIEN (Zhou et al. 2019, arXiv:1809.03672), torch port of
``repro/models/din_dien.py``.

Config: embed_dim=18, seq_len=100, gru_dim=108, MLP 200-80, AUGRU.

Structure: item embeddings -> interest-extraction GRU over the behavior
sequence -> target-conditioned attention -> AUGRU (attention-update-gate
GRU) -> final interest state -> MLP over [interest, target, user].

ROO applicability: the extraction GRU depends only on the user history (RO)
and runs once per request; its hidden states fan out to the request's
impressions. The AUGRU stage is target-conditioned so it runs at B_NRO.

No kernel of its own: plain torch, as the reference is plain jnp. The
reference's ``lax.scan`` is a Python loop over T here (the input
projection of all steps is one product before the loop), so a forward
issues about a dozen small ops per step per scan and training is bound by
host launches on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.fanout import fanout
from repro_torch.core.hstu import normal_init
from repro_torch.core.roo_batch import ROOBatch
from repro_torch.embeddings import collection as ec
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.train.metrics import bce


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    n_items: int
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: Tuple[int, ...] = (200, 80)
    n_ro_dense: int = 16


def _gru_init(gen: torch.Generator, d_in: int, d_h: int, dtype,
              device) -> Dict:
    return {
        "wx": normal_init(gen, (d_in, 3 * d_h), d_in ** -0.5, dtype, device),
        "wh": normal_init(gen, (d_h, 3 * d_h), d_h ** -0.5, dtype, device),
        "b": torch.zeros((3 * d_h,), dtype=dtype, device=device),
    }


def dien_init(gen: torch.Generator, cfg: DIENConfig, dtype=torch.float32,
              device="cuda") -> Dict:
    """Random params in the reference's layout, drawn from ``gen``."""
    d, h = cfg.embed_dim, cfg.gru_dim
    return {
        "item_emb": normal_init(gen, (cfg.n_items, d), 0.02, dtype, device),
        "gru": _gru_init(gen, d, h, dtype, device),
        "augru": _gru_init(gen, h, h, dtype, device),  # on the GRU states
        "att_mlp": mlp_init(gen, (2 * h + d, 64, 1), dtype, device),
        "out_mlp": mlp_init(gen, (h + d + cfg.n_ro_dense,) + cfg.mlp + (1,),
                            dtype, device),
        "h_proj": mlp_init(gen, (d, h), dtype, device),  # emb -> att space
    }


def _gates(p: Dict, gx: torch.Tensor, h: torch.Tensor):
    """One step's update gate z, and candidate state n."""
    xz, xr, xn = torch.chunk(gx, 3, dim=-1)
    hz, hr, hn = torch.chunk(h @ p["wh"], 3, dim=-1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    return z, torch.tanh(xn + r * hn)


def _scan_inputs(p: Dict, xs: torch.Tensor, lengths: torch.Tensor):
    b, t, _ = xs.shape
    gx = xs @ p["wx"] + p["b"]                               # (B, T, 3h)
    valid = (torch.arange(t, device=xs.device)[None]
             < lengths[:, None])[..., None]                  # (B, T, 1)
    h0 = torch.zeros((b, p["wh"].shape[0]), dtype=xs.dtype, device=xs.device)
    return gx, valid, h0


def gru_scan(p: Dict, xs: torch.Tensor, lengths: torch.Tensor
             ) -> torch.Tensor:
    """xs: (B, T, d_in) -> hidden states (B, T, d_h); a row's state stays
    as it was past its length."""
    gx, valid, h = _scan_inputs(p, xs, lengths)
    hs = []
    for i in range(xs.shape[1]):
        z, n = _gates(p, gx[:, i], h)
        h = torch.where(valid[:, i], (1 - z) * n + z * h, h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def augru_scan(p: Dict, xs: torch.Tensor, att: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """AUGRU: the update gate scaled by the attention score (B, T); the
    gate combines the other way round from the GRU's. Returns the final
    state (B, d_h)."""
    gx, valid, h = _scan_inputs(p, xs, lengths)
    for i in range(xs.shape[1]):
        z, n = _gates(p, gx[:, i], h)
        z = z * att[:, i, None]                  # attention-scaled gate
        h = torch.where(valid[:, i], (1 - z) * h + z * n, h)
    return h


def dien_logits_roo(params: Dict, cfg: DIENConfig,
                    batch: ROOBatch, plan=None) -> torch.Tensor:
    """ROO path: extraction GRU at B_RO; AUGRU at B_NRO after fanout.
    Under an SPMD ``plan`` the batch is this rank's block (its segment ids
    rebased to it) and both item lookups take the plan's row-sharded
    route; the other params are whole on every rank."""
    t = cfg.seq_len
    hist_ids = batch.history_ids[:, :t]
    lengths = torch.clamp(batch.history_lengths, max=t)
    hist = ec.seq_lookup(params["item_emb"], hist_ids, vocab=cfg.n_items,
                         plan=plan)
    # ---- RO: interest extraction runs once per request ----------------------
    states = gru_scan(params["gru"], hist, lengths)           # (B_RO, T, h)
    # ---- fanout of the hidden states and lengths, once ----------------------
    states_nro = fanout(states, batch.segment_ids)            # (B_NRO, T, h)
    len_nro = fanout(lengths, batch.segment_ids)
    # ---- NRO: target attention + AUGRU --------------------------------------
    tgt = ec.row_lookup(params["item_emb"], batch.item_ids, vocab=cfg.n_items,
                        plan=plan)
    tgt_h = mlp_apply(params["h_proj"], tgt)                  # (B_NRO, h)
    b_nro, tt, _ = states_nro.shape
    att_in = torch.cat([
        states_nro, tgt_h[:, None, :].expand(b_nro, tt, tgt_h.shape[-1]),
        tgt[:, None, :].expand(b_nro, tt, cfg.embed_dim)], dim=-1)
    scores = mlp_apply(params["att_mlp"], att_in)[..., 0]     # (B_NRO, T)
    valid = torch.arange(t, device=scores.device)[None] < len_nro[:, None]
    att = torch.softmax(torch.where(valid, scores, -1e9), dim=-1)
    h_final = augru_scan(params["augru"], states_nro, att, len_nro)
    ro_dense_nro = fanout(batch.ro_dense, batch.segment_ids)
    x = torch.cat([h_final, tgt, ro_dense_nro], dim=-1)
    return mlp_apply(params["out_mlp"], x)[:, 0]


def dien_table_ids(cfg: DIENConfig,
                   batch: ROOBatch) -> Dict[str, torch.Tensor]:
    """Per-table id declaration for sparse-row training."""
    return {"item_emb": torch.cat([
        batch.history_ids[:, :cfg.seq_len].reshape(-1),
        batch.item_ids.reshape(-1)])}


def dien_loss(params: Dict, cfg: DIENConfig, batch: ROOBatch) -> torch.Tensor:
    """Mean BCE over the real impressions."""
    logits = dien_logits_roo(params, cfg, batch)
    return bce(logits, batch.labels[:, 0],
               batch.impression_mask().to(logits.dtype))
