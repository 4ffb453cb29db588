"""Linear Compressed Embedding (LCE) + UserArch (paper §3.2, Eq. 1–2),
torch port of ``repro/core/lce.py``.

LCE compresses a bag of feature embeddings along the feature-count axis
first (n_in -> n_out, Eq. 1), then projects the embedding axis
(d_in -> d_out, Eq. 2). Under ROO, UserArch runs at B_RO, so its cost is
amortized across the request's impressions; ``models/lsr.py`` applies the
LCE to the user features directly; ``userarch_apply`` is the same LCE over
the user features with an optional history summary appended. Shapes follow
the paper: X in R^{B, d_in, n_in}.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.hstu import normal_init
from repro_torch.core.promote import einsum


@dataclasses.dataclass(frozen=True)
class LCEConfig:
    n_in: int          # input number of feature embeddings
    d_in: int          # input embedding dim
    n_out: int         # compressed number of embeddings
    d_out: int         # output embedding dim


def lce_init(gen: torch.Generator, cfg: LCEConfig, dtype=torch.float32,
             device="cuda") -> Dict:
    s1 = (2.0 / (cfg.n_in + cfg.n_out)) ** 0.5
    s2 = (2.0 / (cfg.d_in + cfg.d_out)) ** 0.5
    return {
        "W": normal_init(gen, (cfg.n_in, cfg.n_out), s1, dtype, device),
        "b": torch.zeros((1, cfg.n_out), dtype=dtype, device=device),
        "W2": normal_init(gen, (cfg.d_in, cfg.d_out), s2, dtype, device),
        "b2": torch.zeros((1, cfg.d_out), dtype=dtype, device=device),
    }


def lce_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Eq. 1–2. x: (B, d_in, n_in) -> (B, n_out, d_out)."""
    h = einsum("bdn,nm->bdm", x, params["W"]) + params["b"][None]
    h = h.transpose(1, 2)                                 # (B, n_out, d_in)
    return einsum("bmd,de->bme", h, params["W2"]) + params["b2"][None]


def lce_flops(cfg: LCEConfig, batch: int) -> int:
    """Forward multiply-add FLOPs (x2 for MAC)."""
    return 2 * batch * (cfg.d_in * cfg.n_in * cfg.n_out
                        + cfg.n_out * cfg.d_in * cfg.d_out)


@dataclasses.dataclass(frozen=True)
class UserArchConfig:
    """UserArch = LCE over user feature embeddings (+ optional history
    summary concatenated as extra input embeddings)."""
    lce: LCEConfig
    use_history_summary: bool = True   # append pooled history embedding


def userarch_init(gen: torch.Generator, cfg: UserArchConfig,
                  dtype=torch.float32, device="cuda") -> Dict:
    return {"lce": lce_init(gen, cfg.lce, dtype, device)}


def userarch_apply(params: Dict, cfg: UserArchConfig,
                   user_feature_embs: torch.Tensor,
                   history_summary: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """user_feature_embs: (B_RO, n_feat, d); history_summary: (B_RO, k, d).
    Returns (B_RO, n_out, d_out) compressed user embeddings."""
    x = user_feature_embs
    if cfg.use_history_summary and history_summary is not None:
        x = torch.cat([x, history_summary], dim=1)
    return lce_apply(params["lce"], x.transpose(1, 2))
