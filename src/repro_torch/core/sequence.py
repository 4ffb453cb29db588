"""ROO sequential modeling (paper §3.3), torch port of
``repro/core/sequence.py``.

Builds, per request, the sequence ``[history (n) | targets (m)]``, encodes it
ONCE with HSTU under the ROO mask (targets see history + self only), and
scatters the m target outputs back to their NRO impression slots. The
impression-level baseline (``encode_per_impression``) encodes (history + 1
target) once per impression: the cost ROO amortizes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.hstu import HSTUConfig, hstu_apply, hstu_init
from repro_torch.core.masks import roo_spec
from repro_torch.core.roo_batch import ROOBatch

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class ROOSequenceConfig:
    hstu: HSTUConfig
    n_hist: int                 # padded history length n
    m_targets: int              # padded per-request target capacity m


def roo_sequence_init(gen: torch.Generator, cfg: ROOSequenceConfig,
                      dtype=torch.float32, device="cuda") -> Dict:
    return {"hstu": hstu_init(gen, cfg.hstu, dtype, device)}


def target_positions(batch: ROOBatch, m_targets: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map each NRO slot to (request_row, slot_within_request).

    Impressions of a request are contiguous in the NRO axis (batcher
    invariant); slot-within-request is the slot minus the first slot of its
    segment. Returns (seg, k) each (B_NRO,) int64; padding slots get
    k = m_targets (parked).
    """
    b_ro = batch.b_ro
    seg = batch.segment_ids.long()
    valid = seg < b_ro
    idx = torch.arange(seg.shape[0], device=seg.device)
    seg_safe = torch.clamp(seg, max=b_ro - 1)
    # padding slots must not pollute the minimum of the segment they alias
    idx_masked = torch.where(valid, idx, torch.full_like(idx, _INT32_MAX))
    seg_min = torch.full((b_ro,), _INT32_MAX, dtype=idx.dtype,
                         device=seg.device).scatter_reduce(
        0, seg_safe, idx_masked, "amin", include_self=False)
    k = idx - seg_min[seg_safe]
    k = torch.where(valid & (k < m_targets), k, torch.full_like(k, m_targets))
    return seg, k


def encode_roo(params: Dict, cfg: ROOSequenceConfig,
               hist_emb: torch.Tensor, hist_lengths: torch.Tensor,
               target_emb_ro: torch.Tensor, target_counts: torch.Tensor,
               backend: Optional[str] = None) -> torch.Tensor:
    """ROO path: one (n+m) sequence per request.

    hist_emb: (B_RO, n, d); target_emb_ro: (B_RO, m, d) — targets gathered
    to request-major layout. Returns (B_RO, m, d) encoded target outputs.
    """
    x = torch.cat([hist_emb, target_emb_ro], dim=1)         # (B_RO, n+m, d)
    spec = roo_spec(hist_lengths, target_counts, cfg.n_hist)
    y = hstu_apply(params["hstu"], cfg.hstu, x, spec, backend=backend)
    return y[:, cfg.n_hist:, :]


def encode_per_impression(params: Dict, cfg: ROOSequenceConfig,
                          hist_emb: torch.Tensor, hist_lengths: torch.Tensor,
                          target_emb: torch.Tensor,
                          backend: Optional[str] = None) -> torch.Tensor:
    """Impression-level baseline: (history + 1 target) per impression.

    hist_emb: (B_NRO, n, d) — history duplicated per impression;
    target_emb: (B_NRO, d). Returns (B_NRO, d).
    """
    x = torch.cat([hist_emb, target_emb[:, None, :]], dim=1)
    spec = roo_spec(hist_lengths, torch.ones_like(hist_lengths), cfg.n_hist)
    y = hstu_apply(params["hstu"], cfg.hstu, x, spec, backend=backend)
    return y[:, cfg.n_hist, :]


def scatter_targets_to_nro(encoded_ro: torch.Tensor, batch: ROOBatch,
                           m_targets: int) -> torch.Tensor:
    """(B_RO, m, d) -> (B_NRO, d): route each encoded target to its slot."""
    seg, k = target_positions(batch, m_targets)
    b_ro, m, d = encoded_ro.shape
    flat = torch.cat([encoded_ro.reshape(b_ro * m, d),
                      encoded_ro.new_zeros((1, d))], dim=0)
    lin = torch.where((seg < b_ro) & (k < m), seg * m + k,
                      torch.full_like(seg, b_ro * m))
    return flat[lin]


def gather_targets_to_ro(target_emb_nro: torch.Tensor, batch: ROOBatch,
                         m_targets: int) -> torch.Tensor:
    """(B_NRO, d) -> (B_RO, m, d): request-major layout (0-padded).

    Slots with no place (padding, or past ``m_targets``) write into one
    parking row that is cropped.
    """
    b_ro = batch.b_ro
    seg, k = target_positions(batch, m_targets)
    d = target_emb_nro.shape[-1]
    out = target_emb_nro.new_zeros((b_ro * m_targets + 1, d))
    lin = torch.where((seg < b_ro) & (k < m_targets), seg * m_targets + k,
                      torch.full_like(seg, b_ro * m_targets))
    out[lin] = target_emb_nro
    return out[:-1].reshape(b_ro, m_targets, d)


def sequence_flops(cfg: ROOSequenceConfig, d: int, roo: bool,
                   b_ro: int, b_nro: int) -> int:
    """§3.3 cost model: m(n²d+nd²) vs (n+m)²d+(n+m)d² (per-request units)."""
    n, m = cfg.n_hist, cfg.m_targets
    if roo:
        s = n + m
        return b_ro * (s * s * d + s * d * d) * cfg.hstu.n_layers
    return b_nro * ((n + 1) * (n + 1) * d + (n + 1) * d * d) \
        * cfg.hstu.n_layers
