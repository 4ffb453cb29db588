"""Fanout — the single RO->NRO broadcast at the heart of ROO training
(§2.2), torch port of ``repro/core/fanout.py``.

In impression-level training every user-side activation exists ``B_NRO``
times. Under ROO the user side is computed once per request (``B_RO``
rows) and fanned out to its impressions exactly once, at the interaction
point. The fanout is a gather by ``segment_ids``; its transpose
(``fanin_sum``, ``fanin_mean``) is a segment sum, in slot order within each
request (a stable sort by segment, then ``torch.segment_reduce``), so two
calls on the card give the same bits, as ``embeddings/bag.bag_pool`` does.

Under an SPMD plan both leading dims are split over the batch axes and
the batcher's request locality keeps every impression on its request's
block, so the gather never crosses ranks: ``fanout_local`` is the fanout of
this rank's block by its local segment ids (the reference spells it with
``shard_map``; here each rank already holds only its block).
"""
from __future__ import annotations

import torch


def fanout(x_ro: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """Broadcast request-level rows ``x_ro (B_RO, ...)`` to impression slots
    by ``segment_ids (B_NRO,)`` in [0, B_RO] (B_RO marks padding). Returns
    (B_NRO, ...) with padding slots zeroed."""
    b_ro = x_ro.shape[0]
    safe = torch.clamp(segment_ids.long(), max=b_ro - 1)
    out = x_ro[safe]
    valid = segment_ids < b_ro
    return out * valid.reshape((-1,) + (1,) * (out.dim() - 1)).to(out.dtype)


def fanin_sum(x_nro: torch.Tensor, segment_ids: torch.Tensor,
              b_ro: int) -> torch.Tensor:
    """Transpose of fanout: sum impression rows back to their request.
    Slots whose id is outside [0, b_ro) (padding) are dropped."""
    seg = segment_ids.long()
    seg = torch.where((seg >= 0) & (seg < b_ro), seg,
                      torch.full_like(seg, b_ro))
    order = torch.sort(seg, stable=True).indices
    counts = torch.bincount(seg, minlength=b_ro + 1)
    return torch.segment_reduce(x_nro[order], "sum", lengths=counts,
                                unsafe=True)[:b_ro]


def fanin_mean(x_nro: torch.Tensor, segment_ids: torch.Tensor,
               b_ro: int) -> torch.Tensor:
    s = fanin_sum(x_nro, segment_ids, b_ro)
    ones = torch.ones((x_nro.shape[0],), dtype=x_nro.dtype,
                      device=x_nro.device)
    n = fanin_sum(ones, segment_ids, b_ro)
    return s / torch.clamp(n, min=1.0).reshape((-1,) + (1,) * (s.dim() - 1))


def fanout_local(x_ro: torch.Tensor, segment_ids: torch.Tensor,
                 plan=None) -> torch.Tensor:
    """Shard-local fanout: ``x_ro`` is this rank's (B_RO / n, ...) block
    and ``segment_ids`` its block's local ids (in [0, B_RO / n], padding
    == B_RO / n; ``spmd.place_batch`` rebases them)."""
    return fanout(x_ro, segment_ids)
