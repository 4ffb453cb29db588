"""Fanout — the single RO->NRO broadcast at the heart of ROO training
(§2.2), torch port of ``repro/core/fanout.py``.

In impression-level training every user-side activation exists ``B_NRO``
times. Under ROO the user side is computed once per request (``B_RO``
rows) and fanned out to its impressions exactly once, at the interaction
point. The fanout is a gather by ``segment_ids``. Its transpose (``fanin_sum``,
``fanin_mean``) waits for a caller, and the shard-local ``fanout_local``
for the multi-card slice (A9).
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

