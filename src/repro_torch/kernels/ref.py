"""Plain torch oracles for the port's kernels (``repro/kernels/ref.py``).

Only the HSTU forward oracle is ported so far; the prefix, embedding-bag
and dot-interaction oracles land with their kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def hstu_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       rab: Optional[torch.Tensor],
                       n_hist: int,
                       hist_lengths: torch.Tensor,
                       target_counts: torch.Tensor,
                       max_rel_pos: int = 128) -> torch.Tensor:
    """HSTU pointwise attention with the ROO mask (dense (S, S) oracle).

    q, k: (B, H, S, Dqk); v: (B, H, S, Dv); rab: (H, 2*max_rel_pos+1)
    learned relative-position bias table or None. S = n_hist + m_targets.
    Mask: history causal; targets attend history + self only; valid lengths.
    Returns (B, H, S, Dv).
    """
    b, h, s, dqk = q.shape
    device = q.device
    scores = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    # python scalars, not device tensors: no host-to-device copy per call
    scores = scores / math.sqrt(dqk)
    pos = torch.arange(s, device=device)
    if rab is not None:
        delta = torch.clamp(pos[:, None] - pos[None, :],
                            -max_rel_pos, max_rel_pos) + max_rel_pos
        scores = scores + rab[:, delta][None].to(scores.dtype)
    i = pos[:, None]
    j = pos[None, :]
    is_hq, is_hk = i < n_hist, j < n_hist
    struct = (is_hq & is_hk & (j <= i)) | (~is_hq & is_hk) | \
             (~is_hq & ~is_hk & (i == j))
    valid = torch.where(pos[None, :] < n_hist,
                        pos[None, :] < hist_lengths[:, None],
                        (pos[None, :] - n_hist) < target_counts[:, None])
    mask = struct[None] & valid[:, None, :] & valid[:, :, None]   # (B,S,S)
    a = F.silu(scores) / float(s)
    a = a * mask[:, None].to(a.dtype)
    return torch.einsum("bhij,bhjd->bhid", a.to(v.dtype), v)
