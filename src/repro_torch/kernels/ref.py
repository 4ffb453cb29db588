"""Plain torch oracles for the port's kernels (``repro/kernels/ref.py``).

The HSTU forward and cached-prefix forward oracles are ported so far; the
embedding-bag and dot-interaction oracles land with their kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.masks import PrefixMaskSpec


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


def hstu_attention_prefix_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, rab: Optional[torch.Tensor],
                              n_hist: int, n_new: int,
                              prefix_lengths: torch.Tensor,
                              new_counts: torch.Tensor,
                              target_counts: torch.Tensor,
                              scale_len: int,
                              max_rel_pos: int = 128) -> torch.Tensor:
    """Cached-prefix HSTU attention (dense oracle).

    Rows are [new events | targets]: q: (B, H, n_new + m, Dqk). Columns are
    the full K/V buffer [history cache | targets]: k: (B, H, n_hist + m,
    Dqk), v: (B, H, n_hist + m, Dv). New event r sits at absolute history
    position ``prefix_lengths[b] + r``; ``scale_len`` is the 1/n normalizer
    of the equivalent full sequence (n_hist + m_targets), pinned by the
    caller so extend-only and extend-and-score calls normalize identically.
    Returns (B, H, n_new + m, Dv).
    """
    b, h, n_rows, dqk = q.shape
    n_cols = k.shape[2]
    device = q.device
    scores = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    scores = scores / math.sqrt(dqk)
    if rab is not None:
        r = torch.arange(n_rows, device=device)
        j = torch.arange(n_cols, device=device)
        row_pos = torch.where((r < n_new)[None, :],
                              prefix_lengths[:, None] + r[None, :],
                              r[None, :] + (n_hist - n_new))         # (B, R)
        delta = torch.clamp(row_pos[:, :, None] - j[None, None, :],
                            -max_rel_pos, max_rel_pos) + max_rel_pos
        bias = rab[:, delta.long()].transpose(0, 1)                  # (B,H,R,C)
        scores = scores + bias.to(scores.dtype)
    spec = PrefixMaskSpec(n_hist, n_new, prefix_lengths, new_counts,
                          target_counts)
    mask = spec.dense(n_rows, n_cols)                                # (B, R, C)
    a = F.silu(scores) / float(scale_len)
    a = a * mask[:, None].to(a.dtype)
    return torch.einsum("bhij,bhjd->bhid", a.to(v.dtype), v)
