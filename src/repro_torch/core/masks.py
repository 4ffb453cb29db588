"""ROO attention masks (paper §3.3), torch port of ``repro/core/masks.py``.

The ROO sequence for one request is ``[h_0 .. h_{n-1} | t_0 .. t_{m-1}]``:
n history items followed by the request's m target (candidate) items.

  * history→history : causal (h_i attends h_j iff j <= i);
  * target→history  : full (every target sees the whole valid history);
  * target→target   : DIAGONAL ONLY — target t_k attends to itself only, so
    scoring m candidates in one pass equals m independent passes.

All masks also honor per-request valid history length and target count.
The cached-prefix spec (``PrefixMaskSpec``) waits for incremental serving.
"""
from __future__ import annotations

import dataclasses

import torch


def roo_sequence_mask(n_hist: int, m_targets: int,
                      device=None) -> torch.Tensor:
    """(n+m, n+m) bool allowed-attention mask (True = may attend)."""
    s = n_hist + m_targets
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    is_hist_q = i < n_hist
    is_hist_k = j < n_hist
    causal = j <= i
    hist_block = is_hist_q & is_hist_k & causal
    target_hist = (~is_hist_q) & is_hist_k
    target_self = (~is_hist_q) & (~is_hist_k) & (i == j)
    return hist_block | target_hist | target_self


def roo_batch_mask(hist_lengths: torch.Tensor, target_counts: torch.Tensor,
                   n_hist: int, m_targets: int) -> torch.Tensor:
    """(B, n+m, n+m) mask with per-request valid lengths applied.

    hist_lengths: (B,) valid history per request.
    target_counts: (B,) valid targets per request.
    """
    device = hist_lengths.device
    base = roo_sequence_mask(n_hist, m_targets, device)[None]    # (1, s, s)
    s = n_hist + m_targets
    pos = torch.arange(s, device=device)
    hist_valid = torch.where(pos[None, :] < n_hist,
                             pos[None, :] < hist_lengths[:, None],
                             (pos[None, :] - n_hist) < target_counts[:, None])
    return base & hist_valid[:, None, :] & hist_valid[:, :, None]


@dataclasses.dataclass(frozen=True, eq=False)
class MaskSpec:
    """Structured description of the ROO mask — what the kernels consume.

    The CUDA kernel and the chunked torch path regenerate the mask blockwise
    from it; only the dense oracle materializes it (via :meth:`dense`).
    ``n_hist`` is the padded history length (positions >= n_hist are target
    slots); a pure causal mask over a history-only sequence is the special
    case ``n_hist == S`` with ``target_counts == 0``.
    """
    n_hist: int
    hist_lengths: torch.Tensor     # (B,) valid history per request
    target_counts: torch.Tensor    # (B,) valid targets per request

    def dense(self, seq_len: int) -> torch.Tensor:
        """Materialize the (B, seq_len, seq_len) bool mask (oracle path)."""
        return roo_batch_mask(self.hist_lengths, self.target_counts,
                              self.n_hist, seq_len - self.n_hist)


def roo_spec(hist_lengths: torch.Tensor, target_counts: torch.Tensor,
             n_hist: int) -> MaskSpec:
    """Spec for the [history | targets] ROO sequence."""
    return MaskSpec(n_hist, hist_lengths, target_counts)


def causal_spec(hist_lengths: torch.Tensor, n_hist: int) -> MaskSpec:
    """Spec for a history-only causal sequence (no target slots)."""
    return MaskSpec(n_hist, hist_lengths, torch.zeros_like(hist_lengths))
