"""ROO attention masks (paper §3.3), torch port of ``repro/core/masks.py``.

The ROO sequence for one request is ``[h_0 .. h_{n-1} | t_0 .. t_{m-1}]``:
n history items followed by the request's m target (candidate) items.

  * history→history : causal (h_i attends h_j iff j <= i);
  * target→history  : full (every target sees the whole valid history);
  * target→target   : DIAGONAL ONLY — target t_k attends to itself only, so
    scoring m candidates in one pass equals m independent passes.

All masks also honor per-request valid history length and target count.
``PrefixMaskSpec`` describes the cached-prefix layout of incremental
serving (new events and targets against a per-user K/V cache).
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


@dataclasses.dataclass(frozen=True, eq=False)
class PrefixMaskSpec:
    """ROO mask for the cached-prefix (incremental) attention layout.

    Rows are ``[e_0 .. e_{n_new-1} | t_0 .. t_{m-1}]`` — the request's new
    history events followed by its target slots. Columns are the full K/V
    buffer ``[h_0 .. h_{n_hist-1} | t_0 .. t_{m-1}]`` — the per-user cache
    (new events scattered in at ``prefix_lengths + r``) followed by the same
    target slots. New event r sits at absolute history position
    ``prefix_lengths[b] + r``, so:

      * new event → history  : causal on absolute positions (j <= prefix + r);
      * new event → target   : never;
      * target → history     : the full valid history (j < prefix + n_new);
      * target → target      : diagonal only.

    With ``prefix_lengths == 0`` and ``n_new == n_hist`` this is exactly the
    :class:`MaskSpec` ROO mask: extend-from-empty is full recompute.
    """
    n_hist: int                      # K/V cache capacity (history columns)
    n_new: int                       # padded new-event row count
    prefix_lengths: torch.Tensor     # (B,) events already in the cache
    new_counts: torch.Tensor         # (B,) valid new events this request
    target_counts: torch.Tensor      # (B,) valid targets this request

    def dense(self, n_rows: int, n_cols: int) -> torch.Tensor:
        """Materialize the (B, n_rows, n_cols) bool mask (oracle path)."""
        device = self.prefix_lengths.device
        r = torch.arange(n_rows, device=device)
        j = torch.arange(n_cols, device=device)
        is_new_r = r < self.n_new                                   # (R,)
        is_hist_c = j < self.n_hist                                 # (C,)
        pfx = self.prefix_lengths[:, None]                          # (B, 1)
        row_pos = torch.where(is_new_r[None, :], pfx + r[None, :],
                              r[None, :] + (self.n_hist - self.n_new))
        new_hist = (is_new_r[None, :, None] & is_hist_c[None, None, :]
                    & (j[None, None, :] <= row_pos[:, :, None]))
        tgt_hist = (~is_new_r)[:, None] & is_hist_c[None, :]        # (R, C)
        tgt_diag = ((~is_new_r)[:, None] & (~is_hist_c)[None, :]
                    & ((r - self.n_new)[:, None]
                       == (j - self.n_hist)[None, :]))
        struct = new_hist | (tgt_hist | tgt_diag)[None]             # (B, R, C)
        valid_r = torch.where(
            is_new_r[None, :], r[None, :] < self.new_counts[:, None],
            (r[None, :] - self.n_new) < self.target_counts[:, None])
        valid_c = torch.where(
            is_hist_c[None, :],
            j[None, :] < (self.prefix_lengths + self.new_counts)[:, None],
            (j[None, :] - self.n_hist) < self.target_counts[:, None])
        return struct & valid_r[:, :, None] & valid_c[:, None, :]


def prefix_spec(prefix_lengths: torch.Tensor, new_counts: torch.Tensor,
                target_counts: torch.Tensor, n_hist: int,
                n_new: int) -> PrefixMaskSpec:
    """Spec for the cached-prefix [new events | targets] row layout."""
    return PrefixMaskSpec(n_hist, n_new, prefix_lengths, new_counts,
                          target_counts)


def roo_spec(hist_lengths: torch.Tensor, target_counts: torch.Tensor,
             n_hist: int) -> MaskSpec:
    """Spec for the [history | targets] ROO sequence."""
    return MaskSpec(n_hist, hist_lengths, target_counts)


def causal_spec(hist_lengths: torch.Tensor, n_hist: int) -> MaskSpec:
    """Spec for a history-only causal sequence (no target slots)."""
    return MaskSpec(n_hist, hist_lengths, torch.zeros_like(hist_lengths))


def causal_mask(n: int, device=None) -> torch.Tensor:
    """(n, n) bool lower-triangular mask (True = may attend)."""
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return j <= i


def history_mask(hist_lengths: torch.Tensor, n_hist: int) -> torch.Tensor:
    """(B, n, n) causal mask over variable-length histories."""
    device = hist_lengths.device
    base = causal_mask(n_hist, device)[None]
    pos = torch.arange(n_hist, device=device)
    valid = pos[None, :] < hist_lengths[:, None]
    return base & valid[:, None, :] & valid[:, :, None]
