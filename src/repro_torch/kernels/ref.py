"""Plain torch oracles for the port's kernels (``repro/kernels/ref.py``).

The HSTU forward, its backward, the cached-prefix forward, the embedding
bag (forward, COO-row backward, max-pooling backward) and the DLRM dot
interaction oracles: one for each of the reference's kernels.

bf16 semantics of the HSTU oracles. The forward oracles (the
``torch-dense`` backend) compute the scores and the probabilities in fp32
and, as the reference's oracles and jnp routes, round the probabilities to
v's dtype before the product with v, which sums in fp32 and rounds once.
The HSTU kernels keep the probabilities in fp32, as the reference's Pallas
kernel does: their function is the forward oracle on the operands' fp32
values (:func:`as_f32`, exact for bf16) with the output rounded once to
the operands' dtype, and that is what a bf16 kernel is held against. The
backward oracle computes in fp32 on the operands' values and rounds each
gradient once to its operand's dtype: the backward kernels' function.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.masks import PrefixMaskSpec, roo_batch_mask
from repro_torch.embeddings.sparse import gather_rows


def as_f32(*tensors: Optional[torch.Tensor]) -> tuple:
    """Each tensor widened to at least fp32 (None stays None; fp32 and fp64
    tensors are returned as they are): bf16 values are exact in fp32."""
    return tuple(None if t is None else
                 t.to(torch.promote_types(t.dtype, torch.float32))
                 for t in tensors)


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


def hstu_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rab: Optional[torch.Tensor], n_hist: int,
                           hist_lengths: torch.Tensor,
                           target_counts: torch.Tensor, max_rel_pos: int,
                           g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, Optional[torch.Tensor]]:
    """Gradients of :func:`hstu_attention_ref` w.r.t. q, k, v and rab
    (dense oracle of the backward kernels), given the output gradient g
    (B, H, S, Dv).

    Recomputes the scores, then with the ROO mask M:
    ``ds = (g vᵀ) / S * silu'(scores) * M``, ``dq = ds k / sqrt(Dqk)``,
    ``dk = dsᵀ q / sqrt(Dqk)``, ``dv = aᵀ g``; ``drab[h, t]`` sums ds over
    the batch and every cell whose clipped delta
    ``clip(i - j, -max_rel, max_rel) + max_rel`` is t. Returns
    ``(dq, dk, dv, drab)``; drab is None when rab is None. fp32 inside on
    bf16 operands, each gradient rounded once to its operand's dtype.
    """
    dtypes = (q.dtype, k.dtype, v.dtype, None if rab is None else rab.dtype)
    q, k, v, rab, g = as_f32(q, k, v, rab, g)
    b, h, s, dqk = q.shape
    device = q.device
    inv_d = 1.0 / math.sqrt(dqk)
    scores = torch.einsum("bhid,bhjd->bhij", q, k) * inv_d
    pos = torch.arange(s, device=device)
    delta = torch.clamp(pos[:, None] - pos[None, :],
                        -max_rel_pos, max_rel_pos) + max_rel_pos
    if rab is not None:
        scores = scores + rab[:, delta][None]
    mask = roo_batch_mask(hist_lengths, target_counts, n_hist,
                          s - n_hist)[:, None].to(q.dtype)   # (B, 1, S, S)
    sig = torch.sigmoid(scores)
    a = F.silu(scores) * (1.0 / s) * mask
    ds = (torch.einsum("bhid,bhjd->bhij", g, v) * (1.0 / s)
          * (sig * (1.0 + scores * (1.0 - sig))) * mask)
    dq = torch.einsum("bhij,bhjd->bhid", ds, k) * inv_d
    dk = torch.einsum("bhij,bhid->bhjd", ds, q) * inv_d
    dv = torch.einsum("bhij,bhid->bhjd", a, g)
    drab = None
    if rab is not None:
        # per-bin sums as a product with the (S*S, nrab) one-hot of delta:
        # no atomics and no host sync on the card
        bins = torch.arange(2 * max_rel_pos + 1, device=device)
        onehot = (delta.reshape(-1, 1) == bins).to(ds.dtype)
        drab = (ds.sum(0).reshape(h, s * s) @ onehot).to(dtypes[3])
    return dq.to(dtypes[0]), dk.to(dtypes[1]), dv.to(dtypes[2]), drab


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


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      lengths: torch.Tensor,
                      pooling: str = "sum") -> torch.Tensor:
    """Pooled embedding bag (sum | mean | max). table: (V, D); ids: (B, L);
    lengths: (B,). Slots past ``lengths`` never contribute, ids are clipped
    to [0, V), and empty bags give zeros. Mean divides the sum by
    ``max(lengths, 1)``, the reference's op."""
    b, l = ids.shape
    valid = torch.arange(l, device=ids.device)[None, :] < lengths[:, None]
    safe = torch.clamp(ids.long(), 0, table.shape[0] - 1)
    emb = gather_rows(table, safe.reshape(-1)).reshape(b, l, -1)
    if pooling == "max":
        neg = torch.full_like(emb, torch.finfo(emb.dtype).min)
        out = torch.where(valid[..., None], emb, neg).amax(dim=1)
        return torch.where((lengths > 0)[:, None], out, torch.zeros_like(out))
    out = torch.sum(emb * valid[..., None].to(emb.dtype), dim=1)
    if pooling == "mean":
        out = out / torch.clamp(lengths, min=1).to(out.dtype)[:, None]
    return out


def embedding_bag_coo_rows_ref(g: torch.Tensor, ids: torch.Tensor,
                               lengths: torch.Tensor, vocab: int,
                               pooling: str = "sum"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """COO gradient of a sum or mean bag w.r.t. its table, given the output
    gradient g (B, D): slot (b, l) contributes ``g[b] * w(b, l)`` to row
    ``ids[b, l]``, with w = [l < len] (sum) or [l < len] / max(len, 1)
    (mean), w in fp32 as the reference's backward kernel computes it.
    Returns ``(ids (B*L,) int32, rows (B*L, D) in g's dtype)``; invalid
    slots carry the ``vocab`` sentinel id and zero rows."""
    b, l = ids.shape
    valid = torch.arange(l, device=ids.device)[None, :] < lengths[:, None]
    w = valid.to(torch.float32)
    if pooling == "mean":
        w = w / torch.clamp(lengths, min=1).to(torch.float32)[:, None]
    rows = (g.to(torch.float32)[:, None, :] * w[:, :, None]).to(g.dtype)
    cids = torch.where(valid, torch.clamp(ids.long(), 0, vocab - 1), vocab)
    return cids.reshape(-1).to(torch.int32), rows.reshape(b * l, -1)


def embedding_bag_max_coo_rows_ref(table: torch.Tensor, ids: torch.Tensor,
                                   lengths: torch.Tensor, out: torch.Tensor,
                                   g: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """COO gradient of a max bag: each output element's gradient goes to
    the slots that hold the maximum, split evenly among ties (the
    reference's max backward). ``out`` is the bag's forward output.
    Returns ``(ids, rows)`` as :func:`embedding_bag_coo_rows_ref`."""
    b, l = ids.shape
    v, d = table.shape
    valid = torch.arange(l, device=ids.device)[None, :] < lengths[:, None]
    safe = torch.where(valid, torch.clamp(ids.long(), 0, v - 1), 0)
    emb = gather_rows(table, safe.reshape(-1)).reshape(b, l, d)
    hit = (emb == out[:, None, :]) & valid[:, :, None]
    cnt = torch.clamp(hit.sum(dim=1, keepdim=True), min=1)
    rows = (hit.to(torch.float32) / cnt.to(torch.float32)) * \
        g.to(torch.float32)[:, None, :]
    cids = torch.where(valid, safe, v)
    return (cids.reshape(-1).to(torch.int32),
            rows.reshape(b * l, d).to(table.dtype))


def dot_interaction_ref(dense_out: torch.Tensor, sparse_embs: torch.Tensor,
                        self_interaction: bool = False) -> torch.Tensor:
    """DLRM dot interaction. dense_out: (B, D); sparse_embs: (B, F, D).
    With T = [dense_out; sparse_embs] (B, F+1, D), returns (B, D + P):
    dense_out, then the pairwise dots T_i . T_j for j < i (j <= i under
    ``self_interaction``) in row-major tril order (1,0), (2,0), (2,1), ...
    P = (F+1)F/2 (or (F+1)(F+2)/2). The Gram matrix is a ``bmm`` in fp32
    (fp64 for fp64 inputs); the pairs are cast to ``dense_out``'s dtype."""
    t = torch.cat([dense_out[:, None, :], sparse_embs], dim=1)
    f1 = t.shape[1]
    tf = t.to(torch.promote_types(t.dtype, torch.float32))
    z = torch.bmm(tf, tf.transpose(1, 2))                    # (B, F1, F1)
    i, j = torch.tril_indices(f1, f1, offset=0 if self_interaction else -1,
                              device=t.device)
    return torch.cat([dense_out, z[:, i, j].to(dense_out.dtype)], dim=1)
