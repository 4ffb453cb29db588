"""EmbeddingBag pooling over the port's jagged layout (torch port of
``repro/embeddings/bag.py``).

A bag lookup pools the embeddings of a variable-length id list per batch
row: a gather over the vocab, then a reduce by row. ``bag_pool`` is the
reduce, split from the gather so ``embeddings/collection.bag_lookup`` can
apply request-level id dedup between them. It runs on
``torch.segment_reduce``, which sums each row's values in order, so it
gives the same bits on every call on the card too. ``bag_pool_dense`` is
its padded-layout twin, and ``bag_lookup`` / ``bag_lookup_dense`` are the
plain gather + pool over a dense table, as in the reference: no kernel
runs here. The kernel route for padded bags is
``embeddings/collection.bag_lookup_dense``, which runs the embedding-bag
kernels of ``kernels/embedding_bag.py`` (B5 forward, B6 backward on the
card).
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.data.jagged import JaggedTensor
from repro_torch.embeddings.sparse import gather_rows

Pooling = Literal["sum", "mean", "max"]


def bag_pool(emb: torch.Tensor, ids: JaggedTensor,
             pooling: Pooling = "sum") -> torch.Tensor:
    """Pool pre-gathered rows ``emb (capacity, D)`` by the jagged layout of
    ``ids``. Returns (batch, D); empty bags give zeros."""
    b = ids.batch_size
    lens = ids.lengths.long()
    # rows are packed in order and cut at the capacity, so a row keeps the
    # slots of [start, end) that fall below it; the padding past the last
    # kept slot is one more segment, cropped
    cap = torch.full((1,), emb.shape[0], dtype=torch.long, device=lens.device)
    ends = torch.minimum(torch.cumsum(lens, 0), cap)
    seg_lens = torch.diff(torch.cat([torch.zeros_like(cap), ends, cap]))
    out = torch.segment_reduce(emb, "max" if pooling == "max" else "sum",
                               lengths=seg_lens, unsafe=True)[:b]
    if pooling == "max":
        return torch.where((lens > 0)[:, None], out, torch.zeros_like(out))
    if pooling == "mean":
        out = out / torch.clamp(ids.lengths, min=1).to(out.dtype)[:, None]
    return out


def bag_pool_dense(emb: torch.Tensor, lengths: torch.Tensor,
                   pooling: Pooling = "sum") -> torch.Tensor:
    """Pool pre-gathered rows ``emb (B, L, D)`` by ``lengths (B,)``; empty
    bags give zeros."""
    b, l = emb.shape[0], emb.shape[1]
    valid = torch.arange(l, device=emb.device)[None, :] < lengths[:, None]
    emb = emb * valid[..., None].to(emb.dtype)
    if pooling == "max":
        neg = torch.full_like(emb, torch.finfo(emb.dtype).min)
        out = torch.where(valid[..., None], emb, neg).amax(dim=1)
        return torch.where((lengths > 0)[:, None], out, torch.zeros_like(out))
    # slot order within each bag, as bag_pool sums
    out = torch.segment_reduce(emb.reshape((b * l,) + tuple(emb.shape[2:])),
                               "sum", lengths=torch.full(
                                   (b,), l, dtype=torch.long,
                                   device=emb.device), unsafe=True)
    if pooling == "mean":
        out = out / torch.clamp(lengths, min=1).to(out.dtype)[:, None]
    return out


def bag_lookup(table: torch.Tensor, ids: JaggedTensor,
               pooling: Pooling = "sum") -> torch.Tensor:
    """table: (V, D); ids: JaggedTensor with int values. Returns (batch, D)
    pooled embeddings; empty bags give zeros."""
    safe = torch.clamp(ids.values.long(), 0, table.shape[0] - 1)
    return bag_pool(gather_rows(table, safe), ids, pooling)


def bag_lookup_dense(table: torch.Tensor, ids: torch.Tensor,
                     lengths: torch.Tensor,
                     pooling: Pooling = "sum") -> torch.Tensor:
    """Padded-layout variant: ids (B, L) int, lengths (B,). The plain
    gather + pool; ``collection.bag_lookup_dense`` is the kernel route."""
    b, l = ids.shape
    safe = torch.clamp(ids.long(), 0, table.shape[0] - 1)
    emb = gather_rows(table, safe.reshape(-1)).reshape(b, l, -1)
    return bag_pool_dense(emb, lengths, pooling)
