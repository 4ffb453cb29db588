"""EmbeddingBag pooling over the port's jagged layout (torch port of
``repro/embeddings/bag.py``).

A bag lookup pools the embeddings of a variable-length id list per batch
row: a gather over the vocab, then a reduce by row. ``bag_pool`` is the
reduce, split from the gather so ``embeddings/collection.bag_lookup`` can
apply request-level id dedup between them. It runs on
``torch.segment_reduce``, which sums each row's values in order, so it
gives the same bits on every call on the card too. The padded layout
(``collection.bag_lookup_dense``) runs the embedding-bag kernels of
``kernels/embedding_bag.py`` instead.
"""
from __future__ import annotations

from typing import Literal

import torch

from repro_torch.data.jagged import JaggedTensor

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
