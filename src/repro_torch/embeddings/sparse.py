"""Sparse embedding gradients: COO row gradients (torch port of the
``SparseRows`` part of ``repro/embeddings/sparse.py``), and the row gather
whose backward writes a table gradient.

:class:`SparseRows` holds a COO row gradient ``(ids, rows)`` for a
``(vocab, D)`` table: the form the embedding-bag backward
(``kernels/embedding_bag.py``) produces before it densifies.
:meth:`SparseRows.to_dense` sums duplicate ids in a fixed order, so two
calls give the same bits on every device (``index_add_``'s float atomics
on the card, and ``index_put_(..., accumulate=True)`` with several CPU
threads, do not):

* on the CPU it runs aten's embedding backward
  (``aten.embedding_dense_backward``) at every size: each thread owns a
  range of table rows and adds that range's ids in input order.
* on the card it runs the same op up to 3,072 ids, where aten merges
  duplicates warp by warp in a fixed order. Past that, aten switches to an
  algorithm whose partial sums meet in no fixed order (on an H100, two
  calls over 8,192 ids into 4 rows did not give the same bits), so larger
  inputs take ``index_put_(..., accumulate=True)``: it sorts the ids and
  adds each id's rows in that order. That is slower where one id repeats
  thousands of times (one warp walks the run), so the small case keeps the
  faster reduction.

:func:`gather_rows` is ``table[ids]`` with the same property for its
backward: on the CPU it is ``F.embedding``, whose backward is aten's
embedding backward; on the card it stays advanced indexing, whose backward
is the sorted ``index_put_``. The forward values are the same rows on
every device.

The merge, the gathered-rows proxy (``GatheredTable``),
``make_sparse_value_and_grad`` and the grad-accumulation helpers wait for
the sparse-row training slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

# the most ids for which aten's embedding backward sums duplicates in a
# fixed order on the card
FIXED_ORDER_MAX_IDS = 3072


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for in-range integer ids of any shape; its backward
    sums duplicate ids in a fixed order on the CPU too (module note)."""
    if table.device.type == "cuda":
        return table[ids]
    return F.embedding(ids, table)


@dataclasses.dataclass(frozen=True)
class SparseRows:
    """COO row-sparse gradient of a ``(vocab, D)`` embedding table.

    ``ids[i]`` is the table row that ``rows[i]`` contributes to; ids may
    repeat (contributions add, as a dense scatter-add would) and entries
    with ``ids == vocab`` are padding, dropped by every consumer.
    """

    ids: torch.Tensor     # (N,) int32; vocab == padding sentinel
    rows: torch.Tensor    # (N, D) float contributions
    vocab: int            # table height

    def to_dense(self) -> torch.Tensor:
        """Densify to the ``(vocab, D)`` scatter-add of the rows; the
        sentinel lands in the extra row of a ``vocab + 1`` buffer, which is
        cut off."""
        if (self.rows.device.type != "cuda"
                or self.ids.numel() <= FIXED_ORDER_MAX_IDS):
            out = torch.ops.aten.embedding_dense_backward(
                self.rows, self.ids, self.vocab + 1, self.vocab, False)
        else:
            out = self.rows.new_zeros((self.vocab + 1,) + tuple(
                self.rows.shape[1:]))
            out.index_put_((self.ids,), self.rows, accumulate=True)
        return out[:self.vocab]
