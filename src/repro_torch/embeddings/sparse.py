"""Sparse embedding gradients: COO row gradients (torch port of the
``SparseRows`` part of ``repro/embeddings/sparse.py``).

:class:`SparseRows` holds a COO row gradient ``(ids, rows)`` for a
``(vocab, D)`` table: the form the embedding-bag backward
(``kernels/embedding_bag.py``) produces before it densifies.
:meth:`SparseRows.to_dense` sums duplicate ids with the embedding
backward's own reduction (``aten.embedding_dense_backward``), which on the
card merges duplicates in a fixed order rather than with float atomics, so
two calls give the same bits (``index_add_`` does not).

The merge, the gathered-rows proxy (``GatheredTable``),
``make_sparse_value_and_grad`` and the grad-accumulation helpers wait for
the sparse-row training slice.
"""
from __future__ import annotations

import dataclasses

import torch


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
        sentinel is the padding row of a ``vocab + 1`` table, so padding
        entries add nothing."""
        return torch.ops.aten.embedding_dense_backward(
            self.rows, self.ids, self.vocab + 1, self.vocab, False
        )[:self.vocab]
