"""Sparse embedding gradients: COO row gradients, the gathered-rows proxy
and the sparse-row training entry point (torch port of
``repro/embeddings/sparse.py``), and the row gather whose backward writes a
table gradient.

The dense training path writes a full ``(V, D)`` gradient for every table
on every step, and row-wise Adagrad then reads and writes all V rows
though a batch touches a few thousand. This module keeps the sparse
structure to the optimizer:

* :class:`SparseRows` holds a COO row gradient ``(ids, rows)`` for a
  ``(vocab, D)`` table: the form the embedding-bag backward
  (``kernels/embedding_bag.py``) produces before it densifies, and the
  gradient ``make_sparse_value_and_grad`` gives a declared table.
  :meth:`SparseRows.merged` sums duplicate ids into unique sorted ids at
  the same capacity, padded with the ``vocab`` sentinel.
* :class:`GatheredTable` holds the distinct rows of one table that a batch
  touches, gathered once. Every lookup of ``embeddings/collection.py``
  takes it in place of the ``(V, D)`` table (ids translate to positions by
  ``searchsorted``; an id that was not gathered reads a zero row), so
  model code is the same in dense and sparse mode, and the gradient with
  respect to its rows is the touched-row gradient.
* :func:`make_sparse_value_and_grad` wraps a model loss so that autograd
  runs against gathered rows instead of the declared tables: the grads
  tree holds a :class:`SparseRows` at each declared table (of at least
  ``SPARSE_MIN_VOCAB`` rows) and dense tensors elsewhere. No ``(V, D)``
  gradient of such a table is ever allocated: the table leaves the
  differentiated tree.
* ``split_sparse``, ``merge_sparse``, ``concat_sparse`` and
  ``flatten_stacked`` carry ``SparseRows`` through gradient accumulation
  (``train/loop.py``): a COO sum is a concatenation.

Sums of duplicate ids run in a fixed order, so two calls give the same
bits on every device (``index_add_``'s float atomics on the card, and
``index_put_(..., accumulate=True)`` with several CPU threads, do not).
:meth:`SparseRows.to_dense`:

* on the CPU runs aten's embedding backward
  (``aten.embedding_dense_backward``) at every size: each thread owns a
  range of table rows and adds that range's ids in input order.
* on the card, for a table under ``ONE_HOT_MAX_ROWS`` rows, is a one-hot
  product in float64 (a fixed-order cuBLAS product, which TF32 settings do
  not touch; rounded once to the rows' dtype): a run of thousands of one
  id costs no more than any other input. dlrm-mlperf's three tiny NRO
  tables (4, 14 and 36 rows) each take 8,192 ids a step this way.
* on the card otherwise, runs aten's embedding backward up to 3,072 ids,
  where aten merges duplicates warp by warp in a fixed order. Past that,
  aten switches to an algorithm whose partial sums meet in no fixed order
  (on an H100, two calls over 8,192 ids into 4 rows did not give the same
  bits), so larger inputs take ``index_put_(..., accumulate=True)``: it
  sorts the ids and adds each id's rows in that order (one warp walks a
  run of one id, so long runs are slow: the one-hot product takes the
  tiny tables).

:meth:`SparseRows.merged` sums by the inverse ids through the same routes
on an ``(N + 1, D)`` buffer, N the number of entries; the unique ids come
from a sort, with no host sync.

:func:`gather_rows` is ``table[ids]`` with the same property for its
backward: on the CPU it is ``F.embedding``, whose backward is aten's
embedding backward; on the card its backward is :meth:`SparseRows.to_dense`
of the output gradient's rows, so a table gradient takes the same routes
whether it comes from a gather or from the bag kernels' COO rows (a plain
bag's gradient and the kernel's then sum in the same order). The forward
values are the same rows on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import leaves, tree_map, unflatten

# the most ids for which aten's embedding backward sums duplicates in a
# fixed order on the card
FIXED_ORDER_MAX_IDS = 3072
# tables under this many rows densify by a one-hot product on the card
ONE_HOT_MAX_ROWS = 64
# declared tables under this many rows keep the dense gradient: gathering
# and merging a batch of COO rows to update a handful of table rows costs
# more than the dense apply it replaces (the reference's value)
SPARSE_MIN_VOCAB = 64


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` whose backward is :meth:`SparseRows.to_dense` of the
    output gradient's rows."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        rows = g.reshape((ids.numel(),) + tuple(g.shape[ids.dim():]))
        return SparseRows(ids.reshape(-1), rows, ctx.vocab).to_dense(), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for in-range integer ids of any shape; its backward
    sums duplicate ids in a fixed order (module note)."""
    if table.device.type == "cuda":
        return _GatherRows.apply(table, ids)
    return F.embedding(ids, table)


def one_hot_sum(ids: torch.Tensor, rows: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """``(n_rows, D)``: row r is the sum of ``rows[i]`` over ``ids[i] ==
    r``; ids outside ``[0, n_rows)`` (the sentinel) drop. A one-hot
    ``(n_rows, N)`` product in float64, rounded once to ``rows``' dtype:
    fixed order on every device, and the same time whatever the runs."""
    rows_at = torch.arange(n_rows, device=ids.device)[:, None]
    hot = ids.long()[None, :] == rows_at
    return (hot.to(torch.float64) @ rows.to(torch.float64)).to(rows.dtype)


def unique_padded(flat: torch.Tensor, fill: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(flat, size=N, fill_value=fill, return_inverse=True)``
    for a 1-D ``flat`` of N ids, with no host sync: the distinct ids sorted
    ascending, then ``fill`` to length N, and for each entry the position
    of its id among them."""
    s, perm = torch.sort(flat, stable=True)
    new = torch.ones_like(s, dtype=torch.bool)
    new[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(new, 0) - 1
    uids = torch.full_like(flat, fill)
    uids.scatter_(0, rank, s)           # a run writes one value n times
    inv = torch.empty_like(rank)
    inv.scatter_(0, perm, rank)
    return uids, inv


@dataclasses.dataclass(frozen=True)
class SparseRows:
    """COO row-sparse gradient of a ``(vocab, D)`` embedding table.

    ``ids[i]`` is the table row that ``rows[i]`` contributes to; ids may
    repeat (contributions add, as a dense scatter-add would) and entries
    with ``ids == vocab`` are padding, dropped by every consumer.
    ``unique=True`` marks ids as unique and sorted ascending with the
    padding last, the layout ``gather_table`` and :meth:`merged` produce,
    so :meth:`merged` returns it as it is; producers that concatenate COO
    entries leave it False.
    """

    ids: torch.Tensor     # (N,) int32; vocab == padding sentinel
    rows: torch.Tensor    # (N, D) float contributions
    vocab: int            # table height
    unique: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.vocab,) + tuple(self.rows.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.rows.dtype

    def merged(self) -> "SparseRows":
        """Unique sorted ids at the same capacity, padded with ``vocab``,
        each with its entries' rows summed (in a fixed order: by the
        inverse ids, through :meth:`to_dense`'s routes); a padding slot's
        row is zero, the sentinel's the sum of the padding entries."""
        if self.unique:
            return self
        uids, inv = unique_padded(self.ids, self.vocab)
        rows = SparseRows(inv, self.rows, self.ids.numel()).to_dense()
        return SparseRows(uids, rows, self.vocab, unique=True)

    def scale(self, s) -> "SparseRows":
        return SparseRows(self.ids, self.rows * s, self.vocab, self.unique)

    def to_dense(self) -> torch.Tensor:
        """Densify to the ``(vocab, D)`` scatter-add of the rows; the
        sentinel drops (it lands in the extra row of a ``vocab + 1``
        buffer, which is cut off)."""
        on_card = self.rows.device.type == "cuda"
        if on_card and self.vocab < ONE_HOT_MAX_ROWS:
            return one_hot_sum(self.ids, self.rows, self.vocab)
        if not on_card or self.ids.numel() <= FIXED_ORDER_MAX_IDS:
            out = torch.ops.aten.embedding_dense_backward(
                self.rows, self.ids, self.vocab + 1, self.vocab, False)
        else:
            out = self.rows.new_zeros((self.vocab + 1,) + tuple(
                self.rows.shape[1:]))
            out.index_put_((self.ids,), self.rows, accumulate=True)
        return out[:self.vocab]


def is_sparse(x) -> bool:
    return isinstance(x, SparseRows)


def sq_sum(g) -> torch.Tensor:
    """Sum of squared gradient entries of one grads leaf, ``SparseRows`` or
    dense: the grad-norm term ``train/loop.py`` logs. A ``SparseRows``'
    entries are squared unmerged, as the reference does (duplicate ids are
    not summed first, so the logged norm differs from the dense run's where
    a batch repeats an id across microbatches)."""
    x = g.rows if is_sparse(g) else g
    return torch.sum(torch.square(x.float()))


# ---------------------------------------------------------------------------
# Gradient accumulation: the dense part of a grads tree sums, the
# SparseRows part concatenates.
# ---------------------------------------------------------------------------

def split_sparse(grads: Any) -> Tuple[Any, Any]:
    """-> (dense tree, sparse tree); each has None at the other's leaves."""
    dense = tree_map(lambda g: None if is_sparse(g) else g, grads,
                     is_leaf=is_sparse)
    sparse = tree_map(lambda g: g if is_sparse(g) else None, grads,
                      is_leaf=is_sparse)
    return dense, sparse


def merge_sparse(dense: Any, sparse: Any) -> Any:
    """Inverse of :func:`split_sparse` given congruent trees."""
    if sparse is None:
        return dense
    if dense is None:
        return sparse
    if isinstance(dense, dict):
        return {k: merge_sparse(dense.get(k), sparse.get(k))
                for k in list(dense) + [k for k in sparse if k not in dense]}
    if isinstance(dense, (list, tuple)):
        return type(dense)(merge_sparse(d, s) for d, s in zip(dense, sparse))
    return dense


def flatten_stacked(sparse_stacked: Any, scale: float = 1.0) -> Any:
    """Stacked ``SparseRows`` — ids (M, N), rows (M, N, D), one slice per
    microbatch — as flat COO, rows scaled (the 1/microbatches mean). Not
    marked unique: stacking repeats ids across microbatches, which the
    optimizer's merge folds."""
    def leaf(g):
        if not is_sparse(g):
            return g
        return SparseRows(g.ids.reshape(-1),
                          g.rows.reshape((-1,) + tuple(g.rows.shape[2:]))
                          * scale, g.vocab)
    return tree_map(leaf, sparse_stacked, is_leaf=is_sparse)


def concat_sparse(sparse_parts, scale: float = 1.0) -> Any:
    """Per-microbatch ``SparseRows`` trees concatenated into flat COO, in
    microbatch order, rows scaled (a COO sum is a concatenation). Not
    marked unique: the optimizer's merge folds duplicates across
    microbatches."""
    def leaf(*gs):
        if not is_sparse(gs[0]):
            return gs[0]
        return SparseRows(torch.cat([g.ids for g in gs]),
                          torch.cat([g.rows for g in gs]) * scale,
                          gs[0].vocab)
    return tree_map(leaf, *sparse_parts, is_leaf=is_sparse)


# ---------------------------------------------------------------------------
# GatheredTable: the lookup-side proxy.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GatheredTable:
    """The distinct rows of one table that the current batch touches.

    ``uids`` is sorted ascending with ``vocab`` sentinels padding the tail
    (``gather_table``'s layout), so an id translates to its row by
    ``searchsorted``. An id absent from ``uids`` reads a zero row: that
    cannot happen when the model's table-ids declaration covers its
    lookups, and shows in the sparse-vs-dense tests when it does not.
    """

    uids: torch.Tensor   # (N,) int32 sorted; vocab == padding
    rows: torch.Tensor   # (N, D)
    vocab: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.vocab,) + tuple(self.rows.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.rows.dtype

    def positions(self, ids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each id's (clipped to ``[0, vocab)``) row among the gathered
        ones, as int32 (the bag kernels' index type, so they convert
        nothing), and whether it was gathered; ids of any shape."""
        ids = torch.clamp(ids, 0, self.vocab - 1).to(self.uids.dtype)
        pos = torch.clamp(torch.searchsorted(self.uids, ids, out_int32=True),
                          max=self.uids.shape[0] - 1)
        return pos, self.uids[pos] == ids

    def take(self, ids: torch.Tensor) -> torch.Tensor:
        """``table[clip(ids)]`` for ids of any shape; a miss reads zero."""
        pos, hit = self.positions(ids)
        emb = gather_rows(self.rows, pos)
        return emb * hit[..., None].to(emb.dtype)

    def padded(self, ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The operands of a bag kernel over the gathered rows: the ``(N +
        1, D)`` rows with a zero row appended, and each id's position, N
        (the zero row) for a miss. A bag over them equals the bag over the
        table, misses reading zero in every pooling, with no host sync."""
        pos, hit = self.positions(ids)
        n = self.rows.shape[0]
        zero = self.rows.new_zeros((1,) + tuple(self.rows.shape[1:]))
        return torch.cat([self.rows, zero]), torch.where(hit, pos, n)


def gather_table(table: torch.Tensor, ids: torch.Tensor) -> GatheredTable:
    """The batch's rows of one table, each distinct id read once: capacity
    the number of ids, uids sorted and padded with ``vocab``, rows gathered
    at ``min(uid, vocab - 1)``."""
    vocab = table.shape[0]
    flat = torch.clamp(ids.reshape(-1), 0, vocab - 1).to(torch.int32)
    uids, _ = unique_padded(flat, vocab)
    rows = gather_rows(table, torch.clamp(uids, max=vocab - 1).long())
    return GatheredTable(uids, rows, vocab)


# ---------------------------------------------------------------------------
# The sparse training entry point.
# ---------------------------------------------------------------------------

def _get_path(tree: Any, path: str) -> Any:
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _set_path(tree: Dict, path: str, value: Any) -> Dict:
    """A copy of the dict path down to ``path``, with ``value`` there."""
    head, _, rest = path.partition("/")
    out = dict(tree)
    out[head] = _set_path(tree[head], rest, value) if rest else value
    return out


def sparse_forward(loss_fn: Callable, table_ids_fn: Callable, params: Any,
                   batch: Any, gen, min_vocab: int = SPARSE_MIN_VOCAB
                   ) -> Tuple[torch.Tensor, Tuple]:
    """The forward half of :func:`make_sparse_value_and_grad`: gathers the
    declared tables' rows, runs ``loss_fn`` against them, and returns the
    loss and the tape :func:`sparse_grads` takes."""
    ids_map = {p: ids for p, ids in table_ids_fn(batch).items()
               if _get_path(params, p).shape[0] >= min_vocab}
    gathered = {p: gather_table(_get_path(params, p).detach(), ids)
                for p, ids in ids_map.items()}
    # the tables leave the differentiated tree: a present (V, D) leaf would
    # come back as a dense zeros gradient, the allocation this path avoids
    stripped = params
    for p in gathered:
        stripped = _set_path(stripped, p, None)
    flat = [x.detach().requires_grad_(True) for x in leaves(stripped)]
    rows = [g.rows.requires_grad_(True) for g in gathered.values()]
    full = unflatten(stripped, flat)
    for (p, g), r in zip(gathered.items(), rows):
        full = _set_path(full, p, GatheredTable(g.uids, r, g.vocab))
    return loss_fn(full, batch, gen), (stripped, flat, gathered, rows)


def sparse_grads(loss: torch.Tensor, tape: Tuple) -> Any:
    """The backward half: the grads tree, ``SparseRows(uids, row grads,
    vocab, unique=True)`` at each gathered table, dense tensors elsewhere
    (zeros for a leaf the loss does not use)."""
    stripped, flat, gathered, rows = tape
    got = torch.autograd.grad(loss, flat + rows, allow_unused=True)
    grads = unflatten(stripped, [torch.zeros_like(x) if g is None else g
                                 for x, g in zip(flat, got)])
    for (p, t), r, g in zip(gathered.items(), rows, got[len(flat):]):
        grads = _set_path(grads, p, SparseRows(
            t.uids, torch.zeros_like(r) if g is None else g, t.vocab,
            unique=True))
    return grads


def make_sparse_value_and_grad(loss_fn: Callable, table_ids_fn: Callable,
                               min_vocab: int = SPARSE_MIN_VOCAB
                               ) -> Callable:
    """Sparse-gradient ``value_and_grad`` for an embedding-heavy loss.

    ``loss_fn(params, batch, gen) -> scalar`` must route every lookup of
    the declared tables through ``embeddings/collection.py`` (which takes
    the :class:`GatheredTable` proxy). ``table_ids_fn(batch) -> {path:
    ids}`` declares, per table (a ``/``-joined params path), every id the
    forward looks up; the models export these beside their losses
    (``lsr_table_ids``, ``dlrm_table_ids``, ``gr_table_ids``). Declared
    tables under ``min_vocab`` rows keep the dense gradient.

    Returns ``vag(params, batch, gen) -> (loss, grads)``, ``grads`` with a
    :class:`SparseRows` at each gathered table path and dense tensors
    elsewhere; it plugs into ``train.loop.make_train_step`` and
    ``Trainer`` as ``value_and_grad_fn``.
    """
    def vag(params, batch, gen):
        loss, tape = sparse_forward(loss_fn, table_ids_fn, params, batch,
                                    gen, min_vocab)
        return loss.detach(), sparse_grads(loss, tape)
    return vag
