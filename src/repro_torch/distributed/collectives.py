"""The explicit collectives of the SPMD path, as autograd ops.

The reference writes ``psum`` / ``psum_scatter`` inside ``shard_map`` and
lets JAX transpose them. The port runs one process per rank, so each
collective is a ``torch.autograd.Function`` whose backward is written out
under one convention: **whatever follows a collective is replicated over
the axis it reduced**, so every rank of that axis computes the same loss
and already holds the whole cotangent of the collective's output.

  * :func:`all_reduce_sum` — forward ``all_reduce(SUM)`` over the groups,
    backward the identity (``shard_map``'s psum transpose under that
    convention). Over ``model`` it completes a lookup's partial; over the
    batch axes it turns a loss's local sums into global ones, and each
    rank's gradient is then its own block's part, which the train step
    sums over the batch axes (``train/loop.py``);
  * :func:`reduce_scatter_cols` — the last dim's n chunks summed over the
    group, chunk k kept by rank k; backward the all-gather of the
    chunks' cotangents;
  * :func:`slice_cols` — rank k's chunk of a replicated tensor; backward
    the all-gather of the chunks' cotangents (each rank's input gets the
    whole gradient, as a replicated input must);
  * :func:`all_gather_dim` — the tiled all-gather on any dim over one axis
    or a tuple of axes (``Axes``). Its backward is the reduce-scatter of
    the cotangent when what follows is split over those axes (each rank's
    use differs: a sequence-parallel residual gathered for local heads, an
    FSDP weight gathered for the rank's own batch block), or this rank's
    chunk of it when what follows is replicated over them (``grad="slice"``);
  * :func:`reduce_scatter_dim` — the tiled reduce-scatter on any dim;
    backward the all-gather;
  * :func:`all_to_all` — ``lax.all_to_all(split_axis, concat_axis,
    tiled=True)``: chunk j of ``split_dim`` goes to rank j, the chunks
    received are concatenated on ``concat_dim`` in rank order; backward
    the inverse exchange.

An ``Axes`` is a list of ``(group, size, index)`` triples, this rank's
index along each axis, outermost first (the mesh's ``("pod", "data")``
order): a block's index over them is mixed radix, so a gather runs the
innermost group first and a reduce-scatter the outermost.

gloo's ``reduce_scatter_tensor`` and ``all_gather_into_tensor`` take a
split of dim 0 only, so the column chunks move to dim 0 before the call
and back after it. A collective over a group of one still runs (it is the
same code path a world of one takes with NCCL on the card).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


def _to_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., D) -> (n * prod(...), D / n): chunk k of the last dim is the
    k-th block of rows."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    return x.reshape(lead + (n, d // n)).movedim(-2, 0).reshape(-1, d // n)


def _from_front(rows: torch.Tensor, lead, n: int) -> torch.Tensor:
    """The inverse of :func:`_to_front`: (n * prod(lead), c) ->
    lead + (n * c,)."""
    c = rows.shape[-1]
    return rows.reshape((n,) + tuple(lead) + (c,)).movedim(0, -2).reshape(
        tuple(lead) + (n * c,))


def gather_rows_front(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """All-gather along dim 0: (R, ...) on each of n ranks -> (n * R, ...)
    in rank order (no gradient)."""
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.detach().contiguous(), group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        y = x.contiguous().clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """Sum ``x`` over each group in turn; identity backward (module note)."""
    return _AllReduceSum.apply(x, list(groups))


class _ReduceScatterCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n, ctx.lead = group, n, tuple(x.shape[:-1])
        rows = _to_front(x, n)
        out = rows.new_empty((rows.shape[0] // n, rows.shape[1]))
        dist.reduce_scatter_tensor(out, rows, group=group)
        return out.reshape(ctx.lead + (x.shape[-1] // n,))

    @staticmethod
    def backward(ctx, g):
        gathered = gather_rows_front(g.reshape(-1, g.shape[-1]), ctx.group,
                                     ctx.n)
        return _from_front(gathered, ctx.lead, ctx.n), None, None


def reduce_scatter_cols(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(..., D) partials on n ranks -> this rank's (..., D / n) chunk of
    their sum; backward all-gathers the chunks' cotangents."""
    return _ReduceScatterCols.apply(x, group, n)


class _SliceCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, k):
        ctx.group, ctx.n, ctx.lead = group, n, tuple(x.shape[:-1])
        c = x.shape[-1] // n
        return x[..., k * c:(k + 1) * c].contiguous()

    @staticmethod
    def backward(ctx, g):
        gathered = gather_rows_front(g.reshape(-1, g.shape[-1]), ctx.group,
                                     ctx.n)
        return _from_front(gathered, ctx.lead, ctx.n), None, None, None


def slice_cols(x: torch.Tensor, group, n: int, k: int) -> torch.Tensor:
    """Rank k's (..., D / n) chunk of a replicated (..., D) tensor;
    backward all-gathers the chunks' cotangents."""
    return _SliceCols.apply(x, group, n, k)


def all_reduce_flat(tensors: List[torch.Tensor], groups: Sequence,
                    async_op: bool = False):
    """Sum same-dtype tensors over the groups as one flat buffer (one
    collective a group instead of one a tensor). Returns the summed
    tensors, or with ``async_op`` a ``finish()`` that waits for the
    collective (issued at once over a single group) and returns them."""
    flat = torch.cat([t.reshape(-1) for t in tensors]) if tensors else None

    def split():
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return out

    if async_op and tensors and len(groups) == 1:
        work = dist.all_reduce(flat, group=groups[0], async_op=True)

        def finish():
            work.wait()
            return split()
        return finish
    if tensors:
        for g in groups:
            dist.all_reduce(flat, group=g)
    return (lambda: split()) if async_op else split()


Axes = List[Tuple[object, int, int]]   # (group, size, index), outer first


def _gather_front(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    for group, n, _ in reversed(axes):       # innermost first
        x = gather_rows_front(x, group, n)
    return x


def _scatter_front(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    x = x.contiguous()
    for group, n, _ in axes:                 # outermost first
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        x = out
    return x


def axes_index(axes: Axes) -> int:
    """This rank's block index over ``axes`` (mixed radix)."""
    idx = 0
    for _, n, k in axes:
        idx = idx * n + k
    return idx


def axes_size(axes: Axes) -> int:
    n = 1
    for _, k, _ in axes:
        n *= k
    return n


def gather_dim(x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
    """The tiled all-gather of ``x`` along ``dim`` over ``axes`` (no
    gradient)."""
    if not axes:
        return x
    y = _gather_front(x.detach().movedim(dim, 0).contiguous(), axes)
    return y.movedim(0, dim)


def scatter_dim(x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
    """The tiled reduce-scatter of ``x`` along ``dim`` over ``axes`` (no
    gradient)."""
    if not axes:
        return x
    return _scatter_front(x.detach().movedim(dim, 0), axes).movedim(0, dim)


def chunk_dim(x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
    """This rank's chunk of ``dim`` over ``axes`` (no collective)."""
    n = axes_size(axes)
    c = x.shape[dim] // n
    return x.narrow(dim, axes_index(axes) * c, c)


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, grad):
        ctx.axes, ctx.dim, ctx.grad = axes, dim, grad
        return gather_dim(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "slice":
            out = chunk_dim(g, ctx.axes, ctx.dim).contiguous()
        else:
            out = scatter_dim(g, ctx.axes, ctx.dim)
        return out, None, None, None


def all_gather_dim(x: torch.Tensor, axes: Axes, dim: int,
                   grad: str = "reduce_scatter") -> torch.Tensor:
    """The tiled all-gather along ``dim`` over ``axes``; backward the
    reduce-scatter, or with ``grad="slice"`` this rank's chunk (module
    note). The identity over no axes."""
    if not axes:
        return x
    return _AllGatherDim.apply(x, axes, dim, grad)


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return scatter_dim(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.axes, ctx.dim), None, None


def reduce_scatter_dim(x: torch.Tensor, axes: Axes, dim: int
                       ) -> torch.Tensor:
    """The tiled reduce-scatter along ``dim`` over ``axes``; backward the
    all-gather. The identity over no axes."""
    if not axes:
        return x
    return _ReduceScatterDim.apply(x, axes, dim)


def _exchange(x: torch.Tensor, group, n: int, split_dim: int,
              concat_dim: int) -> torch.Tensor:
    src = x.detach().movedim(split_dim, 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    blocks = out.reshape((n, src.shape[0] // n) + tuple(src.shape[1:]))
    return torch.cat([b.movedim(0, split_dim) for b in blocks.unbind(0)],
                     dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, concat_dim, split_dim)
        return _exchange(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, group, n: int, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`` over one group of n ranks; backward the inverse
    exchange."""
    return _AllToAll.apply(x, group, n, split_dim, concat_dim)


def all_reduce_max(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The elementwise max over the groups (no gradient)."""
    y = x.detach().contiguous().clone()
    for g in groups:
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=g)
    return y


class _SliceDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return chunk_dim(x, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.axes, ctx.dim), None, None


def slice_dim(x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
    """This rank's chunk of ``dim`` of a replicated tensor whose use from
    here on is split over ``axes``; backward the all-gather of the
    chunks' cotangents."""
    if not axes:
        return x
    return _SliceDim.apply(x, axes, dim)
