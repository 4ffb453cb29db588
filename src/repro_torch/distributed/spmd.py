"""SPMD state and batch placement: the executable half of a
``ShardingPlan`` (torch port of ``repro/distributed/spmd.py``).

  * :func:`param_spec` — path + shape -> spec, the single rule params,
    optimizer state and the ``comms_ef`` residuals go through (ported to
    the letter: a spec equals the reference's after
    ``sharding.normalize_spec``);
  * :func:`state_shardings` — the state's tree of specs (or, with
    ``param_specs=``, a model's own spec tree for its params, e.g.
    ``lm_param_specs``, which Adam's ``m`` / ``v`` follow by path);
    :func:`place_state` realizes it: each rank keeps its block of every
    leaf, the block at its mesh coordinate of each split dim (tables and
    their row-wise accumulators and residuals by rows over ``model``;
    dense leaves of >= 2 dims by their FSDP rows and TP columns).
    :func:`fit_spec` drops a spec entry whose axes do not divide the dim,
    so that dim stays whole;
  * :func:`use_leaf` — gather-before-use: the whole leaf forward from its
    blocks, and the gradient backward reduce-scattered over the axes the
    leaf's use is split over (this rank's chunk over the others);
    :func:`gather_dense` does it for every dense leaf of a model that
    reads its params whole (the recsys archs);
  * :func:`reduce_grads` — the one gradient rule: a leaf's gradient is
    summed over every axis its use was split over and the leaf is not
    split on (the split ones were summed by its gather's backward);
    :func:`grad_sq_norm` sums each leaf's squares over the axes it is
    split on, once;
  * :func:`batch_spec` / :func:`place_batch` / :func:`make_batch_placer` /
    :func:`make_batch_sharding_fn` — each batch leaf's batch dim cut to
    this rank's data block; ``JaggedTensor``s stay whole, as the
    reference keeps them replicated (the jagged lookup sums the whole
    batch and keeps its own rows). A cut ``ROOBatch`` gets its
    ``segment_ids`` rebased to the block: ``seg - k * B_RO / n``, padding
    ``B_RO`` -> ``B_RO / n`` (the batcher's request locality puts every
    impression on its request's block; the ids it emits are global,
    ``local_segment_ids=False``);
  * :func:`data_sum` / :func:`model_sum` — a value summed over the batch
    axes or ``model`` (``collectives.all_reduce_sum``: identity backward).

Everything is the identity under a disabled plan (or None).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.data.jagged import JaggedTensor
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (SHARD_MIN_ROWS,  # noqa: F401
                                              ShardingPlan, Spec)
from repro_torch.train.optim import default_is_embedding
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _enabled(plan: Optional[ShardingPlan]) -> bool:
    return plan is not None and plan.enabled


def data_shard_count(plan: Optional[ShardingPlan]) -> int:
    """Number of batch shards the plan splits leading dims into (1 when
    disabled) — batch sizes and the batcher's n_shards must divide it."""
    if not _enabled(plan):
        return 1
    return _axis_size(plan.mesh, plan.batch_axes)


def model_shard_count(plan: Optional[ShardingPlan]) -> int:
    if not _enabled(plan) or plan.model_axis is None:
        return 1
    return plan.mesh.shape[plan.model_axis]


def data_index(plan: ShardingPlan) -> int:
    """This rank's batch block (mixed radix over the batch axes)."""
    idx = 0
    for a in plan.batch_axes:
        idx = idx * plan.mesh.shape[a] + plan.mesh.coord(a)
    return idx


def model_index(plan: ShardingPlan) -> int:
    return plan.mesh.coord(plan.model_axis)


def batch_groups(plan: ShardingPlan) -> List:
    return [plan.mesh.group(a) for a in plan.batch_axes]


def model_group(plan: ShardingPlan):
    return plan.mesh.group(plan.model_axis)


def table_is_sharded(plan: Optional[ShardingPlan], vocab: int) -> bool:
    """True when the plan row-shards a table of this vocab over ``model``
    (at least ``plan.table_min_rows`` rows, divisible by the model ranks).

    The same predicate gates (a) the table's param / opt-state placement
    and (b) routing its lookups through ``embeddings/sharded.py``.
    """
    return (_enabled(plan) and plan.model_axis is not None
            and vocab >= plan.table_min_rows
            and vocab % plan.mesh.shape[plan.model_axis] == 0)


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               plan: ShardingPlan,
               is_embedding: Callable = default_is_embedding) -> Spec:
    """Spec of one state leaf.

    * embedding tables (path matches the optimizer's embedding predicate):
      rows over ``model``; their 1-D row-wise accumulators follow;
    * the ``comms_ef`` residuals shard like the table they compensate,
      whatever the caller's predicate;
    * dense >= 2-D params: dim 0 over the fsdp axes, the last dim over
      ``model`` (each only when divisible);
    * everything else (biases, scalars, seeds): replicated, ``()``.
    """
    if not plan.enabled or len(shape) == 0:
        return ()
    mesh = plan.mesh
    if (path and "comms_ef" in path[0]) or is_embedding(path):
        if table_is_sharded(plan, shape[0]):
            return (plan.model_axis,) + (None,) * (len(shape) - 1)
        return ()
    if len(shape) < 2:
        return ()
    entries: list = [None] * len(shape)
    n_fsdp = _axis_size(mesh, plan.fsdp_axis)
    if n_fsdp > 1 and shape[0] % n_fsdp == 0:
        entries[0] = plan.fsdp_axis
    if plan.model_axis is not None:
        n_model = mesh.shape[plan.model_axis]
        if n_model > 1 and shape[-1] % n_model == 0:
            entries[-1] = plan.model_axis
    return tuple(entries)


def is_spec(x) -> bool:
    """A spec tuple (axis names, tuples of them, None), not a tree node."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def state_shardings(state: Any, plan: Optional[ShardingPlan],
                    is_embedding: Callable = default_is_embedding,
                    param_specs: Any = None) -> Any:
    """Tree of specs congruent with ``state`` (global shapes), or None when
    the plan is disabled. Walk it with ``is_leaf=spmd.is_spec``.

    ``param_specs`` (a spec tree congruent with the params, as
    ``lm_param_specs`` builds it) replaces :func:`param_spec`: a state
    leaf whose path ends in a param's path (the params themselves, Adam's
    ``m`` / ``v``) takes that param's spec fitted to its shape
    (:func:`fit_spec`), every other leaf ``()``."""
    if not _enabled(plan):
        return None
    flat = flatten_with_path(state)
    if param_specs is None:
        return unflatten(state, [param_spec(path, tuple(leaf.shape), plan,
                                            is_embedding)
                                 for path, leaf in flat])
    by_path = {tuple(p): s for p, s in flatten_with_path(
        param_specs, is_leaf=is_spec)}
    out = []
    for path, leaf in flat:
        spec = ()
        for k in range(len(path)):
            if tuple(path[k:]) in by_path:
                spec = by_path[tuple(path[k:])]
                break
        out.append(fit_spec(spec, tuple(leaf.shape), plan))
    return unflatten(state, out)


def rows_sharded(spec: Spec, plan: ShardingPlan) -> bool:
    """Whether a leaf of this spec is held as its row block over ``model``
    (a table, its accumulator, its residual): the lookups read those."""
    return bool(spec) and spec[0] == plan.model_axis


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry's axis names (None -> ())."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def plan_axes(plan: ShardingPlan, names) -> list:
    """``collectives.Axes`` of axis names (or one spec entry)."""
    if isinstance(names, str) or names is None:
        names = entry_axes(names)
    return [(plan.mesh.group(a), plan.mesh.shape[a], plan.mesh.coord(a))
            for a in names]


def split_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a leaf of this spec is split on."""
    return tuple(a for e in spec for a in entry_axes(e))


def fit_spec(spec: Spec, shape: Tuple[int, ...],
             plan: ShardingPlan) -> Spec:
    """``spec`` for a leaf of ``shape`` with each entry whose axes do not
    divide its dim made None (that dim stays whole)."""
    out = []
    for e, n in zip(tuple(spec), shape):
        axes = entry_axes(e)
        k = _axis_size(plan.mesh, axes)
        out.append(e if axes and n % k == 0 else None)
    return tuple(out)


def local_block(x: torch.Tensor, spec: Spec,
                plan: ShardingPlan) -> torch.Tensor:
    """This rank's part of a global leaf: the block at its mesh
    coordinate of every split dim (a copy, so the whole leaf can be
    freed); the leaf itself when nothing splits it."""
    if not any(entry_axes(e) for e in spec):
        return x
    for dim, e in enumerate(spec):
        axes = entry_axes(e)
        if axes:     # the mesh's coordinates only: no group is asked
            x = coll.chunk_dim(x, [(None, plan.mesh.shape[a],
                                    plan.mesh.coord(a)) for a in axes], dim)
    return x.clone()


def global_leaf(x: torch.Tensor, spec: Spec,
                plan: ShardingPlan) -> torch.Tensor:
    """The whole leaf from every rank's block (every rank of the mesh
    calls it); an unsplit leaf as it is."""
    for dim, e in enumerate(spec):
        if entry_axes(e):
            x = coll.gather_dim(x, plan_axes(plan, e), dim)
    return x


def use_leaf(x: torch.Tensor, spec: Spec, plan: ShardingPlan,
             split: Tuple[str, ...] = ()) -> torch.Tensor:
    """Gather-before-use: the whole leaf from this rank's block, as an
    autograd op. Backward, each split dim's gradient is reduce-scattered
    over its axes when the use is split over them (``split``: each rank
    uses the leaf on its own part of the data) and cut to this rank's
    chunk when the use is replicated over them."""
    for dim, e in enumerate(spec):
        axes = entry_axes(e)
        if not axes:
            continue
        inside = [a in split for a in axes]
        if any(inside) and not all(inside):
            raise ValueError(f"spec entry {e} is partly in the split axes "
                             f"{split}")
        x = coll.all_gather_dim(x, plan_axes(plan, axes), dim,
                                "reduce_scatter" if all(inside) else "slice")
    return x


def gather_dense(params: Any, specs: Any, plan: Optional[ShardingPlan]
                 ) -> Any:
    """Every split leaf but the row-sharded tables gathered for use
    (:func:`use_leaf`) over a use split by the batch axes: the params a
    model that reads its dense leaves whole takes under FSDP / TP."""
    if not _enabled(plan):
        return params
    return unflatten(params, [
        x if rows_sharded(s, plan) else use_leaf(x, s, plan,
                                                 tuple(plan.batch_axes))
        for x, s in zip(leaves(params), leaves(specs, is_leaf=is_spec))])


def place_state(state: Any, plan: Optional[ShardingPlan],
                is_embedding: Callable = default_is_embedding,
                specs: Any = None) -> Any:
    """Each leaf of a global ``state`` cut to this rank's part (identity
    when disabled). ``specs`` defaults to ``state_shardings(state)``."""
    if not _enabled(plan):
        return state
    if specs is None:
        specs = state_shardings(state, plan, is_embedding)
    return unflatten(state, [local_block(x, s, plan) for x, s in zip(
        leaves(state), leaves(specs, is_leaf=is_spec))])


def gather_state(state: Any, specs: Any, plan: Optional[ShardingPlan]) -> Any:
    """The global state from every rank's part (every rank of the mesh
    calls it; identity when disabled)."""
    if not _enabled(plan):
        return state
    return unflatten(state, [global_leaf(x, s, plan) for x, s in zip(
        leaves(state), leaves(specs, is_leaf=is_spec))])


def reduce_grads(grads: Any, specs: Any, plan: ShardingPlan,
                 grad_axes: Any = None, async_op: bool = False):
    """The gradient rule (module note): each leaf summed over its use's
    axes (``grad_axes``: a tree of axis tuples congruent with the params,
    or None for the batch axes everywhere) less the axes it is split on,
    one flat all-reduce per set of axes. With ``async_op`` returns a
    ``finish()`` (the reduction issued at once when every leaf takes the
    same single axis)."""
    flat = leaves(grads)
    spec_l = leaves(specs, is_leaf=is_spec)
    use = ([tuple(plan.batch_axes)] * len(flat) if grad_axes is None
           else leaves(grad_axes, is_leaf=_is_axes))
    order = [a for a in plan.mesh.axis_names]
    todo: dict = {}
    for i, (s, u) in enumerate(zip(spec_l, use)):
        axes = tuple(a for a in order if a in u and a not in split_axes(s))
        if axes:
            todo.setdefault(axes, []).append(i)
    out = list(flat)
    finishers = []
    for axes, idx in todo.items():
        groups = [plan.mesh.group(a) for a in axes]
        done = coll.all_reduce_flat([flat[i] for i in idx], groups,
                                    async_op=async_op)
        finishers.append((idx, done))

    def finish():
        for idx, done in finishers:
            for i, t in zip(idx, done() if async_op else done):
                out[i] = t
        return unflatten(grads, out)
    return finish if async_op else finish()


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def grad_sq_norm(g_leaves: list, specs: Any, plan: ShardingPlan,
                 sq_sum: Callable) -> torch.Tensor:
    """The squared norm of the whole gradient from each rank's blocks:
    each leaf's squares summed over the axes it is split on, once."""
    by_axes: dict = {}
    for g, s in zip(g_leaves, leaves(specs, is_leaf=is_spec)):
        axes = split_axes(s)
        by_axes[axes] = by_axes.get(axes, 0.0) + sq_sum(g)
    total = 0.0
    for axes, v in by_axes.items():
        v = torch.as_tensor(v, dtype=torch.float32,
                            device=g_leaves[0].device)
        if axes:
            v = coll.all_reduce_sum(v, [plan.mesh.group(a) for a in axes])
        total = total + v
    return total


# ---------------------------------------------------------------------------
# Batch placement
# ---------------------------------------------------------------------------

def batch_spec(shape: Tuple[int, ...], plan: ShardingPlan,
               batch_dim: int = 0) -> Spec:
    """Split a batch leaf's ``batch_dim`` over the batch axes when
    divisible; leaves with other batch dims stay whole. With grad
    accumulation the leading dim is the microbatch axis: pass
    ``batch_dim=1``."""
    if not plan.enabled or len(shape) <= batch_dim:
        return ()
    n = _axis_size(plan.mesh, plan.batch_axes)
    if n > 1 and shape[batch_dim] > 0 and shape[batch_dim] % n == 0:
        entries = [None] * len(shape)
        entries[batch_dim] = plan.batch_axes
        return tuple(entries)
    return ()


def _is_jagged(x) -> bool:
    return isinstance(x, JaggedTensor)


def batch_shardings(batch: Any, plan: Optional[ShardingPlan],
                    batch_dim: int = 0) -> Any:
    """The tree of ``batch``'s specs under ``plan`` (None when there is no
    plan or it is disabled): each leaf's :func:`batch_spec`; a jagged
    leaf's values and lengths stay whole (``()``), since jagged buffers are
    packed row-major with no per-row alignment to the data split."""
    if not _enabled(plan):
        return None

    def leaf(x):
        if _is_jagged(x):
            return JaggedTensor(values=(), lengths=())
        return batch_spec(tuple(x.shape), plan, batch_dim)

    return tree_map(leaf, batch, is_leaf=_is_jagged)


def place_batch(batch: Any, plan: Optional[ShardingPlan],
                batch_dim: int = 0) -> Any:
    """This rank's block of a global batch (module note); the leaves stay
    on their device. Identity when disabled."""
    from repro_torch.core.roo_batch import ROOBatch
    if not _enabled(plan):
        return batch
    n, k = data_shard_count(plan), data_index(plan)

    def cut(x):
        if _is_jagged(x) or not batch_spec(tuple(x.shape), plan, batch_dim):
            return x
        m = x.shape[batch_dim] // n
        return x.narrow(batch_dim, k * m, m).contiguous()

    out = tree_map(cut, batch, is_leaf=_is_jagged)
    if isinstance(batch, ROOBatch) and n > 1:
        b = batch.ro_dense.shape[batch_dim]
        m = b // n
        seg = out.segment_ids
        out = dataclasses.replace(out, segment_ids=torch.where(
            seg >= b, torch.full_like(seg, m), seg - k * m))
    return out


def make_batch_placer(plan: Optional[ShardingPlan],
                      batch_dim: int = 0) -> Callable[[Any], Any]:
    """batch -> this rank's block (the identity when disabled)."""
    if not _enabled(plan):
        return lambda batch: batch
    return lambda batch: place_batch(batch, plan, batch_dim)


def make_batch_sharding_fn(plan: Optional[ShardingPlan],
                           batch_dim: int = 0
                           ) -> Optional[Callable[[Any], Any]]:
    """The ``PrefetchLoader(sharding=...)`` callable: the loader's thread
    cuts each host batch to this rank's block before the copy (None when
    the plan is disabled)."""
    if not _enabled(plan):
        return None
    return lambda batch: place_batch(batch, plan, batch_dim)


# ---------------------------------------------------------------------------
# Sums over an axis (autograd: identity backward)
# ---------------------------------------------------------------------------

def data_sum(x: torch.Tensor, plan: Optional[ShardingPlan]) -> torch.Tensor:
    """``x`` summed over the batch axes: what GSPMD makes of the
    reference's ``jnp.sum`` over a batch-sharded array."""
    if not _enabled(plan):
        return x
    return coll.all_reduce_sum(x, batch_groups(plan))


def model_sum(x: torch.Tensor, plan: Optional[ShardingPlan]) -> torch.Tensor:
    if not _enabled(plan):
        return x
    return coll.all_reduce_sum(x, [model_group(plan)])


def gather_batch(x: torch.Tensor,
                 plan: Optional[ShardingPlan]) -> torch.Tensor:
    """The whole batch's ``x`` from every data block, in block order (an
    all-gather over the batch axes; no gradient). Identity when the plan
    does not split the batch."""
    if data_shard_count(plan) == 1:
        return x
    for a in reversed(plan.batch_axes):     # data, then pod: block order
        x = coll.gather_rows_front(x, plan.mesh.group(a), plan.mesh.shape[a])
    return x
