"""Nested containers of tensors ("trees"): the port's stand-in for
``jax.tree_util`` over params, optimizer states and batches.

A tree is a dict, list, tuple or dataclass instance of subtrees; ``None``
is an empty subtree, and anything else is a leaf. Leaves are visited in the
order ``jax.tree_util.tree_flatten`` uses: dict keys sorted, sequences and
dataclass fields in order. So a leaf list of the port lines up, index for
index, with the reference's for the same tree — which is what keeps
``make_mixed``'s per-leaf optimizer states and the checkpoints' leaf
numbering in the reference's layout.

Every walk takes ``is_leaf``, as JAX's does: a node for which it returns
true is a leaf however it is built. The sparse-row path passes
``embeddings.sparse.is_sparse`` so that a ``SparseRows`` gradient stays one
leaf beside its table instead of splitting into its ids and rows (the
reference's ``is_leaf=is_sparse``). Without it the walks are unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]


def _children(tree: Any, is_leaf: IsLeaf = None):
    """(key string, child) pairs of a node in flatten order, or None for a
    leaf. Key strings are formatted as ``str`` of JAX's path keys
    (``['name']`` for a dict key or field, ``[i]`` for an index)."""
    if is_leaf is not None and is_leaf(tree):
        return None
    if isinstance(tree, dict):
        return [(f"['{k}']", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f"['{f.name}']", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


# The walks below are module-level functions that take their accumulator
# as an argument: a nested recursive function refers to itself through its
# closure, and that cycle would keep every leaf it saw (whole parameter
# trees) alive until the cyclic garbage collector happens to run.

def _walk(node: Any, path: Tuple[str, ...],
          out: List[Tuple[Tuple[str, ...], Any]], is_leaf: IsLeaf) -> None:
    if node is None:
        return
    kids = _children(node, is_leaf)
    if kids is None:
        out.append((path, node))
        return
    for key, child in kids:
        _walk(child, path + (key,), out, is_leaf)


def flatten_with_path(tree: Any, is_leaf: IsLeaf = None
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in flatten order; a path is a tuple of key strings."""
    out: List[Tuple[Tuple[str, ...], Any]] = []
    _walk(tree, (), out, is_leaf)
    return out


def leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def _build(node: Any, it: Iterator, is_leaf: IsLeaf) -> Any:
    if node is None:
        return None
    if is_leaf is not None and is_leaf(node):
        return next(it)
    if isinstance(node, dict):
        rebuilt = {k: _build(node[k], it, is_leaf) for k in sorted(node)}
        return {k: rebuilt[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it, is_leaf) for c in node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: _build(getattr(node, f.name), it, is_leaf)
            for f in dataclasses.fields(node)})
    return next(it)


def unflatten(like: Any, new_leaves, is_leaf: IsLeaf = None) -> Any:
    """A tree shaped like ``like`` whose leaves are ``new_leaves`` in
    flatten order."""
    return _build(like, iter(new_leaves), is_leaf)


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: IsLeaf = None) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), position by position."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree, is_leaf), *(leaves(r, is_leaf) for r in rest))],
        is_leaf)
