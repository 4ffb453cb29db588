"""In-repo optimizers: Adam, row-wise Adagrad, SGD, and the mixed router
(torch port of ``repro/train/optim.py``).

Row-wise Adagrad is the production embedding optimizer (one accumulator
scalar per table ROW instead of per element — 1/D the state, the TorchRec
default for huge tables); Adam handles the dense parameters.
``make_mixed`` routes by parameter path, which is how DLRM deployments
configure it.

They are functional, as the reference's are: ``update(grads, state,
params) -> (new_params, new_state)`` returns new tensors and changes
nothing in place (the Trainer's non-finite guard keeps the old ones), and
states keep the reference's layout, leaf for leaf, so a state crosses
between the packages through ``interop``. They run on plain tensors, with
no ``torch.optim``.

Row-wise Adagrad also takes **sparse row gradients**: a grads leaf may be
an ``embeddings.sparse.SparseRows`` (from ``make_sparse_value_and_grad``).
Its duplicates are merged first (contributions add, then the row square
and the accumulator run, as a dense scatter would), then only the touched
rows of the accumulator and the table are read, stepped with the dense
apply's exact arithmetic (bit for bit the same rows), and written back;
padding ids drop. ``make_mixed`` keeps a ``SparseRows`` whole and routes it
with its table.

**In-place contract.** Called as ``update(grads, state, params, ok=ok)``,
with ``ok`` the step's 0-d bool "loss and gradient are finite" (the
Trainer's step does so whenever the grads hold a ``SparseRows``), the
sparse apply writes the touched rows back into the table and its
accumulator **in place** (``index_copy_``), each row the new one where
``ok`` is true and the old one where it is false, and returns those same
tensors. So no pass over a whole ``(V, D)`` table or its accumulator is
left on the sparse path, and the caller's old params tree sees the update:
the step consumes it. The results are bit for bit those of the functional
form (``ok`` not given: a copy with the rows written, then the guard's
``torch.where``). Dense gradients, and every other optimizer, keep the
functional update. Checkpoints copy a state to the host before their
writer thread starts, so a later in-place step does not reach a
checkpoint.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.embeddings.sparse import SparseRows, is_sparse
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten


class Optimizer(NamedTuple):
    init: Callable
    update: Callable        # (grads, state, params) -> (new_params, new_state)


def _map3(fn, params, grads, *states):
    """``fn(p, g, *s) -> tuple`` over the leaves (a ``SparseRows`` grad is
    one leaf); returns one tree per output position."""
    outs = [fn(*xs) for xs in zip(leaves(params),
                                  leaves(grads, is_leaf=is_sparse),
                                  *(leaves(s) for s in states))]
    n = len(outs[0]) if outs else 1 + len(states)
    return [unflatten(params, [o[i] for o in outs]) for i in range(n)]


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        first = next(iter(leaves(params)), None)
        device = first.device if first is not None else "cpu"
        return {"m": zeros,
                "v": tree_map(torch.zeros_like, zeros),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        if grad_clip > 0:
            gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                for g in leaves(grads)) + 1e-12)
            scale = torch.clamp(grad_clip / gn, max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        t = state["t"] + 1
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(b1, tf)
        bc2 = 1 - torch.pow(b2, tf)

        def upd(p, g, m, v):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32 * g32
            step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + lr * weight_decay * p.float()
            return (p.float() - step).to(p.dtype), m, v

        new_p, new_m, new_v = _map3(upd, params, grads, state["m"],
                                    state["v"])
        return new_p, {"m": new_m, "v": new_v, "t": t}

    return Optimizer(init, update)


def _row_sq(g32: torch.Tensor) -> torch.Tensor:
    sq = g32 * g32
    return sq.mean(dim=tuple(range(1, sq.dim()))) if sq.dim() > 1 else sq


def _rowwise_sparse_apply(p: torch.Tensor, g: SparseRows, a: torch.Tensor,
                          lr: float, eps: float, ok=None):
    """Row-wise Adagrad on the touched rows of ``p`` and ``a`` alone (the
    module note's contract: in place when ``ok`` is given). The merged ids
    are sorted with the padding last, so a padding entry rewrites what the
    first entry writes (or, with no row touched, row 0's old value): the
    duplicates write one value, and every index stays in range without a
    host sync."""
    m = g.merged()
    ids = m.ids.long()
    touched = ids < g.vocab
    first = touched[:1]                 # (1,): is any row touched
    idx = torch.where(touched, ids, torch.where(first, ids[:1], 0))
    p_old, a_old = p[idx], a[idx]
    g32 = m.rows.float()
    a_rows = a_old + torch.where(touched, _row_sq(g32), 0.0)
    scale = lr / (torch.sqrt(a_rows) + eps)
    step = g32 * scale.reshape((-1,) + (1,) * (g32.dim() - 1))
    p_rows = (p_old.float() - step).to(p.dtype)
    col = (-1,) + (1,) * (p.dim() - 1)
    p_rows = torch.where(touched.reshape(col), p_rows, torch.where(
        first.reshape(col), p_rows[:1], p_old))
    a_rows = torch.where(touched, a_rows, torch.where(first, a_rows[:1],
                                                      a_old))
    if ok is None:
        return (p.clone().index_copy_(0, idx, p_rows),
                a.clone().index_copy_(0, idx, a_rows))
    p.index_copy_(0, idx, torch.where(ok, p_rows, p_old))
    a.index_copy_(0, idx, torch.where(ok, a_rows, a_old))
    return p, a


def rowwise_adagrad(lr: float = 0.01, eps: float = 1e-8) -> Optimizer:
    """One accumulator per embedding row: state[p] has shape p.shape[:1].
    Dense grads update every row; :class:`SparseRows` grads only the
    touched rows (the same per-row arithmetic), in place when ``update``
    gets ``ok`` (module note)."""
    def init(params):
        return {"acc": tree_map(
            lambda p: torch.zeros(p.shape[:1], dtype=torch.float32,
                                  device=p.device), params)}

    def update(grads, state, params, ok=None):
        def upd(p, g, a):
            if is_sparse(g):
                return _rowwise_sparse_apply(p, g, a, lr, eps, ok)
            g32 = g.float()
            a = a + _row_sq(g32)
            scale = lr / (torch.sqrt(a) + eps)
            step = g32 * scale.reshape((-1,) + (1,) * (g32.dim() - 1))
            return (p.float() - step).to(p.dtype), a

        new_p, new_a = _map3(upd, params, grads, state["acc"])
        return new_p, {"acc": new_a}

    return Optimizer(init, update)


def sgd(lr: float = 0.1, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mom": tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)}
        return {}

    def update(grads, state, params):
        if momentum:
            new_mom = tree_map(lambda m, g: momentum * m + g.float(),
                               state["mom"], grads)
            new_p = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype),
                             params, new_mom)
            return new_p, {"mom": new_mom}
        new_p = tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                         params, grads)
        return new_p, {}

    return Optimizer(init, update)


def make_mixed(dense_opt: Optimizer, embedding_opt: Optimizer,
               is_embedding: Callable[[Tuple[str, ...]], bool]) -> Optimizer:
    """Route params by tree path: embedding tables -> embedding_opt,
    everything else -> dense_opt (the standard DLRM setup). Paths and leaf
    order are the reference's (``repro_torch.tree``), so the ``emb`` and
    ``dense`` state lists line up with its own. ``update``'s ``ok`` goes to
    embedding_opt (the sparse apply's in-place contract)."""

    def _mask(params):
        return [is_embedding(path) for path, _ in flatten_with_path(params)]

    def init(params):
        emb_mask = _mask(params)
        flat = leaves(params)
        return {
            "emb": embedding_opt.init(
                [p for p, m in zip(flat, emb_mask) if m]),
            "dense": dense_opt.init(
                [p for p, m in zip(flat, emb_mask) if not m]),
        }

    def update(grads, state, params, ok=None):
        emb_mask = _mask(params)
        # a SparseRows grad stays whole and pairs up with its table
        g_leaves = leaves(grads, is_leaf=is_sparse)
        p_leaves = leaves(params)
        ge = [g for g, m in zip(g_leaves, emb_mask) if m]
        pe = [p for p, m in zip(p_leaves, emb_mask) if m]
        gd = [g for g, m in zip(g_leaves, emb_mask) if not m]
        pd = [p for p, m in zip(p_leaves, emb_mask) if not m]
        new_pe, new_se = embedding_opt.update(
            ge, state["emb"], pe, **({} if ok is None else {"ok": ok}))
        new_pd, new_sd = dense_opt.update(gd, state["dense"], pd)
        it_e, it_d = iter(new_pe), iter(new_pd)
        merged = [next(it_e) if m else next(it_d) for m in emb_mask]
        return unflatten(params, merged), {"emb": new_se, "dense": new_sd}

    return Optimizer(init, update)


def default_is_embedding(path: Tuple[str, ...]) -> bool:
    s = "/".join(path).lower()
    return any(k in s for k in ("emb", "table"))
