"""Carry parameter trees and user states between numpy and the port.

The JAX package keeps params as a nested dict/list of arrays; the port keeps
the same tree of tensors, path for path. A caller that holds the
reference's params converts the leaves to numpy first (e.g.
``tree_map(np.asarray, params)``), so the port never sees a JAX array.
Incremental-serving user states (``GRUserState``: k, v, length) cross the
same way, field by field, and so do training states ``{params, opt, step}``
(the optimizers keep the reference's state layout). A state's ``rng`` does
not cross: the two packages' generators differ. Under an SPMD plan
:func:`params_onto_plan` cuts a whole tree to this rank's blocks by spec
(tables to their row block, dense leaves to their FSDP / TP block, or by a
model's own spec tree such as ``lm_param_specs``) and
:func:`params_off_plan` gathers them back. The
LM's and MACE's trees and the LM's decode cache (``{k, v, pos}``) cross
like any other tree. bfloat16 leaves cross by their bits: the port hands
them out as ``repro_torch.host.BF16_BITS`` arrays (numpy has no bfloat16)
and takes those or the reference's ``ml_dtypes`` arrays; a round trip is
bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.distributed import spmd
from repro_torch.host import device_copy, host_copy
from repro_torch.models.gr import GRUserState
from repro_torch.tree import leaves, tree_map


def tensor_from_numpy(a: Any, device="cuda") -> torch.Tensor:
    """One numpy array (or scalar) -> a tensor on ``device``, copied. A
    bfloat16 array (the reference's ``ml_dtypes`` dtype, e.g. a bf16
    parameter or the LM's KV cache, or the port's ``BF16_BITS``) crosses
    by its bits."""
    return device_copy(np.array(a, copy=True), device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dict/list/tuple of numpy arrays -> the same tree of tensors on
    ``device`` (tuples become lists, as the port's params use lists)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def params_to_numpy(tree: Any) -> Any:
    """The port's tree of tensors -> the same tree of numpy arrays (bf16
    leaves as their bits, ``BF16_BITS``; a CPU leaf's array is a view)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return host_copy(tree)


def gr_state_from_numpy(state: Any, device="cuda") -> GRUserState:
    """Any (k, v, length) record of numpy arrays — e.g. the reference's
    ``GRUserState`` after ``tree_map(np.asarray, ...)`` — -> the port's
    :class:`GRUserState` of tensors on ``device``."""
    k, v, length = state
    return GRUserState(*(tensor_from_numpy(a, device)
                         for a in (k, v, length)))


def gr_state_to_numpy(state: GRUserState) -> GRUserState:
    """The port's state -> the same record of numpy arrays (the reference's
    ``GRUserState(*gr_state_to_numpy(s))`` takes it as is; a bf16 state's
    k and v as their bits, ``BF16_BITS``)."""
    return GRUserState(*(host_copy(a) for a in state))


TRAIN_STATE_KEYS = ("params", "opt", "step")


def train_state_from_numpy(state: Any, device="cuda") -> dict:
    """The ``{params, opt, step}`` of a training state whose leaves are
    numpy arrays (e.g. the reference Trainer's state after
    ``tree_map(np.asarray, ...)``) -> the port's state on ``device``. Any
    ``rng`` entry is dropped; the port's Trainer adopts its own seed."""
    return {k: params_from_numpy(state[k], device) for k in TRAIN_STATE_KEYS}


def train_state_to_numpy(state: dict) -> dict:
    """The port's ``{params, opt, step}`` -> the same tree of numpy
    arrays."""
    return {k: params_to_numpy(state[k]) for k in TRAIN_STATE_KEYS}


def params_onto_plan(tree: Any, plan, device="cuda", param_specs=None):
    """A whole tree of numpy arrays (e.g. the reference's params) or of
    tensors -> (this rank's tree of tensors on ``device``, the tree's
    specs under ``plan``; None without a plan). ``param_specs`` is a
    model's own spec tree (``spmd.state_shardings``). A tensor tree
    already on ``device`` is not copied before it is cut."""
    specs = spmd.state_shardings(tree, plan, param_specs=param_specs)
    if not isinstance(leaves(tree)[0], torch.Tensor):
        tree = params_from_numpy(tree, device)
    return (spmd.place_state(tree_map(lambda t: t.to(device), tree), plan,
                             specs=specs), specs)


def params_off_plan(params: Any, specs: Any, plan) -> Any:
    """Every rank's blocks -> the whole tree of numpy arrays (a collective:
    every rank of the mesh calls it)."""
    return params_to_numpy(spmd.gather_state(params, specs, plan))
