"""Sharding plans: how each model family maps onto a device mesh (torch
port of ``repro/distributed/sharding.py``).

Meshes (``launch/mesh.py``): ``("data", "model")`` or ``("pod", "data",
"model")``. A :class:`ShardingPlan` carries the axis names so model code
is mesh-shape-agnostic: the batch splits over (pod+data), tables over
``model``.

The reference runs one program over all devices (GSPMD + ``shard_map``);
the port runs one process per rank and says every collective itself
(``distributed/collectives.py``). So a spec here is a plain tuple whose
entries are an axis name, a tuple of axis names or None, and it compares
equal to the reference's ``PartitionSpec`` after
:func:`normalize_spec`. ``constrain`` is the identity: nothing lays a
tensor out behind the caller's back. ``shard_map`` has no counterpart.

Conventions (the reference's):
  * embedding tables and their row-wise optimizer accumulators are
    row-sharded over ``model``; each rank holds its row block;
  * dense >= 2-D params get ``(fsdp, ..., model)`` specs and each rank
    holds its block (FSDP rows over the fsdp axes, TP columns over
    ``model``, where the mesh divides them); a model gathers them before
    use (``spmd.use_leaf``), and the gather's backward reduce-scatters
    the gradient (the LM's specs are its own, ``lm_param_specs``);
  * activations: the batch over (pod, data).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named mesh of ranks: the port's ``jax.sharding.Mesh``.

    ``device_mesh`` is the ``torch.distributed.device_mesh.DeviceMesh``
    that owns the process groups; None makes an abstract mesh, which only
    answers shape questions (specs, counts), as ``AbstractMesh`` does.
    """
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]
    device_mesh: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


def abstract_mesh(dims: Tuple[int, ...],
                  axis_names: Optional[Tuple[str, ...]] = None) -> Mesh:
    """A mesh with a shape and no ranks (for specs and counts)."""
    if axis_names is None:
        axis_names = (("data", "model") if len(dims) == 2
                      else ("pod", "data", "model"))
    return Mesh(tuple(axis_names), tuple(int(d) for d in dims))


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Optional[Mesh]
    batch_axes: Tuple[str, ...] = ("data",)     # ("pod", "data") multi-pod
    model_axis: Optional[str] = "model"
    fsdp_axis: Any = "data"                     # str or tuple: FSDP axes

    @property
    def enabled(self) -> bool:
        return self.mesh is not None

    def constrain(self, x, *entries):
        """The identity: each rank holds its block explicitly."""
        return x


def replicated_plan() -> ShardingPlan:
    """No mesh: every plan-aware path runs as on one device."""
    return ShardingPlan(mesh=None)


def plan_for_mesh(mesh: Mesh) -> ShardingPlan:
    if "pod" in mesh.axis_names:
        return ShardingPlan(mesh=mesh, batch_axes=("pod", "data"),
                            model_axis="model", fsdp_axis=("pod", "data"))
    return ShardingPlan(mesh=mesh, batch_axes=("data",), model_axis="model",
                        fsdp_axis="data")


def normalize_spec(spec) -> Spec:
    """A spec (the port's tuple or the reference's ``PartitionSpec``) in
    one canonical form: a one-axis tuple entry becomes the axis name and
    trailing None entries are dropped, so ``("data",)`` and ``"data"``,
    ``P("model", None)`` and ``("model",)`` compare equal."""
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else (e if e else None)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)
