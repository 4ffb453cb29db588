"""Device meshes (torch port of ``repro/launch/mesh.py``).

Single pod: ``("data", "model")``; multi-pod: ``("pod", "data", "model")``.
A mesh is made over the ranks of the ``torch.distributed`` world
(``torch.distributed.device_mesh``), one rank a device: NCCL ranks each
on their own card, gloo ranks on the CPU (or, as a test of the path,
several gloo ranks holding CUDA tensors of one card). Functions, not
module constants: importing this module touches no process group.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.hostdevices import (ensure_world,
                                            prospective_world_size)


def parse_mesh_spec(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``'DATAxMODEL'`` ('2x4') or ``'PODxDATAxMODEL'`` ('2x2x2') -> (dims,
    axis names)."""
    dims = tuple(int(x) for x in spec.lower().replace("×", "x").split("x"))
    if len(dims) == 2:
        return dims, ("data", "model")
    if len(dims) == 3:
        return dims, ("pod", "data", "model")
    raise ValueError(f"--mesh wants DATAxMODEL or PODxDATAxMODEL, got "
                     f"{spec!r}")


def _mesh_device_type() -> str:
    # the mesh's device type follows the world's backend: NCCL groups are
    # CUDA meshes; gloo groups are CPU meshes, whichever device the
    # tensors they carry live on
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(dims: Tuple[int, ...], axis_names: Tuple[str, ...]) -> Mesh:
    """A mesh of ``dims`` over ranks ``0 .. prod(dims) - 1`` of the world
    (every rank of the world calls it; ranks past the mesh hold a mesh
    they are not in, see :func:`in_mesh`)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    need = 1
    for d in dims:
        need *= d
    device_type = _mesh_device_type()
    if need == dist.get_world_size():
        dm = init_device_mesh(device_type, tuple(dims),
                              mesh_dim_names=tuple(axis_names))
    else:
        dm = DeviceMesh(device_type, torch.arange(need).reshape(dims),
                        mesh_dim_names=tuple(axis_names))
    return Mesh(tuple(axis_names), tuple(dims), dm)


def in_mesh(mesh: Mesh) -> bool:
    return mesh.device_mesh.get_coordinate() is not None


def make_test_mesh(n_data: int = 2, n_model: int = 2,
                   multi_pod: bool = False) -> Mesh:
    """A small mesh over the first ranks of a spawned world
    (``launch/hostdevices.spawn``)."""
    if multi_pod:
        return make_mesh((2, n_data, n_model), ("pod", "data", "model"))
    return make_mesh((n_data, n_model), ("data", "model"))


def make_mesh_from_spec(spec: str, backend: Optional[str] = None) -> Mesh:
    """``--mesh`` / ``train.mesh``: the mesh over the world's first ranks.

    With no world yet, joins torchrun's or makes a world of one
    (``backend`` names it: NCCL on the card, gloo on the CPU). Refuses a
    mesh larger than the world, and an NCCL mesh larger than the cards
    this process sees (NCCL takes one rank a card)."""
    dims, axes = parse_mesh_spec(spec)
    need = 1
    for d in dims:
        need *= d
    nccl = (dist.get_backend() if dist.is_initialized()
            else backend) == "nccl"
    if nccl and torch.cuda.device_count() < need:
        raise RuntimeError(
            f"mesh {spec} needs {need} devices but only "
            f"{torch.cuda.device_count()} visible — NCCL takes one rank a "
            f"card")
    have = prospective_world_size()
    if have < need:
        raise RuntimeError(
            f"mesh {spec} needs {need} ranks but the world has {have} — on "
            f"the CPU let the launcher spawn them (python -m "
            f"repro_torch.launch.train --mesh {spec} --device cpu), or "
            f"start {need} ranks with torchrun")
    ensure_world(backend or "gloo")
    return make_mesh(dims, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes: 16 x 16, or 2 x 16 x 16."""
    return make_mesh_from_spec("2x16x16" if multi_pod else "16x16")
