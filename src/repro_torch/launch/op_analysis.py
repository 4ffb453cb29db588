"""Op-level step analyzer: the dry run's "profiler" (the port's counterpart
of ``repro/launch/hlo_analysis.py``, which it replaces: the port has no
compiled HLO to parse, so it runs the step itself on meta tensors and
counts what each aten op would do).

:func:`analyze` runs ``step(*args)`` once under
``torch.utils.flop_counter.FlopCounterMode`` and one ``TorchDispatchMode``
and reports, for this rank:

  * ``flops`` — FlopCounterMode's count: ``2·m·n·k`` per product (the
    basis of ``hlo_analysis``' dot FLOPs), forward, backward and a
    checkpointed layer's recompute each as they run; elementwise ops are
    not counted, as ``hlo_analysis`` counts dots only. On meta tensors
    ``kernels/dispatch.py`` resolves every kernel wrapper to its plain
    version (meta is not ``cuda``), so the count is of the plain
    versions' products, as the reference's dry run counts its jnp path
    (``hlo_analysis`` never counts inside a Pallas custom call);
  * ``memory_bytes`` — unfused: every aten op's tensor inputs plus its
    outputs (views, empty allocations and collectives move nothing), with
    sparse access counted as ``hlo_analysis`` counts it: a gather reads
    and writes its result's rows (2 x result) plus its indices, a
    scatter read-modify-writes its updates' rows (2 x updates) plus its
    indices. Eager torch fuses nothing, so this is what the port moves
    on the card, and it reads higher than the reference's fused estimate;
  * ``argument_bytes`` — the storages of ``args`` (the rank's state and
    inputs), each once; ``output_bytes`` — the result's new storages;
    ``devices`` — the device types of every op's outputs (``["meta"]``
    when nothing was allocated);
  * ``peak_bytes`` — the most bytes live at once: the arguments, plus
    every storage an op makes from its creation until it dies (views share
    their base's storage; tensors saved for backward stay live until the
    backward frees them);
  * ``collectives`` — ``{kind: {count, bytes}}`` under the reference's
    names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``), each call's output bytes (``dryrun.parse_collectives``'
    rule); ``collective_bytes`` their sum; ``collective_bytes_by_axis``
    the same bytes by the mesh axis whose group the call ran on. A call
    over a group of one moves nothing and is not counted.

The collectives are ``distributed/collectives.py``'s ``torch.distributed``
calls; the dispatch mode sees them as ``c10d`` ops with their process
group as an argument, so they need no hook of their own.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.tree import leaves

aten = torch.ops.aten

_GATHERS = {aten.index_select.default, aten.embedding.default,
            aten.gather.default, aten.index.Tensor}
_SCATTERS = {aten.index_put_.default, aten.index_put.default,
             aten.index_add_.default, aten.index_add.default,
             aten.scatter_add_.default, aten.scatter_add.default,
             aten.index_copy_.default, aten.index_copy.default,
             aten.scatter_.src, aten.scatter.src}
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten.detach.default,
             aten.lift_fresh.default}
_COLLECTIVES = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
                "allgather_": "all-gather",
                "allgather_into_tensor_coalesced_": "all-gather",
                "_reduce_scatter_base_": "reduce-scatter",
                "reduce_scatter_": "reduce-scatter",
                "alltoall_base_": "all-to-all", "alltoall_": "all-to-all"}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a read of ``t`` touches: its elements, or its storage's
    when it is an expanded view over fewer."""
    es = t.element_size()
    return min(t.numel(), t.untyped_storage().nbytes() // es) * es


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _axis_names(mesh) -> Dict[str, str]:
    """process group name -> mesh axis, for this rank's groups."""
    if mesh is None or getattr(mesh, "device_mesh", None) is None:
        return {}
    return {mesh.group(a).group_name: a for a in mesh.axis_names}


def _group(args):
    """The process group among a ``c10d`` op's arguments (None if none)."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:      # a ReduceOp, not a group
                continue
    return None


class _Counter(TorchDispatchMode):
    def __init__(self, mesh=None):
        super().__init__()
        self.axes = _axis_names(mesh)
        self.memory_bytes = 0
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.by_axis: Dict[str, float] = {}
        self.devices = set()

    # -- live storages -------------------------------------------------------
    def _release(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage live until it dies; its new bytes."""
        key = _key(t)
        if key in self.live:
            return 0
        st = t.untyped_storage()
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        self.peak = max(self.peak, self.live_bytes)
        weakref.finalize(st, self._release, key)
        return n

    # -- the ops -------------------------------------------------------------
    def _collective(self, func, args) -> None:
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVES.get(name)
        if kind is None:
            raise NotImplementedError(f"op_analysis: collective {name}")
        group = _group(args)
        if group is not None and group.size() == 1:
            return                    # moves nothing between devices
        n = sum(t.numel() * t.element_size() for t in _tensors(args[0]))
        d = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
        d["count"] += 1
        d["bytes"] += n
        axis = "?" if group is None else self.axes.get(group.group_name,
                                                        "other")
        self.by_axis[axis] = self.by_axis.get(axis, 0.0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            self._collective(func, args)
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self.hold(t)
            self.devices.add(t.device.type)
        if func.is_view or func in _NO_BYTES:
            return out
        if func in _GATHERS:
            idx = [t for t in _tensors((args[1:], kwargs))
                   if not t.is_floating_point()]
            self.memory_bytes += (2 * sum(tensor_bytes(t) for t in outs)
                                  + sum(tensor_bytes(t) for t in idx))
        elif func in _SCATTERS:
            rest = _tensors((args[1:], kwargs))
            self.memory_bytes += sum(
                tensor_bytes(t) * (1 if not t.is_floating_point() else 2)
                for t in rest)
        else:
            self.memory_bytes += sum(tensor_bytes(t) for t in
                                     _tensors((args, kwargs)) + outs)
        return out


def analyze(step: Callable, *args: Any, mesh=None) -> Dict[str, Any]:
    """Run ``step(*args)`` once (meta tensors: nothing is computed) and
    count it (module note). ``mesh`` names the collectives' axes."""
    counter = _Counter(mesh)
    arg_tensors = _tensors([leaves(a) for a in args])
    argument_bytes = sum(counter.hold(t) for t in arg_tensors)
    flops = FlopCounterMode(display=False)
    with flops, counter:
        out = step(*args)
    new_out = {_key(t): t.untyped_storage().nbytes()
               for t in _tensors(leaves(out)) if _key(t) in counter.live}
    arg_keys = {_key(t) for t in arg_tensors}
    output_bytes = sum(n for k, n in new_out.items() if k not in arg_keys)
    coll = {k: {"count": int(v["count"]), "bytes": float(v["bytes"])}
            for k, v in counter.collectives.items()}
    return {
        "flops": float(flops.get_total_flops()),
        "memory_bytes": float(counter.memory_bytes),
        "argument_bytes": int(argument_bytes),
        "output_bytes": int(output_bytes),
        "peak_bytes": int(counter.peak),
        "collectives": coll,
        "collective_bytes": float(sum(v["bytes"] for v in coll.values())),
        "collective_bytes_by_axis": dict(counter.by_axis),
        "devices": sorted(counter.devices),
        "outputs": out,
    }
