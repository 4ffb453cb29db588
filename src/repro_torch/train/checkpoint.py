"""Fault-tolerant checkpointing: atomic, async, keep-k, digest-checked
(torch port of ``repro/train/checkpoint.py``).

  * atomic commit: a step is written into ``step_<n>.tmp`` and renamed to
    ``step_<n>`` once complete — a writer killed mid-save never corrupts the
    latest checkpoint;
  * async save thread — training blocks only for the host snapshot;
  * keep-last-k retention;
  * resume picks the newest COMMITTED step that passes its digests; partial
    writes (``*.tmp``, no ``meta.json``) are ignored and swept;
  * ``meta.json`` holds the step, the time, the crc32 digest of every
    payload file and the caller's provenance (``meta=``).

A state is a tree of tensors (``repro_torch.tree``). Leaves are numbered in
the reference's flatten order and saved as numpy arrays (``arrays.npz``);
the tree's shape goes to ``structure.json``. Restore returns CPU tensors.
A bf16 leaf is written as the reference writes one (numpy has no
bfloat16): its bytes as ``uint8`` (a 0-d leaf: two raw bytes) in one
full-extent shard ``a{i}.s0`` under a ``sharding.json`` entry of dtype
``bfloat16``, and comes back as a ``torch.bfloat16`` tensor of the same
bits. A checkpoint with such entries also gets ``treedef.pkl`` (below), so
the reference restores it; the port restores a checkpoint the reference
wrote from its ``treedef.pkl``, read without importing ``jax``.
The ``ckpt.write`` fault site mirrors the reference's: ``torn`` stops the
writer between the payload and the commit (the ``.tmp`` dir stays, no
``meta.json``), ``corrupt`` flips a byte of the committed ``arrays.npz``
so that only digest verification catches it.

**Sharded states** (``save(..., plan=, specs=)`` under an SPMD plan). Every
rank takes part in gathering each leaf's blocks (FSDP rows and TP columns
of the dense leaves, the tables' row blocks), and rank 0 writes the
reference's sharded layout: a leaf with a spec gets a ``sharding.json``
entry (global shape, dtype, spec, shards) and one ``a{i}.s{k}`` array a
block of the mesh, with its ``index`` ranges on every dim (a 2-D block of
an FSDP x TP leaf; a leaf held whole: one shard of the whole extent; a
bf16 block as its bytes), the rest ``a{i}``; ``treedef.pkl`` holds the
tree as the reference's ``jax`` (0.9) pickles a ``PyTreeDef``, written
opcode by opcode here without importing it. So the reference's
``CheckpointManager.restore()`` reassembles a port checkpoint on one
device. ``restore`` reassembles the global tree; ``saved_specs`` reads
the specs back; ``restore_sharded(plan)`` re-applies each saved spec on
the (possibly other) mesh and cuts the leaf to this rank's block (a dim
the new mesh does not divide stays whole);
``restore_resharded(specs, plan)`` cuts by an explicit spec tree.
"""
from __future__ import annotations

import io
import itertools
import json
import os
import pickle
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.host import BF16_BITS, bf16_bits, host_copy
from repro_torch.reliability import faults
from repro_torch.tree import leaves, unflatten

# pickle opcodes of protocol 4 (``pickletools``), for treedef.pkl
_PROTO, _STOP, _MARK, _NONE = b"\x80\x04", b".", b"(", b"N"
_TUPLE, _TUPLE2, _EMPTY_TUPLE = b"t", b"\x86", b")"
_EMPTY_LIST, _APPENDS = b"]", b"e"
_STACK_GLOBAL, _NEWOBJ, _BUILD = b"\x93", b"\x81", b"b"
# the reference's PyTreeDef node kinds
_LEAF, _NONE_NODE, _TUPLE_NODE, _LIST_NODE, _DICT_NODE = 0, 1, 2, 4, 5


class CheckpointCorruptionError(ValueError):
    """An explicitly requested checkpoint step failed integrity checks."""


def _skeleton(tree: Any) -> Any:
    """JSON-able copy of a tree's shape: dicts and lists kept, every leaf
    replaced by null."""
    if isinstance(tree, dict):
        return {"dict": {k: _skeleton(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"list": [_skeleton(v) for v in tree]}
    if tree is None:
        return {"none": True}
    return None


def _from_skeleton(sk: Any) -> Any:
    if sk is None:
        return 0                     # a leaf slot for unflatten
    if "dict" in sk:
        return {k: _from_skeleton(v) for k, v in sk["dict"].items()}
    if "list" in sk:
        return [_from_skeleton(v) for v in sk["list"]]
    return None


def _pkl_str(text: str) -> bytes:
    raw = text.encode("utf-8")
    if len(raw) < 256:
        return b"\x8c" + bytes([len(raw)]) + raw       # SHORT_BINUNICODE
    return b"X" + len(raw).to_bytes(4, "little") + raw  # BINUNICODE


def _pkl_int(v: int) -> bytes:
    if 0 <= v < 256:
        return b"K" + bytes([v])                        # BININT1
    return b"J" + int(v).to_bytes(4, "little", signed=True)   # BININT


def _treedef_nodes(tree: Any, out: list) -> tuple:
    """Post-order node records of ``tree`` as the reference's PyTreeDef
    state holds them: (kind, arity, node data, None, leaves, nodes)."""
    if tree is None:
        out.append((_NONE_NODE, 0, None, 0, 1))
        return 0, 1
    if isinstance(tree, dict):
        keys = sorted(tree)
        kids = [tree[k] for k in keys]
        kind, data = _DICT_NODE, keys
    elif isinstance(tree, (list, tuple)):
        kids = list(tree)
        kind = _LIST_NODE if isinstance(tree, list) else _TUPLE_NODE
        data = None
    else:
        out.append((_LEAF, 0, None, 1, 1))
        return 1, 1
    n_leaves, n_nodes = 0, 1
    for child in kids:
        nl, nn = _treedef_nodes(child, out)
        n_leaves += nl
        n_nodes += nn
    out.append((kind, len(kids), data, n_leaves, n_nodes))
    return n_leaves, n_nodes


def jax_treedef_pickle(tree: Any) -> bytes:
    """The bytes ``pickle.dumps(jax.tree_util.tree_structure(tree))``
    unpickles from under the reference's jax, for a tree of dicts (str
    keys), lists, tuples, None and leaves."""
    nodes: list = []
    _treedef_nodes(tree, nodes)
    body = b""
    for kind, arity, data, n_leaves, n_nodes in nodes:
        if data is None:
            data_b = _NONE
        else:
            data_b = _EMPTY_LIST + (_MARK + b"".join(map(_pkl_str, data))
                                    + _APPENDS if data else b"")
        body += (_MARK + _pkl_int(kind) + _pkl_int(arity) + data_b + _NONE
                 + _pkl_int(n_leaves) + _pkl_int(n_nodes) + _TUPLE)
    return (_PROTO + _pkl_str("jaxlib._jax.pytree") + _pkl_str("PyTreeDef")
            + _STACK_GLOBAL + _EMPTY_TUPLE + _NEWOBJ
            + _pkl_str("jax._src.tree_util") + _pkl_str("default_registry")
            + _STACK_GLOBAL + _EMPTY_LIST + _MARK + body + _APPENDS
            + _TUPLE2 + _BUILD + _STOP)


def _spec_to_json(spec) -> Optional[list]:
    """A spec tuple -> JSON ([axis | [axes...] | null, ...])."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _host(x) -> np.ndarray:
    return (host_copy(x).copy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _stored_bf16(block: np.ndarray) -> np.ndarray:
    """A block of bf16 bits as the reference stores one in npz: its bytes
    (``uint8``, the last dim doubled), or a 0-d leaf's two raw bytes
    (``V2``, which npz keeps as they are)."""
    bits = bf16_bits(block)
    return bits.view(np.uint8) if bits.ndim else bits.view("V2")


def _leaf_payload(i: int, arr: np.ndarray, spec, mesh_shape: dict):
    """(npz arrays, manifest entry or None) of global leaf ``i``: one
    shard a block of the mesh along the dims ``spec`` splits, blocks in
    row-major order of their dims' block indices. A leaf no spec splits is
    ``a{i}`` with no entry, unless it is bf16: that leaf is one
    full-extent shard under an entry, as the reference writes it, so that
    its dtype survives npz."""
    bf16 = arr.dtype == BF16_BITS
    split = spec is not None and any(e is not None for e in spec)
    if not (split or bf16):
        return {f"a{i}": arr}, None
    counts = []
    for dim in range(arr.ndim):
        e = spec[dim] if split and dim < len(spec) else None
        names = () if e is None else ((e,) if isinstance(e, str) else e)
        counts.append(int(np.prod([mesh_shape[a] for a in names])))
    host: Dict[str, np.ndarray] = {}
    shards = []
    for k, blk in enumerate(itertools.product(*map(range, counts))):
        index = [[b * (d // c), (b + 1) * (d // c)]
                 for b, c, d in zip(blk, counts, arr.shape)]
        key = f"a{i}.s{k}"
        block = arr[tuple(slice(a, b) for a, b in index)] if index else arr
        host[key] = _stored_bf16(block) if bf16 else block
        shards.append({"key": key, "index": index})
    entry = {"shape": list(arr.shape),
             "dtype": "bfloat16" if bf16 else str(arr.dtype),
             "spec": None if spec is None else _spec_to_json(spec),
             "shards": shards}
    return host, entry


def _payload(flat: list, spec_leaves: list, mesh_shape: dict):
    """(arrays, manifest) of global leaves and their specs (None: saved
    without a plan) in the reference's layout (module note)."""
    host: Dict[str, np.ndarray] = {}
    manifest: Dict[str, dict] = {}
    for i, (x, spec) in enumerate(zip(flat, spec_leaves)):
        arrays, entry = _leaf_payload(i, _host(x), spec, mesh_shape)
        host.update(arrays)
        if entry is not None:
            manifest[str(i)] = entry
    return host, manifest


def _leaf_from_entry(entry: dict, data) -> torch.Tensor:
    """A leaf reassembled from its manifest entry's shards. ``bfloat16``
    (the reference's ``ml_dtypes`` name, which numpy alone cannot parse)
    comes back as a ``torch.bfloat16`` tensor of the stored bits."""
    name = entry["dtype"]
    bf16 = name == "bfloat16"
    try:
        dtype = np.dtype(np.uint16 if bf16 else name)
    except TypeError:
        raise TypeError(f"checkpoint leaf of dtype {name!r}: the port reads "
                        f"numpy's dtypes and bfloat16") from None
    out = np.empty(tuple(entry["shape"]), dtype=dtype)
    for sh in entry["shards"]:
        block = data[sh["key"]]
        out[tuple(slice(a, b) for a, b in sh["index"])] = (
            bf16_bits(block) if bf16 else block)
    t = torch.from_numpy(out)
    return t.view(torch.int16).view(torch.bfloat16) if bf16 else t


class _PickledTreeDef:
    """Stands in for the reference's ``PyTreeDef`` while its pickle is
    read: keeps the node records, imports nothing of ``jax``."""

    def __setstate__(self, state) -> None:
        self.nodes = state[1]


class _TreeDefUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if name == "PyTreeDef":
            return _PickledTreeDef
        if name == "default_registry":
            return None
        raise pickle.UnpicklingError(
            f"treedef.pkl names {module}.{name}, not a PyTreeDef")


def _like_from_treedef(blob: bytes) -> Any:
    """The tree shape (leaf slots 0) that a ``treedef.pkl`` holds: the
    reference's post-order node records rebuilt into dicts and lists."""
    nodes = _TreeDefUnpickler(io.BytesIO(blob)).load().nodes
    stack: list = []
    for kind, arity, data, *_ in nodes:
        kids = stack[len(stack) - arity:]
        del stack[len(stack) - arity:]
        if kind == _LEAF:
            stack.append(0)
        elif kind == _NONE_NODE:
            stack.append(None)
        elif kind == _DICT_NODE:
            stack.append(dict(zip(data, kids)))
        elif kind in (_LIST_NODE, _TUPLE_NODE):
            stack.append(kids)
        else:
            raise ValueError(f"treedef.pkl holds a node of kind {kind}; the "
                             f"port reads dicts, lists, tuples and None")
    (root,) = stack
    return root


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 meta: Optional[Dict[str, Any]] = None):
        # ``meta``: extra provenance merged into every step's meta.json
        # (core keys — step/ts/digests — always win on collision)
        self.dir = directory
        self.keep_last = keep_last
        self.meta = dict(meta) if meta else {}
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        # a writer killed mid-save leaves step_*.tmp dirs; they were never
        # committed (all_steps ignores them) so they are pure dead weight
        self._sweep_tmp()

    def _sweep_tmp(self) -> None:
        for name in os.listdir(self.dir):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # ---- save ---------------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:012d}")

    def save(self, step: int, state: Any, blocking: bool = True,
             plan=None, specs: Any = None) -> None:
        """Snapshot ``state`` to host memory synchronously and write it
        (async unless ``blocking``). Under an enabled ``plan`` every rank
        calls it with its part and the state's ``specs`` (each takes part
        in the gather); rank 0 writes."""
        sharded_manifest: Dict[str, dict] = {}
        if plan is not None and plan.enabled:
            import torch.distributed as dist

            from repro_torch.distributed import spmd
            state = spmd.gather_state(state, specs, plan)
            if dist.get_rank() != 0:
                return
            flat = leaves(state)
            host, sharded_manifest = _payload(
                flat, leaves(specs, is_leaf=spmd.is_spec), plan.mesh.shape)
        else:
            flat = leaves(state)
            host, sharded_manifest = _payload(flat, [None] * len(flat), {})
        structure = json.dumps(_skeleton(state)).encode("utf-8")
        treedef = jax_treedef_pickle(state) if sharded_manifest else None

        def _write():
            tmp = self._path(step) + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            digests: Dict[str, int] = {}   # filename -> crc32 of bytes

            def put(name: str, blob: bytes) -> None:
                with open(os.path.join(tmp, name), "wb") as f:
                    f.write(blob)
                digests[name] = zlib.crc32(blob)

            buf = io.BytesIO()
            np.savez(buf, **host)
            put("arrays.npz", buf.getvalue())
            put("structure.json", structure)
            if sharded_manifest:
                put("treedef.pkl", treedef)
                put("sharding.json",
                    json.dumps(sharded_manifest).encode("utf-8"))
            spec = faults.fire("ckpt.write")
            if spec is not None and spec.kind == "torn":
                # simulated kill between payload write and commit: the
                # .tmp dir stays behind, meta.json is never written, and
                # all_steps() never reports this step
                return
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({**self.meta, "step": step, "ts": time.time(),
                           "n_arrays": len(flat),
                           **({"n_sharded": len(sharded_manifest)}
                              if sharded_manifest else {}),
                           "digests": digests}, f)
            final = self._path(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic commit
            if spec is not None and spec.kind == "corrupt":
                # bit rot after commit: flip a byte in the committed
                # payload so only digest verification can catch it
                apath = os.path.join(final, "arrays.npz")
                with open(apath, "rb") as f:
                    blob = f.read()
                with open(apath, "wb") as f:
                    f.write(faults.corrupt_bytes("ckpt.write", blob, spec))
            self._gc()

        if blocking:
            _write()
        else:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self._path(s), ignore_errors=True)
        self._sweep_tmp()

    # ---- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step: int) -> bool:
        """True iff every payload file matches the crc32 digest recorded in
        the step's meta.json."""
        path = self._path(step)
        try:
            with open(os.path.join(path, "meta.json")) as f:
                digests = json.load(f)["digests"]
        except (OSError, ValueError, KeyError):
            return False
        for name, want in digests.items():
            try:
                with open(os.path.join(path, name), "rb") as f:
                    got = zlib.crc32(f.read())
            except OSError:
                return False
            if got != int(want):
                return False
        return True

    def valid_steps(self) -> List[int]:
        return [s for s in self.all_steps() if self.verify(s)]

    def latest_valid_step(self) -> Optional[int]:
        """Newest step that passes verification — the step ``restore()``
        falls back to when the latest commit rotted."""
        for s in reversed(self.all_steps()):
            if self.verify(s):
                return s
        return None

    def restore(self, step: Optional[int] = None) -> Any:
        """The saved tree with CPU tensor leaves.

        With ``step=None`` restores the newest step that PASSES integrity
        verification (skipping corrupt or torn ones); an explicitly
        requested corrupt step raises :class:`CheckpointCorruptionError`.
        """
        if step is None:
            step = self.latest_valid_step()
            if step is None:
                raise FileNotFoundError(
                    f"no committed valid checkpoint in {self.dir}")
        elif not self.verify(step):
            raise CheckpointCorruptionError(
                f"checkpoint step {step} in {self.dir} failed integrity "
                f"verification (crc mismatch or missing payload)")
        path = self._path(step)
        if os.path.exists(os.path.join(path, "structure.json")):
            with open(os.path.join(path, "structure.json")) as f:
                like = _from_skeleton(json.load(f))
        else:                       # written by the reference
            with open(os.path.join(path, "treedef.pkl"), "rb") as f:
                like = _like_from_treedef(f.read())
        manifest = self._load_manifest(path)
        n = len(leaves(like))
        flat = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i in range(n):
                entry = manifest.get(str(i))
                flat.append(torch.from_numpy(np.array(data[f"a{i}"]))
                            if entry is None
                            else _leaf_from_entry(entry, data))
        return unflatten(like, flat)

    def _load_manifest(self, path: str) -> Dict[str, dict]:
        mpath = os.path.join(path, "sharding.json")
        if not os.path.exists(mpath):
            return {}
        with open(mpath) as f:
            return json.load(f)

    def saved_specs(self, step: Optional[int] = None) -> Dict[int, list]:
        """leaf index -> JSON spec for the leaves a sharded save recorded
        a spec for."""
        step = step if step is not None else self.latest_valid_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        manifest = self._load_manifest(self._path(step))
        return {int(i): e["spec"] for i, e in manifest.items()}

    def restore_sharded(self, plan, step: Optional[int] = None) -> Any:
        """Restore onto ``plan``'s mesh (possibly of another shape than
        the one saved from): each leaf's saved spec is re-applied and the
        leaf cut to this rank's block, a dim the new mesh does not divide
        (or whose axis it lacks) whole."""
        from repro_torch.distributed import spmd
        state = self.restore(step)
        specs = self.saved_specs(step)
        names = set(plan.mesh.axis_names)
        cut = []
        for i, x in enumerate(leaves(state)):
            spec = tuple(
                None if e is None or not set(spmd.entry_axes(
                    tuple(e) if isinstance(e, list) else e)) <= names
                else (tuple(e) if isinstance(e, list) else e)
                for e in (specs.get(i) or ()))
            cut.append(spmd.local_block(
                x, spmd.fit_spec(spec, tuple(x.shape), plan), plan))
        return unflatten(state, cut)

    def restore_resharded(self, specs: Any, plan,
                          step: Optional[int] = None) -> Any:
        """Restore, then cut by an explicit spec tree congruent with the
        saved state (``spmd.state_shardings`` of it, say)."""
        from repro_torch.distributed import spmd
        return spmd.place_state(self.restore(step), plan, specs=specs)
