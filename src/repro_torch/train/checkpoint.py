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
The ``ckpt.write`` fault site mirrors the reference's: ``torn`` stops the
writer between the payload and the commit (the ``.tmp`` dir stays, no
``meta.json``), ``corrupt`` flips a byte of the committed ``arrays.npz``
so that only digest verification catches it. Not ported yet: the
sharded-leaf manifest and elastic reshard (they come with multi-card
training).
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.reliability import faults
from repro_torch.tree import leaves, unflatten


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

    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        # snapshot to host memory synchronously, write async
        flat = leaves(state)
        host = {f"a{i}": (x.detach().to("cpu").numpy().copy()
                          if isinstance(x, torch.Tensor) else np.asarray(x))
                for i, x in enumerate(flat)}
        structure = json.dumps(_skeleton(state)).encode("utf-8")

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
            spec = faults.fire("ckpt.write")
            if spec is not None and spec.kind == "torn":
                # simulated kill between payload write and commit: the
                # .tmp dir stays behind, meta.json is never written, and
                # all_steps() never reports this step
                return
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({**self.meta, "step": step, "ts": time.time(),
                           "n_arrays": len(flat), "digests": digests}, f)
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
        with open(os.path.join(path, "structure.json")) as f:
            like = _from_skeleton(json.load(f))
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = [torch.from_numpy(np.array(data[f"a{i}"]))
                    for i in range(len(data.files))]
        return unflatten(like, flat)
