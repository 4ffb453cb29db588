"""Process bootstrap for SPMD runs (the port's counterpart of
``repro/launch/hostdevices.py``).

The reference simulates N devices in one process with an XLA flag; the
port runs one process per rank, joined into one ``torch.distributed``
world:

  * :func:`spawn` starts ``world`` local ranks (the ``spawn`` start
    method), each joined through a ``FileStore`` under a fresh temporary
    directory, so concurrent runs (pytest-xdist workers) never race for a
    TCP port; gloo on the CPU by default. A rank that raises writes its
    traceback beside the store, the others are stopped, and the parent
    raises with it;
  * :func:`init_from_env` joins the world ``torchrun`` describes
    (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``);
  * :func:`ensure_world` makes sure a world exists: torchrun's, or a world
    of one (a mesh of 1 x 1 needs no other process); it leaves a world
    that exists alone;
  * :func:`init_fake_world` makes the dry run's world: ``world`` ranks in
    this one process as rank 0, on ``torch.distributed``'s fake backend
    (its collectives return at once and move nothing: the dry run runs
    them on meta tensors to count them).

Importing this module starts nothing.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ones."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_from_env(backend: str) -> bool:
    """Join torchrun's world when its variables are set; True if joined."""
    if not all(v in os.environ for v in TORCHRUN_VARS):
        return False
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://")
    return True


def prospective_world_size() -> int:
    """The world :func:`ensure_world` would give, without joining it."""
    if dist.is_initialized():
        return dist.get_world_size()
    if all(v in os.environ for v in TORCHRUN_VARS):
        return int(os.environ["WORLD_SIZE"])
    return 1


def ensure_world(backend: str) -> int:
    """The world size, after joining torchrun's world or making a world of
    one when no process group exists yet."""
    if not dist.is_initialized() and not init_from_env(backend):
        store_dir = tempfile.mkdtemp(prefix="repro_torch_world1_")
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(store_dir, "store"),
                                          1), rank=0, world_size=1)
    return dist.get_world_size()


def init_fake_world(world: int) -> None:
    """A fake world of ``world`` ranks, this process rank 0 (module note).
    Refuses to start inside an existing process group."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a process group exists already ({dist.get_backend()}, "
            f"{dist.get_world_size()} ranks): the dry run owns its process")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _rank_entry(rank: int, world: int, store_dir: str, backend: str,
                threads: Optional[int], fn: Callable, args: Sequence):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(store_dir, "store"),
                                          world),
            rank=rank, world_size=world)
        try:
            fn(rank, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(store_dir, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world: int, args: Sequence = (),
          backend: str = "gloo", threads: Optional[int] = None,
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``world`` new processes joined into one
    world. ``fn`` and ``args`` are pickled (a module-level function).
    Returns when every rank has exited 0; raises RuntimeError with the
    first failing rank's traceback otherwise (or at ``timeout_s``), after
    stopping the ranks still running."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, store_dir, backend, threads, fn,
                               tuple(args)), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = [(r, p.exitcode) for r, p in enumerate(procs)
                  if p.exitcode != 0]
        if failed:
            msgs = []
            for r, _ in failed:
                path = os.path.join(store_dir, f"error_rank{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        msgs.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(
                f"spawned ranks failed (rank, exit code): {failed}\n"
                + "\n".join(msgs))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
        shutil.rmtree(store_dir, ignore_errors=True)
