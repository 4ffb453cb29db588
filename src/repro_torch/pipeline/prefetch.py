"""Async prefetching input loader over on-disk ROO shards (torch port of
``repro/pipeline/prefetch.py``).

Decode and host-side batch assembly steal step time if they run on the
training thread (the InTune observation, arXiv:2308.08500). This loader
moves them to a background thread:

    [reader thread]  shard file -> decode_roo_shard -> ROOBatcher pack on
                     the host -> pinned copy to the card on a side stream,
                     synchronized -> bounded queue
    [train  thread]  queue.get() -> record_stream(current stream) -> step

A queue of depth >= 2 gives double buffering: while step N runs, batch N+1
is already resident and N+2 is being assembled.

**Placement on the card** (where the port departs from the reference's
``jax.device_put`` + ``block_until_ready``). ``ShardDataset`` packs on the
host (``ROOBatcher(cfg, device="cpu")``), so a batch is copied once. The
producer copies it to the loader's explicit ``device`` itself, from pinned
memory on a side stream of its own, and synchronizes that stream before it
enqueues the batch: a queued batch is complete on the card, the counterpart
of ``block_until_ready``. Its blocks belong to the side stream's pool, so
the consumer calls ``record_stream(torch.cuda.current_stream())`` on every
leaf it yields: without it the caching allocator could hand a freed leaf's
block to the next copy on the side stream while the train step that reads
it is still queued on the card. Copying on the consumer's stream instead
needs no ``record_stream`` but puts the pin and the copy's launch back on
the training thread, which is what the loader exists to take off it. With
``prefetch=False`` the calling thread copies on its current stream.
Under an SPMD plan ``sharding`` (``spmd.make_batch_sharding_fn(plan)``)
cuts each host batch to this rank's block (its data rows, rebased
``segment_ids``) before the copy, so each rank's thread copies only its
own block.

Determinism / resume: shards are read in manifest order; each shard is
packed independently by a fresh ``ROOBatcher``; so the batch stream is a
pure function of (manifest, BatcherConfig) and a position in it is the
``Cursor (epoch, shard, batch)`` — "``batch`` batches of ``shard`` already
consumed". Every yielded batch comes with the cursor of the *next* batch;
checkpoint that cursor (pipeline/resume.py) and a restarted loader
reproduces the remaining stream bit-identically, prefetch on or off.

Graceful degradation:

  * **corrupt-shard quarantine** — a shard failing integrity checks
    (``ShardCorruptionError``; per-block CRC32 since schema v2) yields zero
    batches instead of killing training; the skip is counted in
    ``ShardDataset.stats`` and warned once per shard. ``strict=True``
    raises instead (debugging / data-validation runs).
  * **bounded retry** — transient read failures (``OSError``, including
    injected ``TransientFault``) are retried ``max_retries`` times with
    exponential backoff + seeded jitter before surfacing.
  * **stall watchdog** — if the producer thread goes silent for
    ``stall_timeout_s`` the consumer abandons it and restarts a fresh
    producer at the exact cursor of the next undelivered batch, so a hung
    I/O call costs one timeout, not the training job. Producer
    generations are tagged so a zombie thread — which may still hold
    pinned or card tensors — can never interleave stale batches into the
    stream.
  * **explicit shutdown** — ``close()`` (or ``with PrefetchLoader(...)``)
    stops and joins every producer thread this loader started; exhausting
    or ``close()``-ing the generator returned by ``batches()`` does the
    same for that iteration.

The producer decodes and packs in Python and numpy under the GIL, so on a
launch-bound train step the thread moves the pack off the step's critical
path only as far as the two threads interleave; PERF.md records what the
card measured.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.roo_batch import ROOBatch
from repro_torch.data.batcher import BatcherConfig, ROOBatcher
from repro_torch.data.storage import ShardCorruptionError
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.log import warn_once
from repro_torch.pipeline.shards import (ShardManifest, load_manifest,
                                         read_shard)
from repro_torch.reliability import faults
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True, order=True)
class Cursor:
    """Position in the deterministic batch stream (see module docstring)."""
    epoch: int = 0
    shard: int = 0
    batch: int = 0       # batches already consumed from this shard

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(obj: dict) -> "Cursor":
        return Cursor(epoch=int(obj["epoch"]), shard=int(obj["shard"]),
                      batch=int(obj["batch"]))


@dataclasses.dataclass
class DatasetStats:
    """Corrupt-shard quarantine accounting (per ShardDataset)."""
    shards_quarantined: int = 0
    quarantined_files: List[str] = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def quarantine(self, filename: str) -> int:
        """Record one quarantined shard; returns the running total."""
        with self._lock:
            self.shards_quarantined += 1
            self.quarantined_files.append(filename)
            return self.shards_quarantined

    def snapshot(self) -> dict:
        with self._lock:
            return {"shards_quarantined": self.shards_quarantined,
                    "quarantined_files": list(self.quarantined_files)}


@dataclasses.dataclass
class LoaderStats:
    """Degraded-mode accounting (per PrefetchLoader).

    Mutated from the producer thread and read from the training thread —
    go through ``inc``/``snapshot``, not bare ``+=``.
    """
    read_retries: int = 0        # transient read failures that were retried
    read_failures: int = 0       # reads that exhausted the retry budget
    producer_restarts: int = 0   # stall-watchdog producer replacements
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def inc(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> dict:
        with self._lock:
            return {f.name: getattr(self, f.name)
                    for f in dataclasses.fields(self)
                    if not f.name.startswith("_")}


class ShardDataset:
    """Decode + pack one shard at a time (the host-side unit of work).

    Batches are packed on the host (``ROOBatcher(cfg, device="cpu")``);
    the loader places them. ``strict=False`` (default) quarantines shards
    that fail integrity checks — ``shard_batches`` returns no batches for
    them and ``stats.shards_quarantined`` counts the loss; ``strict=True``
    raises the underlying :class:`ShardCorruptionError`.
    """

    def __init__(self, shard_dir: str, batcher_cfg: BatcherConfig,
                 manifest: Optional[ShardManifest] = None,
                 strict: bool = False):
        self.shard_dir = shard_dir
        self.batcher_cfg = batcher_cfg
        self.manifest = manifest or load_manifest(shard_dir)
        self.strict = strict
        self.stats = DatasetStats()
        obs_metrics.register_stats("pipeline.dataset", self.stats)
        if not self.manifest.shards:
            raise ValueError(f"empty shard manifest in {shard_dir}")

    @property
    def n_shards(self) -> int:
        return len(self.manifest.shards)

    def shard_batches(self, shard_index: int) -> List[ROOBatch]:
        info = self.manifest.shards[shard_index]
        try:
            samples = read_shard(self.shard_dir, info)
        except ShardCorruptionError as e:
            if self.strict:
                raise
            # quarantine: training keeps running on the surviving shards;
            # the loss is counted, never silent. One warning per shard
            # file — a run quarantining the same shard every epoch counts
            # repeats instead of flooding stderr.
            total = self.stats.quarantine(info.filename)
            warn_once(os.path.join(self.shard_dir, info.filename),
                      f"quarantined corrupt shard ({e}); "
                      f"{total} quarantined so far", RuntimeWarning)
            return []
        # a fresh batcher per shard: packing must not depend on what was
        # packed before the shard, or the cursor loses determinism
        with obs_trace.span("pipeline.pack", shard=shard_index,
                            samples=len(samples)):
            return list(ROOBatcher(self.batcher_cfg, device="cpu")
                        .batches(samples))


class _Producer:
    """One background producer generation: thread + stop flag."""

    def __init__(self, gen: int, target) -> None:
        self.gen = gen
        self.stop = threading.Event()
        self.thread = threading.Thread(target=target, daemon=True,
                                       name=f"roo-prefetch-{gen}")

    def close(self, q: "queue.Queue", join_timeout: float = 5.0) -> None:
        """Stop the producer and join it, draining the queue so a thread
        blocked on ``put`` can exit (bounded wait; a truly hung I/O call
        leaves a daemon thread behind by design — that is what the stall
        watchdog abandoned it for)."""
        self.stop.set()
        deadline = time.monotonic() + join_timeout
        while self.thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.05)


class PrefetchLoader:
    """Iterate (batch on ``device``, next_cursor) pairs from a shard
    directory.

    ``prefetch=False`` runs the same stream synchronously on the calling
    thread — the benchmark baseline and a debugging aid. ``device`` is
    where batches land (the card unless the caller asks for the CPU).

    Reliability knobs: ``max_retries`` / ``retry_backoff_s`` /
    ``retry_backoff_max_s`` bound the transient-read retry loop;
    ``stall_timeout_s`` arms the producer stall watchdog (None = off);
    ``retry_seed`` seeds the backoff jitter so chaos runs are repeatable.
    """

    def __init__(self, dataset: ShardDataset, prefetch: bool = True,
                 prefetch_depth: int = 3, epochs: Optional[int] = None,
                 device="cuda", max_retries: int = 3,
                 retry_backoff_s: float = 0.05,
                 retry_backoff_max_s: float = 2.0,
                 stall_timeout_s: Optional[float] = 300.0,
                 retry_seed: int = 0, sharding=None):
        if prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got "
                             f"{prefetch_depth}")
        self.dataset = dataset
        self.prefetch = prefetch
        self.prefetch_depth = prefetch_depth
        self.epochs = epochs          # None = cycle forever (training)
        self.device = torch.device(device)
        self.sharding = sharding      # host batch -> this rank's block
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_max_s = retry_backoff_max_s
        self.stall_timeout_s = stall_timeout_s
        self.stats = LoaderStats()
        obs_metrics.register_stats("pipeline.loader", self.stats)
        self._retry_rng = np.random.default_rng(retry_seed)
        self._producers: Set[_Producer] = set()
        self._queues = {}             # producer -> its queue (for close())
        self._closed = False

    # -- lifecycle ---------------------------------------------------------------
    def close(self) -> None:
        """Stop and join every producer thread this loader started. Safe to
        call twice; also runs when the loader is used as a context manager
        or when a ``batches()`` generator is closed/exhausted."""
        self._closed = True
        for prod in list(self._producers):
            prod.close(self._queues.get(prod) or queue.Queue())
            self._producers.discard(prod)
            self._queues.pop(prod, None)

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- placement ---------------------------------------------------------------
    def _place(self, batch: ROOBatch,
               stream: Optional["torch.cuda.Stream"] = None) -> ROOBatch:
        """The host batch on ``self.device``. With a ``stream`` (the
        producer's), the copy runs from pinned memory on that stream and
        the stream is synchronized before returning; without one, on the
        calling thread's current stream."""
        with obs_trace.span("pipeline.device_put"):
            if self.sharding is not None:
                batch = self.sharding(batch)
            if stream is None or self.device.type != "cuda":
                return batch.to(self.device)
            with torch.cuda.stream(stream):
                out = tree_map(lambda t: t.pin_memory().to(
                    self.device, non_blocking=True), batch)
            stream.synchronize()
            return out

    def _adopt(self, batch: ROOBatch) -> ROOBatch:
        """Mark a producer-placed batch as used by the consumer's stream,
        so its blocks are not reused before the step that reads them has
        run on the card."""
        if self.device.type == "cuda":
            current = torch.cuda.current_stream(self.device)
            for leaf in leaves(batch):
                leaf.record_stream(current)
        return batch

    # -- fault-tolerant shard read ----------------------------------------------
    def _read_with_retry(self, shard_index: int,
                         waiter: Optional[threading.Event] = None
                         ) -> List[ROOBatch]:
        """``dataset.shard_batches`` with bounded retry + exponential
        backoff + jitter on transient (OSError-shaped) failures. Corruption
        is NOT retried — re-reading a rotten block yields the same bytes;
        the dataset quarantines it instead."""
        delay = self.retry_backoff_s
        attempt = 0
        while True:
            try:
                faults.maybe_fail("prefetch.io")    # injected transient I/O
                return self.dataset.shard_batches(shard_index)
            except ShardCorruptionError:
                raise
            except OSError:
                if attempt >= self.max_retries:
                    self.stats.inc("read_failures")
                    raise
                self.stats.inc("read_retries")
                attempt += 1
                # full jitter in [0.5, 1.5) x the exponential term: retries
                # from many workers must not synchronize into a thundering
                # herd against shared storage
                sleep_s = min(delay * (0.5 + self._retry_rng.random()),
                              self.retry_backoff_max_s)
                if waiter is not None:
                    if waiter.wait(sleep_s):
                        raise        # producer being torn down: stop retrying
                else:
                    time.sleep(sleep_s)
                delay *= 2.0

    # -- the deterministic host-side stream -------------------------------------
    def _host_stream(self, start: Cursor, skip_batches: int = 0,
                     waiter: Optional[threading.Event] = None
                     ) -> Iterator[Tuple[ROOBatch, Cursor]]:
        """Stream from ``start``; the first ``skip_batches`` batches are
        dropped here, host-side, before any device transfer happens (the
        cursor-miss replay fallback in pipeline/resume.py)."""
        n_shards = self.dataset.n_shards
        epoch, shard, skip = start.epoch, start.shard, start.batch
        if shard >= n_shards:
            epoch, shard, skip = epoch + 1, 0, 0
        while self.epochs is None or epoch < self.epochs:
            packed = self._read_with_retry(shard, waiter)
            obs_export.maybe_emit("pipeline.shard")
            if skip >= len(packed) > 0:
                # cursors we emit always satisfy batch < len(packed); an
                # out-of-range value means the shards or the batcher config
                # changed under the cursor — fail loudly, don't misalign
                raise ValueError(
                    f"resume cursor batch={skip} out of range for shard "
                    f"{shard} ({len(packed)} batches) — shard contents or "
                    f"batcher config changed since the cursor was saved")
            for i in range(skip, len(packed)):
                if i + 1 < len(packed):
                    nxt = Cursor(epoch, shard, i + 1)
                elif shard + 1 < n_shards:
                    nxt = Cursor(epoch, shard + 1, 0)
                else:
                    nxt = Cursor(epoch + 1, 0, 0)
                if skip_batches > 0:
                    skip_batches -= 1
                    continue
                yield packed[i], nxt
            skip = 0
            shard += 1
            if shard >= n_shards:
                shard = 0
                epoch += 1

    # -- iteration ----------------------------------------------------------------
    def batches(self, start: Cursor = Cursor(), skip_batches: int = 0
                ) -> Iterator[Tuple[ROOBatch, Cursor]]:
        if not self.prefetch:
            for batch, nxt in self._host_stream(start, skip_batches):
                yield self._place(batch), nxt
            return
        yield from self._prefetch_iter(start, skip_batches)

    def _spawn(self, q: "queue.Queue", gen: int, start: Cursor,
               skip_batches: int) -> _Producer:
        def offer(item) -> bool:
            """Put ``item`` unless the producer is stopped first."""
            while not prod.stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _produce() -> None:
            stop = prod.stop
            try:
                stream = (torch.cuda.Stream(self.device)
                          if self.device.type == "cuda" else None)
                for batch, nxt in self._host_stream(start, skip_batches,
                                                    waiter=stop):
                    spec = faults.fire("prefetch.stall")
                    if spec is not None and spec.kind == "stall":
                        # simulated hung I/O: go silent until abandoned
                        stop.wait()
                        return
                    if not offer((gen, (self._place(batch, stream), nxt))):
                        return
                offer((gen, _EndOfStream))
            except BaseException as e:               # surface in consumer
                if not stop.is_set():
                    offer((gen, e))

        prod = _Producer(gen, _produce)
        self._producers.add(prod)
        self._queues[prod] = q
        prod.thread.start()
        return prod

    def _prefetch_iter(self, start: Cursor, skip_batches: int = 0
                       ) -> Iterator[Tuple[ROOBatch, Cursor]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        gen = 0
        # where a replacement producer must resume: the cursor of the next
        # batch the consumer has NOT yet received (+ any pending host-side
        # skip, which only a producer that never delivered still owes)
        resume: Tuple[Cursor, int] = (start, skip_batches)
        prod = self._spawn(q, gen, *resume)
        spawned = [prod]              # joined, abandoned ones too, at the end
        try:
            while True:
                try:
                    item = q.get(timeout=self.stall_timeout_s)
                except queue.Empty:
                    # stall watchdog: the producer went silent past the
                    # deadline — abandon it and restart at the current
                    # cursor. The zombie's generation tag keeps any batch
                    # it might still emit out of the stream.
                    self.stats.inc("producer_restarts")
                    prod.stop.set()
                    gen += 1
                    prod = self._spawn(q, gen, *resume)
                    spawned.append(prod)
                    continue
                item_gen, payload = item
                if item_gen != gen:          # stale batch from a zombie
                    continue
                if payload is _EndOfStream:
                    return
                if isinstance(payload, BaseException):
                    raise payload
                batch, nxt = payload
                resume = (nxt, 0)
                obs_metrics.gauge("pipeline.queue_depth").set(q.qsize())
                yield self._adopt(batch), nxt
        finally:
            for p in spawned:
                p.close(q)
                self._producers.discard(p)
                self._queues.pop(p, None)


class _EndOfStream:
    """Sentinel type: end of a producer's stream (compared by identity)."""
