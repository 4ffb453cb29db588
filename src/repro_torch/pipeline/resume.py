"""Deterministic (shard, offset) resume: cursor persistence + Trainer
wiring (torch port of ``repro/pipeline/resume.py``).

``Trainer.run`` has a fast-forward contract: ``batch_iter_fn(start_step)``
must yield batches *from that step on*. With in-memory data that's a modulo
index; with a disk-backed prefetching stream the loader needs a ``Cursor``
for the checkpointed step. ``PipelineDataSource`` provides both halves:

  * ``batch_iter_fn(start_step)`` — looks the step's cursor up in the
    ``CursorStore`` (falling back to replaying the deterministic stream
    from the start when no cursor was persisted) and streams from there,
    remembering step -> next-cursor for every batch it hands out;
  * ``on_checkpoint(step)`` — persists the cursor for ``step`` atomically,
    called by ``Trainer.run`` right where it commits the model checkpoint.

Because the batch stream is a pure function of (manifest, BatcherConfig),
a restart resumes with **bit-identical** batches, prefetch on or off: a
killed and resumed run ends with the uninterrupted run's params.

Cursor files are the reference's (``cursor_<step>.json``: epoch, shard,
batch and the fingerprint), and so is :func:`dataset_fingerprint`, so a
cursor written by either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterator, Optional

from repro_torch.pipeline.prefetch import (Cursor, PrefetchLoader,
                                          ShardDataset)


def dataset_fingerprint(dataset: ShardDataset) -> str:
    """Hash of (BatcherConfig, manifest shard index): a cursor is only
    meaningful against the exact batch stream it was saved from."""
    cfg = dataclasses.asdict(dataset.batcher_cfg)
    shards = [[s.filename, s.n_bytes, s.n_requests, s.n_impressions]
              for s in dataset.manifest.shards]
    blob = json.dumps([cfg, shards], sort_keys=True, default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]


class CursorStore:
    """step -> Cursor persistence (one tiny JSON per checkpointed step).

    ``keep_last`` bounds the directory like CheckpointManager's retention
    (keep it >= the checkpoint manager's keep_last so every restorable
    model checkpoint still has its cursor).
    """

    def __init__(self, directory: str, keep_last: int = 8):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"cursor_{step:012d}.json")

    def save(self, step: int, cursor: Cursor,
             fingerprint: Optional[str] = None) -> None:
        obj = cursor.to_json()
        if fingerprint is not None:
            obj["fingerprint"] = fingerprint
        tmp = self._path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.rename(tmp, self._path(step))           # atomic commit
        for old in self.steps()[:-self.keep_last]:
            os.remove(self._path(old))

    def load(self, step: int,
             fingerprint: Optional[str] = None) -> Optional[Cursor]:
        path = self._path(step)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            obj = json.load(f)
        stored = obj.get("fingerprint")
        if fingerprint is not None and stored is not None \
                and stored != fingerprint:
            raise ValueError(
                f"cursor for step {step} was saved against a different "
                f"batch stream (fingerprint {stored} != {fingerprint}): "
                f"shards or batcher config changed — resume would misalign")
        return Cursor.from_json(obj)

    def steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("cursor_") and name.endswith(".json"):
                out.append(int(name[len("cursor_"):-len(".json")]))
        return sorted(out)


class PipelineDataSource:
    """Adapts a PrefetchLoader to Trainer.run's fast-forward contract.

    ``fingerprint`` overrides what cursors are keyed on — scenario-driven
    runs pass ``scenario.build.cursor_fingerprint(spec, manifest)`` so the
    cursor is provably tied to the spec's data/batcher sections; the
    default is the legacy (BatcherConfig, manifest) hash."""

    def __init__(self, loader: PrefetchLoader, store: CursorStore,
                 fingerprint: Optional[str] = None):
        self.loader = loader
        self.store = store
        self._fingerprint = fingerprint or dataset_fingerprint(loader.dataset)
        self._pending: Dict[int, Cursor] = {}      # step -> resume cursor

    def close(self) -> None:
        """Shut down the underlying loader (joins producer threads)."""
        self.loader.close()

    def __enter__(self) -> "PipelineDataSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- Trainer.run(batch_iter_fn=...) -----------------------------------------
    def batch_iter_fn(self, start_step: int) -> Iterator:
        cursor = Cursor()
        skip = 0
        if start_step > 0:
            saved = self.store.load(start_step,
                                    fingerprint=self._fingerprint)
            if saved is not None:
                cursor = saved
            else:
                # no cursor persisted for this step (e.g. checkpoint cadence
                # mismatch): replay the deterministic stream from the top,
                # skipping host-side (no device transfer for dropped batches)
                skip = start_step

        def gen():
            step = start_step
            for batch, nxt in self.loader.batches(cursor, skip_batches=skip):
                self._pending[step + 1] = nxt
                self._pending.pop(step - 1, None)  # keep the map bounded
                yield batch
                step += 1
        return gen()

    # -- Trainer.run(on_checkpoint=...) -----------------------------------------
    def on_checkpoint(self, step: int) -> None:
        cursor = self._pending.get(step)
        if cursor is not None:
            self.store.save(step, cursor, fingerprint=self._fingerprint)


def make_data_source(shard_dir: str, batcher_cfg, cursor_dir: str,
                     prefetch: bool = True, prefetch_depth: int = 3,
                     device="cuda", strict: bool = False,
                     fingerprint: Optional[str] = None,
                     **loader_kwargs) -> PipelineDataSource:
    """Convenience: shard dir + batcher config -> ready-to-run data source.

    ``device`` is forwarded to PrefetchLoader, whose thread places batches
    there (``sharding=``, in ``loader_kwargs``, first cuts each to this
    rank's block under an SPMD plan). ``strict`` turns
    corrupt-shard quarantine into a hard error; ``fingerprint`` keys the
    cursor store (scenario provenance hash) instead of the legacy dataset
    hash; remaining keyword args reach PrefetchLoader (retry/backoff/
    watchdog knobs).
    """
    loader = PrefetchLoader(ShardDataset(shard_dir, batcher_cfg,
                                         strict=strict),
                            prefetch=prefetch, prefetch_depth=prefetch_depth,
                            device=device, **loader_kwargs)
    return PipelineDataSource(loader, CursorStore(cursor_dir),
                              fingerprint=fingerprint)
