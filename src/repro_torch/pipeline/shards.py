"""On-disk ROO shard files + manifest (the pipeline's warm storage) —
torch port of ``repro/pipeline/shards.py``. It needs no torch: the shard
files and the manifest are byte for byte the reference's.

Layout of a shard directory::

    shards/
      manifest.json            # schema version, codec params, shard index
      shard_000000.roos        # columnar blob (data/storage.py codec)
      shard_000001.roos
      ...

Shards are written atomically (tmp + rename) in bounded request-count
chunks, so a crashed writer never leaves a torn shard visible, and the
manifest is only committed by ``close()`` — readers see either the previous
complete dataset or the new one. ``ShardInfo`` records real byte sizes and
RO-dedup pool stats per shard; benchmarks read those instead of modeled
byte counts.

The manifest's shard order IS the training data order: the prefetch loader
(pipeline/prefetch.py) iterates shards by manifest index, which is what
makes the ``(shard, offset)`` resume cursor deterministic.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.joiner import ROOSample
from repro_torch.data.storage import (SCHEMA_VERSION, ShardCorruptionError,
                                decode_roo_shard, encode_roo_shard,
                                peek_shard_header)
from repro_torch.obs import trace as obs_trace
from repro_torch.reliability import faults

MANIFEST_NAME = "manifest.json"


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    filename: str
    n_requests: int
    n_impressions: int
    n_bytes: int
    ro_pool_size: int   # unique RO payload rows stored (all 3 pools summed)

    @property
    def ro_dedup_saved(self) -> int:
        """RO payload rows the dedup pools avoided storing (3 components
        per request: ro_dense, ro_idlist, history)."""
        return 3 * self.n_requests - self.ro_pool_size


@dataclasses.dataclass(frozen=True)
class ShardManifest:
    schema_version: int
    label_keys: Tuple[str, ...]
    compress: bool
    shards: Tuple[ShardInfo, ...]
    # free-form record of what produced the shards (join/stream knobs);
    # consumers compare it against their requested config so a reused
    # directory can't silently carry stale semantics
    provenance: dict = dataclasses.field(default_factory=dict)

    @property
    def n_requests(self) -> int:
        return sum(s.n_requests for s in self.shards)

    @property
    def n_impressions(self) -> int:
        return sum(s.n_impressions for s in self.shards)

    @property
    def n_bytes(self) -> int:
        return sum(s.n_bytes for s in self.shards)

    def to_json(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "label_keys": list(self.label_keys),
            "compress": self.compress,
            "shards": [dataclasses.asdict(s) for s in self.shards],
            "provenance": self.provenance,
        }

    @staticmethod
    def from_json(obj: dict) -> "ShardManifest":
        return ShardManifest(
            schema_version=int(obj["schema_version"]),
            label_keys=tuple(obj["label_keys"]),
            compress=bool(obj["compress"]),
            shards=tuple(ShardInfo(**s) for s in obj["shards"]),
            provenance=obj.get("provenance", {}))


class ShardWriter:
    """Append ROO samples; flushes a shard every ``requests_per_shard``.

    ``close()`` flushes the tail and atomically commits the manifest.
    """

    def __init__(self, out_dir: str, requests_per_shard: int = 512,
                 compress: bool = True,
                 label_keys: Sequence[str] = ("click", "view_sec"),
                 provenance: Optional[dict] = None):
        if requests_per_shard <= 0:
            raise ValueError("requests_per_shard must be positive")
        self.out_dir = out_dir
        self.requests_per_shard = requests_per_shard
        self.compress = compress
        self.label_keys = tuple(label_keys)
        self.provenance = dict(provenance or {})
        self._buffer: List[ROOSample] = []
        self._shards: List[ShardInfo] = []
        self._closed = False
        os.makedirs(out_dir, exist_ok=True)
        # sweep torn tmp files a killed writer left behind — they were
        # never committed (manifest can't reference them) and a restarted
        # writer regenerates those shard indices from scratch
        for name in os.listdir(out_dir):
            if name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(out_dir, name))
                except OSError:
                    pass

    def append(self, sample: ROOSample) -> None:
        assert not self._closed, "writer already closed"
        self._buffer.append(sample)
        if len(self._buffer) >= self.requests_per_shard:
            self._flush()

    def extend(self, samples: Iterable[ROOSample]) -> None:
        for s in samples:
            self.append(s)

    def _flush(self) -> None:
        if not self._buffer:
            return
        blob = encode_roo_shard(self._buffer, compress=self.compress,
                                label_keys=self.label_keys)
        header = peek_shard_header(blob)
        name = f"shard_{len(self._shards):06d}.roos"
        path = os.path.join(self.out_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        spec = faults.fire("shard.write")
        if spec is not None and spec.kind == "torn":
            # simulated kill between tmp write and rename: the tmp file
            # stays, the shard is never committed, the writer dies
            raise faults.InjectedFault(
                f"injected writer kill before committing {name}")
        os.rename(tmp, path)                       # atomic commit
        self._shards.append(ShardInfo(
            filename=name, n_requests=header["n_requests"],
            n_impressions=header["n_impressions"], n_bytes=len(blob),
            ro_pool_size=header["ro_pool_size"]))
        self._buffer = []

    def close(self) -> ShardManifest:
        self._flush()
        self._closed = True
        manifest = ShardManifest(
            schema_version=SCHEMA_VERSION, label_keys=self.label_keys,
            compress=self.compress, shards=tuple(self._shards),
            provenance=self.provenance)
        tmp = os.path.join(self.out_dir, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest.to_json(), f, indent=1, sort_keys=True)
        os.rename(tmp, os.path.join(self.out_dir, MANIFEST_NAME))
        return manifest


def write_samples(out_dir: str, samples: Iterable[ROOSample],
                  requests_per_shard: int = 512, compress: bool = True,
                  label_keys: Sequence[str] = ("click", "view_sec"),
                  provenance: Optional[dict] = None) -> ShardManifest:
    """One-shot convenience: write all samples and commit the manifest."""
    writer = ShardWriter(out_dir, requests_per_shard, compress, label_keys,
                         provenance=provenance)
    writer.extend(samples)
    return writer.close()


def load_manifest(shard_dir: str) -> ShardManifest:
    path = os.path.join(shard_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no shard manifest in {shard_dir}")
    with open(path) as f:
        manifest = ShardManifest.from_json(json.load(f))
    if manifest.schema_version > SCHEMA_VERSION:
        raise ValueError(
            f"manifest schema_version {manifest.schema_version} is newer "
            f"than supported {SCHEMA_VERSION}")
    return manifest


def read_shard(shard_dir: str, shard: ShardInfo) -> List[ROOSample]:
    """Read + decode one shard.

    Raises :class:`TransientFault`/``OSError`` for (possibly injected)
    transient I/O failures — retryable — and
    :class:`ShardCorruptionError` when the blob fails integrity checks
    (CRC mismatch, truncated frame) — NOT retryable; lenient readers
    (``ShardDataset``) quarantine the shard instead of crashing.
    """
    spec = faults.fire("shard.read")
    if spec is not None and spec.kind == "error":   # injected transient I/O
        raise faults.TransientFault(
            f"injected read error on {shard.filename}")
    with obs_trace.span("pipeline.read", shard=shard.filename,
                        bytes=shard.n_bytes):
        with open(os.path.join(shard_dir, shard.filename), "rb") as f:
            blob = f.read()
    if spec is not None and spec.kind == "corrupt":
        blob = faults.corrupt_bytes("shard.read", blob, spec)
    with obs_trace.span("pipeline.decode", shard=shard.filename):
        try:
            return decode_roo_shard(blob)
        except ShardCorruptionError as e:
            raise ShardCorruptionError(
                f"{shard.filename}: {e}") from e


def read_all(shard_dir: str,
             manifest: Optional[ShardManifest] = None) -> List[ROOSample]:
    manifest = manifest or load_manifest(shard_dir)
    out: List[ROOSample] = []
    for s in manifest.shards:
        out.extend(read_shard(shard_dir, s))
    return out
