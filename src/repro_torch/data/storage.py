"""Columnar storage codec: byte accounting AND the on-disk shard format
(torch port of ``repro/data/storage.py``; numpy and the standard library
only). The encoder writes the reference's bytes — zlib level 6, the header
JSON with sorted keys, the same dtype codes and block order — so a shard
written by either package decodes in the other.

Two layers live here:

1. **Byte accounting** (`encode_impression_table` / `encode_roo_table` /
   `sample_volume_increase`) — models the paper's feature-flattened columnar
   warm storage (§2.1.1) to reproduce Table 4's *ratio* claim.

2. **Shard codec** (`encode_roo_shard` / `decode_roo_shard` and the
   impression-level counterparts) — the on-disk columnar format of the
   request-log pipeline (``pipeline/shards.py``). One shard blob is

       magic "ROOSHRD1" | u32 header_len | header JSON | column blocks

   where each column block is ``u32 name_len | name | u8 dtype | u8 flags |
   u64 raw_len | u64 stored_len | u32 crc32 | payload`` (flags bit 0 =
   zlib; the ``crc32`` field — over the stored payload — is new in schema
   v2 and absent from v1 blocks, which remain readable: the header's
   ``schema_version`` tells the reader which frame it is).

   **Corruption detection**: v2 readers verify every block's CRC before
   touching the payload and raise :class:`ShardCorruptionError` (also
   raised for truncated frames and undecompressible payloads), which the
   pipeline layer turns into per-shard quarantine instead of a training
   crash.

   RO payloads (ro_dense, ro_idlist, history) are stored **deduplicated**:
   a pool of unique payloads per component plus one ref int per request.
   Within a request this is the paper's native ROO dedup; across requests
   it also collapses repeated payloads from the same user.

   The codec is float32/int64-typed: encoding casts dense features and
   labels to float32 and ids to int64; decode returns exactly those dtypes.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.joiner import ImpressionSample, ROOSample

SCHEMA_VERSION = 2      # v2 = per-block CRC32; v1 frames remain readable
_MAGIC = b"ROOSHRD1"
_DTYPES = {0: np.int32, 1: np.int64, 2: np.float32}
_DTYPE_CODES = {np.dtype(np.int32): 0, np.dtype(np.int64): 1,
                np.dtype(np.float32): 2}


class ShardCorruptionError(ValueError):
    """A shard blob failed integrity checks (CRC mismatch, truncated frame,
    undecompressible payload). Lenient readers quarantine; strict raise."""


def _col_bytes(arrays: Sequence[np.ndarray], compress: bool) -> int:
    if not arrays:
        return 0
    flat = np.concatenate([np.asarray(a).ravel() for a in arrays])
    raw = flat.astype(np.float32).tobytes() if flat.dtype.kind == "f" \
        else flat.astype(np.int32).tobytes()
    # length prefixes for ragged reconstruction
    lens = np.asarray([np.asarray(a).size for a in arrays], np.int32).tobytes()
    blob = raw + lens
    return len(zlib.compress(blob, 6)) if compress else len(blob)


def encode_impression_table(samples: List[ImpressionSample],
                            compress: bool = True) -> Dict[str, int]:
    """Column-block byte sizes for an impression-level table (Table 1)."""
    cols = {
        "request_id": _col_bytes([np.asarray([s.request_id, s.user_id, s.item_id])
                                  for s in samples], compress),
        "labels": _col_bytes([np.asarray(list(s.labels.values()), np.float32)
                              for s in samples], compress),
        "ro_dense": _col_bytes([s.ro_dense for s in samples], compress),
        "ro_idlist": _col_bytes([np.asarray(s.ro_idlist, np.int32)
                                 for s in samples], compress),
        "history": _col_bytes([np.asarray(s.history_ids, np.int32)
                               for s in samples], compress)
                   + _col_bytes([np.asarray(s.history_actions, np.int32)
                                 for s in samples], compress),
        "item_dense": _col_bytes([s.item_dense for s in samples], compress),
        "item_idlist": _col_bytes([np.asarray(s.item_idlist, np.int32)
                                   for s in samples], compress),
    }
    cols["total"] = sum(v for k, v in cols.items() if k != "total")
    return cols


def encode_roo_table(samples: List[ROOSample],
                     compress: bool = True) -> Dict[str, int]:
    """Column-block byte sizes for a request-level table (Table 2)."""
    cols = {
        "request_id": _col_bytes([np.asarray([s.request_id, s.user_id])
                                  for s in samples], compress),
        "labels": _col_bytes([np.asarray([list(l.values()) for l in s.labels],
                                         np.float32) for s in samples], compress),
        "ro_dense": _col_bytes([s.ro_dense for s in samples], compress),
        "ro_idlist": _col_bytes([np.asarray(s.ro_idlist, np.int32)
                                 for s in samples], compress),
        "history": _col_bytes([np.asarray(s.history_ids, np.int32)
                               for s in samples], compress)
                   + _col_bytes([np.asarray(s.history_actions, np.int32)
                                 for s in samples], compress),
        "item_ids": _col_bytes([np.asarray(s.item_ids, np.int32)
                                for s in samples], compress),
        "item_dense": _col_bytes([np.concatenate([d.ravel() for d in s.item_dense])
                                  for s in samples], compress),
        "item_idlist": _col_bytes([np.concatenate(
            [np.asarray(l, np.int32).ravel() for l in s.item_idlist])
            for s in samples], compress),
    }
    cols["total"] = sum(v for k, v in cols.items() if k != "total")
    return cols


def sample_volume_increase(imp_samples: List[ImpressionSample],
                           roo_samples: List[ROOSample],
                           compress: bool = True) -> Dict[str, float]:
    """Paper Table 4: % more impressions storable in the same bytes.

    bytes/impression under each schema; increase = imp/roo - 1.
    """
    n_imp = len(imp_samples)
    n_roo_imp = sum(s.num_impressions for s in roo_samples)
    b_imp = encode_impression_table(imp_samples, compress)["total"]
    b_roo = encode_roo_table(roo_samples, compress)["total"]
    per_imp = b_imp / max(n_imp, 1)
    per_roo = b_roo / max(n_roo_imp, 1)
    return {
        "bytes_per_impression_impression_schema": per_imp,
        "bytes_per_impression_roo_schema": per_roo,
        "sample_volume_increase_pct": 100.0 * (per_imp / per_roo - 1.0),
    }


# ---------------------------------------------------------------------------
# Shard codec (real encode/decode; used by pipeline/shards.py)
# ---------------------------------------------------------------------------

def _write_block(parts: List[bytes], name: str, arr: np.ndarray,
                 compress: bool, crc: bool = True) -> None:
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES[arr.dtype]
    raw = arr.tobytes()
    flags = 0
    payload = raw
    if compress:
        z = zlib.compress(raw, 6)
        if len(z) < len(raw):
            payload, flags = z, 1
    nm = name.encode("utf-8")
    parts.append(struct.pack("<I", len(nm)))
    parts.append(nm)
    parts.append(struct.pack("<BBQQ", code, flags, len(raw), len(payload)))
    if crc:
        parts.append(struct.pack("<I", zlib.crc32(payload)))
    parts.append(payload)


def _read_blocks(blob: bytes, offset: int,
                 crc: bool = True) -> Dict[str, np.ndarray]:
    cols: Dict[str, np.ndarray] = {}
    n = len(blob)
    try:
        while offset < n:
            (nm_len,) = struct.unpack_from("<I", blob, offset)
            offset += 4
            name = blob[offset:offset + nm_len].decode("utf-8")
            offset += nm_len
            code, flags, raw_len, stored_len = struct.unpack_from(
                "<BBQQ", blob, offset)
            offset += struct.calcsize("<BBQQ")
            want_crc = None
            if crc:
                (want_crc,) = struct.unpack_from("<I", blob, offset)
                offset += 4
            payload = blob[offset:offset + stored_len]
            offset += stored_len
            if len(payload) != stored_len:
                raise ShardCorruptionError(
                    f"shard column {name!r}: truncated payload")
            if want_crc is not None and zlib.crc32(payload) != want_crc:
                raise ShardCorruptionError(
                    f"shard column {name!r}: CRC32 mismatch (stored "
                    f"{want_crc:#010x}, computed {zlib.crc32(payload):#010x})")
            raw = zlib.decompress(payload) if flags & 1 else payload
            if len(raw) != raw_len:
                raise ShardCorruptionError(
                    f"shard column {name!r}: raw length mismatch")
            cols[name] = np.frombuffer(raw, dtype=_DTYPES[code]).copy()
    except (struct.error, UnicodeDecodeError, zlib.error, KeyError) as e:
        # truncated frame / garbage name / undecompressible payload / bad
        # dtype code — all shapes a bit-flip takes in a v1 (no-CRC) block
        raise ShardCorruptionError(f"shard frame unreadable: {e}") from e
    return cols


def _frame(header: Dict, parts: List[bytes]) -> bytes:
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    return b"".join([_MAGIC, struct.pack("<I", len(hdr)), hdr] + parts)


def peek_shard_header(blob: bytes) -> Dict:
    """Parse just the header JSON (schema checks, manifest stats)."""
    if blob[:8] != _MAGIC:
        raise ShardCorruptionError("not a ROO shard (bad magic)")
    try:
        (hdr_len,) = struct.unpack_from("<I", blob, 8)
        return json.loads(blob[12:12 + hdr_len].decode("utf-8"))
    except (struct.error, UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ShardCorruptionError(f"shard header unreadable: {e}") from e


def _decode_body(blob: bytes) -> Tuple[Dict, Dict[str, np.ndarray]]:
    header = peek_shard_header(blob)
    (hdr_len,) = struct.unpack_from("<I", blob, 8)
    if header.get("schema_version", 0) > SCHEMA_VERSION:
        raise ValueError(
            f"shard schema_version {header['schema_version']} is newer than "
            f"supported {SCHEMA_VERSION}")
    # v1 blocks carry no CRC field; v2+ blocks are verified before use
    has_crc = header.get("schema_version", 0) >= 2
    return header, _read_blocks(blob, 12 + hdr_len, crc=has_crc)


def _ragged(values_by_row: Sequence[np.ndarray], dtype) -> Tuple[np.ndarray,
                                                                 np.ndarray]:
    lens = np.asarray([np.asarray(v).size for v in values_by_row], np.int32)
    if values_by_row:
        vals = np.concatenate(
            [np.asarray(v, dtype).ravel() for v in values_by_row]) \
            if lens.sum() else np.zeros((0,), dtype)
    else:
        vals = np.zeros((0,), dtype)
    return vals, lens


def _split_ragged(vals: np.ndarray, lens: np.ndarray) -> List[np.ndarray]:
    return np.split(vals, np.cumsum(lens)[:-1]) if lens.size else []


def _infer_label_keys(labels: Sequence[Dict[str, float]]) -> Tuple[str, ...]:
    for lab in labels:
        if lab:
            return tuple(lab.keys())
    return ()


class _Pool:
    """Dedup pool for one RO payload component: unique rows + per-row refs.

    A "row" is a tuple of parallel arrays (1 for ro_dense/ro_idlist, 2 for
    the history ids/acts pair); identity is the length-prefixed
    concatenation of the components, so ([1],[2,3]) and ([1,2],[3]) never
    collide.
    """

    def __init__(self):
        self.index: Dict[bytes, int] = {}
        self.rows: List[Tuple[np.ndarray, ...]] = []
        self.refs: List[int] = []

    def add(self, *row: np.ndarray) -> None:
        key = b"".join(struct.pack("<Q", a.nbytes) + a.tobytes()
                       for a in row)
        ref = self.index.get(key)
        if ref is None:
            ref = len(self.rows)
            self.index[key] = ref
            self.rows.append(row)
        self.refs.append(ref)

    def column(self, i: int) -> List[np.ndarray]:
        return [row[i] for row in self.rows]


def encode_roo_shard(samples: Sequence[ROOSample], compress: bool = True,
                     label_keys: Optional[Sequence[str]] = None,
                     crc: bool = True) -> bytes:
    """Serialize ROO samples into one columnar shard blob (schema v2).

    RO payloads are pooled **per component** (ro_dense / ro_idlist /
    history): identical rows are stored once, each request keeps int refs.
    Component-wise pooling is what pays off across requests — a user's
    ro_dense is stable and their history only changes on engagement, so
    consecutive requests share pool entries even when another component
    (e.g. a fast-moving id-list) differs.

    ``crc=False`` writes the legacy v1 frame (no per-block CRC32) — kept so
    the v1-compatibility path stays testable.
    """
    if label_keys is None:
        label_keys = _infer_label_keys(
            [l for s in samples for l in s.labels]) or ("click", "view_sec")
    label_keys = tuple(label_keys)

    dense_pool, idlist_pool, hist_pool = _Pool(), _Pool(), _Pool()
    for s in samples:
        dense_pool.add(np.asarray(s.ro_dense, np.float32).ravel())
        idlist_pool.add(np.asarray(s.ro_idlist, np.int64))
        hist_pool.add(np.asarray(s.history_ids, np.int64),
                      np.asarray(s.history_actions, np.int64))

    total_imp = sum(s.num_impressions for s in samples)
    labels = np.zeros((total_imp, max(len(label_keys), 1)), np.float32)
    row = 0
    item_dense_rows: List[np.ndarray] = []
    item_idlist_rows: List[np.ndarray] = []
    item_ids: List[int] = []
    for s in samples:
        for j in range(s.num_impressions):
            item_ids.append(int(s.item_ids[j]))
            item_dense_rows.append(np.asarray(s.item_dense[j], np.float32))
            item_idlist_rows.append(np.asarray(s.item_idlist[j], np.int64))
            for k, key in enumerate(label_keys):
                labels[row, k] = float(s.labels[j].get(key, 0.0))
            row += 1

    parts: List[bytes] = []

    def wb(name: str, arr: np.ndarray) -> None:
        _write_block(parts, name, arr, compress, crc=crc)

    wb("request_id", np.asarray([s.request_id for s in samples], np.int64))
    wb("user_id", np.asarray([s.user_id for s in samples], np.int64))
    wb("num_impressions",
       np.asarray([s.num_impressions for s in samples], np.int32))
    wb("ro_dense_ref", np.asarray(dense_pool.refs, np.int32))
    wb("ro_idlist_ref", np.asarray(idlist_pool.refs, np.int32))
    wb("history_ref", np.asarray(hist_pool.refs, np.int32))
    for name, rows, dtype in (
            ("pool_ro_dense", dense_pool.column(0), np.float32),
            ("pool_ro_idlist", idlist_pool.column(0), np.int64),
            ("pool_hist_ids", hist_pool.column(0), np.int64),
            ("pool_hist_acts", hist_pool.column(1), np.int64),
            ("item_dense", item_dense_rows, np.float32),
            ("item_idlist", item_idlist_rows, np.int64)):
        vals, lens = _ragged(rows, dtype)
        wb(name + "_vals", vals)
        wb(name + "_lens", lens)
    wb("item_ids", np.asarray(item_ids, np.int64))
    wb("labels", labels.ravel())

    pool_sizes = {"ro_dense": len(dense_pool.rows),
                  "ro_idlist": len(idlist_pool.rows),
                  "history": len(hist_pool.rows)}
    header = {
        "schema": "roo", "schema_version": SCHEMA_VERSION if crc else 1,
        "n_requests": len(samples), "n_impressions": total_imp,
        "pool_sizes": pool_sizes,
        "ro_pool_size": sum(pool_sizes.values()),
        "label_keys": list(label_keys),
        "compress": bool(compress),
    }
    return _frame(header, parts)


def decode_roo_shard(blob: bytes) -> List[ROOSample]:
    """Inverse of :func:`encode_roo_shard` (exact at codec dtypes)."""
    header, cols = _decode_body(blob)
    if header.get("schema") != "roo":
        raise ValueError(f"expected roo shard, got {header.get('schema')!r}")
    label_keys = tuple(header["label_keys"])
    n = header["n_requests"]

    pools = {}
    for name in ("pool_ro_dense", "pool_ro_idlist", "pool_hist_ids",
                 "pool_hist_acts", "item_dense", "item_idlist"):
        pools[name] = _split_ragged(cols[name + "_vals"],
                                    cols[name + "_lens"])
    num_imp = cols["num_impressions"]
    labels = cols["labels"].reshape(-1, max(len(label_keys), 1))
    item_ids = cols["item_ids"]
    imp_offsets = np.concatenate([[0], np.cumsum(num_imp)])

    out: List[ROOSample] = []
    for i in range(n):
        dref = int(cols["ro_dense_ref"][i])
        iref = int(cols["ro_idlist_ref"][i])
        href = int(cols["history_ref"][i])
        lo, hi = int(imp_offsets[i]), int(imp_offsets[i + 1])
        out.append(ROOSample(
            request_id=int(cols["request_id"][i]),
            user_id=int(cols["user_id"][i]),
            ro_dense=pools["pool_ro_dense"][dref].astype(np.float32),
            ro_idlist=[int(x) for x in pools["pool_ro_idlist"][iref]],
            history_ids=[int(x) for x in pools["pool_hist_ids"][href]],
            history_actions=[int(x) for x in pools["pool_hist_acts"][href]],
            item_ids=[int(x) for x in item_ids[lo:hi]],
            item_dense=[pools["item_dense"][j].astype(np.float32)
                        for j in range(lo, hi)],
            item_idlist=[[int(x) for x in pools["item_idlist"][j]]
                         for j in range(lo, hi)],
            labels=[{k: float(labels[j, c])
                     for c, k in enumerate(label_keys)}
                    for j in range(lo, hi)]))
    return out


def encode_impression_shard(samples: Sequence[ImpressionSample],
                            compress: bool = True,
                            label_keys: Optional[Sequence[str]] = None,
                            crc: bool = True) -> bytes:
    """Impression-level (Table 1) shard: RO features duplicated per row.

    This is the established-practice baseline the pipeline benchmark
    compares real on-disk bytes against; no dedup pool on purpose.
    """
    if label_keys is None:
        label_keys = _infer_label_keys([s.labels for s in samples]) \
            or ("click", "view_sec")
    label_keys = tuple(label_keys)
    n = len(samples)
    labels = np.zeros((n, max(len(label_keys), 1)), np.float32)
    for i, s in enumerate(samples):
        for k, key in enumerate(label_keys):
            labels[i, k] = float(s.labels.get(key, 0.0))

    parts: List[bytes] = []

    def wb(name: str, arr: np.ndarray) -> None:
        _write_block(parts, name, arr, compress, crc=crc)

    wb("request_id", np.asarray([s.request_id for s in samples], np.int64))
    wb("user_id", np.asarray([s.user_id for s in samples], np.int64))
    wb("item_id", np.asarray([s.item_id for s in samples], np.int64))
    for name, rows, dtype in (
            ("ro_dense", [s.ro_dense for s in samples], np.float32),
            ("ro_idlist", [np.asarray(s.ro_idlist, np.int64)
                           for s in samples], np.int64),
            ("hist_ids", [np.asarray(s.history_ids, np.int64)
                          for s in samples], np.int64),
            ("hist_acts", [np.asarray(s.history_actions, np.int64)
                           for s in samples], np.int64),
            ("item_dense", [s.item_dense for s in samples], np.float32),
            ("item_idlist", [np.asarray(s.item_idlist, np.int64)
                             for s in samples], np.int64)):
        vals, lens = _ragged(rows, dtype)
        wb(name + "_vals", vals)
        wb(name + "_lens", lens)
    wb("labels", labels.ravel())

    header = {
        "schema": "impression",
        "schema_version": SCHEMA_VERSION if crc else 1,
        "n_rows": n, "label_keys": list(label_keys),
        "compress": bool(compress),
    }
    return _frame(header, parts)


def decode_impression_shard(blob: bytes) -> List[ImpressionSample]:
    header, cols = _decode_body(blob)
    if header.get("schema") != "impression":
        raise ValueError(
            f"expected impression shard, got {header.get('schema')!r}")
    label_keys = tuple(header["label_keys"])
    n = header["n_rows"]
    labels = cols["labels"].reshape(-1, max(len(label_keys), 1))
    ragged = {name: _split_ragged(cols[name + "_vals"], cols[name + "_lens"])
              for name in ("ro_dense", "ro_idlist", "hist_ids", "hist_acts",
                           "item_dense", "item_idlist")}
    out: List[ImpressionSample] = []
    for i in range(n):
        out.append(ImpressionSample(
            request_id=int(cols["request_id"][i]),
            user_id=int(cols["user_id"][i]),
            item_id=int(cols["item_id"][i]),
            labels={k: float(labels[i, c])
                    for c, k in enumerate(label_keys)},
            ro_dense=ragged["ro_dense"][i].astype(np.float32),
            ro_idlist=[int(x) for x in ragged["ro_idlist"][i]],
            history_ids=[int(x) for x in ragged["hist_ids"][i]],
            history_actions=[int(x) for x in ragged["hist_acts"][i]],
            item_dense=ragged["item_dense"][i].astype(np.float32),
            item_idlist=[int(x) for x in ragged["item_idlist"][i]]))
    return out
