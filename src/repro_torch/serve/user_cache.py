"""Serving-side per-user stores — ROO dedup applied to inference (§2.2);
numpy and hashlib only, a copy of ``repro/serve/user_cache.py`` whose
digests match the reference's byte for byte.

Two stores with one theme: everything user-side (RO) is recomputed far more
often than it changes, so memoize it across requests.

* :class:`UserTowerCache` — memoizes the user-tower *output*: RO-payload
  fingerprint -> user-repr row. A request whose features evolved gets a
  fresh entry (the payload is the key), so staleness is impossible by
  construction.
* :class:`UserStateStore` — persists the incremental serving *state*: per
  user, the HSTU K/V cache over their history prefix plus how many events it
  covers. A repeat request extends the state with only its new events
  (O(new events), not O(S)); the stored prefix digest detects divergence
  (history rewrite, window slide) and forces a clean full recompute.

Both stores version entries by **param epoch**: the engine bumps the epoch
on every weight swap and calls :meth:`invalidate_epoch`, so rows computed
under old parameters can never be served under new ones. Both mirror their
hit/miss/eviction counters into ``repro_torch.obs`` (``register_stats``), so
one ``obs.snapshot()`` covers cache effectiveness beside the engine's.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.joiner import ROOSample
from repro_torch.obs import metrics as obs_metrics

CacheKey = Tuple[int, bytes]


def request_key(sample: ROOSample) -> CacheKey:
    """Fingerprint of a request's RO payload. Two requests with identical
    user-side features map to the same key regardless of their candidates."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(sample.ro_dense, np.float32).tobytes())
    h.update(np.asarray(list(sample.ro_idlist or []), np.int64).tobytes())
    h.update(b"|")
    h.update(np.asarray(list(sample.history_ids or []), np.int64).tobytes())
    h.update(b"|")
    h.update(np.asarray(list(sample.history_actions or []), np.int64).tobytes())
    return (sample.user_id, h.digest())


def history_digest(ids: Sequence[int], actions: Sequence[int]) -> bytes:
    """Order-sensitive fingerprint of a history prefix (ids + actions) —
    what the state store compares to decide 'is the cached prefix still a
    prefix of this request's history'."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(list(ids), np.int64).tobytes())
    h.update(b"|")
    h.update(np.asarray(list(actions), np.int64).tobytes())
    return h.digest()


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "hit_rate": round(self.hit_rate, 6)}


class UserTowerCache:
    """LRU cache: (RO-payload fingerprint, param epoch) -> user-tower output
    row (numpy). ``epoch`` defaults to 0 for epoch-unaware callers; the
    engine passes its current param epoch and calls
    :meth:`invalidate_epoch` on every weight swap."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._data: "OrderedDict[Tuple[CacheKey, int], np.ndarray]" = \
            OrderedDict()
        self.stats = CacheStats()
        obs_metrics.register_stats("serve.user_cache", self)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: CacheKey) -> bool:
        return (key, 0) in self._data

    def get(self, key: CacheKey, epoch: int = 0) -> Optional[np.ndarray]:
        row = self._data.get((key, epoch))
        if row is None:
            self.stats.misses += 1
            return None
        self._data.move_to_end((key, epoch))
        self.stats.hits += 1
        return row

    def put(self, key: CacheKey, row: np.ndarray, epoch: int = 0) -> None:
        # copy: callers pass views into the full (b_ro, ...) batch output,
        # and a cached view would pin the whole batch array in memory
        self._data[(key, epoch)] = np.array(row, copy=True)
        self._data.move_to_end((key, epoch))
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.stats.evictions += 1

    def invalidate_epoch(self, current_epoch: int) -> int:
        """Drop every entry not computed under ``current_epoch`` (a weight
        refresh must not serve mixed-version scores). Returns the number
        dropped."""
        doomed = [k for k in self._data if k[1] != current_epoch]
        for k in doomed:
            del self._data[k]
        self.stats.invalidations += len(doomed)
        return len(doomed)

    def invalidate_user(self, user_id: int) -> int:
        """Drop every entry for a user (e.g. on a feature-store update that
        bypasses the request payload). Returns the number dropped."""
        doomed = [k for k in self._data if k[0][0] == user_id]
        for k in doomed:
            del self._data[k]
        self.stats.invalidations += len(doomed)
        return len(doomed)

    def clear(self) -> None:
        self._data.clear()

    def snapshot(self) -> dict:
        """obs mirror: size + capacity + hit/miss/eviction counters."""
        return {"size": len(self._data), "capacity": self.capacity,
                **self.stats.snapshot()}


# ---------------------------------------------------------------------------
# Incremental user state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StateStats(CacheStats):
    prefix_mismatches: int = 0     # stored prefix no longer matches history

    def snapshot(self) -> dict:
        out = super().snapshot()
        out["prefix_mismatches"] = self.prefix_mismatches
        return out


@dataclasses.dataclass
class _StateEntry:
    epoch: int
    length: int          # history events the state covers
    digest: bytes        # history_digest of those events
    state: Any           # per-user model state record (host numpy)


class StateProbe(NamedTuple):
    """Result of :meth:`UserStateStore.probe` for one request."""
    prefix_len: int            # usable cached events (0 on miss)
    state: Optional[Any]       # the cached state record, or None
    eff_len: int               # window-clipped history length of the request
    digest: bytes              # digest of the full effective history (for put)


class UserStateStore:
    """LRU store: user_id -> incremental serving state, versioned by param
    epoch and guarded by a history-prefix digest.

    The batcher keeps the most recent ``hist_cap`` events of a history
    (sliding window), so the *effective* history of a request is its last
    ``hist_cap`` events. A stored state is usable iff it was computed under
    the current param epoch AND the events it covers are still a prefix of
    the effective history (digest match). Anything else — unknown user,
    evicted entry, stale epoch, rewritten history, slid window — probes as a
    miss, and the engine recomputes from empty through the same prefix path
    (one fallback, no second code path).
    """

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._data: "OrderedDict[int, _StateEntry]" = OrderedDict()
        self.stats = StateStats()
        obs_metrics.register_stats("serve.user_state", self)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, user_id: int) -> bool:
        return user_id in self._data

    def probe(self, sample: ROOSample, epoch: int,
              hist_cap: int) -> StateProbe:
        """Look up the usable cached prefix for a request (see class doc)."""
        ids = list(sample.history_ids or [])[-hist_cap:]
        acts = list(sample.history_actions or [])[-hist_cap:]
        full_digest = history_digest(ids, acts)
        entry = self._data.get(sample.user_id)
        if entry is None:
            self.stats.misses += 1
            return StateProbe(0, None, len(ids), full_digest)
        if entry.epoch != epoch:
            del self._data[sample.user_id]
            self.stats.invalidations += 1
            self.stats.misses += 1
            return StateProbe(0, None, len(ids), full_digest)
        if (entry.length > len(ids)
                or history_digest(ids[:entry.length],
                                  acts[:entry.length]) != entry.digest):
            # history diverged from the cached prefix (rewrite or window
            # slide) — the state is unusable, drop it
            del self._data[sample.user_id]
            self.stats.prefix_mismatches += 1
            self.stats.misses += 1
            return StateProbe(0, None, len(ids), full_digest)
        self._data.move_to_end(sample.user_id)
        self.stats.hits += 1
        return StateProbe(entry.length, entry.state, len(ids), full_digest)

    def put(self, user_id: int, epoch: int, length: int, digest: bytes,
            state: Any) -> None:
        """Store a user's refreshed state (the caller passes host-side
        arrays; the store holds them as given — the engine copies row
        slices)."""
        self._data[user_id] = _StateEntry(epoch, length, digest, state)
        self._data.move_to_end(user_id)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.stats.evictions += 1

    def invalidate_epoch(self, current_epoch: int) -> int:
        """Drop every state not computed under ``current_epoch``."""
        doomed = [u for u, e in self._data.items()
                  if e.epoch != current_epoch]
        for u in doomed:
            del self._data[u]
        self.stats.invalidations += len(doomed)
        return len(doomed)

    def invalidate_user(self, user_id: int) -> int:
        if user_id in self._data:
            del self._data[user_id]
            self.stats.invalidations += 1
            return 1
        return 0

    def clear(self) -> None:
        self._data.clear()

    def snapshot(self) -> dict:
        """obs mirror: size + capacity + hit/miss/eviction/mismatch
        counters."""
        return {"size": len(self._data), "capacity": self.capacity,
                **self.stats.snapshot()}
