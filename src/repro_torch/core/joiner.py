"""Request-level event-feature joiner (the paper's Algorithm 1) — a
numpy-only copy of ``repro/core/joiner.py``, so the same event stream gives
the same samples.

  * join records keyed by (user_id, current request_id);
  * the join window closes on (a) the user issuing a NEW request id,
    (b) an engagement-count threshold, (c) a fixed-time timeout;
  * one copy of RO features per record; NRO features + labels per impression.

The impression-level baseline joiner and the ROO expansion adapter are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.data.events import ConversionEvent, ImpressionEvent


@dataclasses.dataclass
class ROOSample:
    """Request-level training sample (paper Table 2)."""
    request_id: int
    user_id: int
    ro_dense: np.ndarray
    ro_idlist: List[int]
    history_ids: List[int]
    history_actions: List[int]
    item_ids: List[int]
    item_dense: List[np.ndarray]
    item_idlist: List[List[int]]
    labels: List[Dict[str, float]]       # aligned with item_ids

    @property
    def num_impressions(self) -> int:
        return len(self.item_ids)


@dataclasses.dataclass
class _RequestJoinRecord:
    """Algorithm 1's RequestJoinRecord."""
    user_id: int
    request_id: int
    open_ts: float
    impressions: List[int] = dataclasses.field(default_factory=list)
    conversions: Dict[int, Dict[str, float]] = dataclasses.field(default_factory=dict)
    ro_dense: Optional[np.ndarray] = None
    ro_idlist: Optional[List[int]] = None
    history_ids: Optional[List[int]] = None
    history_actions: Optional[List[int]] = None
    item_dense: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    item_idlist: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    engagement_count: int = 0


def record_to_sample(rec: "_RequestJoinRecord",
                     label_keys: Tuple[str, ...]) -> ROOSample:
    """Close a join record into a ROOSample; missing feedback defaults
    every label key to 0.0."""
    items = list(rec.impressions)
    labels = []
    for it in items:
        lab = rec.conversions.get(it, {})
        labels.append({k: float(lab.get(k, 0.0)) for k in label_keys})
    return ROOSample(
        request_id=rec.request_id, user_id=rec.user_id,
        ro_dense=rec.ro_dense, ro_idlist=rec.ro_idlist,
        history_ids=rec.history_ids, history_actions=rec.history_actions,
        item_ids=items,
        item_dense=[rec.item_dense[i] for i in items],
        item_idlist=[rec.item_idlist[i] for i in items],
        labels=labels)


class RequestLevelJoiner:
    """Streaming request-level joiner (Algorithm 1).

    Default labels (no feedback observed before window close) are zeros.
    """

    def __init__(self, join_window_s: float = 960.0,
                 engagement_threshold: int = 64,
                 label_keys: Tuple[str, ...] = ("click", "view_sec")):
        self.join_window_s = join_window_s
        self.engagement_threshold = engagement_threshold
        self.label_keys = label_keys
        # joinKey = (user_id) -> current open record (Alg.1 keeps one per user)
        self._open: Dict[int, _RequestJoinRecord] = {}
        self.window_close_lag_s: List[float] = []   # §2.1.2 ATS measurement

    # -- window management -----------------------------------------------------
    def _close(self, rec: _RequestJoinRecord, now_ts: float) -> ROOSample:
        self.window_close_lag_s.append(max(0.0, now_ts - rec.open_ts))
        return record_to_sample(rec, self.label_keys)

    def _flush_if_needed(self, user_id: int, request_id: Optional[int],
                         ts: float) -> Iterator[ROOSample]:
        rec = self._open.get(user_id)
        if rec is None:
            return
        new_request = request_id is not None and request_id != rec.request_id
        over_engaged = rec.engagement_count >= self.engagement_threshold
        timed_out = (ts - rec.open_ts) >= self.join_window_s
        if new_request or over_engaged or timed_out:
            del self._open[user_id]
            yield self._close(rec, ts)

    def _flush_timeouts(self, ts: float) -> Iterator[ROOSample]:
        expired = [u for u, r in self._open.items()
                   if (ts - r.open_ts) >= self.join_window_s]
        for u in expired:
            rec = self._open.pop(u)
            yield self._close(rec, ts)

    # -- the Algorithm 1 entry point --------------------------------------------
    def process(self, event) -> Iterator[ROOSample]:
        ts = event.ts
        yield from self._flush_timeouts(ts)
        if isinstance(event, ImpressionEvent):
            yield from self._flush_if_needed(event.user_id, event.request_id, ts)
            rec = self._open.get(event.user_id)
            if rec is None:
                rec = _RequestJoinRecord(
                    user_id=event.user_id, request_id=event.request_id,
                    open_ts=ts, ro_dense=event.ro_dense,
                    ro_idlist=event.ro_idlist, history_ids=event.history_ids,
                    history_actions=event.history_actions)
                self._open[event.user_id] = rec
            if event.item_id not in rec.item_dense:
                rec.impressions.append(event.item_id)
                rec.item_dense[event.item_id] = event.item_dense
                rec.item_idlist[event.item_id] = event.item_idlist
        elif isinstance(event, ConversionEvent):
            rec = self._open.get(event.user_id)
            if rec is not None and rec.request_id == event.request_id \
                    and event.item_id in rec.item_dense:
                acc = rec.conversions.setdefault(event.item_id, {})
                for k, v in event.labels.items():
                    acc[k] = max(acc.get(k, 0.0), float(v))
                rec.engagement_count += 1
            # a late conversion (window already closed) is dropped
        return

    def finalize(self, ts: float = float("inf")) -> Iterator[ROOSample]:
        for u in list(self._open):
            rec = self._open.pop(u)
            yield self._close(rec, min(ts, rec.open_ts + self.join_window_s))

    def join(self, events: Iterable) -> List[ROOSample]:
        out: List[ROOSample] = []
        for ev in events:
            out.extend(self.process(ev))
        out.extend(self.finalize())
        return out
