"""Watermark-based online request join (the pipeline's ingest stage) —
torch port of ``repro/pipeline/joiner.py`` (numpy and the standard
library only).

The core Algorithm-1 joiner (``core/joiner.py``) closes a user's window
the moment the user issues a *new* request — correct for batch replay, but
an online ingest pipeline has to decide when labels are "complete enough"
without that signal (the next request may be hours away) and has to tolerate
slightly out-of-order event delivery. This joiner implements the standard
streaming answer:

  * windows are keyed by ``(user_id, request_id)`` — several requests from
    one user may be open at once (unlike Algorithm 1's one-per-user);
  * the **event-time watermark** is ``max_event_ts - watermark_lag_s``: the
    pipeline's promise that no event older than the watermark will arrive;
  * a window opened at ``t0`` closes when the watermark passes
    ``t0 + label_wait_s``. ``label_wait_s`` is the label-completeness vs
    freshness tradeoff: larger waits join more late conversions but emit
    staler training data (close lag is tracked per window);
  * conversions that arrive after their window closed (or that never match
    an open window) are **counted, not silently dropped** — JoinStats
    exposes the late fraction so the watermark/wait knobs can be tuned.

Emission order is deterministic: windows close in (deadline, user, request)
order, so the downstream shard files — and therefore the training batch
sequence and the resume cursor — are reproducible.

``process`` recognizes events by class, the port's ``data/events.py``
ones. An event of any other class (the reference's events among them)
raises ``TypeError``: the reference's joiner skips such an event without
a word, which would join an empty stream.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from repro_torch.core.joiner import (ROOSample, _RequestJoinRecord,
                                     record_to_sample)
from repro_torch.data.events import ConversionEvent, ImpressionEvent
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class OnlineJoinConfig:
    label_wait_s: float = 600.0       # wait this long (event time) for labels
    watermark_lag_s: float = 60.0     # allowed event lateness
    engagement_threshold: int = 64    # close early after this many feedbacks
    label_keys: Tuple[str, ...] = ("click", "view_sec")


@dataclasses.dataclass
class JoinStats:
    requests_emitted: int = 0
    impressions_emitted: int = 0
    conversions_joined: int = 0
    conversions_late: int = 0         # arrived after window close / no match
    close_lag_s_sum: float = 0.0      # freshness: emit time - window open

    @property
    def label_completeness(self) -> float:
        total = self.conversions_joined + self.conversions_late
        return self.conversions_joined / total if total else 1.0

    @property
    def mean_close_lag_s(self) -> float:
        return (self.close_lag_s_sum / self.requests_emitted
                if self.requests_emitted else 0.0)

    def snapshot(self) -> dict:
        out = dataclasses.asdict(self)
        out["label_completeness"] = round(self.label_completeness, 6)
        out["mean_close_lag_s"] = round(self.mean_close_lag_s, 6)
        return out


class WatermarkJoiner:
    """Streaming joiner with bounded-lateness windows.

    ``process(event)`` yields every ROOSample whose window the advancing
    watermark closed; ``finalize()`` drains the rest (end of stream).
    """

    def __init__(self, cfg: Optional[OnlineJoinConfig] = None):
        self.cfg = cfg or OnlineJoinConfig()
        self.stats = JoinStats()
        obs_metrics.register_stats("pipeline.join", self.stats)
        self._open: Dict[Tuple[int, int], _RequestJoinRecord] = {}
        self._deadlines: List[Tuple[float, int, int]] = []   # heap
        self._max_ts = float("-inf")

    # -- window close ---------------------------------------------------------
    def _emit(self, rec: _RequestJoinRecord, close_ts: float) -> ROOSample:
        sample = record_to_sample(rec, self.cfg.label_keys)
        self.stats.requests_emitted += 1
        self.stats.impressions_emitted += sample.num_impressions
        self.stats.close_lag_s_sum += max(0.0, close_ts - rec.open_ts)
        return sample

    def _advance_watermark(self, ts: float) -> Iterator[ROOSample]:
        self._max_ts = max(self._max_ts, ts)
        watermark = self._max_ts - self.cfg.watermark_lag_s
        while self._deadlines and self._deadlines[0][0] <= watermark:
            deadline, user_id, request_id = heapq.heappop(self._deadlines)
            rec = self._open.pop((user_id, request_id), None)
            if rec is not None:                 # may have closed early
                yield self._emit(rec, deadline)

    def _close_now(self, key: Tuple[int, int]) -> Iterator[ROOSample]:
        rec = self._open.pop(key, None)
        if rec is not None:                     # heap entry becomes stale
            yield self._emit(rec, self._max_ts)

    # -- event entry point ------------------------------------------------------
    def process(self, event) -> Iterator[ROOSample]:
        yield from self._advance_watermark(event.ts)
        if isinstance(event, ImpressionEvent):
            key = (event.user_id, event.request_id)
            rec = self._open.get(key)
            if rec is None:
                rec = _RequestJoinRecord(
                    user_id=event.user_id, request_id=event.request_id,
                    open_ts=event.ts, ro_dense=event.ro_dense,
                    ro_idlist=event.ro_idlist,
                    history_ids=event.history_ids,
                    history_actions=event.history_actions)
                self._open[key] = rec
                heapq.heappush(self._deadlines,
                               (event.ts + self.cfg.label_wait_s,
                                event.user_id, event.request_id))
            if event.item_id not in rec.item_dense:
                rec.impressions.append(event.item_id)
                rec.item_dense[event.item_id] = event.item_dense
                rec.item_idlist[event.item_id] = event.item_idlist
        elif isinstance(event, ConversionEvent):
            key = (event.user_id, event.request_id)
            rec = self._open.get(key)
            if rec is not None and event.item_id in rec.item_dense:
                acc = rec.conversions.setdefault(event.item_id, {})
                for k, v in event.labels.items():
                    acc[k] = max(acc.get(k, 0.0), float(v))
                rec.engagement_count += 1
                self.stats.conversions_joined += 1
                if rec.engagement_count >= self.cfg.engagement_threshold:
                    yield from self._close_now(key)
            else:
                self.stats.conversions_late += 1
        else:
            raise TypeError(
                f"WatermarkJoiner: {type(event).__module__}."
                f"{type(event).__qualname__} is not an event of "
                f"repro_torch.data.events")
        return

    def finalize(self) -> Iterator[ROOSample]:
        """End of stream: close remaining windows in deadline order."""
        while self._deadlines:
            deadline, user_id, request_id = heapq.heappop(self._deadlines)
            rec = self._open.pop((user_id, request_id), None)
            if rec is not None:
                yield self._emit(rec, min(deadline, self._max_ts)
                                 if self._max_ts > float("-inf")
                                 else deadline)

    def join(self, events: Iterable) -> List[ROOSample]:
        out: List[ROOSample] = []
        for ev in events:
            out.extend(self.process(ev))
        out.extend(self.finalize())
        return out
