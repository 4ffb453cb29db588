"""Synthetic impression/conversion event streams — a numpy-only copy of
``repro/data/events.py``, so the same seed gives the same stream.

Reproduces the *structure* of the paper's data (Fig. 1a / Fig. 2): users
issue requests; each request serves several impressions; feedback events
(conversions, view durations) arrive with delay during the feedback phase.

Labels are planted from a ground-truth logit model
``p(click) = sigmoid(<u*, i*> / sqrt(d) + b)`` over latent user/item vectors,
so downstream NE / Recall@K deltas between models are meaningful rather than
noise.

Impressions-per-request distributions mimic the paper's three products
(Fig. 2 — means in the 4–7 range, heavy tail):
  product_a: mean ~4.2   product_b: mean ~6.8   product_c: mean ~5.4
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np


@dataclasses.dataclass
class ImpressionEvent:
    ts: float
    user_id: int
    request_id: int
    item_id: int
    # item-side (NRO) payload
    item_dense: np.ndarray            # (n_item_dense,)
    item_idlist: List[int]            # item id-list feature (e.g. categories)
    # user-side (RO) payload — identical for every impression of the request;
    # impression-level logging stores it per event (this is the waste ROO removes)
    ro_dense: np.ndarray              # (n_ro_dense,)
    ro_idlist: List[int]              # e.g. user engaged-category ids
    history_ids: List[int]            # user history item ids
    history_actions: List[int]


@dataclasses.dataclass
class ConversionEvent:
    ts: float
    user_id: int
    request_id: int
    item_id: int
    labels: Dict[str, float]          # {"click":0/1, "view_sec": float}


PRODUCT_MIX = {
    # (geometric-ish pmf support 1..16, mean):
    "product_a": 4.2,
    "product_b": 6.8,
    "product_c": 5.4,
}


@dataclasses.dataclass
class EventStreamConfig:
    n_users: int = 200
    n_items: int = 5000
    n_requests: int = 1000
    product: str = "product_a"
    n_ro_dense: int = 16
    n_item_dense: int = 8
    hist_len_max: int = 64
    ro_idlist_max: int = 12
    item_idlist_max: int = 4
    latent_dim: int = 16
    feedback_delay_mean_s: float = 240.0   # conversions trail impressions
    # late-conversion tail: with probability ``late_fraction`` a conversion's
    # delay gets an extra exponential(late_delay_mean_s) draw — the heavy
    # tail that makes joiner watermark/label-wait behavior testable
    # (benchmarks/join_quality.py sweeps it). When 0.0 (default) NO extra
    # rng draws happen, so existing seeds produce bit-identical streams.
    late_fraction: float = 0.0
    late_delay_mean_s: float = 3600.0
    request_gap_s: float = 30.0
    hist_init_max: int = 0     # seed users with random-length prior histories
    item_zipf: float = 0.0     # >0: Zipf-like item popularity (hot heads)
    seed: int = 0


class EventSimulator:
    """Generates a time-ordered interleaved stream of impression and
    conversion events, tracking per-user history so RO features evolve."""

    def __init__(self, cfg: EventStreamConfig):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        d = cfg.latent_dim
        self.user_latent = self.rng.normal(size=(cfg.n_users, d)) / np.sqrt(d)
        self.item_latent = self.rng.normal(size=(cfg.n_items, d)) / np.sqrt(d)
        self.item_cats = self.rng.randint(1, 200, size=(cfg.n_items, cfg.item_idlist_max))
        self.user_hist: Dict[int, List[int]] = {}
        self.user_acts: Dict[int, List[int]] = {}
        for u in range(cfg.n_users):
            n0 = int(self.rng.randint(0, cfg.hist_init_max + 1))
            self.user_hist[u] = self.rng.randint(0, cfg.n_items, size=n0).tolist()
            self.user_acts[u] = self.rng.randint(0, 2, size=n0).tolist()

    def _n_impressions(self) -> int:
        mean = PRODUCT_MIX[self.cfg.product]
        # zero-truncated geometric-ish with the product's mean; cap at 16
        p = 1.0 / mean
        n = 1 + self.rng.geometric(p) - 1
        return int(np.clip(n, 1, 16))

    def _ro_payload(self, user_id: int):
        cfg = self.cfg
        u = self.user_latent[user_id]
        ro_dense = np.concatenate([
            u[: cfg.n_ro_dense] if cfg.n_ro_dense <= u.shape[0] else
            np.resize(u, cfg.n_ro_dense)
        ]).astype(np.float32)
        hist = self.user_hist[user_id][-cfg.hist_len_max:]
        acts = self.user_acts[user_id][-cfg.hist_len_max:]
        ro_idlist = list(
            (np.abs(self.rng.randint(1, 200, size=self.rng.randint(1, self.cfg.ro_idlist_max + 1)))).tolist()
        )
        return ro_dense, ro_idlist, list(hist), list(acts)

    def stream(self) -> Iterator[object]:
        """Yield events in ts order (heap-merge of impressions + feedback)."""
        cfg = self.cfg
        pending: List[object] = []
        ts = 0.0
        for req in range(cfg.n_requests):
            ts += self.rng.exponential(cfg.request_gap_s)
            user = int(self.rng.randint(cfg.n_users))
            n_imp = self._n_impressions()
            if cfg.item_zipf > 0:
                # Zipf-ish popularity: u^(1/(1-a)) rank sampling, hot head
                u = self.rng.rand(n_imp * 2)
                ranks = (u ** (1.0 / (1.0 - cfg.item_zipf))
                         * cfg.n_items).astype(np.int64) % cfg.n_items
                items = np.unique(ranks)[:n_imp]
                while items.shape[0] < n_imp:   # top-up on collision
                    extra = int(self.rng.rand() ** (1.0 / (1.0 - cfg.item_zipf))
                                * cfg.n_items) % cfg.n_items
                    if extra not in items:
                        items = np.append(items, extra)
            else:
                items = self.rng.choice(cfg.n_items, size=n_imp, replace=False)
            ro_dense, ro_idlist, hist, acts = self._ro_payload(user)
            for item in items:
                item = int(item)
                item_dense = np.resize(self.item_latent[item], cfg.n_item_dense).astype(np.float32)
                pending.append(ImpressionEvent(
                    ts=ts, user_id=user, request_id=req, item_id=item,
                    item_dense=item_dense,
                    item_idlist=self.item_cats[item].tolist(),
                    ro_dense=ro_dense, ro_idlist=ro_idlist,
                    history_ids=hist, history_actions=acts))
                # planted label model
                logit = float(self.user_latent[user] @ self.item_latent[item]) * 4.0 - 1.0
                click = int(self.rng.rand() < 1.0 / (1.0 + np.exp(-logit)))
                view = float(np.exp(self.rng.normal(2.0, 0.5))) if click else 0.0
                delay = self.rng.exponential(cfg.feedback_delay_mean_s)
                if cfg.late_fraction > 0.0 \
                        and self.rng.rand() < cfg.late_fraction:
                    delay += self.rng.exponential(cfg.late_delay_mean_s)
                pending.append(ConversionEvent(
                    ts=ts + delay, user_id=user, request_id=req, item_id=item,
                    labels={"click": float(click), "view_sec": view}))
                # evolve history with positive engagements
                if click:
                    self.user_hist[user].append(item)
                    self.user_acts[user].append(1)
                elif self.rng.rand() < 0.3:
                    self.user_hist[user].append(item)
                    self.user_acts[user].append(0)
        pending.sort(key=lambda e: e.ts)
        yield from pending
