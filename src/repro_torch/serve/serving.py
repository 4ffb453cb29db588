"""ROO inference (paper §2.2): ``ROOServer``, the front end over the
request-centric ``ScoringEngine`` (torch port of ``repro/serve/serving.py``).

A serving request is {user (RO) features, m candidate items} — one
ROOSample without labels. Scores come back aligned: one array per input
request, shape-aligned with that request's ``item_ids`` (empty for a
zero-impression request); oversize requests are split across batches and
reassembled. Flushes are shape-bucketed (serve/bucketing.py). With split
model entry points the user tower is memoized across repeat requests
(``cache_user_tower``; serve/user_cache.py). Incremental user-state serving
is the engine's ``state_store`` (serve/engine.py). ``bucketed=False``
pads every flush to the one shape (b_ro, b_nro).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.joiner import ROOSample
from repro_torch.serve.bucketing import BucketLadder
from repro_torch.serve.engine import EnginePolicy, EngineStats, ScoringEngine
from repro_torch.serve.user_cache import UserTowerCache

__all__ = ["ServeConfig", "ROOServer", "retrieval_scoring"]


@dataclasses.dataclass
class ServeConfig:
    b_ro: int = 64                 # max requests per batch (top bucket rung)
    b_nro: int = 512               # max impression slots per batch
    hist_len: int = 64
    # HSTU attention backend for inference (kernels/dispatch.py); None =
    # auto (the CUDA kernel on the card, torch-chunked on the CPU)
    attn_backend: Optional[str] = None
    bucketed: bool = True          # shape ladder vs a single fixed shape
    max_delay_ms: float = 2.0      # online admission deadline
    cache_user_tower: bool = False # needs user_fn + score_from_user
    cache_capacity: int = 4096


class ROOServer:
    """Request-aligned batched server around eager scoring functions.

    ``score_fn(params, batch) -> (B_NRO,) or (B_NRO, n_tasks)``; batches are
    placed on ``device`` (the card unless the caller asks for the CPU).
    Optionally pass the model's split entry points ``user_fn(params,
    batch)`` and ``score_from_user(params, batch, user)`` (e.g.
    ``gr_history_repr`` / ``gr_ranking_logits_from_history``) to enable the
    user-tower cache (``cfg.cache_user_tower=True``).
    ``cfg.attn_backend`` pins the HSTU attention backend for every batch.
    """

    def __init__(self, params, score_fn: Callable, cfg: ServeConfig,
                 user_fn: Optional[Callable] = None,
                 score_from_user: Optional[Callable] = None,
                 device="cuda"):
        self.cfg = cfg
        policy = EnginePolicy(max_requests=cfg.b_ro,
                              max_impressions=cfg.b_nro,
                              max_delay_ms=cfg.max_delay_ms,
                              hist_len=cfg.hist_len)
        ladder = (BucketLadder.geometric(
                      min_b_ro=min(4, cfg.b_ro), min_b_nro=min(32, cfg.b_nro),
                      max_b_ro=cfg.b_ro, max_b_nro=cfg.b_nro)
                  if cfg.bucketed else
                  BucketLadder.fixed(cfg.b_ro, cfg.b_nro))
        cache = (UserTowerCache(cfg.cache_capacity)
                 if cfg.cache_user_tower else None)
        self.engine = ScoringEngine(
            params, score_fn, policy=policy, ladder=ladder, user_fn=user_fn,
            score_from_user=score_from_user, cache=cache,
            attn_backend=cfg.attn_backend, device=device)

    @property
    def params(self):
        return self.engine.params

    @params.setter
    def params(self, new_params) -> None:
        """Weight refresh: swaps params and clears the user-tower cache."""
        self.engine.params = new_params

    @property
    def stats(self) -> EngineStats:
        return self.engine.stats

    @property
    def cache(self) -> Optional[UserTowerCache]:
        return self.engine.cache

    def score_requests(self, requests: List[ROOSample]) -> List[np.ndarray]:
        """Exactly ``len(requests)`` score arrays, each aligned with the
        corresponding ``request.item_ids`` (empty for zero impressions)."""
        return self.engine.score_requests(requests)

    def score_requests_iter(self, requests
                            ) -> Iterator[Tuple[int, np.ndarray]]:
        """Streaming variant: yields ``(request_index, scores)`` per batch —
        bulk scoring never holds the full result set host-side twice."""
        return self.engine.score_stream(requests)


def retrieval_scoring(user_repr: torch.Tensor, candidate_repr: torch.Tensor,
                      k: int = 100):
    """1-vs-N candidate scoring: (d,) x (N, d) -> top-k (scores, indices).
    One matvec — never a loop over candidates."""
    scores = candidate_repr @ user_repr
    return torch.topk(scores, k)
