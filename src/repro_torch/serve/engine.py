"""Micro-batching scoring engine — the request is the unit of work (torch
port of ``repro/serve/engine.py``).

  * **request-aligned scoring** — the batcher's ``BatchPlan`` maps every
    request to its contiguous slot range, so the engine returns exactly one
    score array per input request, shape-aligned with ``request.item_ids``
    (empty for zero-impression requests). Requests larger than the biggest
    batch are *split* across batches and reassembled, never truncated.
  * **adaptive micro-batching** — online traffic is admitted into a pending
    queue and flushed by a size-or-deadline policy (``EnginePolicy``); every
    flush is rounded up to a rung of a fixed shape ladder
    (serve/bucketing.py).
  * **failure isolation** — a batch whose forward raises resolves its
    requests to ``ScoreError`` values; a circuit breaker sheds work after
    consecutive failures.
  * **user-tower memoization** — with split model entry points
    (``user_fn`` + ``score_from_user``) and a ``cache``, the RO side is
    computed once per unique request payload and reused
    (serve/user_cache.py ``UserTowerCache``).
  * **incremental user state** — with an adapter's stateful hooks and a
    ``state_store``, each user's per-layer K/V cache persists across
    requests (``UserStateStore``): a repeat user costs O(new events), and
    every miss recomputes from empty through the same prefix path.

Batches are packed on the host and moved to ``device`` once; scores come
back to the host as float32 numpy arrays (a bf16 model's scores widened on
the host). User states and cached user-tower rows live on the host as numpy
(``repro_torch.host.host_copy``: a bf16 tensor as its bits, two bytes an
element, since numpy has no bfloat16); per batch, each state leaf is
stacked and copied to the card once, and copied back once, bit for bit.

Observability (``repro_torch.obs``) mirrors the reference: the engine
registers its ``snapshot`` as ``serve.engine``; in ``metrics`` mode each
online request's submit-to-result time lands in ``engine.request_ms``; in
``trace`` mode every admitted request gets a trace id that rides the
``engine.admit`` / ``engine.reassemble`` instants and the ``engine.flush``
> ``engine.bucket`` / ``engine.score`` spans. Each flush offers a telemetry
line (``serve.flush``). The ``engine.score`` fault site raises inside the
isolation boundary. ``ScoringEngine.from_scenario`` builds an engine from a
``ScenarioSpec`` (scenario/build.py).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import (Callable, Dict, Hashable, Iterable, Iterator, List,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.joiner import ROOSample
from repro_torch.data.batcher import BatchPlan, BatcherConfig, ROOBatcher
from repro_torch.host import BF16_BITS, device_copy, host_copy  # noqa: F401
from repro_torch.kernels.dispatch import use_backend
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.reliability import faults
from repro_torch.serve.adapter import ServeAdapter
from repro_torch.serve.bucketing import BucketLadder, BucketStats
from repro_torch.serve.user_cache import (StateProbe, UserStateStore,
                                          UserTowerCache, request_key)


class ScoreError:
    """Returned (never raised) in place of a score array when the engine
    could not score a request: its batch's forward failed, or the circuit
    breaker shed it. Callers check ``isinstance(x, ScoreError)``."""
    __slots__ = ("reason", "shed")

    def __init__(self, reason: str, shed: bool = False):
        self.reason = reason
        self.shed = shed

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ScoreError({self.reason!r}, shed={self.shed})"


@dataclasses.dataclass
class EnginePolicy:
    """Admission policy: a flush happens when the pending queue reaches
    ``max_requests`` requests or ``max_impressions`` impressions (size), or
    when the oldest pending request has waited ``max_delay_ms`` (deadline).

    Circuit breaker: after ``breaker_threshold`` CONSECUTIVE batch scoring
    failures the engine sheds incoming work (``ScoreError(shed=True)``) for
    ``breaker_cooldown_s``; the first batch after the cooldown is a
    half-open trial. ``breaker_threshold=0`` disables shedding."""
    max_requests: int = 64
    max_impressions: int = 512
    max_delay_ms: float = 2.0
    hist_len: int = 64
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 1.0


@dataclasses.dataclass
class EngineStats:
    n_requests: int = 0
    n_impressions: int = 0
    n_batches: int = 0
    n_split_requests: int = 0          # requests scored across >1 batch
    n_size_flushes: int = 0
    n_deadline_flushes: int = 0
    n_forced_flushes: int = 0
    n_full_cache_batches: int = 0      # batches whose user tower was skipped
    n_incremental_batches: int = 0     # batches scored via the state store
    n_failed_batches: int = 0          # forwards that raised (isolated)
    n_failed_requests: int = 0         # requests resolved to ScoreError
    n_shed_requests: int = 0           # requests shed by the open breaker
    n_breaker_opens: int = 0           # open transitions (incl. re-opens)
    buckets: BucketStats = dataclasses.field(default_factory=BucketStats)
    # counters may be read from monitoring threads; bare += loses updates
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def inc(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def record_bucket(self, spec) -> None:
        with self._lock:
            self.buckets.record(spec)

    def snapshot(self) -> dict:
        """Consistent point-in-time copy of every counter."""
        with self._lock:
            out = {f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)
                   if not f.name.startswith("_") and f.name != "buckets"}
            out["buckets"] = self.buckets.snapshot()
            return out


def split_oversize(sample: ROOSample, cap: int) -> List[ROOSample]:
    """Chunk a request with more than ``cap`` impressions into sub-requests
    sharing the RO payload; the engine scores each chunk and concatenates."""
    if sample.num_impressions <= cap:
        return [sample]
    return [
        dataclasses.replace(
            sample,
            item_ids=sample.item_ids[lo:lo + cap],
            item_dense=sample.item_dense[lo:lo + cap],
            item_idlist=sample.item_idlist[lo:lo + cap],
            labels=sample.labels[lo:lo + cap])
        for lo in range(0, sample.num_impressions, cap)
    ]


class ScoringEngine:
    """Request-aligned, cache-aware scoring around an eager model forward.

    The model halves come from a :class:`~repro_torch.serve.adapter.
    ServeAdapter` (``adapter=``) or from bare callables: ``score_fn(params,
    batch) -> (B_NRO,) | (B_NRO, n_tasks)`` is the fused forward; the split
    entry points ``user_fn(params, batch) -> (B_RO, ...)`` and
    ``score_from_user(params, batch, user)`` additionally enable the
    user-tower cache; an adapter with stateful hooks plus a ``state_store``
    routes every batch through the incremental path. Batches run on
    ``device``.

    Two front ends share one scoring core:
      * online:  ``submit`` / ``poll`` / ``flush`` / ``take``  (micro-batcher)
      * bulk:    ``score_stream`` (generator) / ``score_requests`` (list)
    """

    def __init__(self, params, score_fn: Optional[Callable] = None, *,
                 policy: Optional[EnginePolicy] = None,
                 ladder: Optional[BucketLadder] = None,
                 adapter: Optional[ServeAdapter] = None,
                 user_fn: Optional[Callable] = None,
                 score_from_user: Optional[Callable] = None,
                 cache: Optional[UserTowerCache] = None,
                 state_store: Optional[UserStateStore] = None,
                 attn_backend: Optional[str] = None,
                 device="cuda",
                 clock: Callable[[], float] = time.monotonic):
        if adapter is not None:
            score_fn = score_fn or adapter.score
            user_fn = user_fn or adapter.user_repr
            score_from_user = score_from_user or adapter.score_from_user
        if score_fn is None:
            raise ValueError("ScoringEngine needs score_fn or an adapter")
        if cache is not None and (user_fn is None or score_from_user is None):
            raise ValueError("user-tower cache requires the split entry "
                             "points user_fn and score_from_user")
        if state_store is not None:
            if adapter is None or not adapter.supports_incremental:
                raise ValueError(
                    "state_store requires an adapter with the stateful "
                    "hooks (init_user_state / score_from_state)")
            if cache is not None:
                raise ValueError("state_store and the user-tower cache are "
                                 "mutually exclusive")
        self._params = params
        self.policy = policy or EnginePolicy()
        if (state_store is not None
                and adapter.state_hist_len != self.policy.hist_len):
            raise ValueError(
                f"incremental serving needs the adapter state capacity "
                f"({adapter.state_hist_len}) to equal the batcher window "
                f"(policy.hist_len={self.policy.hist_len}) so 'prefix of "
                f"the effective history' is well defined")
        self.ladder = ladder or BucketLadder.geometric(
            max_b_ro=self.policy.max_requests,
            max_b_nro=self.policy.max_impressions)
        self.adapter = adapter
        self.cache = cache
        self.state_store = state_store
        self.attn_backend = attn_backend
        self.device = torch.device(device)
        self.clock = clock
        self.stats = EngineStats()
        self._score = score_fn
        self._user = user_fn
        self._from_user = score_from_user
        # param epoch versions every store entry; bumped on weight swap
        self._param_epoch = 0
        # host (numpy) copy of the adapter's empty user state, made once
        self._state_template = None
        # online micro-batcher state
        self._pending: List[Tuple[int, ROOSample]] = []
        self._pending_imps = 0
        self._oldest_ts: Optional[float] = None
        self._next_ticket = 0
        self._results: Dict[int, np.ndarray] = {}
        self._submit_ts: Dict[int, float] = {}
        obs_metrics.register_stats("serve.engine", self)
        # trailing score dims ((,) single-task, (n_tasks,) multi-task) from
        # the last scored batch — shapes empty results of zero-impression
        # requests
        self._score_tail: Tuple[int, ...] = ()
        # circuit breaker: consecutive batch failures + open-until deadline
        self._breaker_failures = 0
        self._breaker_open_until: Optional[float] = None

    @classmethod
    def from_scenario(cls, spec, params=None, rng_seed: int = 0,
                      clock: Optional[Callable[[], float]] = None,
                      device="cuda") -> "ScoringEngine":
        """Build an engine from a ScenarioSpec: the serve section sets the
        admission policy, ladder and stores, the knobs section pins the
        attention backend, and the arch's serving adapter
        (scenario/build.py) supplies the model halves. ``params=None``
        initializes fresh parameters from ``rng_seed``."""
        from repro_torch.scenario.build import engine_from_scenario
        return engine_from_scenario(spec, params=params, rng_seed=rng_seed,
                                    clock=clock, device=device)

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, new_params) -> None:
        # cached rows / user states were computed with the old params — a
        # weight refresh bumps the epoch and drops every stale-epoch entry,
        # so mixed-version scores are impossible
        self._params = new_params
        self._param_epoch += 1
        if self.cache is not None:
            self.cache.invalidate_epoch(self._param_epoch)
        if self.state_store is not None:
            self.state_store.invalidate_epoch(self._param_epoch)

    @property
    def param_epoch(self) -> int:
        """Monotone version of the served parameters (0 at construction,
        +1 per assignment to ``params``); stores key entries by it."""
        return self._param_epoch

    def snapshot(self) -> dict:
        """Whole-engine view for ``obs.snapshot()``: scoring counters,
        cache effectiveness, breaker state — one consistent read."""
        out = {"stats": self.stats.snapshot(),
               "pending_requests": len(self._pending),
               "param_epoch": self._param_epoch,
               "breaker": {"consecutive_failures": self._breaker_failures,
                           "open": self._breaker_open_until is not None}}
        if self.cache is not None:
            out["cache"] = self.cache.snapshot()
        if self.state_store is not None:
            out["state_store"] = self.state_store.snapshot()
        return out

    # ---- online front end ----------------------------------------------------
    def submit(self, request: ROOSample) -> int:
        """Admit one request; returns a ticket redeemable via ``take``."""
        ticket = self._next_ticket
        self._next_ticket += 1
        if not self._pending:
            self._oldest_ts = self.clock()
        self._pending.append((ticket, request))
        self._pending_imps += request.num_impressions
        if obs_metrics.metrics_enabled():
            self._submit_ts[ticket] = self.clock()
        return ticket

    def poll(self, now: Optional[float] = None) -> bool:
        """Flush if the admission policy triggers. Returns True if a batch
        was scored (results became available)."""
        if not self._pending:
            return False
        now = self.clock() if now is None else now
        if (len(self._pending) >= self.policy.max_requests
                or self._pending_imps >= self.policy.max_impressions):
            self.stats.inc("n_size_flushes")
        elif (now - self._oldest_ts) * 1e3 >= self.policy.max_delay_ms:
            self.stats.inc("n_deadline_flushes")
        else:
            return False
        self._drain()
        return True

    def flush(self) -> None:
        """Force-score everything pending regardless of policy."""
        if self._pending:
            self.stats.inc("n_forced_flushes")
            self._drain()

    def take(self, ticket: int) -> Optional[np.ndarray]:
        """Scores for a submitted request, or None if not yet flushed."""
        return self._results.pop(ticket, None)

    def _drain(self) -> None:
        pending, self._pending = self._pending, []
        self._pending_imps, self._oldest_ts = 0, None
        for ticket, scores in self._score_keyed(pending):
            self._results[ticket] = scores
            t0 = self._submit_ts.pop(ticket, None)
            if t0 is not None:
                obs_metrics.histogram("engine.request_ms").observe(
                    (self.clock() - t0) * 1e3)

    # ---- bulk front end ------------------------------------------------------
    def score_stream(self, requests: Iterable[ROOSample]
                     ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(request_index, scores)`` as batches complete."""
        yield from self._score_keyed(enumerate(requests))

    def score_requests(self, requests: Sequence[ROOSample]
                       ) -> List[np.ndarray]:
        """One score array per input request, aligned with that request's
        ``item_ids`` (empty array for zero-impression requests)."""
        out: List[Optional[np.ndarray]] = [None] * len(requests)
        for i, scores in self.score_stream(requests):
            out[i] = scores
        return out

    # ---- scoring core --------------------------------------------------------
    def _score_keyed(self, keyed: Iterable[Tuple[Hashable, ROOSample]]
                     ) -> Iterator[Tuple[Hashable, np.ndarray]]:
        """Split oversize requests, group into bucket-shaped flushes, score,
        reassemble per original key. Yields each key exactly once."""
        top = self.ladder.max_rung
        tracing = obs_trace.tracing_enabled()
        trace_ids: Dict[Hashable, int] = {}
        parts_needed: Dict[Hashable, int] = {}
        parts_got: Dict[Hashable, List[np.ndarray]] = {}
        group: List[Tuple[Hashable, ROOSample]] = []
        group_imps = 0
        # zero-impression requests never enter a batch; they resolve to an
        # empty array once the trailing score dims are known
        deferred_empty: List[Hashable] = []

        def reassemble(scored: Iterator[Tuple[Hashable, np.ndarray]]):
            for key, piece in scored:
                got = parts_got.setdefault(key, [])
                got.append(piece)
                if len(got) == parts_needed[key]:
                    del parts_got[key], parts_needed[key]
                    if tracing:
                        obs_trace.instant("engine.reassemble",
                                          trace_id=trace_ids.pop(key, None),
                                          parts=len(got))
                    errs = [p for p in got if isinstance(p, ScoreError)]
                    if errs:
                        # one bad piece poisons the request: a partial
                        # score array misaligned with item_ids is worse
                        # than an explicit error
                        hard = [e for e in errs if not e.shed]
                        err = hard[0] if hard else errs[0]
                        self.stats.inc("n_failed_requests" if hard
                                       else "n_shed_requests")
                        yield key, err
                        continue
                    yield key, (np.concatenate(got, axis=0)
                                if len(got) > 1 else got[0])

        def flush_empty():
            while deferred_empty:
                yield (deferred_empty.pop(),
                       np.zeros((0,) + self._score_tail, np.float32))

        for key, sample in keyed:
            self.stats.inc("n_requests")
            self.stats.inc("n_impressions", sample.num_impressions)
            if sample.num_impressions == 0:
                deferred_empty.append(key)
                continue
            if tracing:
                trace_ids[key] = obs_trace.new_trace_id()
                obs_trace.instant("engine.admit", trace_id=trace_ids[key],
                                  impressions=sample.num_impressions)
            parts = split_oversize(sample, top.b_nro)
            parts_needed[key] = len(parts)
            if len(parts) > 1:
                self.stats.inc("n_split_requests")
            for part in parts:
                n = part.num_impressions
                if group and (len(group) + 1 > top.b_ro
                              or group_imps + n > top.b_nro):
                    yield from reassemble(
                        self._score_group(group, trace_ids))
                    yield from flush_empty()
                    group, group_imps = [], 0
                group.append((key, part))
                group_imps += n
        if group:
            yield from reassemble(self._score_group(group, trace_ids))
        yield from flush_empty()
        if parts_needed:
            raise RuntimeError("engine bug: unreassembled request parts")

    def _score_group(self, group: List[Tuple[Hashable, ROOSample]],
                     trace_ids: Dict[Hashable, int]
                     ) -> Iterator[Tuple[Hashable, np.ndarray]]:
        """Score one flush-group at its bucket shape; yields (key, piece)
        for every request part via the batch plan's slot mapping."""
        n_imps = sum(s.num_impressions for _, s in group)
        with obs_trace.span("engine.flush", requests=len(group),
                            impressions=n_imps):
            with obs_trace.span("engine.bucket") as bspan:
                bucket = self.ladder.select(len(group), n_imps)
                bspan.set(b_ro=bucket.b_ro, b_nro=bucket.b_nro)
                self.stats.record_bucket(bucket)
                batcher = ROOBatcher(BatcherConfig(
                    b_ro=bucket.b_ro, b_nro=bucket.b_nro,
                    hist_len=self.policy.hist_len), device=self.device)
                samples = [s for _, s in group]
                plans = list(batcher.batches_with_plan(samples))
            for batch, plan in plans:
                if self._breaker_sheds():
                    for p in plan.requests:
                        yield (group[p.request_index][0],
                               ScoreError("shed: circuit breaker open",
                                          shed=True))
                    continue
                tids = {trace_ids.get(group[p.request_index][0])
                        for p in plan.requests} - {None}
                span = obs_trace.span("engine.score",
                                      rows=len(plan.requests),
                                      trace_ids=sorted(tids))
                try:
                    with span:
                        scores = self._score_batch(batch, samples, plan)
                except Exception as e:   # isolation boundary: batch != engine
                    self._breaker_record_failure()
                    self.stats.inc("n_failed_batches")
                    for p in plan.requests:
                        yield (group[p.request_index][0],
                               ScoreError(f"scoring failed: {e!r}"))
                    continue
                self._breaker_failures = 0
                self._breaker_open_until = None
                self.stats.inc("n_batches")
                for p in plan.requests:
                    if p.n_dropped:
                        raise RuntimeError(
                            "engine invariant violated: truncation inside a "
                            f"bucket-shaped batch ({p.n_dropped} dropped)")
                    yield (group[p.request_index][0],
                           scores[p.slot_start:p.slot_start + p.n_packed])
        obs_export.maybe_emit("serve.flush")

    # ---- circuit breaker -----------------------------------------------------
    def _breaker_sheds(self) -> bool:
        """True when the open breaker should shed the next batch; an expired
        cooldown admits the batch as a half-open trial."""
        if (self.policy.breaker_threshold <= 0
                or self._breaker_open_until is None):
            return False
        if self.clock() < self._breaker_open_until:
            return True
        self._breaker_open_until = None        # half-open: one trial batch
        return False

    def _breaker_record_failure(self) -> None:
        self._breaker_failures += 1
        if (self.policy.breaker_threshold > 0
                and self._breaker_failures >= self.policy.breaker_threshold):
            if self._breaker_open_until is None:
                self.stats.inc("n_breaker_opens")
            self._breaker_open_until = (self.clock()
                                        + self.policy.breaker_cooldown_s)

    def _score_batch(self, batch, samples: List[ROOSample],
                     plan: BatchPlan) -> np.ndarray:
        faults.maybe_fail("engine.score")   # injected forward failure
        with use_backend(self.attn_backend), torch.inference_mode():
            scores = self._score_batch_device(batch, samples, plan)
        out = scores.detach().to("cpu").float().numpy()
        self._score_tail = out.shape[1:]
        return out

    def _score_batch_device(self, batch, samples: List[ROOSample],
                            plan: BatchPlan) -> torch.Tensor:
        if self.state_store is not None:
            return self._score_batch_incremental(batch, samples, plan)
        if self.cache is None:
            return self._score(self.params, batch)
        # cache path: try to serve the whole RO side from cache; on any
        # miss compute the user tower once for the batch and backfill.
        epoch = self._param_epoch
        keys = {p.row: request_key(samples[p.request_index])
                for p in plan.requests}
        cached = {row: self.cache.get(k, epoch) for row, k in keys.items()}
        if cached and all(v is not None for v in cached.values()):
            any_row = next(iter(cached.values()))
            u_host = np.zeros((batch.b_ro,) + any_row.shape, any_row.dtype)
            for row, v in cached.items():
                u_host[row] = v
            user = device_copy(u_host, self.device)
            self.stats.inc("n_full_cache_batches")
        else:
            user = self._user(self.params, batch)
            u_host = host_copy(user)
            for row, k in keys.items():
                self.cache.put(k, u_host[row], epoch)
        return self._from_user(self.params, batch, user)

    def _score_batch_incremental(self, batch, samples: List[ROOSample],
                                 plan: BatchPlan) -> torch.Tensor:
        """Incremental path: probe the state store per row, extend each
        user's K/V state with only their uncached events, score, and write
        the refreshed per-row states back.

        Misses (unknown user / eviction / epoch change / prefix mismatch)
        probe as prefix 0 with an empty state, which makes them full
        recomputes through the same prefix kernel. The per-batch new-event
        budget ``n_new`` is the largest uncached count rounded up to a power
        of two and capped at the state capacity, so a batch has one of at
        most log2(capacity) + 1 row counts.
        """
        ad = self.adapter
        epoch = self._param_epoch
        cap = ad.state_hist_len
        probes = {p.row: self.state_store.probe(
            samples[p.request_index], epoch, cap) for p in plan.requests}
        for pr in probes.values():
            # the prefix kernel's contract, checked here on host ints so
            # that no device value is read back
            if not 0 <= pr.prefix_len <= pr.eff_len <= cap:
                raise RuntimeError(
                    f"engine invariant violated: prefix {pr.prefix_len}, "
                    f"history {pr.eff_len}, capacity {cap}")
        n_new_max = max([pr.eff_len - pr.prefix_len
                         for pr in probes.values()], default=1)
        n_new = 1
        while n_new < n_new_max:
            n_new *= 2
        n_new = min(n_new, cap)
        state = self._stack_states(probes, batch.b_ro)
        scores, new_state = ad.score_from_state(self.params, batch, state,
                                                n_new=n_new)
        self._put_states(samples, plan, probes, self._states_to_host(
            new_state), epoch)
        self.stats.inc("n_incremental_batches")
        return scores

    def _stack_states(self, probes: Dict[int, StateProbe], b_ro: int):
        """Stack each row's host state (the empty template for misses and
        padding rows) and copy each leaf to the card once. States are
        NamedTuples of arrays (e.g. ``GRUserState``)."""
        if self._state_template is None:
            self._state_template = self._states_to_host(
                self.adapter.init_user_state())
        template = self._state_template
        rows = [probes[r].state if r in probes and probes[r].state is not None
                else template for r in range(b_ro)]
        return template._make(device_copy(np.stack(leaves), self.device)
                              for leaves in zip(*rows))

    @staticmethod
    def _states_to_host(state):
        """The state record with each leaf copied to host numpy once."""
        return state._make(host_copy(leaf) for leaf in state)

    def _put_states(self, samples: List[ROOSample], plan: BatchPlan,
                    probes: Dict[int, StateProbe], new_host,
                    epoch: int) -> None:
        """Write each request's refreshed row state back to the store (a
        copy of its row, so the store never pins the batch arrays)."""
        for p in plan.requests:
            pr = probes[p.row]
            row_state = new_host._make(np.array(leaf[p.row])
                                       for leaf in new_host)
            self.state_store.put(samples[p.request_index].user_id, epoch,
                                 pr.eff_len, pr.digest, row_state)
