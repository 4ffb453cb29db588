"""ROO mini-batch packing — torch port of ``repro/data/batcher.py``.

Packs a list of ROOSamples into fixed-shape ``ROOBatch``es on the host in
numpy, then moves each packed batch to the requested device in one step:
  * ``B_RO`` request rows, ``B_NRO`` impression slots (static capacities);
  * requests are packed greedily, in order, shard by shard: with
    ``n_shards`` data shards each shard's block of B_RO / n rows and
    B_NRO / n slots is filled in turn, so when a batch is split over the
    data ranks every request's impressions sit in its request's block (the
    request-locality ``fanout_local`` and ``spmd.place_batch`` rely on);
    every request's impressions take contiguous slots;
  * ``segment_ids`` are global (default) or shard-local
    (``local_segment_ids``: padding is the local B_RO / n);
  * ``batches_with_plan`` also yields a ``BatchPlan`` mapping every input
    request to its (row, slot range) — what serving needs to return scores
    aligned with each request's ``item_ids`` — and counts impressions
    dropped by truncation.

Dropped impressions are always counted in the ungated
``batcher.impressions_dropped`` obs counter. ``impression_batches`` packs
impression samples as degenerate ROO batches (one impression a request):
the paper's impression-level baseline on the same model code.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.joiner import ImpressionSample, ROOSample
from repro_torch.core.roo_batch import ROOBatch
from repro_torch.data.jagged import JaggedTensor, KeyedJagged
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class BatcherConfig:
    b_ro: int = 64                 # requests per batch
    b_nro: int = 512               # impression slots per batch
    hist_len: int = 64
    ro_idlist_capacity: int = 1024
    item_idlist_capacity: int = 4096
    n_shards: int = 1              # data shards; leading dims divisible by it
    local_segment_ids: bool = False
    label_keys: Sequence[str] = ("click", "view_sec")


@dataclasses.dataclass(frozen=True)
class PackedRequest:
    """Where one input request landed inside a packed ROOBatch; its
    impressions occupy contiguous NRO slots
    ``slot_start .. slot_start + n_packed``."""
    request_index: int        # index into the samples passed to batches()
    row: int                  # RO row in the batch
    slot_start: int           # first NRO slot
    n_packed: int             # impressions packed into this batch
    n_total: int              # the request's total impressions

    @property
    def n_dropped(self) -> int:
        return self.n_total - self.n_packed


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Request -> slot mapping for one packed batch (same order as packing)."""
    requests: Tuple[PackedRequest, ...]

    @property
    def dropped_impressions(self) -> int:
        return sum(p.n_dropped for p in self.requests)

    @property
    def truncated_requests(self) -> int:
        return sum(1 for p in self.requests if p.n_dropped > 0)


@dataclasses.dataclass
class BatcherStats:
    """Accumulated over one ``batches``/``batches_with_plan`` call."""
    n_batches: int = 0
    n_requests: int = 0
    n_impressions_packed: int = 0
    n_impressions_dropped: int = 0
    n_requests_truncated: int = 0

    def update(self, plan: BatchPlan) -> None:
        self.n_batches += 1
        self.n_requests += len(plan.requests)
        self.n_impressions_packed += sum(p.n_packed for p in plan.requests)
        self.n_impressions_dropped += plan.dropped_impressions
        self.n_requests_truncated += plan.truncated_requests

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


def _pad_seq(rows: List[List[int]], n: int, width: int):
    out = np.zeros((n, width), np.int32)
    lens = np.zeros((n,), np.int32)
    for i, r in enumerate(rows[:n]):
        k = min(width, len(r))
        if k:
            out[i, :k] = np.asarray(r[-k:], np.int32)   # keep most recent
        lens[i] = k
    return out, lens


class ROOBatcher:
    """Greedy shard-aware packer: fills each shard's request / impression
    quota; every batch lands on ``device``."""

    def __init__(self, cfg: BatcherConfig, device="cuda"):
        if cfg.b_ro % cfg.n_shards or cfg.b_nro % cfg.n_shards:
            raise ValueError(f"b_ro={cfg.b_ro} and b_nro={cfg.b_nro} must be "
                             f"divisible by n_shards={cfg.n_shards}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.stats = BatcherStats()   # accumulated over the most recent call
        self._trunc_warned = False    # warn once per batcher

    def batches(self, samples: Sequence[ROOSample]) -> Iterator[ROOBatch]:
        for batch, _ in self.batches_with_plan(samples):
            yield batch

    def batches_with_plan(
            self, samples: Sequence[ROOSample],
    ) -> Iterator[Tuple[ROOBatch, BatchPlan]]:
        """Yield (batch, plan); the plan maps every admitted request to its
        (row, slot range) and records impressions dropped by truncation."""
        cfg = self.cfg
        per_shard_ro = cfg.b_ro // cfg.n_shards
        per_shard_nro = cfg.b_nro // cfg.n_shards
        queue = list(enumerate(samples))
        self.stats = BatcherStats()
        while queue:
            shard_reqs: List[List[Tuple[int, ROOSample]]] = [
                [] for _ in range(cfg.n_shards)]
            for reqs in shard_reqs:
                n_imps = 0
                while queue and len(reqs) < per_shard_ro:
                    idx, s = queue[0]
                    # clamped to the shard quota, so an over-size request is
                    # always admitted into an empty shard (and truncated by
                    # _pack, which the plan records)
                    n_imp = min(s.num_impressions, per_shard_nro)
                    if n_imps + n_imp > per_shard_nro:
                        break
                    queue.pop(0)
                    reqs.append((idx, s))
                    n_imps += n_imp
            batch, plan = self._pack(shard_reqs)
            self.stats.update(plan)
            if plan.dropped_impressions:
                # always counted (ungated: data loss must never be silent);
                # warned once per batcher
                obs_metrics.counter(
                    "batcher.impressions_dropped",
                    gated=False).inc(plan.dropped_impressions)
                if not self._trunc_warned:
                    self._trunc_warned = True
                    warnings.warn(
                        f"ROOBatcher: dropped {plan.dropped_impressions} "
                        f"impression(s) from {plan.truncated_requests} "
                        f"truncated request(s) — b_nro={cfg.b_nro} "
                        f"(per-shard {per_shard_nro}) is smaller than the "
                        f"request", stacklevel=2)
            yield batch, plan

    def _pack(self, shard_reqs: List[List[Tuple[int, ROOSample]]]
              ) -> Tuple[ROOBatch, BatchPlan]:
        cfg = self.cfg
        per_shard_ro = cfg.b_ro // cfg.n_shards
        per_shard_nro = cfg.b_nro // cfg.n_shards
        ro_dense_rows, ro_idlists, hists, acts = [], [], [], []
        num_imp = np.zeros((cfg.b_ro,), np.int32)
        seg = np.full((cfg.b_nro,), cfg.b_ro, np.int32)
        nro_dense_rows: List[Tuple[int, np.ndarray]] = []
        nro_idlists: List[Tuple[int, List[int]]] = []
        item_ids = np.zeros((cfg.b_nro,), np.int32)
        labels = np.zeros((cfg.b_nro, len(cfg.label_keys)), np.float32)

        packed: List[PackedRequest] = []
        for shard, reqs in enumerate(shard_reqs):
            fill = shard * per_shard_nro
            for j, (idx, s) in enumerate(reqs):
                row = shard * per_shard_ro + j
                ro_dense_rows.append((row, s.ro_dense))
                ro_idlists.append((row, s.ro_idlist))
                hists.append((row, s.history_ids))
                acts.append((row, s.history_actions))
                n = min(s.num_impressions,
                        (shard + 1) * per_shard_nro - fill)
                num_imp[row] = n
                packed.append(PackedRequest(
                    request_index=idx, row=row, slot_start=fill, n_packed=n,
                    n_total=s.num_impressions))
                for k in range(n):
                    slot = fill + k
                    seg[slot] = j if cfg.local_segment_ids else row
                    item_ids[slot] = s.item_ids[k]
                    nro_dense_rows.append((slot, s.item_dense[k]))
                    nro_idlists.append((slot, s.item_idlist[k]))
                    labels[slot] = [s.labels[k].get(key, 0.0)
                                    for key in cfg.label_keys]
                fill += n
        if cfg.local_segment_ids:
            # padding marker becomes the local b_ro
            seg = np.where(seg == cfg.b_ro, per_shard_ro, seg)

        # densify RO side
        n_ro_dense = ro_dense_rows[0][1].shape[-1] if ro_dense_rows else 1
        ro_dense = np.zeros((cfg.b_ro, n_ro_dense), np.float32)
        for row, v in ro_dense_rows:
            ro_dense[row] = np.asarray(v, np.float32)[:n_ro_dense]
        hist_rows = [[] for _ in range(cfg.b_ro)]
        act_rows = [[] for _ in range(cfg.b_ro)]
        for row, h in hists:
            hist_rows[row] = list(h)
        for row, a in acts:
            act_rows[row] = list(a)
        history_ids, hist_lens = _pad_seq(hist_rows, cfg.b_ro, cfg.hist_len)
        history_actions, _ = _pad_seq(act_rows, cfg.b_ro, cfg.hist_len)

        ro_idlist_rows = [[] for _ in range(cfg.b_ro)]
        for row, ids in ro_idlists:
            ro_idlist_rows[row] = list(ids)
        ro_sparse = KeyedJagged({"user_ids": JaggedTensor.from_lists(
            ro_idlist_rows, cfg.ro_idlist_capacity)})

        n_item_dense = nro_dense_rows[0][1].shape[-1] if nro_dense_rows else 1
        nro_dense = np.zeros((cfg.b_nro, n_item_dense), np.float32)
        for slot, v in nro_dense_rows:
            nro_dense[slot] = np.asarray(v, np.float32)[:n_item_dense]
        nro_idlist_rows = [[] for _ in range(cfg.b_nro)]
        for slot, ids in nro_idlists:
            nro_idlist_rows[slot] = list(ids)
        nro_sparse = KeyedJagged({"item_cats": JaggedTensor.from_lists(
            nro_idlist_rows, cfg.item_idlist_capacity)})

        t = torch.from_numpy
        batch = ROOBatch(
            ro_dense=t(ro_dense), ro_sparse=ro_sparse,
            history_ids=t(history_ids), history_actions=t(history_actions),
            history_lengths=t(hist_lens), nro_dense=t(nro_dense),
            nro_sparse=nro_sparse, item_ids=t(item_ids), labels=t(labels),
            num_impressions=t(num_imp), segment_ids=t(seg))
        return batch.to(self.device), BatchPlan(requests=tuple(packed))


def impression_batches(samples: Sequence[ImpressionSample], batch_size: int,
                       cfg: BatcherConfig,
                       device="cuda") -> Iterator[ROOBatch]:
    """Pack impression samples as degenerate ROO batches (1 impression per
    'request'): this is exactly impression-level training, reusing the same
    model code. B_RO == B_NRO == batch_size."""
    roo_like = [
        ROOSample(request_id=s.request_id, user_id=s.user_id,
                  ro_dense=s.ro_dense, ro_idlist=s.ro_idlist,
                  history_ids=s.history_ids,
                  history_actions=s.history_actions, item_ids=[s.item_id],
                  item_dense=[s.item_dense], item_idlist=[s.item_idlist],
                  labels=[s.labels])
        for s in samples
    ]
    sub = dataclasses.replace(cfg, b_ro=batch_size, b_nro=batch_size)
    yield from ROOBatcher(sub, device=device).batches(roo_like)
