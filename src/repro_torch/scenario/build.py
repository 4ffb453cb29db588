"""Builders from a scenario to runnable pieces (torch port of part of
``repro/scenario/build.py``).

So far only :func:`synthetic_dlrm_batches`, the dlrm-mlperf data source.
The ``ScenarioSpec`` layer and the model bundles come with the config
slice; until then the caller passes the seed and batch sizes that the
reference reads from the spec, and writes the loss itself, as the
reference's bundle does: ``bce(dlrm_forward_roo(p, cfg, b["ro_dense"],
b["ro_ids"], b["ro_len"], b["nro_ids"], b["nro_len"], b["seg"]), b["y"])``
with ``train/metrics.bce``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def synthetic_dlrm_batches(seed: int, b_ro: int, b_nro: int, cfg,
                           n_batches: int = 4,
                           device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Deterministic field-dict batches for dlrm-mlperf (its MLPerf input
    format predates the ROO schema; the stream simulator doesn't emit it).

    The same ``np.random.RandomState(seed)`` draws in the same order as the
    reference's ``synthetic_dlrm_batches(spec, cfg, n_batches)`` with
    ``spec.data.seed = seed`` and ``spec.batcher.b_ro / b_nro``, so both
    give the same bytes. Each batch: ``ro_dense (B_RO, n_dense)`` fp32,
    ``ro_ids (B_RO, n_ro, mh)`` and ``nro_ids (B_NRO, n_nro, mh)`` int32
    below each field's (unpadded) vocab, full lengths, ``seg`` (B_NRO,)
    giving each request B_NRO / B_RO impressions, labels ``y`` (B_NRO,)
    with a 0.3 positive rate; all on ``device``.
    """
    if b_nro % b_ro:
        raise ValueError(f"dlrm synthetic batches need b_nro ({b_nro}) "
                         f"divisible by b_ro ({b_ro})")
    r = np.random.RandomState(seed)
    mh, n_ro = cfg.multi_hot, cfg.n_ro_fields
    n_nro = cfg.n_sparse - n_ro
    out = []
    for _ in range(n_batches):
        ro_dense = r.normal(size=(b_ro, cfg.n_dense)).astype(np.float32)
        ro_ids = np.stack([r.randint(0, cfg.vocabs[f], (b_ro, mh))
                           for f in range(n_ro)], axis=1).astype(np.int32)
        nro_ids = np.stack([r.randint(0, cfg.vocabs[n_ro + f], (b_nro, mh))
                            for f in range(n_nro)], axis=1).astype(np.int32)
        y = (r.uniform(size=(b_nro,)) < 0.3).astype(np.float32)
        batch = {
            "ro_dense": ro_dense, "ro_ids": ro_ids,
            "ro_len": np.full((b_ro, n_ro), mh, np.int32),
            "nro_ids": nro_ids,
            "nro_len": np.full((b_nro, n_nro), mh, np.int32),
            "seg": np.repeat(np.arange(b_ro, dtype=np.int32), b_nro // b_ro),
            "y": y}
        out.append({k: torch.from_numpy(v).to(device)
                    for k, v in batch.items()})
    return out
