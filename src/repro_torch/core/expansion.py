"""ROO expansion adapter (paper Appendix C), torch port of
``repro/core/expansion.py``.

Expands a request-level ``ROOBatch`` into impression-level tensors (every
RO feature duplicated to ``B_NRO`` rows) so impression-level models run
unchanged on ROO storage: compute traded for compatibility, as the paper
describes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.fanout import fanout
from repro_torch.core.roo_batch import ROOBatch


@dataclasses.dataclass(frozen=True)
class ImpressionBatch:
    """Impression-level view: every tensor has leading dim B_NRO."""
    ro_dense: torch.Tensor          # (B_NRO, n_ro_dense)
    history_ids: torch.Tensor       # (B_NRO, hist_len)
    history_actions: torch.Tensor   # (B_NRO, hist_len)
    history_lengths: torch.Tensor   # (B_NRO,)
    nro_dense: torch.Tensor         # (B_NRO, n_item_dense)
    item_ids: torch.Tensor          # (B_NRO,)
    labels: torch.Tensor            # (B_NRO, n_tasks)
    valid: torch.Tensor             # (B_NRO,) bool

    @property
    def batch_size(self) -> int:
        return self.nro_dense.shape[0]


def expand(batch: ROOBatch) -> ImpressionBatch:
    """ROO -> impression-level (all RO features fanned out to B_NRO)."""
    seg = batch.segment_ids
    return ImpressionBatch(
        ro_dense=fanout(batch.ro_dense, seg),
        history_ids=fanout(batch.history_ids, seg),
        history_actions=fanout(batch.history_actions, seg),
        history_lengths=fanout(batch.history_lengths, seg),
        nro_dense=batch.nro_dense,
        item_ids=batch.item_ids,
        labels=batch.labels,
        valid=batch.impression_mask(),
    )
