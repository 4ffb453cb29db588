"""ROOBatch — the request-level batch (the paper's Table 2 schema), torch
port of ``repro/core/roo_batch.py``.

A batch holds ``B_RO`` request-level rows and ``B_NRO`` impression slots
(``B_NRO = capacity >= sum(num_impressions)``; the tail is padding). RO
tensors have leading dim ``B_RO``; NRO tensors have leading dim ``B_NRO``.
``segment_ids`` maps every impression slot to its request row (== ``B_RO``
for padding).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.data.jagged import KeyedJagged


@dataclasses.dataclass(frozen=True)
class ROOBatch:
    # ---- RO (request-only / user side): leading dim B_RO --------------------
    ro_dense: torch.Tensor                # (B_RO, n_ro_dense) float
    ro_sparse: Optional[KeyedJagged]      # user id-list features
    history_ids: torch.Tensor             # (B_RO, hist_len) int32, 0-padded
    history_actions: torch.Tensor         # (B_RO, hist_len) int32
    history_lengths: torch.Tensor         # (B_RO,) int32
    # ---- NRO (impression / item side): leading dim B_NRO --------------------
    nro_dense: torch.Tensor               # (B_NRO, n_item_dense) float
    nro_sparse: Optional[KeyedJagged]     # item id-list features
    item_ids: torch.Tensor                # (B_NRO,) int32
    labels: torch.Tensor                  # (B_NRO, n_tasks) float
    # ---- structure -----------------------------------------------------------
    num_impressions: torch.Tensor         # (B_RO,) int32
    segment_ids: torch.Tensor             # (B_NRO,) int32; == B_RO for padding

    # ---- sizes ---------------------------------------------------------------
    @property
    def b_ro(self) -> int:
        return self.ro_dense.shape[0]

    @property
    def b_nro(self) -> int:
        return self.nro_dense.shape[0]

    # ---- masks ---------------------------------------------------------------
    def impression_mask(self) -> torch.Tensor:
        """(B_NRO,) bool — True for real impressions, False for padding."""
        return self.segment_ids < self.b_ro

    def request_mask(self) -> torch.Tensor:
        """(B_RO,) bool — True for real requests (>=1 impression)."""
        return self.num_impressions > 0

    def num_valid_impressions(self) -> torch.Tensor:
        return torch.sum(self.num_impressions)

    def validate_static(self) -> None:
        """Host-side shape checks; raises AssertionError, as the
        reference's asserts do."""
        for what, a, b in (
                ("segment_ids / nro_dense", self.segment_ids, self.nro_dense),
                ("num_impressions / ro_dense", self.num_impressions,
                 self.ro_dense),
                ("history_ids / ro_dense", self.history_ids, self.ro_dense),
                ("labels / nro_dense", self.labels, self.nro_dense)):
            if a.shape[0] != b.shape[0]:
                raise AssertionError(f"{what}: leading dims {a.shape[0]} "
                                     f"!= {b.shape[0]}")

    def to(self, device) -> "ROOBatch":
        """The same batch with every tensor on ``device``."""
        return ROOBatch(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})


def segment_ids_from_counts(num_impressions: torch.Tensor,
                            capacity: int) -> torch.Tensor:
    """Derive (capacity,) segment ids from per-request impression counts.

    Padding slots (at or past sum(num_impressions)) get ``B_RO``.
    """
    b_ro = num_impressions.shape[0]
    ends = torch.cumsum(num_impressions, 0)
    idx = torch.arange(capacity, dtype=ends.dtype,
                       device=num_impressions.device)
    seg = torch.searchsorted(ends, idx, right=True).to(torch.int32)
    return torch.where(idx < ends[-1], seg,
                       torch.full_like(seg, b_ro))
