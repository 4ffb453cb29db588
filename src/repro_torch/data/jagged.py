"""Jagged (ragged) tensors — torch port of ``repro/data/jagged.py``.

A JaggedTensor carries a fixed-capacity ``values`` buffer plus ``lengths``;
entries past ``sum(lengths)`` are padding that every consumer masks. The
batcher builds them from host lists; the jagged bag pools by their
lengths. Offsets, segment ids, the valid mask and the padded-layout helpers
(``to_padded``, ``from_dense``) are not ported yet: nothing in the port
reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _cumsum_exclusive(lengths: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros((1,), dtype=lengths.dtype,
                                  device=lengths.device),
                      torch.cumsum(lengths, 0, dtype=lengths.dtype)[:-1]])


@dataclasses.dataclass(frozen=True)
class JaggedTensor:
    """values[(capacity, *feat)] + lengths[(batch,)]; rows are contiguous."""

    values: torch.Tensor      # (capacity, ...) packed row-major by batch entry
    lengths: torch.Tensor     # (batch,) int32

    @property
    def batch_size(self) -> int:
        return self.lengths.shape[0]

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def offsets(self) -> torch.Tensor:
        """``offsets[i] = sum(lengths[:i])``: where row i starts."""
        return _cumsum_exclusive(self.lengths)

    def total(self) -> torch.Tensor:
        return torch.sum(self.lengths)

    def segment_ids(self) -> torch.Tensor:
        """(capacity,) int32 mapping each value slot to its batch row;
        padding slots get ``batch_size`` (one past the end)."""
        dev = self.lengths.device
        idx = torch.arange(self.capacity, dtype=torch.int32, device=dev)
        if self.batch_size == 0:
            return torch.zeros_like(idx)
        ends = torch.cumsum(self.lengths, 0, dtype=torch.int32)
        seg = torch.searchsorted(ends, idx, right=True).to(torch.int32)
        return torch.where(idx < ends[-1], seg,
                           torch.full_like(seg, self.batch_size))

    def valid_mask(self) -> torch.Tensor:
        """(capacity,) bool: True for real entries, False for padding."""
        idx = torch.arange(self.capacity, dtype=torch.int32,
                           device=self.lengths.device)
        return idx < self.total()

    def to_padded(self, max_len: int, fill_value=0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(batch, max_len, *feat) dense tensor + (batch, max_len) mask;
        rows longer than ``max_len`` are truncated."""
        b, dev = self.batch_size, self.lengths.device
        pos = torch.arange(max_len, dtype=torch.int32, device=dev)
        idx = self.offsets[:, None] + pos[None, :]
        mask = pos[None, :] < torch.clamp(self.lengths, max=max_len)[:, None]
        idx = torch.clamp(idx, 0, self.capacity - 1).long()
        dense = self.values[idx.reshape(-1)].reshape(
            (b, max_len) + tuple(self.values.shape[1:]))
        bmask = mask.reshape(tuple(mask.shape) + (1,) * (dense.dim() - 2))
        fill = torch.full((), fill_value, dtype=dense.dtype, device=dev)
        return torch.where(bmask, dense, fill), mask

    @staticmethod
    def from_dense(dense: torch.Tensor, lengths: torch.Tensor,
                   capacity: Optional[int] = None) -> "JaggedTensor":
        """Pack a padded (batch, max_len, *feat) tensor into the jagged
        layout; slots past ``capacity`` are dropped."""
        b, ml = dense.shape[0], dense.shape[1]
        capacity = capacity if capacity is not None else b * ml
        pos = torch.arange(ml, dtype=torch.int32, device=dense.device)
        dest = _cumsum_exclusive(lengths.to(torch.int32))[:, None] \
            + pos[None, :]
        keep = (pos[None, :] < lengths[:, None]) & (dest < capacity)
        # padding and overflow land in one extra slot that is cut off
        dest = torch.where(keep, dest, torch.full_like(dest, capacity))
        out = torch.zeros((capacity + 1,) + tuple(dense.shape[2:]),
                          dtype=dense.dtype, device=dense.device)
        out[dest.reshape(-1).long()] = dense.reshape(
            (b * ml,) + tuple(dense.shape[2:]))
        return JaggedTensor(out[:capacity], lengths.to(torch.int32))

    def to(self, device) -> "JaggedTensor":
        return JaggedTensor(self.values.to(device), self.lengths.to(device))

    @staticmethod
    def from_lists(rows: Sequence[Sequence], capacity: int,
                   dtype=np.int32) -> "JaggedTensor":
        """Host-side packing (numpy), truncated to ``capacity`` values."""
        lengths = np.asarray([len(r) for r in rows], np.int32)
        flat = np.zeros((capacity,), dtype)
        cat = (np.concatenate([np.asarray(r, dtype) for r in rows]) if rows
               else np.zeros((0,), dtype))
        n = min(capacity, cat.shape[0])
        flat[:n] = cat[:n]
        return JaggedTensor(torch.from_numpy(flat), torch.from_numpy(lengths))


@dataclasses.dataclass(frozen=True)
class KeyedJagged:
    """Named bundle of JaggedTensors with a shared batch size (KJT analogue)."""

    features: Dict[str, JaggedTensor]

    def __getitem__(self, key: str) -> JaggedTensor:
        return self.features[key]

    def keys(self):
        return sorted(self.features)

    @property
    def batch_size(self) -> int:
        return self.features[next(iter(self.features))].batch_size

    def to(self, device) -> "KeyedJagged":
        return KeyedJagged({k: jt.to(device)
                            for k, jt in self.features.items()})
