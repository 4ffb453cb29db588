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
from typing import Dict, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class JaggedTensor:
    """values[(capacity, *feat)] + lengths[(batch,)]; rows are contiguous."""

    values: torch.Tensor      # (capacity, ...) packed row-major by batch entry
    lengths: torch.Tensor     # (batch,) int32

    @property
    def batch_size(self) -> int:
        return self.lengths.shape[0]

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

    def to(self, device) -> "KeyedJagged":
        return KeyedJagged({k: jt.to(device)
                            for k, jt in self.features.items()})
