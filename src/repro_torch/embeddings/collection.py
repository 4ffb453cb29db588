"""Embedding lookups — torch port of the local path of
``repro/embeddings/collection.py``.

  * ``seq_lookup`` — (B, L) ids -> (B, L, D) rows (HSTU inputs)
  * ``row_lookup`` — (B,)  ids -> (B, D) single rows (item towers)

Both clip ids to ``[0, vocab)`` and may apply request-level id dedup
(``dedup_gather``: each distinct id read once, duplicates expanded from the
small gathered buffer — bit-identical to the direct gather). Policy: the
``emb_dedup`` knob (arg > process default > ``REPRO_TORCH_EMB_DEDUP`` >
auto); auto never dedups, as the reference dedups only on TPU. The sharded
paths, the bag lookups and the ``GatheredTable`` proxy are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.scenario.knobs import UNSET, Knob

DEDUP_KNOB = Knob("emb_dedup", "REPRO_TORCH_EMB_DEDUP",
                  choices=("always", "never", "auto"), kind="policy",
                  auto=lambda: "auto")


def set_dedup_policy(policy: Optional[str]) -> None:
    """Process-wide dedup policy: "always" | "never" | "auto" | None."""
    DEDUP_KNOB.set_default(UNSET if policy is None else policy)


def _want_dedup(dedup: Optional[bool]) -> bool:
    if dedup is not None:
        return dedup
    return DEDUP_KNOB.resolve() == "always"


def dedup_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with each distinct id read once; ids pre-clipped."""
    uids, inv = torch.unique(ids.reshape(-1), return_inverse=True)
    rows = table[uids]
    return rows[inv].reshape(tuple(ids.shape) + tuple(rows.shape[1:]))


def seq_lookup(table: torch.Tensor, ids: torch.Tensor, *,
               vocab: Optional[int] = None,
               dedup: Optional[bool] = None) -> torch.Tensor:
    """(B, L) ids -> (B, L, D); exact ``table[clip(ids)]`` semantics."""
    v = int(vocab) if vocab is not None else int(table.shape[0])
    ids = torch.clamp(ids.long(), 0, v - 1)
    if _want_dedup(dedup):
        return dedup_gather(table, ids)
    return table[ids]


def row_lookup(table: torch.Tensor, ids: torch.Tensor, *,
               vocab: Optional[int] = None,
               dedup: Optional[bool] = None) -> torch.Tensor:
    """(B,) ids -> (B, D) single-row gather."""
    return seq_lookup(table, ids[:, None], vocab=vocab, dedup=dedup)[:, 0, :]
