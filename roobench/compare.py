"""The numbers ``correct`` compares, each a gap between the program's
reading and the plain reference's, as a share of the reference's."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Sequence

import numpy as np


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """Widest relative gap between the program's and the reference's
    losses, step by step."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    """Worst leaf's gap between the two norms, against the larger of the
    leaf's reference norm and the median leaf's (some gradients are all
    but zero). ``leaves`` limits which leaves count."""
    names = list(ref if leaves is None else leaves)
    med = statistics.median(ref[n] for n in ref)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def moving_leaves(grad_ref: Dict[str, float], floor: float) -> list:
    """Leaves whose reference gradient is at least ``floor`` of the median
    leaf's: the others move by round-off alone."""
    med = statistics.median(grad_ref.values())
    return [n for n, g in grad_ref.items() if g >= floor * med]


def score_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """Widest gap between served scores, against the reference scores'
    root mean square."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(prog - ref)) / np.sqrt(np.mean(ref * ref)))
