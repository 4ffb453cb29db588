"""Shape-bucketed batching for serving — a copy of
``repro/serve/bucketing.py`` (framework-free).

The engine rounds every flush up to a rung of a fixed *bucket ladder*, so
the model only ever sees ``len(ladder)`` batch shapes. In the JAX package
that bounds jit recompiles; in the eager port it bounds the distinct
launch shapes and keeps batch shapes identical across the two packages.

The ladder is geometric (both dims double per rung), so padding waste is
bounded by ~2x while the number of shapes stays logarithmic in the max
batch size. ``fixed`` is the single-shape ladder (``serve.bucketed=false``
in a scenario, ``ServeConfig(bucketed=False)``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class BucketSpec:
    """One batch shape: B_RO request rows, B_NRO impression slots."""
    b_ro: int
    b_nro: int


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    rungs: Tuple[BucketSpec, ...]     # sorted ascending

    def __post_init__(self):
        if not self.rungs:
            raise ValueError("empty bucket ladder")
        if list(self.rungs) != sorted(self.rungs):
            raise ValueError("ladder rungs must be sorted ascending")

    @classmethod
    def geometric(cls, min_b_ro: int = 4, min_b_nro: int = 32,
                  max_b_ro: int = 64, max_b_nro: int = 512) -> "BucketLadder":
        rungs = []
        b_ro = min(min_b_ro, max_b_ro)
        b_nro = min(min_b_nro, max_b_nro)
        while True:
            rungs.append(BucketSpec(b_ro, b_nro))
            if b_ro >= max_b_ro and b_nro >= max_b_nro:
                break
            b_ro = min(2 * b_ro, max_b_ro)
            b_nro = min(2 * b_nro, max_b_nro)
        return cls(tuple(rungs))

    @classmethod
    def fixed(cls, b_ro: int, b_nro: int) -> "BucketLadder":
        """Single-shape ladder: every flush is padded to (b_ro, b_nro)."""
        return cls((BucketSpec(b_ro, b_nro),))

    @property
    def max_rung(self) -> BucketSpec:
        return self.rungs[-1]

    def select(self, n_requests: int, n_impressions: int) -> BucketSpec:
        """Smallest rung that fits the demand; the top rung if nothing does
        (the batcher then splits the flush into several top-rung batches)."""
        for r in self.rungs:
            if r.b_ro >= n_requests and r.b_nro >= n_impressions:
                return r
        return self.rungs[-1]


@dataclasses.dataclass
class BucketStats:
    """Observed rung usage — one count per scored flush shape."""
    counts: Dict[BucketSpec, int] = dataclasses.field(default_factory=dict)

    def record(self, spec: BucketSpec) -> None:
        self.counts[spec] = self.counts.get(spec, 0) + 1

    @property
    def distinct_shapes(self) -> int:
        return len(self.counts)

    def snapshot(self) -> dict:
        return {"distinct_shapes": self.distinct_shapes,
                "counts": {f"{s.b_ro}x{s.b_nro}": c
                           for s, c in self.counts.items()}}
