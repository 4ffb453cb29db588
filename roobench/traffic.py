"""The one general traffic generator: laws named in a traffic file, drawn
from ``--seed`` alone.

A law is a JSON object with a ``law`` key:

- ``{"law": "uniform_int", "lo": a, "hi": b}``: integers a..b, each as likely;
- ``{"law": "log_uniform_int", "lo": a, "hi": b}``: floor(a * (b / a) ** u);
- ``{"law": "zipf", "s": s}``: ids 0..n-1 (n a table's rows, a catalog)
  whose ranks follow a bounded Zipf law with exponent s, through the
  continuous inverse of its cumulative sum, scattered over the ids by a
  seeded affine permutation ``(a * rank + b) mod n`` (:func:`zipf_ids`);
- ``{"law": "normal"}``: standard normal floats;
- ``{"law": "bernoulli", "p": p}``: 0.0 / 1.0 floats;
- ``{"law": "poisson", "rate_per_s": r}``: arrival offsets in seconds of an
  open-loop Poisson process.

Draws of a law are quantile-stratified: the n values come from the n
quantile cells ((i + u_i) / n), in a seeded order, so every seed gets the
same multiset of sizes up to one cell each and only their order and the
ids change. That keeps two seeds' work alike.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def rng(seed: int, *keys: int) -> np.random.Generator:
    """An independent stream for (seed, *keys); any non-negative seed."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed), *map(int, keys)])))


def stratified_uniform(g: np.random.Generator, n: int) -> np.ndarray:
    """n floats in [0, 1), one in each cell [i / n, (i + 1) / n), in a
    seeded order."""
    return (g.permutation(n) + g.random(n)) / n


def affine_permutation(g: np.random.Generator, n: int) -> Tuple[int, int]:
    """(a, b) with gcd(a, n) = 1, so rank -> (a * rank + b) mod n is a
    bijection of 0..n-1."""
    if n <= 1:
        return 1, 0
    while True:
        a = int(g.integers(1, n))
        if math.gcd(a, n) == 1:
            return a, int(g.integers(0, n))


def zipf_ranks(u: np.ndarray, n: int, s: float) -> np.ndarray:
    """Ranks 0..n-1 of a bounded Zipf law with exponent s at the uniform
    quantiles u: the inverse of H(x) = integral_1^x t^-s dt over [1, n + 1),
    floored (rank 0 is the most frequent)."""
    if abs(s - 1.0) < 1e-12:
        x = np.exp(u * math.log(n + 1.0))
    else:
        h = ((n + 1.0) ** (1.0 - s) - 1.0) / (1.0 - s)
        x = (1.0 + (1.0 - s) * u * h) ** (1.0 / (1.0 - s))
    return np.clip(np.floor(x).astype(np.int64) - 1, 0, n - 1)


def zipf_ids(law: dict, g: np.random.Generator, size: int, n: int,
             perm: Tuple[int, int]) -> np.ndarray:
    """``size`` ids of a ``zipf`` law over 0..n-1: stratified ranks,
    scattered by ``perm`` (:func:`affine_permutation` of n), which a run
    keeps for all its draws of one id range, so the same ids are popular
    throughout."""
    ranks = zipf_ranks(stratified_uniform(g, size), n, float(law["s"]))
    a, b = perm
    return (a * ranks + b) % n


def draw(law: dict, g: np.random.Generator, size: int) -> np.ndarray:
    """``size`` values of ``law`` (module note; ``zipf`` draws through
    :func:`zipf_ids`)."""
    kind = law["law"]
    if kind == "normal":
        return g.standard_normal(size).astype(np.float32)
    u = stratified_uniform(g, size)
    if kind == "uniform_int":
        lo, hi = int(law["lo"]), int(law["hi"])
        return lo + np.minimum((u * (hi - lo + 1)).astype(np.int64), hi - lo)
    if kind == "log_uniform_int":
        lo, hi = float(law["lo"]), float(law["hi"])
        return np.minimum(np.floor(lo * (hi / lo) ** u).astype(np.int64),
                          int(hi))
    if kind == "bernoulli":
        return (u < float(law["p"])).astype(np.float32)
    if kind == "poisson":
        gaps = -np.log1p(-u) / float(law["rate_per_s"])
        return np.cumsum(gaps)
    raise ValueError(f"unknown law {kind!r}")


def request_sizes(law: dict, g: np.random.Generator,
                  slots: int) -> np.ndarray:
    """Impressions of the requests that fill exactly ``slots`` impression
    slots: as many stratified sizes of ``law`` as its mean fills, more if
    they fall short, the last one cut to fit."""
    mean = float(draw(law, rng(0), 1 << 16).mean())
    sizes = draw(law, g, max(1, int(slots / mean)))
    while int(sizes.sum()) < slots:
        short = slots - int(sizes.sum())
        sizes = np.concatenate([sizes, draw(law, g, max(1, int(short / mean))
                                            + 1)])
    ends = np.cumsum(sizes)
    k = int(np.searchsorted(ends, slots))      # first request reaching it
    out = sizes[:k + 1].copy()
    out[-1] -= int(ends[k]) - slots
    return out
