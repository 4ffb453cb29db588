"""B5's launch choice and its deep kernel's arithmetic, modelled on the CPU
(the kernel runs only on the card, in ``chip_smoke.py`` phase 5, which asks
the built library for each launch through ``embedding_bag.fwd_plan``).

  * a Python model of the host's rule (``fwd_plan`` in
    ``csrc/embedding_bag.cu``), its constants read from the source: LSR's
    history bags (L 64, D 64) take the deep kernel in both dtypes, dlrm's
    one-hot bags the short 16-byte path, misaligned tables the
    one-element path; the rule's every launch is one ``chip_smoke`` holds
    phase 5 to reach (``chip_smoke.b5_launches``);
  * the deep kernel's 16-byte copies: every chunk of a round's rows is
    copied exactly once, and every lane's columns are among them;
  * the deep kernel's rounds emulated in torch (ids read at min(l, L - 1),
    64 slots a round, the first ``len`` added in slot order) on the same
    numpy inputs as the reference's ``embedding_bag`` (jnp backend): the
    same bags, and bit for bit the slot-ordered adds;
  * the collection's dedup on meta tensors (the dry run): the reference's
    static-size ``jnp.unique`` contract, and ``torch.unique`` elsewhere.

If the rule, the copy map or the rounds change in the source, change the
models with them.
"""
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embedding_bag as jax_eb
from repro_torch.embeddings import collection as ec
from repro_torch.kernels import embedding_bag as eb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = eb.SOURCE.read_text()


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS, SHORT, LONG = (constant("kThreads"), constant("kShortBag"),
                        constant("kLongBag"))
DEEP, DEEP_ROW, DEEP_THREADS = (constant("kDeepBag"), constant("kDeepRow"),
                                constant("kDeepThreads"))


def fwd_plan(l, d, esz, aligned=True):
    """The host's rule: (VEC, U, threads a block)."""
    widest = 16 if aligned and d % (16 // esz) == 0 else esz
    row = d * esz
    if l <= SHORT or widest != 16 or row < DEEP_ROW:
        return widest // esz, SHORT if l <= SHORT else LONG, THREADS
    size = 16
    while size > 4 and row // (size // 2) <= 32:
        size //= 2
    return size // esz, DEEP, DEEP_THREADS


@pytest.mark.parametrize("esz,vec", [(4, 2), (2, 2)])
def test_lsr_history_bags_take_the_deep_kernel(esz, vec):
    # L 64, D 64: 8 bytes of fp32 or 4 of bf16 a lane, a warp a bag
    assert fwd_plan(64, 64, esz) == (vec, 64, 32)
    # the impression-level and serving batches take the same launch: the
    # rule reads no B
    assert fwd_plan(5, 64, esz) == (vec, 64, 32)


@pytest.mark.parametrize("esz", [4, 2])
def test_short_misaligned_and_narrow_bags_keep_their_paths(esz):
    k16 = 16 // esz
    assert fwd_plan(1, 128, esz) == (k16, 4, 128)     # dlrm's one-hot
    assert fwd_plan(4, 128, esz) == (k16, 4, 128)
    assert fwd_plan(64, 64, esz, aligned=False) == (1, 8, 128)
    assert fwd_plan(9, 18, esz) == (1, 8, 128)        # D % VEC != 0
    assert fwd_plan(64, 8, esz) == (k16, 8, 128)      # rows < 128 bytes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_launch_is_one_chip_smoke_reaches(dtype):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    esz = 4 if dtype == torch.float32 else 2
    got = {fwd_plan(l, d, esz, aligned)
           for l in (0, 1, 4, 5, 64, 200)
           for d in (1, 8, 18, 32, 64, 96, 128, 256, 512)
           for aligned in (True, False)}
    assert got == chip_smoke.b5_launches(dtype)


def deep_copies(esz, d):
    """The deep kernel's copy map over one round: {(pass, row, chunk):
    copying lanes}, and each lane's add bytes (pass, byte offset, bytes)."""
    vec, _, _ = fwd_plan(64, d, esz)
    size = vec * esz
    slab = 32 * size
    chunks = slab // 16
    rows = 32 // chunks
    copied, adds = {}, []
    for c0 in range(0, d, 32 * vec):
        for s in range(32):
            chunk, first = s % chunks, s // chunks
            at = c0 * esz + 16 * chunk
            if at < d * esz:
                for j in range(first, DEEP, rows):
                    copied.setdefault((c0, j, chunk), []).append(s)
            if c0 + s * vec < d:
                adds.append((c0, s * size, size))
    return copied, adds, chunks


@pytest.mark.parametrize("esz,d", [(esz, d) for esz in (4, 2)
                                   for d in (32, 64, 96, 128, 256, 384)
                                   if d * esz >= 128])  # the deep kernel's
def test_deep_copies_cover_every_chunk_once(esz, d):
    assert fwd_plan(64, d, esz)[1] == DEEP
    copied, adds, chunks = deep_copies(esz, d)
    assert all(len(lanes) == 1 for lanes in copied.values())
    for c0 in range(0, d, 32 * (fwd_plan(64, d, esz)[0])):
        in_row = [k for k in range(chunks) if c0 * esz + 16 * k < d * esz]
        for j in range(DEEP):
            assert all((c0, j, k) in copied for k in in_row)
    # a lane adds bytes that a copy of its pass's slab brought
    for c0, start, size in adds:
        assert (c0, 0, start // 16) in copied
        assert start // 16 == (start + size - 1) // 16


def deep_rounds(table, ids, lens, pooling):
    """The deep kernel's arithmetic in torch: rounds of DEEP slots whose
    ids are read at min(l, L - 1) whatever the length, the first
    min(len, L) - base of each round added in slot order in fp32, one
    rounding an add; then the reference's rounding and mean."""
    b, l = ids.shape
    v = table.shape[0]
    out = []
    for i in range(b):
        n = int(min(max(int(lens[i]), 0), l))
        acc = torch.full((table.shape[1],), torch.finfo(table.dtype).min
                         if pooling == "max" else 0.0)
        for base in range(0, n, DEEP):
            slots = [min(base + j, l - 1) for j in range(DEEP)]
            rows = table[ids[i, slots].long().clamp(0, v - 1)].float()
            for j in range(min(n - base, DEEP)):
                acc = (torch.maximum(acc, rows[j]) if pooling == "max"
                       else acc + rows[j])
        if pooling == "max":
            r = (acc if n > 0 else torch.zeros_like(acc)).to(table.dtype)
        else:
            r = acc.to(table.dtype)
            if pooling == "mean":
                r = (r.float() / torch.tensor(max(int(lens[i]), 1),
                                              dtype=table.dtype).float()
                     ).to(table.dtype)
        out.append(r)
    return torch.stack(out)


@pytest.mark.parametrize("pooling", ["sum", "mean", "max"])
@pytest.mark.parametrize("l", [5, 64, 200])
def test_deep_rounds_match_the_reference(pooling, l):
    rng = np.random.default_rng(31 + l)
    b, d, v = 9, 64, 300
    table = (0.5 * rng.normal(size=(v, d))).astype(np.float32)
    ids = rng.integers(-5, v + 5, size=(b, l)).astype(np.int32)
    lens = rng.integers(0, l + 3, size=b).astype(np.int32)
    lens[0], lens[1], lens[2] = 0, l, l + 2
    got = deep_rounds(torch.from_numpy(table), torch.from_numpy(ids),
                      torch.from_numpy(lens), pooling)
    want = jax_eb.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                jnp.asarray(lens), pooling, backend="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if pooling != "max":
        sys.path.insert(0, ROOT)
        try:
            import chip_smoke
        finally:
            sys.path.remove(ROOT)
        ordered = chip_smoke.ordered_bags(
            [torch.from_numpy(table)], torch.from_numpy(ids)[:, None],
            torch.from_numpy(lens)[:, None], pooling)[:, 0]
        assert torch.equal(got, ordered)


def test_dedup_on_meta_takes_the_static_size_contract():
    flat = torch.empty(37, dtype=torch.long, device="meta")
    uids, inv = ec._unique_inverse(flat)
    assert uids.device.type == inv.device.type == "meta"
    assert uids.shape == inv.shape == (37,)
    assert uids.dtype == inv.dtype == torch.long
    ids = torch.tensor([5, 3, 5, 9, 3, 0])
    uids, inv = ec._unique_inverse(ids)
    want = torch.unique(ids, return_inverse=True)
    assert torch.equal(uids, want[0]) and torch.equal(inv, want[1])
    assert torch.equal(uids[inv], ids)
