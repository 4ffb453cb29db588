"""The arithmetic of the CUDA dot-interaction kernel (B7), modelled on the
CPU.

B7 runs the Gram matrix of T = [dense_out; sparse_embs] on tensor cores:
mma.sync.m16n8k8 with TF32 operands and fp32 accumulators, a warp a
sample. T's F1 rows are padded to RB = ceil(F1 / 16) row blocks; row block
r multiplies column blocks c <= 2r + 1 that start below F1 (the lower
tiles), with the B fragment of column block c taken from the A fragment of
row block c // 2. The k index is permuted: lane (g, t) loads physical
columns 16s + 4t .. 4t + 3 and serves them as logical columns t and t + 4
of k-steps 2s and 2s + 1. fp32 inputs run as 3xTF32 (hi = tf32(x), lo =
tf32(x - hi); lo·hi + hi·lo + hi·hi), bf16 inputs in one pass (exact in
TF32). The epilogue stages accumulator e of lane (g, t) in tile (r, c) at
tril position (i, j) = (16r + g + 8 (e >> 1), 8c + 2t + (e & 1)) when
j < i (j <= i with the diagonal) and i < F1; then the block writes its
samples' span of out, 16-byte stores between element stores at the ends.
Each k-step's products go into a fresh fragment, added to the fp32 sum
once. At a small batch a sample takes KS warps, each every KS-th chunk of
16 columns; the first adds the others' sums in split order.

Here, in torch and Python:

  * the emulation (those passes, that k order, only the lower tiles, the
    rest NaN, and the epilogue's map) against the port's plain version,
    the reference's oracle and its Pallas kernel in interpret mode, at the
    card's gate (atol 1e-4, rtol 1e-5), with and without the diagonal;
  * the tile → tril map: every kept pair written once, from a computed
    tile, nothing above the diagonal, no padding row;
  * the permuted k order: a permutation, zero past D in both operands;
  * one TF32 pass misses the fp32 gate (why there are three), and is exact
    for bf16 inputs;
  * the k split: every chunk taken by one warp, and the split sums within
    the gate too;
  * the warps a sample, the samples a block and the span's write split
    (head, 16-byte body, tail), mirrored from the kernel's host code.

The kernel itself runs only on the card (``chip_smoke.py`` phase 6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dot_interaction as jax_dot
from repro.kernels import ref as jax_ref
from repro.models import interactions as jax_inter
from repro_torch.kernels import dot_interaction as di
from test_torch_hstu_attention import tf32_round

ATOL, RTOL = 1e-4, 1e-5          # chip_smoke.DOT_ATOL / DOT_RTOL
MAX_SAMPLES = 4                  # dot_interaction.cu: warps a block
MAX_SPLIT = 4                    # warps a sample at most
SPLIT_WARPS = 16 * 132           # split while B KS is under
FILL_BLOCKS = 132                # one block an H100 SM
STAGE_BYTES = 48 * 1024

# (B, F, D): dlrm's rows and width at a small batch, the scenario-like
# D 24 (D % 16 != 0), one sparse field, and the widest the kernel takes
SHAPES = {"dlrm F26 D128": (4, 26, 128), "F13 D24": (6, 13, 24),
          "F1 D16": (8, 1, 16), "F63 D256": (2, 63, 256)}
F1S = [1, 2, 14, 16, 17, 27, 32, 33, 41, 64]


def row_blocks(f1):
    return -(-f1 // 16)


def computed_tiles(f1):
    """(r, c) of the tiles a warp multiplies."""
    return [(r, c) for r in range(row_blocks(f1)) for c in range(2 * r + 2)
            if 8 * c < f1]


def tile_writes(f1, self_interaction):
    """[(pair index, i, j, (r, c), lane, e)] for every accumulator element
    the epilogue stages; it walks every tile c <= 2r + 1, as the kernel
    does, computed or not."""
    skip = 0 if self_interaction else 1
    out = []
    for r in range(row_blocks(f1)):
        for c in range(2 * r + 2):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(4):
                    i = 16 * r + g + 8 * (e >> 1)
                    j = 8 * c + 2 * t + (e & 1)
                    if i < f1 and j <= i - skip:
                        out.append((i * (i + 1) // 2 - skip * i + j, i, j,
                                    (r, c), lane, e))
    return out


def k_steps(d):
    """The physical column of each logical k of each k-step: lane t's four
    columns 16s + 4t + (0, 1) feed logical t, t + 4 of k-step 2s, and
    + (2, 3) those of k-step 2s + 1."""
    steps = []
    for s in range(-(-d // 16)):
        for kk in range(2):
            steps.append([16 * s + 4 * t + 2 * kk for t in range(4)]
                         + [16 * s + 4 * t + 2 * kk + 1 for t in range(4)])
    return steps


def split_chunks(n_chunks, ks):
    """The chunks each of a sample's KS warps takes: split, + KS, ..."""
    return [list(range(split, n_chunks, ks)) for split in range(ks)]


def emulate(dense, sparse, self_interaction=False, passes=3, ks=1):
    """B7's arithmetic in fp32 torch; the Gram matrix outside the lower
    tiles is NaN, so a map that read it would show."""
    b, f, d = sparse.shape
    f1, rb = f + 1, row_blocks(f + 1)
    steps = k_steps(d)
    t = torch.zeros((b, 16 * rb, 16 * len(steps) // 2))
    t[:, :f1, :d] = torch.cat([dense[:, None], sparse], 1).float()
    gram = torch.full((b, 16 * rb, 16 * rb), float("nan"))
    tiles = computed_tiles(f1)
    for r, c in tiles:
        gram[:, 16 * r:16 * r + 16, 8 * c:8 * c + 8] = 0.0
    sums = []
    for chunks in split_chunks(len(steps) // 2, ks):
        acc = torch.zeros_like(gram)
        for step in (steps[2 * s + kk] for s in chunks for kk in (0, 1)):
            x = t[:, :, step]
            hi = tf32_round(x)
            lo = tf32_round(x - hi)
            for r, c in tiles:
                rows, cols = slice(16 * r, 16 * r + 16), slice(8 * c,
                                                                8 * c + 8)
                b_hi = hi[:, cols].transpose(1, 2)
                part = hi[:, rows] @ b_hi         # a fresh fragment
                if passes == 3:
                    part = lo[:, rows] @ b_hi + hi[:, rows] @ lo[
                        :, cols].transpose(1, 2) + part
                acc[:, rows, cols] += part
        sums.append(acc)
    for acc in sums:                              # in split order
        gram = gram + acc
    writes = tile_writes(f1, self_interaction)
    pairs = torch.empty((b, len(writes)))
    for p, i, j, *_ in writes:
        pairs[:, p] = gram[:, i, j]
    return torch.cat([dense, pairs.to(dense.dtype)], 1)


def case(shape, seed, dtype=torch.float32):
    b, f, d = shape
    rng = np.random.default_rng(seed)
    dense = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    sparse = torch.from_numpy(rng.normal(size=(b, f, d)).astype(np.float32))
    return dense.to(dtype), sparse.to(dtype)


def within_gate(got, want):
    return bool(torch.all((got - want).abs() <= ATOL + RTOL * want.abs()))


@pytest.mark.parametrize("f1", F1S)
@pytest.mark.parametrize("self_interaction", [False, True])
def test_tile_map_writes_every_kept_pair_once(f1, self_interaction):
    writes = tile_writes(f1, self_interaction)
    rows, cols = np.tril_indices(f1, k=0 if self_interaction else -1)
    assert sorted(p for p, *_ in writes) == list(range(len(rows)))
    assert len(rows) == di.n_pairs(f1, self_interaction)
    tiles = set(computed_tiles(f1))
    for p, i, j, tile, _, _ in writes:
        assert (i, j) == (rows[p], cols[p])
        assert i < f1 and (j < i or (self_interaction and j == i))
        assert tile in tiles             # never an uncomputed tile


def test_lower_tiles_at_the_main_shapes():
    # dlrm: 2 row blocks, 6 of the 8 m16n8 tiles, 288 mma a sample
    assert row_blocks(27) == 2 and len(computed_tiles(27)) == 6
    assert len(k_steps(128)) * len(computed_tiles(27)) * 3 == 288
    # a column block that starts at or past F1 is skipped
    assert computed_tiles(17) == [(0, 0), (0, 1), (1, 0), (1, 1), (1, 2)]
    assert computed_tiles(2) == [(0, 0)]
    assert len(computed_tiles(64)) == 20


@pytest.mark.parametrize("d", [1, 13, 16, 24, 128, 256])
def test_k_order_is_a_permutation_with_zero_padding(d):
    steps = k_steps(d)
    flat = [k for step in steps for k in step]
    assert sorted(flat) == list(range(16 * -(-d // 16)))
    # each lane reads 4 contiguous columns a chunk: t and t + 4 of both
    # k-steps of the chunk
    for s in range(len(steps) // 2):
        for t in range(4):
            got = [steps[2 * s][t], steps[2 * s][t + 4],
                   steps[2 * s + 1][t], steps[2 * s + 1][t + 4]]
            assert got == [16 * s + 4 * t + e for e in range(4)]
    # columns past D are zero in both operands, so they add exact zeros:
    # seven more zero columns leave every pair's bits as they were
    dense, sparse = case((3, 5, d), d)
    padded = torch.cat([sparse, torch.zeros(3, 5, 7)], 2)
    dense_p = torch.cat([dense, torch.zeros(3, 7)], 1)
    assert torch.equal(emulate(dense_p, padded)[:, d + 7:],
                       emulate(dense, sparse)[:, d:])


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("self_interaction", [False, True])
def test_emulation_holds_the_gate(name, self_interaction):
    dense, sparse = case(SHAPES[name], 11)
    got = emulate(dense, sparse, self_interaction)
    plain = di.dot_interaction_plain(dense, sparse, self_interaction)
    assert got.shape == plain.shape
    assert torch.equal(got[:, :dense.shape[1]], dense)
    assert bool(torch.isfinite(got).all())
    assert within_gate(got, plain), float((got - plain).abs().max())
    jd, js = jnp.asarray(dense.numpy()), jnp.asarray(sparse.numpy())
    want = torch.from_numpy(np.array(jax_inter.dot_interaction(
        jd, js, self_interaction)))
    assert within_gate(got, want), float((got - want).abs().max())
    if not self_interaction:           # the reference's kernel and oracle
        for ref in (jax_ref.dot_interaction_ref(jd, js),
                    jax_dot.dot_interaction(jd, js, interpret=True)):
            ref = torch.from_numpy(np.array(ref))
            assert within_gate(got, ref), float((got - ref).abs().max())


def test_one_tf32_pass_misses_the_gate():
    """A single TF32 product (hi·hi alone) errs by about √D · 2⁻¹¹ |a||b|:
    far past atol 1e-4 at dlrm's shape. So fp32 inputs take three passes."""
    dense, sparse = case(SHAPES["dlrm F26 D128"], 12)
    plain = di.dot_interaction_plain(dense, sparse)
    one = emulate(dense, sparse, passes=1)
    three = emulate(dense, sparse, passes=3)
    assert not within_gate(one, plain)
    assert float((one - plain).abs().max()) > 1e-3
    assert within_gate(three, plain)
    assert 100 * float((three - plain).abs().max()) < float(
        (one - plain).abs().max())


@pytest.mark.parametrize("self_interaction", [False, True])
def test_one_pass_is_exact_for_bf16(self_interaction):
    dense, sparse = case(SHAPES["F13 D24"], 13, torch.bfloat16)
    for x in (dense, sparse):
        assert torch.equal(tf32_round(x.float()), x.float())
        assert not bool(tf32_round(x.float() - tf32_round(x.float())).any())
    one = emulate(dense, sparse, self_interaction, passes=1)
    assert one.dtype == torch.bfloat16
    assert torch.equal(one, emulate(dense, sparse, self_interaction, 3))
    plain = di.dot_interaction_plain(dense, sparse, self_interaction)
    assert torch.allclose(one.float(), plain.float(), atol=1e-3, rtol=1e-2)


def warps_per_sample(b, f, d):
    """The host's choice (dot_interaction.cu): 1, doubled up to 4 (and to
    the sample's chunks) while B·KS would stay under 16 warps an SM; only
    up to 2 row blocks."""
    ks = 1
    if row_blocks(f + 1) > 2:
        return ks
    while ks < MAX_SPLIT and 2 * ks <= -(-d // 16) and b * 2 * ks <= \
            SPLIT_WARPS:
        ks *= 2
    return ks


def smem_bytes(s, ks, w, esz, nt):
    """A block's shared memory: the staging of its samples' span (16 bytes
    of slack, rounded to 16), then their other warps' partial sums."""
    return -(-(s * w * esz + 16) // 16) * 16 + s * (ks - 1) * nt * 4 * 32 * 4


def samples_per_block(b, f, d, self_interaction=False, esz=4):
    """4 warps a block: 4 / KS samples, halved while the grid would be
    under one block an SM or the shared memory would pass 48 KB."""
    ks = warps_per_sample(b, f, d)
    w = d + di.n_pairs(f + 1, self_interaction)
    nt = row_blocks(f + 1) * (row_blocks(f + 1) + 1)
    s = MAX_SAMPLES // ks
    while s > 1 and (-(-b // s) < FILL_BLOCKS or
                     smem_bytes(s, ks, w, esz, nt) > STAGE_BYTES):
        s //= 2
    return s


def test_warps_a_sample_and_samples_a_block():
    assert warps_per_sample(8192, 26, 128) == 1   # dlrm training
    assert samples_per_block(8192, 26, 128) == 4  # 2,048 blocks of 4
    assert warps_per_sample(512, 26, 128) == 4    # dlrm scoring
    assert samples_per_block(512, 26, 128) == 1   # 512 blocks of 4 warps
    assert warps_per_sample(1003, 26, 128) == 2
    assert 1003 % samples_per_block(1003, 26, 128) != 0  # chip_smoke's B
    assert warps_per_sample(37, 13, 24) == 2      # 2 chunks: 2 warps
    assert warps_per_sample(8, 63, 256) == 1      # 4 row blocks: no split
    for b in (1, 37, 512, 1003, 8192):
        for f, d in ((26, 128), (13, 24), (31, 64), (63, 256), (1, 13)):
            rb = row_blocks(f + 1)
            for si in (False, True):
                for esz in (4, 2):
                    ks = warps_per_sample(b, f, d)
                    s = samples_per_block(b, f, d, si, esz)
                    w = d + di.n_pairs(f + 1, si)
                    assert ks in (1, 2, 4) and ks <= -(-d // 16)
                    assert s * ks <= MAX_SAMPLES
                    # under the 48 KB a launch may take without an opt-in
                    assert smem_bytes(s, ks, w, esz, rb * (rb + 1)) <= \
                        STAGE_BYTES


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("ks", [1, 2, 4])
def test_k_split_takes_every_chunk_once(n_chunks, ks):
    parts = split_chunks(n_chunks, ks)
    assert sorted(c for part in parts for c in part) == list(range(n_chunks))
    # the kernel's count a warp: (chunks - split + KS - 1) // KS
    assert [len(p) for p in parts] == [(n_chunks - split + ks - 1) // ks
                                       for split in range(ks)]


@pytest.mark.parametrize("ks", [2, 4])
def test_split_sums_hold_the_gate(ks):
    dense, sparse = case(SHAPES["dlrm F26 D128"], 14)
    plain = di.dot_interaction_plain(dense, sparse)
    got = emulate(dense, sparse, ks=ks)
    assert within_gate(got, plain), float((got - plain).abs().max())


def span_writes(start, n, esz):
    """The block's write of its samples' span [start, start + n * esz)
    bytes: the element stores before the first 16-byte boundary, the
    16-byte stores, the element stores after; the staging is offset by the
    same misalignment."""
    mis = start % 16
    head = min(n, (16 - mis) // esz if mis else 0)
    n16 = (n - head) * esz // 16
    return head, n16, n - head - n16 * 16 // esz


@pytest.mark.parametrize("esz", [4, 2])
@pytest.mark.parametrize("w", [128 + 351, 2, 7, 256 + 2080])  # 479: odd
def test_span_write_covers_each_element_once(esz, w):
    for s0 in range(0, 40, 3):
        for n_here in (1, 2, 3, 4):
            start, n = s0 * w * esz, n_here * w
            head, n16, tail = span_writes(start, n, esz)
            assert head >= 0 and n16 >= 0 and tail >= 0
            assert head + n16 * 16 // esz + tail == n
            assert n16 == 0 or (start + head * esz) % 16 == 0
            assert n16 == 0 or (start % 16 + head * esz) % 16 == 0  # staging
            assert tail * esz < 16
