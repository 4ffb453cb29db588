"""The segmented merge (``kernels/segment_merge.py``, the ``segment`` route
of ``SparseRows.to_dense`` on the card) on the CPU:

  * the plain version against a float64 ``np.add.at`` on runs shorter than,
    equal to and longer than a chunk, a run across one chunk edge and one
    across many, every id the same, the sentinel and ids past it dropped,
    n = 0 and n = 1, a width that is not a multiple of 4, bf16 rows;
  * the plain version against the JAX reference's ``SparseRows.to_dense``
    (the densify the route stands in for) on the same run shapes;
  * the plain version bit for bit against a scalar model of the kernel's
    order (a run's rows added in fp32 chunk by chunk, then its chunks'
    partials in chunk order, rounded once), and bit for bit on repeat;
  * ``densify_route`` (one_hot / aten / segment / index_put) from the
    table's height, the number of ids, the rows' dtype and their device;
  * ``to_dense``'s segment branch (its reshapes and its span) with the
    kernel's wrapper swapped for the plain version;
  * the wrapper's lane width and refusals, and ``CHUNK`` equal to the
    source's ``kChunk``.

The kernel itself runs only on the card:
``tests/test_torch_segment_merge_device.py`` (marker ``chip``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embeddings.sparse import SparseRows as RefSparseRows
from repro_torch.embeddings import sparse as sp
from repro_torch.kernels import segment_merge as sm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

C = sm.CHUNK


def runs_case(lengths, seed, vocab=None, w=8, sentinels=0):
    """ids with runs of the given lengths (ids 0, 1, ... in turn) plus
    ``sentinels`` entries of id ``vocab`` and one past it, shuffled; N(0, 1)
    rows."""
    rng = np.random.default_rng(seed)
    vocab = len(lengths) if vocab is None else vocab
    ids = np.repeat(np.arange(len(lengths)), lengths)
    ids = np.concatenate([ids, np.full(sentinels, vocab),
                          np.full(min(sentinels, 1), vocab + 1)])
    ids = rng.permutation(ids).astype(np.int32)
    rows = rng.normal(size=(ids.size, w)).astype(np.float32)
    return ids, rows, vocab


def scatter64(ids, rows, vocab):
    """The float64 scatter-add of ``rows`` by ``ids`` (ids outside the
    table dropped) and the same of ``|rows|``."""
    keep = (ids >= 0) & (ids < vocab)
    want = np.zeros((vocab, rows.shape[1]), np.float64)
    mag = np.zeros_like(want)
    np.add.at(want, ids[keep], rows[keep].astype(np.float64))
    np.add.at(mag, ids[keep], np.abs(rows[keep].astype(np.float64)))
    return want, mag


def fp32_sum_tol(ids, rows, vocab):
    """What fp32 sums of a row's entries can miss, in any order: each add
    off by at most 2^-24 of the sum of |x|."""
    _, mag = scatter64(ids, rows, vocab)
    count = np.bincount(ids[(ids >= 0) & (ids < vocab)],
                        minlength=vocab)[:, None]
    return 2.0 ** -24 * count * mag


def assert_near_scatter(got, ids, rows, vocab, rounding=0.0):
    """Within :func:`fp32_sum_tol` of the float64 scatter, plus
    ``rounding`` of the sum (one bf16 rounding: 2^-8)."""
    x = rows.float().numpy() if isinstance(rows, torch.Tensor) else rows
    want, _ = scatter64(ids, x, vocab)
    tol = fp32_sum_tol(ids, x, vocab) + rounding * np.abs(want)
    err = np.abs(got.double().numpy() - want)
    assert got.shape == (vocab, x.shape[1])
    assert np.all(err <= tol), float((err - tol).max())


CASES = {
    "short runs": [3, 1, 7, 2, 5] * 20,
    "runs of one chunk": [C] * 6,
    "runs longer than a chunk": [C + 9, 2 * C - 1, 3 * C + 5],
    "a run across one chunk edge": [50, 30, 20],
    "a run across many chunk edges": [30, 20 * C + 7, 11],
    "every id the same": [17 * C + 3],
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("sentinels", [0, 40])
def test_plain_matches_float64_scatter(name, sentinels):
    ids, rows, vocab = runs_case(CASES[name], len(name), sentinels=sentinels)
    got = sm.segment_merge_plain(torch.from_numpy(ids),
                                 torch.from_numpy(rows), vocab)
    assert got.dtype == torch.float32
    assert_near_scatter(got, ids, rows, vocab)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("sentinels", [0, 40])
def test_plain_matches_the_references_to_dense(name, sentinels):
    """The JAX reference's ``SparseRows.to_dense`` (one scatter-add, the
    sentinel and ids past it dropped) on the same operands: each sum lies
    within :func:`fp32_sum_tol` of the exact one, so within twice it of
    the other's."""
    ids, rows, vocab = runs_case(CASES[name], len(name), sentinels=sentinels)
    got = sm.segment_merge_plain(torch.from_numpy(ids),
                                 torch.from_numpy(rows), vocab)
    ref = np.asarray(RefSparseRows(jnp.asarray(ids), jnp.asarray(rows),
                                   vocab).to_dense())
    assert ref.shape == tuple(got.shape) and ref.dtype == np.float32
    err = np.abs(got.double().numpy() - ref.astype(np.float64))
    tol = 2 * fp32_sum_tol(ids, rows, vocab)
    assert np.all(err <= tol), float((err - tol).max())


@pytest.mark.parametrize("n", [0, 1])
def test_plain_takes_no_or_one_entry(n):
    ids = torch.zeros(n, dtype=torch.int32)
    rows = torch.full((n, 5), 1.5)
    got = sm.segment_merge_plain(ids, rows, 3)
    want = torch.zeros((3, 5))
    want[0] = 1.5 * n
    assert torch.equal(got, want)


def test_plain_width_not_a_multiple_of_four():
    ids, rows, vocab = runs_case([C + 3, 5, 2 * C], 3, w=13, sentinels=4)
    got = sm.segment_merge_plain(torch.from_numpy(ids),
                                 torch.from_numpy(rows), vocab)
    assert_near_scatter(got, ids, rows, vocab)


def test_plain_bf16_rows_round_once():
    ids, rows, vocab = runs_case([3 * C + 1, 40, 1, C], 4, w=24,
                                 sentinels=3)
    r16 = torch.from_numpy(rows).to(torch.bfloat16)
    got = sm.segment_merge_plain(torch.from_numpy(ids), r16, vocab)
    assert got.dtype == torch.bfloat16
    assert_near_scatter(got.float(), ids, r16, vocab, rounding=2.0 ** -8)
    # the sums run in fp32: one rounding of the fp32 result
    want = sm.segment_merge_plain(torch.from_numpy(ids), r16.float(), vocab)
    assert torch.equal(got, want.to(torch.bfloat16))


def kernel_order_model(ids, rows, vocab):
    """The kernel's arithmetic written out entry by entry in np.float32:
    stable sort; in each chunk a run's rows added from its first; a run's
    chunk partials added in chunk order; one rounding at the end (fp32
    here)."""
    order = np.argsort(ids, kind="stable")
    out = np.zeros((vocab, rows.shape[1]), np.float32)
    pieces = {}                      # id -> [partial of each chunk, in order]
    for c0 in range(0, ids.size, C):
        cur, acc = None, None
        for e in order[c0:c0 + C]:
            x = rows[e].astype(np.float32)
            if ids[e] == cur:
                acc = np.float32(acc + x)
            else:
                if cur is not None:
                    pieces.setdefault(cur, []).append(acc)
                cur, acc = ids[e], x.copy()
        pieces.setdefault(cur, []).append(acc)
    for v, parts in pieces.items():
        if 0 <= v < vocab:
            total = parts[0]
            for p in parts[1:]:
                total = np.float32(total + p)
            out[v] = total
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_adds_in_the_kernels_order(seed):
    """Bit for bit against the scalar model, on rows whose sums depend on
    the order (magnitudes spread over 2^-12..2^12), and bit for bit on
    repeat."""
    rng = np.random.default_rng(seed)
    lengths = list(rng.integers(1, 3 * C, size=12)) + [9 * C + 5]
    ids, _, vocab = runs_case(lengths, seed, sentinels=7)
    rows = (rng.normal(size=(ids.size, 6))
            * 2.0 ** rng.integers(-12, 13, size=(ids.size, 1))
            ).astype(np.float32)
    got = sm.segment_merge_plain(torch.from_numpy(ids),
                                 torch.from_numpy(rows), vocab)
    np.testing.assert_array_equal(got.numpy(),
                                  kernel_order_model(ids, rows, vocab))
    again = sm.segment_merge_plain(torch.from_numpy(ids),
                                   torch.from_numpy(rows), vocab)
    assert torch.equal(got, again)


@pytest.mark.parametrize("vocab, n_ids, dtype, device, route", [
    (4, 8192, torch.float32, "cpu", "aten"),
    (50_000, 65_536, torch.float32, "cpu", "aten"),
    (63, 8192, torch.float32, "cuda", "one_hot"),
    (63, 100, torch.bfloat16, "cuda", "one_hot"),
    (64, sp.FIXED_ORDER_MAX_IDS, torch.float32, "cuda", "aten"),
    (64, sp.FIXED_ORDER_MAX_IDS + 1, torch.float32, "cuda", "segment"),
    (65_537, 65_536, torch.float32, "cuda", "segment"),
    (65_537, 65_536, torch.bfloat16, "cuda", "segment"),
    (65_537, 65_536, torch.float64, "cuda", "index_put"),
    (65_537, 65_536, torch.float16, "cuda", "index_put"),
])
def test_densify_route(vocab, n_ids, dtype, device, route):
    assert sp.densify_route(vocab, n_ids, dtype, device) == route


@pytest.fixture
def trace_on():
    saved = obs_metrics.OBS_KNOB.snapshot()
    obs_metrics.OBS_KNOB.set_default("trace")
    obs_trace.get_tracer().clear()
    yield
    obs_trace.get_tracer().clear()
    obs_metrics.OBS_KNOB.restore(saved)


@pytest.mark.parametrize("tail", [(6,), (2, 3)])
def test_to_dense_segment_branch(monkeypatch, trace_on, tail):
    """With the route forced to ``segment`` and the wrapper swapped for the
    plain version, ``to_dense`` of rows (n, *tail) hands the wrapper (n, 6),
    gives the (vocab, *tail) sum, and its span says ``segment``."""
    ids, rows, vocab = runs_case([C + 5, 2, 3 * C], 8, w=6, sentinels=5)
    called = []

    def plain(i, r, v):
        called.append(tuple(r.shape))
        return sm.segment_merge_plain(i, r, v)
    monkeypatch.setattr(sp, "densify_route", lambda *a: "segment")
    monkeypatch.setattr(sm, "segment_merge_cuda", plain)
    coo = sp.SparseRows(torch.from_numpy(ids),
                        torch.from_numpy(rows).reshape((-1,) + tail), vocab)
    got = coo.to_dense()
    assert called == [(ids.size, 6)] and got.shape == (vocab,) + tail
    assert_near_scatter(got.reshape(vocab, 6), ids, rows, vocab)
    spans = [e for e in obs_trace.get_tracer().events()
             if e["name"] == "sparse.to_dense"]
    assert [s["args"]["route"] for s in spans] == ["segment"]
    assert spans[0]["args"]["n_ids"] == ids.size


@pytest.mark.parametrize("dtype, w, offset, vec", [
    (torch.float32, 128, 0, 4), (torch.float32, 13, 0, 1),
    (torch.float32, 128, 1, 1), (torch.bfloat16, 2048, 0, 8),
    (torch.bfloat16, 2044, 0, 1), (torch.bfloat16, 64, 2, 1)])
def test_lane_width(dtype, w, offset, vec):
    """16 bytes a lane where the width and both pointers allow it."""
    n = 5
    flat = torch.zeros(n * w + 64, dtype=dtype)
    base = (-flat.data_ptr() // flat.element_size()) % 16   # 64-byte edge
    rows = flat[base + offset:base + offset + n * w].view(n, w)
    out = torch.zeros((3, w), dtype=dtype)
    assert sm.lane_width(rows, out) == vec


def test_wrapper_refuses_before_any_build(monkeypatch):
    def no_build():
        raise AssertionError("built the kernel")
    monkeypatch.setattr(sm, "_load", no_build)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sm.segment_merge_cuda(ids, torch.zeros((4, 3), dtype=torch.float64),
                              2)
    with pytest.raises(ValueError, match="CUDA"):
        sm.segment_merge_cuda(ids, torch.zeros((4, 3)), 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        sm.segment_merge_cuda(ids, torch.zeros((4, 3), requires_grad=True),
                              2)


def test_chunk_equals_the_sources():
    text = sm.SOURCE.read_text()
    assert f"constexpr int kChunk = {sm.CHUNK};" in text


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("b_ro, b_nro", [(1024, 4096), (4096, 8192)])
def test_chip_smokes_merge_count_is_a_steps_routes(monkeypatch, sparse,
                                                   b_ro, b_nro):
    """``chip_smoke.dlrm_merges``, the segmented merges a dlrm step takes as
    counted from the configuration, against the routes the step's densifies
    take on the card. On the CPU ``gather_rows`` is made to take the card's
    autograd Function, so the plain bags densify each field's gradient
    through ``to_dense`` at B6's (vocab, ids) on the card, and each call's
    route is asked for a CUDA device."""
    import os
    import sys
    from collections import Counter

    from repro_torch.configs.registry import scenario
    from repro_torch.kernels import ref
    from repro_torch.models import dlrm
    from repro_torch.scenario.build import synthetic_dlrm_batches
    from repro_torch.train import metrics
    from repro_torch.train.loop import value_and_grad

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    cfg = dlrm.DLRMConfig(n_dense=13, embed_dim=8, bot_mlp=(13, 16, 8),
                          top_mlp=(36, 16, 1),
                          vocabs=(4096, 50, 70_000, 200, 3, 100_000, 64),
                          n_ro_fields=3, multi_hot=1)
    spec = scenario("dlrm-mlperf", {"data.seed": 0, "batcher.b_ro": b_ro,
                                    "batcher.b_nro": b_nro})
    (batch,) = synthetic_dlrm_batches(spec, cfg, 1, "cpu")
    params = dlrm.dlrm_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    card_gather = sp._GatherRows.apply
    monkeypatch.setattr(sp, "gather_rows", card_gather)
    monkeypatch.setattr(ref, "gather_rows", card_gather)
    routes = Counter()
    to_dense = sp.SparseRows.to_dense

    def recording(self):
        routes[sp.densify_route(self.vocab, self.ids.numel(),
                                self.rows.dtype, "cuda")] += 1
        return to_dense(self)
    monkeypatch.setattr(sp.SparseRows, "to_dense", recording)

    def loss(p, b, g):
        return metrics.bce(dlrm.dlrm_forward_roo(
            p, cfg, b["ro_dense"], b["ro_ids"], b["ro_len"], b["nro_ids"],
            b["nro_len"], b["seg"]), b["y"])
    vag = value_and_grad(loss)
    if sparse:
        vag = sp.make_sparse_value_and_grad(
            loss, lambda b: dlrm.dlrm_table_ids(cfg, b["ro_ids"],
                                                b["nro_ids"]))
    vag(params, batch, None)
    assert sum(routes.values()) == len(cfg.vocabs)
    assert routes["segment"] == chip_smoke.dlrm_merges(cfg, b_ro, b_nro)
    # the fields of 64 rows or more: 2 on the request side, 3 on the
    # impression side; the request side's past 3,072 ids at B_RO 4,096
    assert routes["segment"] == (5 if b_ro > 3072 else 3)
