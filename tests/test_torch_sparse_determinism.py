"""The port's CPU table gradients are bitwise on repeat with several threads.

``SparseRows.to_dense``, the plain bag's backward (through
``embedding_bag_ref`` and through the COO rows + densify) and
``seq_lookup``'s backward each run three times on 20,000 ids into 50 rows
of a (50,000, 64) table with 8 CPU threads: the three results must be the
same bits, and equal to a float64 ``index_add_`` within 1e-5.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.embeddings.collection import seq_lookup
from repro_torch.embeddings.sparse import SparseRows
from repro_torch.kernels.embedding_bag import embedding_bag_grouped_coo_grad
from repro_torch.kernels.ref import embedding_bag_ref

VOCAB, D, N_IDS, N_ROWS = 50_000, 64, 20_000, 50
BAGS, SLOTS = 200, 100                 # 20,000 bag slots
TOL = 1e-5


@pytest.fixture(autouse=True)
def eight_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    assert torch.get_num_threads() > 1
    yield
    torch.set_num_threads(before)


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    rows_hit = rng.choice(VOCAB, size=N_ROWS, replace=False)
    ids = rows_hit[rng.integers(0, N_ROWS, size=N_IDS)]
    # gradient-sized rows (~400 per table row): fp32 sums stay well inside
    # the 1e-5 tolerance of the float64 sum
    contrib = (0.01 * rng.normal(size=(N_IDS, D))).astype(np.float32)
    table = (0.02 * rng.normal(size=(VOCAB, D))).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(contrib), \
        torch.from_numpy(table)


def _scatter_f64(ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((VOCAB, rows.shape[1]), dtype=torch.float64)
    keep = ids < VOCAB
    out.index_add_(0, ids[keep].long(), rows[keep].double())
    return out


def _assert_repeat_bitwise(results, want: torch.Tensor) -> None:
    first = results[0]
    for other in results[1:]:
        assert torch.equal(first, other)
    assert torch.allclose(first.double(), want, atol=TOL, rtol=TOL)


def test_to_dense_bitwise_on_repeat():
    ids, rows, _ = _inputs(0)
    coo = SparseRows(ids.to(torch.int32), rows, VOCAB)
    _assert_repeat_bitwise([coo.to_dense() for _ in range(3)],
                           _scatter_f64(ids, rows))


def _bag_case(seed: int):
    ids, _, table = _inputs(seed)
    rng = np.random.default_rng(seed + 1)
    ids = ids.reshape(BAGS, SLOTS).to(torch.int32)
    lengths = torch.from_numpy(
        rng.integers(0, SLOTS + 1, size=BAGS).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(BAGS, D)).astype(np.float32))
    valid = torch.arange(SLOTS)[None, :] < lengths[:, None]
    w = valid.double() / lengths.clamp(min=1).double()[:, None]
    want = torch.zeros((VOCAB, D), dtype=torch.float64)
    want.index_add_(0, ids.reshape(-1).long(),
                    (w[:, :, None] * g.double()[:, None, :]).reshape(-1, D))
    return table, ids, lengths, g, want


@pytest.mark.parametrize("route", ["embedding_bag_ref", "coo"])
def test_plain_bag_backward_bitwise_on_repeat(route):
    table, ids, lengths, g, want = _bag_case(1)

    def grad():
        t = table.clone().requires_grad_(True)
        out = embedding_bag_ref(t, ids, lengths, "mean")
        if route == "embedding_bag_ref":
            return torch.autograd.grad(out, t, g)[0]
        (coo,) = embedding_bag_grouped_coo_grad(
            "mean", [t], ids[:, None], lengths[:, None],
            out.detach()[:, None], g[:, None], [True])
        return coo.to_dense()

    _assert_repeat_bitwise([grad() for _ in range(3)], want)


@pytest.mark.parametrize("dedup", [False, True])
def test_seq_lookup_backward_bitwise_on_repeat(dedup):
    ids, rows, table = _inputs(2)
    ids = ids.reshape(200, 100)
    g = rows.reshape(200, 100, D)

    def grad():
        t = table.clone().requires_grad_(True)
        out = seq_lookup(t, ids, dedup=dedup)
        assert torch.equal(out.detach(), table[ids])     # forward unchanged
        return torch.autograd.grad(out, t, g)[0]

    _assert_repeat_bitwise([grad() for _ in range(3)],
                           _scatter_f64(ids.reshape(-1), rows))
