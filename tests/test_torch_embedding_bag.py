"""The port's embedding bag (kernels B5, B6 and their plain versions) held
against the JAX reference.

The same numpy tables, ids (some out of range) and ragged lengths (some
zero) go through both packages:

  * the plain forward against the reference's Pallas kernel in interpret
    mode and its jnp oracle, sum / mean / max, at ``tests/test_kernels.py``'s
    shapes, to 1e-6; empty bags exactly 0; bf16 against the bf16 oracle;
  * the COO backward (ids and rows) of a group of one field against the
    reference's ``embedding_bag_coo_grad``, and its densify against the
    reference's ``SparseRows``;
  * ``GroupedEmbeddingBagFn`` at one field (what ``embedding_bag`` runs on
    a CUDA table) with its CUDA forward swapped for the plain version (the
    kernels run only on the card, in ``chip_smoke.py``): the table
    gradient against ``jax.grad`` through the Pallas-interpret kernel;
  * the dispatch ladder (``REPRO_TORCH_EMB_BACKEND``; the reference's
    ``REPRO_EMB_BACKEND`` never reaches the port) and the raw wrappers'
    refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embeddings.sparse import SparseRows as JaxSparseRows
from repro.kernels import dispatch as jax_dispatch
from repro.kernels import embedding_bag as jax_eb
from repro.kernels import ref as jax_ref
from repro_torch.embeddings.sparse import SparseRows
from repro_torch.kernels import dispatch
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import hstu_attention as b1

FWD_TOL = dict(atol=1e-6, rtol=1e-6)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
POOLINGS = ["sum", "mean", "max"]
SHAPES = [(100, 8, 4, 3), (1000, 64, 16, 10), (5000, 128, 32, 20)]


def bag_case(seed, v, d, b, l, dtype=np.float32):
    """Seeded table, ids with out-of-range entries, lengths incl. 0 and L,
    and an output gradient."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(dtype)
    ids = rng.integers(0, v, size=(b, l)).astype(np.int32)
    ids[0, 0], ids[-1, -1] = -3, v + 7          # clipped to 0 and V - 1
    lens = rng.integers(0, l + 1, size=b).astype(np.int32)
    lens[0], lens[-1] = l, 0
    if b > 2:
        ids[1, :] = ids[1, 0]                   # a bag of one repeated id
        lens[1] = l
    g = rng.normal(size=(b, d)).astype(np.float32)
    return dict(table=table, ids=ids, lens=lens, g=g)


def port(x, *keys):
    return [torch.from_numpy(x[k]) for k in keys]


@pytest.mark.parametrize("v,d,b,l", SHAPES)
@pytest.mark.parametrize("pooling", POOLINGS)
def test_plain_forward_matches_reference(v, d, b, l, pooling):
    x = bag_case(v + d, v, d, b, l)
    table, ids, lens = port(x, "table", "ids", "lens")
    got = eb.embedding_bag_fwd_plain(table, ids, lens, pooling).numpy()
    args = (jnp.asarray(x["table"]), jnp.asarray(x["ids"]),
            jnp.asarray(x["lens"]))
    kernel = jax_eb.embedding_bag(*args, pooling, backend="pallas-interpret")
    np.testing.assert_allclose(got, np.asarray(kernel), **FWD_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.embedding_bag_ref(*args, pooling)), **FWD_TOL)
    assert np.all(got[x["lens"] == 0] == 0)


@pytest.mark.parametrize("pooling", POOLINGS)
def test_plain_forward_bf16_matches_bf16_oracle(pooling):
    x = bag_case(3, 1000, 64, 16, 10)
    table = torch.from_numpy(x["table"]).to(torch.bfloat16)
    ids, lens = port(x, "ids", "lens")
    got = eb.embedding_bag_fwd_plain(table, ids, lens, pooling)
    assert got.dtype == torch.bfloat16
    want = jax_ref.embedding_bag_ref(
        jnp.asarray(x["table"]).astype(jnp.bfloat16), jnp.asarray(x["ids"]),
        jnp.asarray(x["lens"]), pooling)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def jax_coo(x, pooling):
    """The reference's COO backward on its own safe ids."""
    table, ids, lens = (jnp.asarray(x[k]) for k in ("table", "ids", "lens"))
    v, l = table.shape[0], ids.shape[1]
    safe = jnp.where(jnp.arange(l)[None, :] < lens[:, None],
                     jnp.clip(ids, 0, v - 1), 0).astype(jnp.int32)
    out = jax_eb.embedding_bag(table, ids, lens, pooling,
                               backend="pallas-interpret")
    return jax_eb.embedding_bag_coo_grad((pooling, True), table, safe, lens,
                                         out, jnp.asarray(x["g"]))


@pytest.mark.parametrize("pooling", POOLINGS)
def test_coo_grad_matches_reference(pooling):
    x = bag_case(11, 200, 16, 8, 6)
    table, ids, lens, g = port(x, "table", "ids", "lens", "g")
    out = eb.embedding_bag_fwd_plain(table, ids, lens, pooling)
    (got,) = eb.embedding_bag_grouped_coo_grad(
        pooling, [table], ids[:, None], lens[:, None], out[:, None],
        g[:, None], [True])
    want = jax_coo(x, pooling)
    assert got.vocab == want.vocab == 200
    assert got.ids.dtype == torch.int32
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows),
                               **FWD_TOL)
    np.testing.assert_allclose(got.to_dense().numpy(),
                               np.asarray(want.to_dense()), **FWD_TOL)


def test_coo_rows_mirror_the_kernel_op_order():
    """Mean weights are fp32 ``valid / max(len, 1)`` times g, so the plain
    rows equal the reference kernel's bit for bit."""
    x = bag_case(12, 300, 32, 6, 9)
    g, ids, lens = port(x, "g", "ids", "lens")
    cids, rows = eb.embedding_bag_coo_rows_plain(g, ids, lens, 300, "mean")
    want = jax_coo(x, "mean")
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(cids.numpy(), np.asarray(want.ids))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sparse_rows_densify_matches_reference(dtype):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 12, size=40).astype(np.int32)
    ids[::7] = 12                                  # the padding sentinel
    rows = rng.normal(size=(40, 3)).astype(dtype)
    got = SparseRows(torch.from_numpy(ids), torch.from_numpy(rows), 12)
    want = JaxSparseRows(jnp.asarray(ids), jnp.asarray(rows), 12)
    dense = got.to_dense()
    assert dense.shape == (12, 3) and dense.dtype == got.rows.dtype
    np.testing.assert_allclose(dense.numpy(), np.asarray(want.to_dense()),
                               **FWD_TOL)
    assert torch.equal(dense, got.to_dense())      # the same bits again


def test_sparse_rows_densify_edges():
    # all padding, and no rows at all, give a zero table
    pad = SparseRows(torch.full((5,), 4, dtype=torch.int32),
                     torch.ones((5, 2)), 4)
    assert torch.equal(pad.to_dense(), torch.zeros((4, 2)))
    none = SparseRows(torch.zeros(0, dtype=torch.int32), torch.zeros((0, 2)),
                      3)
    assert torch.equal(none.to_dense(), torch.zeros((3, 2)))


@pytest.fixture
def plain_forward(monkeypatch):
    """The Function's CUDA forward swapped for the plain version, so its
    plumbing (saved tensors, the COO backward, the densify) runs on CPU
    tensors; on a CPU ``g`` its backward takes B6's plain version."""
    calls = []

    def fwd(tables, ids, lengths, pooling):
        calls.append(pooling)
        return eb.embedding_bag_grouped_plain(tables, ids, lengths, pooling)

    monkeypatch.setattr(eb, "embedding_bag_grouped_fwd_cuda", fwd)
    return calls


def one_field(table, ids, lens, pooling):
    """``GroupedEmbeddingBagFn`` on one table, as ``embedding_bag`` runs it
    on a CUDA table: (B, D)."""
    return eb.GroupedEmbeddingBagFn.apply(ids[:, None], lens[:, None],
                                          pooling, table).squeeze(1)


@pytest.mark.parametrize("pooling", POOLINGS)
def test_function_table_grad_matches_jax_grad(plain_forward, pooling):
    x = bag_case(3, 200, 16, 8, 6)
    w = np.random.default_rng(4).normal(size=(8, 16)).astype(np.float32)
    table, ids, lens = port(x, "table", "ids", "lens")
    table.requires_grad_(True)
    out = one_field(table, ids, lens, pooling)
    (grad,) = torch.autograd.grad(torch.sum(torch.from_numpy(w) * out),
                                  [table])
    assert plain_forward == [pooling]
    jids, jlens = jnp.asarray(x["ids"]), jnp.asarray(x["lens"])
    want = jax.grad(lambda t: jnp.sum(w * jax_eb.embedding_bag(
        t, jids, jlens, pooling, backend="pallas-interpret")))(
        jnp.asarray(x["table"]))
    assert grad.shape == table.shape and grad.dtype == table.dtype
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), **GRAD_TOL)
    # a second backward gives the same bits (fixed-order densify)
    out = one_field(table, ids, lens, pooling)
    (again,) = torch.autograd.grad(torch.sum(torch.from_numpy(w) * out),
                                   [table])
    assert torch.equal(grad, again)


def test_function_gives_no_grad_to_ids_and_lengths(plain_forward):
    x = bag_case(8, 50, 8, 4, 5)
    table, ids, lens = port(x, "table", "ids", "lens")
    table.requires_grad_(True)
    out = eb.GroupedEmbeddingBagFn.apply(ids[:, None], lens[:, None], "mean",
                                         table)
    g = torch.ones_like(out)
    with torch.no_grad():                 # as autograd runs a backward
        grads = out.grad_fn.apply(g)
    assert len(grads) == 4 and all(a is None for a in grads[:3])
    assert grads[3].shape == (50, 8)


def test_dispatch_ladder(monkeypatch):
    monkeypatch.delenv(dispatch.EMB_ENV_VAR, raising=False)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dispatch.resolve_emb_backend(None, cpu) == "torch"     # auto
    assert dispatch.resolve_emb_backend(None, cuda) == "cuda"
    assert dispatch.resolve_emb_backend() == "torch"
    # the reference's env var never reaches the port, nor the port's the
    # reference
    monkeypatch.setenv(jax_dispatch.EMB_ENV_VAR, "pallas-interpret")
    assert dispatch.resolve_emb_backend(None, cpu) == "torch"
    monkeypatch.setenv(dispatch.EMB_ENV_VAR, "cuda")
    assert dispatch.EMB_ENV_VAR == "REPRO_TORCH_EMB_BACKEND"
    assert dispatch.resolve_emb_backend(None, cpu) == "cuda"      # env
    assert jax_dispatch.resolve_emb_backend() == "pallas-interpret"
    monkeypatch.delenv(jax_dispatch.EMB_ENV_VAR)
    assert jax_dispatch.resolve_emb_backend() == "jnp"
    assert dispatch.resolve_emb_backend("torch", cuda) == "torch"  # arg
    with dispatch.use_emb_backend("torch"):                    # scope > env
        assert dispatch.resolve_emb_backend(None, cuda) == "torch"
    with dispatch.use_emb_backend(None):                       # no-op
        assert dispatch.resolve_emb_backend(None, cpu) == "cuda"
    dispatch.set_default_emb_backend("torch")                  # default > env
    try:
        assert dispatch.get_default_emb_backend() == "torch"
        assert dispatch.resolve_emb_backend(None, cuda) == "torch"
    finally:
        dispatch.set_default_emb_backend(None)
    assert dispatch.get_default_emb_backend() is None
    for bad in ("pallas", "jnp"):
        with pytest.raises(ValueError):
            dispatch.resolve_emb_backend(bad)
    # the HSTU ladder is a separate knob
    assert dispatch.resolve_backend(None, cpu) == "torch-chunked"


def test_entry_point_on_cpu_takes_plain_version(monkeypatch):
    monkeypatch.delenv(dispatch.EMB_ENV_VAR, raising=False)
    x = bag_case(9, 100, 8, 4, 3)
    table, ids, lens = port(x, "table", "ids", "lens")
    before = (eb.fwd_launch_count, eb.coo_launch_count)
    for pooling in POOLINGS:
        got = eb.embedding_bag(table, ids, lens, pooling)
        assert torch.equal(got, eb.embedding_bag_fwd_plain(table, ids, lens,
                                                           pooling))
    assert (eb.fwd_launch_count, eb.coo_launch_count) == before
    with pytest.raises(ValueError, match="CUDA"):
        eb.embedding_bag(table, ids, lens, backend="cuda")
    with pytest.raises(ValueError, match="pooling"):
        eb.embedding_bag(table, ids, lens, "median")


def test_raw_wrappers_refuse_grad_before_device():
    x = bag_case(10, 100, 8, 4, 3)
    table, ids, lens, g = port(x, "table", "ids", "lens", "g")
    with pytest.raises(RuntimeError, match="requires grad"):
        eb.embedding_bag_fwd_cuda(table.requires_grad_(True), ids, lens)
    with pytest.raises(RuntimeError, match="requires grad"):
        eb.embedding_bag_coo_rows_cuda(g.requires_grad_(True), ids, lens,
                                       100)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx(), pytest.raises(ValueError, match="CUDA tensors"):
            eb.embedding_bag_fwd_cuda(table, ids, lens)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eb.embedding_bag_coo_rows_cuda(g.detach(), ids, lens, 100, "mean")


def test_kernel_module_imports_without_nvcc():
    # importing compiled and loaded nothing; B5 and B6 share one source
    assert eb._lib is None
    assert eb.SOURCE.exists() and eb.SOURCE.parent == b1.SOURCE.parent
    text = eb.SOURCE.read_text()
    for name in ("_sum_kernel", "_max_kernel", "_bwd_coo_kernel",
                 'extern "C"', "embedding_bag_fwd", "embedding_bag_bwd_coo"):
        assert name in text
