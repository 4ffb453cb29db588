"""The port's grouped embedding bag (B5 and B6 as one launch over the F
fields of a lookup, their plain versions and ``GroupedEmbeddingBagFn``)
held against the JAX reference, which runs one bag per field.

The same numpy tables (one vocab per field, one of them V 3), ids (some
out of range) and ragged lengths (some 0, some past L) go through both
packages:

  * the plain grouped forward against the reference's per-field
    ``embedding_bag`` with its Pallas-interpret and jnp backends, sum /
    mean / max, F = 1, 3 and 13, to 1e-6; bit for bit against the port's
    own per-field plain path; bf16 against the bf16 oracle (2e-2);
  * the plain grouped COO rows against the reference's per-field
    ``embedding_bag_coo_grad``, bit for bit;
  * ``GroupedEmbeddingBagFn`` on CPU tensors with its CUDA launches swapped
    for the plain versions (the kernels run only on the card, in
    ``chip_smoke.py``): every table's gradient against ``jax.grad`` of the
    reference's per-field loop; no gradient for ids and lengths, None for a
    frozen table;
  * the wrappers' refusals before any build, the collection's grouped
    lookup (with forced dedup) against its per-field one, and dlrm's
    lookups as one group a side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embedding_bag as jax_eb
from repro.kernels import ref as jax_ref
from repro_torch.embeddings import collection as ec
from repro_torch.kernels import embedding_bag as eb
from repro_torch.models import dlrm

FWD_TOL = dict(atol=1e-6, rtol=1e-6)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
POOLINGS = ["sum", "mean", "max"]


def group_case(seed, n_fields, b=6, l=4, d=8, dtype=np.float32):
    """Seeded tables of different vocabs (the second one V 3), ids with
    out-of-range entries, lengths with 0, L and past-L bags, and a grouped
    output gradient."""
    rng = np.random.default_rng(seed)
    vocabs = [int(v) for v in rng.integers(5, 60, size=n_fields)]
    if n_fields > 1:
        vocabs[1] = 3
    tables = [rng.normal(size=(v, d)).astype(dtype) for v in vocabs]
    ids = np.stack([rng.integers(-2, v + 3, size=(b, l)) for v in vocabs],
                   axis=1).astype(np.int32)
    lens = rng.integers(0, l + 3, size=(b, n_fields)).astype(np.int32)
    lens[0, :], lens[-1, :] = 0, l
    lens[1, 0] = l + 2
    g = rng.normal(size=(b, n_fields, d)).astype(np.float32)
    return dict(tables=tables, vocabs=vocabs, ids=ids, lens=lens, g=g)


def port(x):
    return ([torch.from_numpy(t) for t in x["tables"]],
            torch.from_numpy(x["ids"]), torch.from_numpy(x["lens"]))


def jax_fields(tables, ids, lens, pooling, backend):
    """The reference's bags, one call per field, stacked."""
    return jnp.stack([jax_eb.embedding_bag(t, ids[:, f, :], lens[:, f],
                                           pooling, backend=backend)
                      for f, t in enumerate(tables)], axis=1)


@pytest.mark.parametrize("pooling", POOLINGS)
@pytest.mark.parametrize("n_fields", [1, 3, 13])
@pytest.mark.parametrize("backend", ["pallas-interpret", "jnp"])
def test_plain_grouped_forward_matches_reference(backend, n_fields, pooling):
    x = group_case(n_fields, n_fields)
    tables, ids, lens = port(x)
    got = eb.embedding_bag_grouped_plain(tables, ids, lens, pooling)
    assert got.shape == (6, n_fields, 8) and got.dtype == torch.float32
    want = jax_fields([jnp.asarray(t) for t in x["tables"]],
                      jnp.asarray(x["ids"]), jnp.asarray(x["lens"]),
                      pooling, backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    # bit for bit against the port's per-field plain path, and the entry
    # point's torch backend is the plain version
    per = torch.stack([eb.embedding_bag_fwd_plain(t, ids[:, f, :],
                                                  lens[:, f], pooling)
                       for f, t in enumerate(tables)], dim=1)
    assert torch.equal(got, per)
    assert torch.equal(got, eb.embedding_bag_grouped(tables, ids, lens,
                                                     pooling,
                                                     backend="torch"))
    assert torch.all(got[0] == 0)                  # empty bags


@pytest.mark.parametrize("pooling", POOLINGS)
def test_plain_grouped_forward_bf16_matches_bf16_oracle(pooling):
    x = group_case(21, 3, b=8, l=5, d=16)
    tables = [torch.from_numpy(t).to(torch.bfloat16) for t in x["tables"]]
    _, ids, lens = port(x)
    got = eb.embedding_bag_grouped_plain(tables, ids, lens, pooling)
    assert got.dtype == torch.bfloat16
    jids, jlens = jnp.asarray(x["ids"]), jnp.asarray(x["lens"])
    want = jnp.stack([jax_ref.embedding_bag_ref(
        jnp.asarray(t).astype(jnp.bfloat16), jids[:, f, :], jlens[:, f],
        pooling) for f, t in enumerate(x["tables"])], axis=1)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_plain_grouped_coo_rows_match_reference(pooling):
    x = group_case(31, 3)
    tables, ids, lens = port(x)
    g = torch.from_numpy(x["g"])
    cids, rows = eb.embedding_bag_grouped_coo_rows_plain(g, ids, lens,
                                                         x["vocabs"], pooling)
    assert cids.shape == (3, 6 * 4) and cids.dtype == torch.int32
    assert rows.shape == (3, 6 * 4, 8)
    l = x["ids"].shape[2]
    for f, t in enumerate(x["tables"]):
        jt, jl = jnp.asarray(t), jnp.asarray(x["lens"][:, f])
        v = t.shape[0]
        safe = jnp.where(jnp.arange(l)[None, :] < jl[:, None],
                         jnp.clip(jnp.asarray(x["ids"][:, f, :]), 0, v - 1),
                         0).astype(jnp.int32)
        out = jax_eb.embedding_bag(jt, jnp.asarray(x["ids"][:, f, :]), jl,
                                   pooling, backend="pallas-interpret")
        want = jax_eb.embedding_bag_coo_grad((pooling, True), jt, safe, jl,
                                             out, jnp.asarray(x["g"][:, f]))
        np.testing.assert_array_equal(cids[f].numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(rows[f].numpy(), np.asarray(want.rows))


@pytest.fixture
def plain_launches(monkeypatch):
    """The grouped CUDA launches swapped for their plain versions, counted,
    so ``GroupedEmbeddingBagFn`` runs on CPU tensors (on a CPU gradient its
    backward takes B6's plain version, counted too)."""
    calls = {"fwd": 0, "coo": 0}
    plain_fwd = eb.embedding_bag_grouped_plain
    plain_coo = eb.embedding_bag_grouped_coo_rows_plain

    def fwd(tables, ids, lengths, pooling="sum"):
        calls["fwd"] += 1
        return plain_fwd(tables, ids, lengths, pooling)

    def coo(g, ids, lengths, vocabs, pooling="sum"):
        calls["coo"] += 1
        return plain_coo(g, ids, lengths, vocabs, pooling)

    monkeypatch.setattr(eb, "embedding_bag_grouped_fwd_cuda", fwd)
    monkeypatch.setattr(eb, "embedding_bag_grouped_coo_rows_cuda", coo)
    monkeypatch.setattr(eb, "embedding_bag_grouped_coo_rows_plain", coo)
    return calls


@pytest.mark.parametrize("pooling", POOLINGS)
def test_grouped_function_table_grads_match_jax_grad(plain_launches,
                                                     pooling):
    x = group_case(41, 3, b=8, l=5, d=16)
    tables, ids, lens = port(x)
    for t in tables:
        t.requires_grad_(True)
    w = np.random.default_rng(42).normal(size=(8, 3, 16)).astype(np.float32)
    out = eb.GroupedEmbeddingBagFn.apply(ids, lens, pooling, *tables)
    grads = torch.autograd.grad(torch.sum(torch.from_numpy(w) * out), tables)
    assert plain_launches == {"fwd": 1, "coo": 0 if pooling == "max" else 1}
    jids, jlens = jnp.asarray(x["ids"]), jnp.asarray(x["lens"])
    want = jax.grad(lambda ts: jnp.sum(w * jax_fields(
        ts, jids, jlens, pooling, "pallas-interpret")))(
        tuple(jnp.asarray(t) for t in x["tables"]))
    for got, t, ref in zip(grads, tables, want):
        assert got.shape == t.shape and got.dtype == t.dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)
    # a second backward gives the same bits (fixed-order densify)
    out = eb.GroupedEmbeddingBagFn.apply(ids, lens, pooling, *tables)
    again = torch.autograd.grad(torch.sum(torch.from_numpy(w) * out), tables)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("pooling", ["mean", "max"])
def test_grouped_function_grads_only_where_needed(plain_launches, pooling):
    x = group_case(51, 3)
    tables, ids, lens = port(x)
    tables[0].requires_grad_(True)
    tables[2].requires_grad_(True)                 # tables[1] is frozen
    out = eb.GroupedEmbeddingBagFn.apply(ids, lens, pooling, *tables)
    with torch.no_grad():                          # as autograd runs it
        grads = out.grad_fn.apply(torch.ones_like(out))
    assert len(grads) == 6
    assert grads[:3] == (None, None, None)         # ids, lengths, pooling
    assert grads[4] is None
    assert grads[3].shape == tables[0].shape
    assert grads[5].shape == tables[2].shape
    # the gradient the table gets through autograd of the plain version
    leaf = tables[2].detach().clone().requires_grad_(True)
    alone = eb.embedding_bag_fwd_plain(leaf, ids[:, 2, :], lens[:, 2],
                                       pooling)
    (want,) = torch.autograd.grad(alone.sum(), [leaf])
    np.testing.assert_allclose(grads[5].numpy(), want.numpy(), **FWD_TOL)


def _refusals():
    t = torch.zeros((5, 8))
    ids = torch.zeros((2, 1, 3), dtype=torch.int32)
    lens = torch.ones((2, 1), dtype=torch.int32)
    many = torch.zeros((2, eb.MAX_FIELDS + 1, 3), dtype=torch.int32)
    many_lens = torch.ones((2, eb.MAX_FIELDS + 1), dtype=torch.int32)
    g = torch.zeros((2, 1, 8))
    return {
        "too many fields": (lambda: eb.embedding_bag_grouped_fwd_cuda(
            [t] * (eb.MAX_FIELDS + 1), many, many_lens), "kMaxFields"),
        "mixed D": (lambda: eb.embedding_bag_grouped_fwd_cuda(
            [t, torch.zeros((5, 4))], ids.expand(2, 2, 3),
            lens.expand(2, 2)), "share D"),
        "mixed dtype": (lambda: eb.embedding_bag_grouped_fwd_cuda(
            [t, t.to(torch.bfloat16)], ids.expand(2, 2, 3),
            lens.expand(2, 2)), "share D"),
        "cpu tables": (lambda: eb.embedding_bag_grouped_fwd_cuda(
            [t], ids, lens), "CUDA tensors"),
        "cpu entry under cuda": (lambda: eb.embedding_bag_grouped(
            [t], ids, lens, backend="cuda"), "CUDA tensors"),
        "coo too many fields": (lambda: eb.embedding_bag_grouped_coo_rows_cuda(
            torch.zeros((2, eb.MAX_FIELDS + 1, 8)), many, many_lens,
            [5] * (eb.MAX_FIELDS + 1)), "kMaxFields"),
        "coo cpu": (lambda: eb.embedding_bag_grouped_coo_rows_cuda(
            g, ids, lens, [5]), "CUDA tensors"),
        "grad under grad mode": (lambda: eb.embedding_bag_grouped_fwd_cuda(
            [t.clone().requires_grad_(True)], ids, lens), "requires grad"),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_grouped_wrappers_refuse_before_any_build(case):
    call, match = _refusals()[case]
    with pytest.raises((ValueError, RuntimeError), match=match):
        call()
    assert eb._lib is None                         # nothing was built


def test_grouped_entry_point_on_cpu_takes_plain_version(monkeypatch):
    from repro_torch.kernels import dispatch
    monkeypatch.delenv(dispatch.EMB_ENV_VAR, raising=False)
    x = group_case(61, 3)
    tables, ids, lens = port(x)
    before = (eb.fwd_launch_count, eb.coo_launch_count)
    for pooling in POOLINGS:
        assert torch.equal(eb.embedding_bag_grouped(tables, ids, lens,
                                                    pooling),
                           eb.embedding_bag_grouped_plain(tables, ids, lens,
                                                          pooling))
    assert (eb.fwd_launch_count, eb.coo_launch_count) == before
    with pytest.raises(ValueError, match="pooling"):
        eb.embedding_bag_grouped(tables, ids, lens, "median")
    with pytest.raises(ValueError, match="at least one"):
        eb.embedding_bag_grouped([], ids, lens)


def test_group_index_converts_only_when_needed():
    cpu = torch.device("cpu")
    base = torch.arange(60, dtype=torch.int32).reshape(3, 5, 4)
    ids = base[:, 1:4, :]                          # a strided view
    lens = torch.full((3, 5), 2, dtype=torch.int32)[:, 1:4]
    got_ids, got_lens = eb._group_index("t", ids, lens, 3, cpu)
    assert got_ids is ids and got_lens is lens     # no copy
    assert got_ids.stride() == (20, 4, 1)
    wide_ids, wide_lens = eb._group_index("t", ids.long(), lens.long(), 3,
                                          cpu)
    assert wide_ids.dtype == wide_lens.dtype == torch.int32
    assert torch.equal(wide_ids, ids) and torch.equal(wide_lens, lens)
    with pytest.raises(ValueError, match=r"\(B, F, L\)"):
        eb._group_index("t", ids, lens, 2, cpu)
    with pytest.raises(ValueError, match=r"\(B, F, L\)"):
        eb._group_index("t", ids[:, :, 0], lens, 3, cpu)
    with pytest.raises(TypeError, match="integers"):
        eb._group_index("t", ids.float(), lens, 3, cpu)


@pytest.mark.parametrize("dedup", [False, True])
def test_collection_grouped_lookup_matches_per_field(plain_launches,
                                                     monkeypatch, dedup):
    """The grouped lookup equals the per-field one, output and gradients;
    under forced dedup each field pools its own distinct rows, and the
    small tables still go through one grouped call."""
    x = group_case(71, 4, b=10, l=6, d=8)
    tables, ids, lens = port(x)
    seen = []

    def grouped(ts, i, n, pooling="sum", backend=None):
        seen.append([t.shape[0] for t in ts])
        return eb.GroupedEmbeddingBagFn.apply(i, n, pooling, *ts)

    monkeypatch.setattr(ec, "embedding_bag_grouped", grouped)
    leaves = [t.clone().requires_grad_(True) for t in tables]
    got = ec.bag_lookup_dense_grouped(leaves, ids, lens, "mean", dedup=dedup)
    grads = torch.autograd.grad(got.sum(), leaves)
    ref_leaves = [t.clone().requires_grad_(True) for t in tables]
    want = torch.stack([ec.bag_lookup_dense(t, ids[:, f, :], lens[:, f],
                                            "mean", dedup=False,
                                            backend="torch")
                        for f, t in enumerate(ref_leaves)], dim=1)
    want_grads = torch.autograd.grad(want.sum(), ref_leaves)
    assert torch.equal(got, want)
    for a, b in zip(grads, want_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD_TOL)
    distinct = [len(np.unique(np.clip(x["ids"][:, f, :], 0, v - 1)))
                for f, v in enumerate(x["vocabs"])]
    assert seen == [distinct if dedup else x["vocabs"]]
    assert plain_launches == {"fwd": 1, "coo": 1}


def test_dlrm_runs_one_group_a_side(plain_launches, monkeypatch):
    """dlrm's ROO forward makes one grouped bag call a side (13 RO + 13
    NRO fields), the impression-level forward one over all 26; through
    ``GroupedEmbeddingBagFn`` a ROO training step launches B5 and B6 twice
    each."""
    cfg = dlrm.DLRMConfig(vocabs=tuple([100] * 26), embed_dim=16,
                          bot_mlp=(13, 32, 16), top_mlp=(64, 32, 1))
    params = dlrm.dlrm_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    from repro_torch.configs.registry import scenario
    from repro_torch.scenario.build import synthetic_dlrm_batches
    b = synthetic_dlrm_batches(
        scenario("dlrm-mlperf", {"data.seed": 3, "batcher.b_ro": 8,
                                 "batcher.b_nro": 32}),
        cfg, n_batches=1, device="cpu")[0]
    widths = []

    def grouped(ts, i, n, pooling="sum", backend=None):
        widths.append(len(ts))
        return eb.GroupedEmbeddingBagFn.apply(i, n, pooling, *ts)

    monkeypatch.setattr(ec, "embedding_bag_grouped", grouped)
    for t in params["tables"].values():
        t.requires_grad_(True)
    args = (b["ro_dense"], b["ro_ids"], b["ro_len"], b["nro_ids"],
            b["nro_len"], b["seg"])
    logits = dlrm.dlrm_forward_roo(params, cfg, *args)
    assert widths == [13, 13] and plain_launches["fwd"] == 2
    logits.sum().backward()
    assert plain_launches == {"fwd": 2, "coo": 2}
    seg = b["seg"].long()
    with torch.no_grad():
        imp = dlrm.dlrm_forward_impression(
            params, cfg, b["ro_dense"][seg],
            torch.cat([b["ro_ids"][seg], b["nro_ids"]], 1),
            torch.cat([b["ro_len"][seg], b["nro_len"]], 1))
    assert widths == [13, 13, 26] and plain_launches["fwd"] == 3
    np.testing.assert_allclose(imp.numpy(), logits.detach().numpy(),
                               atol=1e-5, rtol=1e-5)


def test_kernel_source_is_one_grouped_family():
    text = eb.SOURCE.read_text()
    assert f"constexpr int kMaxFields = {eb.MAX_FIELDS};" in text
    for name in ("embedding_bag_fwd_grouped_kernel",
                 "embedding_bag_bwd_coo_grouped_kernel",
                 "int embedding_bag_fwd_grouped(",
                 "int embedding_bag_bwd_coo_grouped(", "static_assert"):
        assert name in text
    # the per-field kernels and entries are gone
    for name in ("embedding_bag_fwd_kernel", "embedding_bag_bwd_coo_kernel",
                 "int embedding_bag_fwd(", "int embedding_bag_bwd_coo("):
        assert name not in text
