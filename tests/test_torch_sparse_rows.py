"""The port's sparse-row structures held against the JAX reference
(``repro/embeddings/sparse.py`` and the proxy in its collection), as
``tests/test_embeddings.py``'s ``TestGatheredTable`` and ``TestSparseRows``
hold the reference:

  * ``SparseRows``: ``merged`` (unique sorted ids padded with the vocab
    sentinel, duplicates summed), ``to_dense``, ``scale``, ``sq_sum`` and
    the accumulation helpers against the reference's on the same numpy
    COO; the one-hot route the card takes for tiny tables against a
    float64 scatter; the card's gather backward is the densify;
  * ``gather_table``: the same uids and rows as the reference's;
  * the proxy lookups (seq, row, jagged bag, padded bag in sum / mean /
    max, the grouped bag with gathered and dense fields mixed) equal the
    dense lookups exactly, and an id that was not gathered reads zero;
  * ``GroupedEmbeddingBagFn`` over gathered rows, its launches swapped for
    counting plain versions: the rows' gradient equals the reference's
    ``SparseRows`` rows, and a mixed group is one launch each way;
  * ``dlrm_table_ids`` and ``EmbeddingCollection.request_ids`` /
    ``lookup`` / ``lookup_keyed`` against the reference's;
  * ``tree.py``'s ``is_leaf`` rule, and today's leaf order unchanged;
  * the merge, the gathered-rows densify and the one-hot route bitwise on
    repeat with 8 CPU threads.

Lookups are index bookkeeping, so they compare exactly (atol 0); sums of
duplicates compare at 1e-6 against the reference and bit for bit on
repeat.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.jagged import JaggedTensor as JaxJagged
from repro.data.jagged import KeyedJagged as JaxKeyed
from repro.embeddings import collection as jax_ec
from repro.embeddings import sparse as jax_sp
from repro.models import dlrm as jax_dlrm
from repro_torch import tree
from repro_torch.data.jagged import JaggedTensor, KeyedJagged
from repro_torch.embeddings import collection as ec
from repro_torch.embeddings import sparse as sp
from repro_torch.kernels import embedding_bag as eb
from repro_torch.models import dlrm

SUM_TOL = dict(atol=1e-6, rtol=1e-6)
POOLINGS = ["sum", "mean", "max"]


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def coo_case(seed, n=40, vocab=12, d=5):
    """COO entries with repeated ids and a few padding (== vocab) ones."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab + 1, size=n).astype(np.int32)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    return ids, rows, vocab


def both_coo(ids, rows, vocab):
    return (sp.SparseRows(torch.from_numpy(ids), torch.from_numpy(rows),
                          vocab),
            jax_sp.SparseRows(jnp.asarray(ids), jnp.asarray(rows), vocab))


# ---------------------------------------------------------------------------
# SparseRows
# ---------------------------------------------------------------------------

def test_merge_and_densify_reference_case():
    g = sp.SparseRows(torch.tensor([2, 0, 2, 5], dtype=torch.int32),
                      torch.tensor([[1., 1.], [2., 2.], [3., 3.], [4., 4.]]),
                      vocab=5)                       # id 5 == padding
    dense = g.to_dense()
    assert dense.shape == (5, 2) and g.shape == (5, 2)
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(np_(dense[2]), [4., 4.])
    np.testing.assert_array_equal(np_(dense[0]), [2., 2.])
    m = g.merged()
    assert m.unique and m.merged() is m
    np.testing.assert_array_equal(np_(m.ids), [0, 2, 5, 5])
    np.testing.assert_array_equal(np_(m.to_dense()), np_(dense))


@pytest.mark.parametrize("seed,n,vocab", [(0, 40, 12), (1, 200, 7),
                                          (2, 64, 500), (3, 1, 3)])
def test_merged_matches_reference(seed, n, vocab):
    ports, ref = both_coo(*coo_case(seed, n, vocab))
    got, want = ports.merged(), ref.merged()
    assert got.unique and got.vocab == vocab
    assert got.ids.dtype == torch.int32
    np.testing.assert_array_equal(np_(got.ids), np_(want.ids))
    np.testing.assert_allclose(np_(got.rows), np_(want.rows), **SUM_TOL)
    np.testing.assert_allclose(np_(got.to_dense()), np_(ref.to_dense()),
                               **SUM_TOL)


def test_scale_sq_sum_and_is_sparse_match_reference():
    ports, ref = both_coo(*coo_case(5))
    assert sp.is_sparse(ports) and not sp.is_sparse(ports.rows)
    np.testing.assert_allclose(np_(ports.scale(0.5).rows),
                               np_(ref.scale(0.5).rows), atol=0)
    np.testing.assert_allclose(float(sp.sq_sum(ports)),
                               float(jax_sp.sq_sum(ref)), rtol=1e-6)
    dense = np.random.default_rng(6).normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(float(sp.sq_sum(torch.from_numpy(dense))),
                               float(jax_sp.sq_sum(jnp.asarray(dense))),
                               rtol=1e-6)


def test_accumulation_helpers_match_reference():
    """split -> merge round trip, concat in microbatch order and scaled,
    flatten_stacked of a stacked pair, each against the reference's."""
    parts = [coo_case(s, 10, 9, 3) for s in (7, 8)]
    dense = np.ones((2, 2), np.float32)

    def grads(make_rows, make_arr, i):
        return {"w": make_arr(dense * (i + 1)),
                "tables": {"t0": make_rows(*parts[i])}}

    port_g = [grads(lambda *c: both_coo(*c)[0], torch.from_numpy, i)
              for i in range(2)]
    ref_g = [grads(lambda *c: both_coo(*c)[1], jnp.asarray, i)
             for i in range(2)]
    d, s = sp.split_sparse(port_g[0])
    assert d["tables"]["t0"] is None and s["w"] is None
    assert s["tables"]["t0"] is port_g[0]["tables"]["t0"]
    back = sp.merge_sparse(d, s)
    assert list(back) == list(port_g[0])
    assert back["tables"]["t0"] is port_g[0]["tables"]["t0"]
    assert back["w"] is port_g[0]["w"]

    got = sp.concat_sparse([sp.split_sparse(g)[1] for g in port_g], 0.5)
    want = jax_sp.concat_sparse([jax_sp.split_sparse(g)[1] for g in ref_g],
                                0.5)
    t, w = got["tables"]["t0"], want["tables"]["t0"]
    assert not t.unique and t.vocab == 9
    np.testing.assert_array_equal(np_(t.ids), np_(w.ids))
    np.testing.assert_array_equal(np_(t.rows), np_(w.rows))

    stacked = sp.SparseRows(
        torch.stack([torch.from_numpy(p[0]) for p in parts]),
        torch.stack([torch.from_numpy(p[1]) for p in parts]), 9)
    jstacked = jax_sp.SparseRows(jnp.stack([p[0] for p in parts]),
                                 jnp.stack([p[1] for p in parts]), 9)
    f = sp.flatten_stacked({"t": stacked}, 0.25)["t"]
    jf = jax_sp.flatten_stacked({"t": jstacked}, 0.25)["t"]
    np.testing.assert_array_equal(np_(f.ids), np_(jf.ids))
    np.testing.assert_array_equal(np_(f.rows), np_(jf.rows))


@pytest.mark.parametrize("vocab", [4, 14, 36, 63])
def test_one_hot_route_matches_scatter(vocab):
    """The card's route for tables under ONE_HOT_MAX_ROWS rows, run on the
    CPU: 8,192 ids into ``vocab`` rows (dlrm's tiny NRO tables), the
    sentinel dropped, against a float64 scatter within one fp32 rounding."""
    assert vocab < sp.ONE_HOT_MAX_ROWS
    ids, rows, _ = coo_case(vocab, 8192, vocab, 16)
    want = np.zeros((vocab + 1, 16), np.float64)
    np.add.at(want, ids, rows.astype(np.float64))
    got = sp.one_hot_sum(torch.from_numpy(ids), torch.from_numpy(rows),
                         vocab)
    assert got.shape == (vocab, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(np_(got), want[:vocab].astype(np.float32),
                               rtol=1e-6, atol=1e-6)


def test_card_gather_backward_is_the_densify():
    """On the card ``gather_rows``' backward is ``SparseRows.to_dense`` of
    the gradient's rows, so a plain bag's table gradient sums in the order
    the kernels' densify does; the Function runs on CPU tensors too."""
    rng = np.random.default_rng(15)
    table = torch.from_numpy(rng.normal(size=(9, 4)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 9, size=(6, 7)))
    g = torch.from_numpy(rng.normal(size=(6, 7, 4)).astype(np.float32))
    leaf = table.clone().requires_grad_(True)
    out = sp._GatherRows.apply(leaf, ids)
    assert torch.equal(out, table[ids])
    (got,) = torch.autograd.grad(out, leaf, g)
    want = sp.SparseRows(ids.reshape(-1), g.reshape(-1, 4), 9).to_dense()
    assert torch.equal(got, want)


def test_unique_padded_matches_jnp_unique():
    flat = np.random.default_rng(9).integers(0, 20, size=50).astype(np.int32)
    uids, inv = sp.unique_padded(torch.from_numpy(flat), 20)
    want, winv = jnp.unique(jnp.asarray(flat), size=50, fill_value=20,
                            return_inverse=True)
    np.testing.assert_array_equal(np_(uids), np_(want))
    np.testing.assert_array_equal(np_(inv), np_(winv).reshape(-1))
    assert torch.equal(uids[inv], torch.from_numpy(flat))


# ---------------------------------------------------------------------------
# GatheredTable and the proxy lookups
# ---------------------------------------------------------------------------

def lookup_case(seed=0, v=300, d=8, b=7, l=11):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(-3, v + 4, size=(b, l)).astype(np.int32)
    lens = rng.integers(0, l + 2, size=(b,)).astype(np.int32)
    return table, ids, lens


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_table_matches_reference(seed):
    table, ids, _ = lookup_case(seed)
    got = sp.gather_table(torch.from_numpy(table), torch.from_numpy(ids))
    want = jax_sp.gather_table(jnp.asarray(table), jnp.asarray(ids))
    assert isinstance(got, sp.GatheredTable) and got.shape == (300, 8)
    assert got.vocab == want.vocab and got.uids.dtype == torch.int32
    np.testing.assert_array_equal(np_(got.uids), np_(want.uids))
    np.testing.assert_array_equal(np_(got.rows), np_(want.rows))


def test_missing_id_reads_zero():
    """Ids outside the gathered set read zero rows, in the gathers and in
    every pooling of the padded bag."""
    table = torch.from_numpy(lookup_case(3, v=100, d=4)[0])
    gt = sp.gather_table(table, torch.tensor([3, 5]))
    out = gt.take(torch.tensor([3, 7, 5]))
    jout = jax_sp.gather_table(jnp.asarray(np_(table)),
                               jnp.asarray([3, 5])).take(
        jnp.asarray([3, 7, 5]))
    np.testing.assert_array_equal(np_(out), np_(jout))
    assert torch.equal(out[0], table[3]) and torch.equal(out[2], table[5])
    assert not out[1].any()
    ids = torch.tensor([[7, 8, 9], [3, 7, 5]])
    lens = torch.tensor([3, 3])
    for pooling in POOLINGS:
        got = ec.bag_lookup_dense(gt, ids, lens, pooling)
        assert not got[0].any()
        rows = torch.stack([table[3], torch.zeros(4), table[5]])
        want = {"sum": rows.sum(0), "mean": rows.sum(0) / 3,
                "max": rows.amax(0)}[pooling]
        assert torch.equal(got[1], want)


@pytest.mark.parametrize("dedup", [False, True])
def test_proxy_lookups_equal_dense(dedup):
    table, ids, lens = lookup_case(4)
    t, i, n = map(torch.from_numpy, (table, ids, lens))
    gt = sp.gather_table(t, i)
    assert torch.equal(ec.seq_lookup(gt, i, dedup=dedup),
                       ec.seq_lookup(t, i, dedup=False))
    assert torch.equal(ec.row_lookup(gt, i[:, 0], dedup=dedup),
                       ec.row_lookup(t, i[:, 0], dedup=False))
    for pooling in POOLINGS:
        assert torch.equal(
            ec.bag_lookup_dense(gt, i, n, pooling, dedup=dedup),
            ec.bag_lookup_dense(t, i, n, pooling, dedup=False))
        # and the reference's proxy bag on the same numbers
        want = jax_ec.bag_lookup_dense(
            jax_sp.gather_table(jnp.asarray(table), jnp.asarray(ids)),
            jnp.asarray(ids), jnp.asarray(lens), pooling)
        np.testing.assert_allclose(
            np_(ec.bag_lookup_dense(gt, i, n, pooling)), np_(want),
            **SUM_TOL)


@pytest.mark.parametrize("pooling", POOLINGS)
def test_proxy_jagged_bag_equals_dense(pooling):
    table, _, _ = lookup_case(5, v=40)
    rng = np.random.default_rng(5)
    values = np.zeros(20, np.int32)
    values[:13] = rng.integers(-2, 43, size=13)
    jt = JaggedTensor(torch.from_numpy(values),
                      torch.tensor([3, 0, 5, 1, 4], dtype=torch.int32))
    t = torch.from_numpy(table)
    gt = sp.gather_table(t, jt.values)
    assert torch.equal(ec.bag_lookup(gt, jt, pooling),
                       ec.bag_lookup(t, jt, pooling))


def grouped_case(seed=6, b=9, l=3, d=8):
    """Four fields: two tables of 300 and 120 rows gathered, a dense one
    under 64 rows between them, one more dense; ids with out-of-range
    entries and ragged lengths."""
    rng = np.random.default_rng(seed)
    vocabs = [300, 20, 120, 9]
    tables = [rng.normal(size=(v, d)).astype(np.float32) for v in vocabs]
    ids = np.stack([rng.integers(-2, v + 2, size=(b, l)) for v in vocabs],
                   axis=1).astype(np.int32)
    lens = rng.integers(0, l + 1, size=(b, 4)).astype(np.int32)
    return vocabs, tables, ids, lens


@pytest.fixture
def counted(monkeypatch):
    """The grouped CUDA launches swapped for counting plain versions, and
    the collection's grouped entry point routed through
    ``GroupedEmbeddingBagFn`` on CPU tensors, as it runs on the card."""
    calls = {"fwd": 0, "coo": 0}
    plain_fwd = eb.embedding_bag_grouped_plain
    plain_coo = eb.embedding_bag_grouped_coo_rows_plain

    def fwd(tables, ids, lengths, pooling="sum"):
        calls["fwd"] += 1
        return plain_fwd(tables, ids, lengths, pooling)

    def coo(g, ids, lengths, vocabs, pooling="sum"):
        calls["coo"] += 1
        return plain_coo(g, ids, lengths, vocabs, pooling)

    def grouped(ts, i, n, pooling="sum", backend=None):
        return eb.GroupedEmbeddingBagFn.apply(i, n, pooling, *ts)

    monkeypatch.setattr(eb, "embedding_bag_grouped_fwd_cuda", fwd)
    monkeypatch.setattr(eb, "embedding_bag_grouped_coo_rows_cuda", coo)
    monkeypatch.setattr(eb, "embedding_bag_grouped_coo_rows_plain", coo)
    monkeypatch.setattr(ec, "embedding_bag_grouped", grouped)
    return calls


@pytest.mark.parametrize("pooling", POOLINGS)
def test_mixed_group_is_one_launch_and_equals_dense(counted, pooling):
    vocabs, tables, ids, lens = grouped_case()
    ts = [torch.from_numpy(t) for t in tables]
    i, n = torch.from_numpy(ids), torch.from_numpy(lens)
    mixed = [sp.gather_table(t, i[:, f]) if v >= sp.SPARSE_MIN_VOCAB else t
             for f, (t, v) in enumerate(zip(ts, vocabs))]
    assert [isinstance(t, sp.GatheredTable) for t in mixed] == [
        True, False, True, False]
    got = ec.bag_lookup_dense_grouped(mixed, i, n, pooling)
    assert counted == {"fwd": 1, "coo": 0}
    want = ec.bag_lookup_dense_grouped(ts, i, n, pooling)
    assert torch.equal(got, want)
    for f, t in enumerate(ts):
        assert torch.equal(got[:, f], ec.bag_lookup_dense(
            t, i[:, f], n[:, f], pooling, backend="torch"))


@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_gathered_rows_gradient_matches_reference(counted, pooling):
    """A loss over the mixed group through ``GroupedEmbeddingBagFn`` (one
    B5, one B6 launch): each gathered table's row gradient equals the rows
    of the reference's ``SparseRows`` from its sparse value_and_grad, the
    dense tables' gradients its dense ones."""
    vocabs, tables, ids, lens = grouped_case(7)
    w = np.random.default_rng(8).normal(size=(9, 4, 8)).astype(np.float32)
    paths = [f"t{f}" for f in range(4)]

    def port_loss(p, b, gen):
        out = ec.bag_lookup_dense_grouped([p[k] for k in paths], b["ids"],
                                          b["lens"], pooling)
        return torch.sum(torch.from_numpy(w) * out)

    def jax_loss(p, b, r):
        out = jnp.stack([jax_ec.bag_lookup_dense(
            p[k], b["ids"][:, f], b["lens"][:, f], pooling, backend="jnp")
            for f, k in enumerate(paths)], axis=1)
        return jnp.sum(w * out)

    def ids_fn(b):
        return {k: b["ids"][:, f] for f, k in enumerate(paths)}

    params = {k: torch.from_numpy(t) for k, t in zip(paths, tables)}
    batch = {"ids": torch.from_numpy(ids), "lens": torch.from_numpy(lens)}
    loss, grads = sp.make_sparse_value_and_grad(port_loss, ids_fn)(
        params, batch, None)
    assert counted == {"fwd": 1, "coo": 1}
    jparams = {k: jnp.asarray(t) for k, t in zip(paths, tables)}
    jbatch = {"ids": jnp.asarray(ids), "lens": jnp.asarray(lens)}
    jloss, jgrads = jax_sp.make_sparse_value_and_grad(jax_loss, ids_fn)(
        jparams, jbatch, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k, v in zip(paths, vocabs):
        g, jg = grads[k], jgrads[k]
        if v >= sp.SPARSE_MIN_VOCAB:
            assert sp.is_sparse(g) and g.unique and g.vocab == v
            np.testing.assert_array_equal(np_(g.ids), np_(jg.ids))
            np.testing.assert_allclose(np_(g.rows), np_(jg.rows), **SUM_TOL)
        else:
            assert not sp.is_sparse(g) and g.shape == (v, 8)
            np.testing.assert_allclose(np_(g), np_(jg), **SUM_TOL)


def test_bag_gradient_densifies_into_the_small_buffer(counted, monkeypatch):
    """The gathered rows' gradient is the densify of B6's COO rows into
    the (N + 1, D) buffer of the rows and the zero row."""
    seen = []
    to_dense = sp.SparseRows.to_dense

    def spy(self):
        seen.append((self.vocab, tuple(self.ids.shape)))
        return to_dense(self)

    monkeypatch.setattr(sp.SparseRows, "to_dense", spy)
    table, ids, lens = lookup_case(9, v=500)
    i, n = torch.from_numpy(ids), torch.from_numpy(lens)
    gt = sp.gather_table(torch.from_numpy(table), i)
    rows = gt.rows.requires_grad_(True)
    out = ec.bag_lookup_dense_grouped(
        [sp.GatheredTable(gt.uids, rows, gt.vocab)], i[:, None],
        n[:, None], "sum")
    out.sum().backward()
    assert seen == [(ids.size + 1, (ids.size,))]
    assert rows.grad.shape == rows.shape


# ---------------------------------------------------------------------------
# the collection and dlrm's declaration
# ---------------------------------------------------------------------------

def test_collection_lookup_and_request_ids_match_reference():
    cfg = ec.EmbeddingCollectionConfig((
        ec.TableConfig("items", 50, 4), ec.TableConfig("cats", 10, 4)))
    feats = (ec.FeatureSpec("hist", "items", "bag", "mean"),
             ec.FeatureSpec("tgt", "items", "row"),
             ec.FeatureSpec("seq", "items", "seq"),
             ec.FeatureSpec("cat", "cats", "jagged", "sum"))
    jcfg = jax_ec.EmbeddingCollectionConfig((
        jax_ec.TableConfig("items", 50, 4), jax_ec.TableConfig("cats", 10, 4)))
    jfeats = tuple(jax_ec.FeatureSpec(f.name, f.table, f.kind, f.pooling)
                   for f in feats)
    col, jcol = ec.EmbeddingCollection(cfg, feats), \
        jax_ec.EmbeddingCollection(jcfg, jfeats)
    rng = np.random.default_rng(10)
    tables = {"items": rng.normal(size=(50, 4)).astype(np.float32),
              "cats": rng.normal(size=(10, 4)).astype(np.float32)}
    hist = rng.integers(0, 52, size=(3, 5)).astype(np.int32)
    tgt = rng.integers(0, 50, size=(3,)).astype(np.int32)
    vals = rng.integers(0, 10, size=(8,)).astype(np.int32)
    lens = np.array([2, 0, 4], np.int32)
    pt = {k: torch.from_numpy(v) for k, v in tables.items()}
    jt = {k: jnp.asarray(v) for k, v in tables.items()}
    pj = JaggedTensor(torch.from_numpy(vals), torch.from_numpy(lens))
    jj = JaxJagged(jnp.asarray(vals), jnp.asarray(lens))
    for name, pids, jids in (("hist", torch.from_numpy(hist), hist),
                             ("tgt", torch.from_numpy(tgt), tgt),
                             ("seq", torch.from_numpy(hist), hist),
                             ("cat", pj, jj)):
        np.testing.assert_allclose(
            np_(col.lookup(pt, name, pids)),
            np_(jcol.lookup(jt, name, jids if name == "cat"
                            else jnp.asarray(jids))), **SUM_TOL)
    got = col.lookup_keyed(pt, KeyedJagged({"cat": pj, "other": pj}))
    want = jcol.lookup_keyed(jt, JaxKeyed({"cat": jj, "other": jj}))
    assert list(got) == list(want) == ["cat"]
    np.testing.assert_allclose(np_(got["cat"]), np_(want["cat"]), **SUM_TOL)
    ids = col.request_ids({"hist": torch.from_numpy(hist),
                           "tgt": torch.from_numpy(tgt), "cat": pj},
                          prefix="tables/")
    jids = jcol.request_ids({"hist": jnp.asarray(hist),
                             "tgt": jnp.asarray(tgt), "cat": jj},
                            prefix="tables/")
    assert list(ids) == list(jids) == ["tables/items", "tables/cats"]
    for k in ids:
        np.testing.assert_array_equal(np_(ids[k]), np_(jids[k]))
    # the gathered proxy through the collection's named lookup
    gt = {"items": sp.gather_table(pt["items"], ids["tables/items"]),
          "cats": pt["cats"]}
    assert torch.equal(col.lookup(gt, "hist", torch.from_numpy(hist)),
                       col.lookup(pt, "hist", torch.from_numpy(hist)))


def test_dlrm_table_ids_match_reference():
    kw = dict(n_dense=4, embed_dim=16, bot_mlp=(4, 32, 16),
              top_mlp=(64, 32, 1), vocabs=(512, 256, 64, 32),
              n_ro_fields=2, multi_hot=2)
    cfg, jcfg = dlrm.DLRMConfig(**kw), jax_dlrm.DLRMConfig(**kw)
    rng = np.random.default_rng(11)
    ro = rng.integers(0, 256, size=(8, 2, 2)).astype(np.int32)
    nro = rng.integers(0, 32, size=(32, 2, 2)).astype(np.int32)
    got = dlrm.dlrm_table_ids(cfg, torch.from_numpy(ro),
                              torch.from_numpy(nro))
    want = jax_dlrm.dlrm_table_ids(jcfg, jnp.asarray(ro), jnp.asarray(nro))
    assert list(got) == list(want) == [f"tables/t{i}" for i in range(4)]
    for k in got:
        np.testing.assert_array_equal(np_(got[k]), np_(want[k]))


# ---------------------------------------------------------------------------
# tree.py's leaf rule
# ---------------------------------------------------------------------------

def test_is_leaf_keeps_sparse_rows_whole():
    g = sp.SparseRows(torch.zeros(3, dtype=torch.int32), torch.ones(3, 2), 9)
    t = {"b": [g, torch.ones(1)], "a": torch.zeros(2)}
    # without the rule a dataclass is a node: its fields, the vocab int
    # too, become leaves
    assert [p[2:] for p, _ in tree.flatten_with_path(t) if len(p) > 2] == [
        ("['ids']",), ("['rows']",), ("['vocab']",), ("['unique']",)]
    flat = tree.flatten_with_path(t, is_leaf=sp.is_sparse)
    assert [p for p, _ in flat] == [("['a']",), ("['b']", "[0]"),
                                    ("['b']", "[1]")]
    assert flat[1][1] is g
    mapped = tree.tree_map(lambda x: x if sp.is_sparse(x) else x + 1, t,
                           is_leaf=sp.is_sparse)
    assert mapped["b"][0] is g and torch.equal(mapped["a"], torch.ones(2))
    assert tree.unflatten(t, ["x", "y", "z"],
                          is_leaf=sp.is_sparse) == {"b": ["y", "z"],
                                                    "a": "x"}


def test_leaf_order_unchanged_for_params_trees():
    """Today's trees (no SparseRows) flatten in JAX's order with and
    without the rule: checkpoints and make_mixed states do not move."""
    kw = dict(vocabs=(100, 70), embed_dim=8, bot_mlp=(13, 16, 8),
              top_mlp=(16, 1), n_ro_fields=1)
    jp = jax_dlrm.dlrm_init(jax.random.PRNGKey(0), jax_dlrm.DLRMConfig(**kw))
    pp = dlrm.dlrm_init(torch.Generator().manual_seed(0),
                        dlrm.DLRMConfig(**kw), device="cpu")
    jpaths = [tuple(str(k) for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    for rule in (None, sp.is_sparse):
        assert [p for p, _ in tree.flatten_with_path(pp, is_leaf=rule)] \
            == jpaths


# ---------------------------------------------------------------------------
# bitwise on repeat with 8 threads
# ---------------------------------------------------------------------------

@pytest.fixture
def eight_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    assert torch.get_num_threads() > 1
    yield
    torch.set_num_threads(before)


def _repeat(fn, n=3):
    out = [fn() for _ in range(n)]
    for other in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], other))
    return out[0]


def test_merge_and_densify_routes_bitwise_on_repeat(eight_threads):
    """20,000 COO entries into 50 of 50,000 rows: ``merged``, the densify
    of gathered rows' positions into an (N + 1, D) buffer, and the one-hot
    route at 8,192 ids into 4 rows, three times each."""
    rng = np.random.default_rng(12)
    hit = rng.choice(50_000, size=50, replace=False)
    ids = torch.from_numpy(hit[rng.integers(0, 50, size=20_000)].astype(
        np.int32))
    rows = torch.from_numpy((0.01 * rng.normal(size=(20_000, 64))).astype(
        np.float32))
    coo = sp.SparseRows(ids, rows, 50_000)
    m = _repeat(lambda: (coo.merged().ids, coo.merged().rows))
    want = np.zeros((50_000, 64))
    np.add.at(want, np_(ids), np_(rows).astype(np.float64))
    np.testing.assert_allclose(
        np_(sp.SparseRows(m[0], m[1], 50_000).to_dense()), want, atol=1e-5)
    gt = sp.gather_table(torch.zeros((50_000, 64)), ids)
    pos, _ = gt.positions(ids)
    dense = _repeat(lambda: (sp.SparseRows(pos, rows, len(pos) + 1)
                             .to_dense(),))[0]
    np.testing.assert_allclose(np_(dense[:50]), want[np.sort(hit)],
                               atol=1e-5)
    small = torch.from_numpy(rng.integers(0, 5, size=8192).astype(np.int32))
    _repeat(lambda: (sp.one_hot_sum(small, rows[:8192], 4),))
