"""The port's incremental hstu-gr serving held against the JAX reference.

Layers under test, bottom up, each fed the same seeded numpy inputs:

  * attention — the port's cached-prefix dense oracle and chunked path vs
    the reference's ``jnp-dense``, ``jnp-chunked`` and Pallas (interpret)
    prefix backends, rab on and off; rows past the counts exactly 0; the
    unified fallback (prefix 0, n_new == n_hist) equal to the full forward;
  * model     — gr_score_from_state / gr_extend_user_state with the
    reference's params carried across (interop), and states carried across
    both ways;
  * stores    — UserStateStore / UserTowerCache driven by the same
    operations as the reference's, digests equal byte for byte;
  * engine    — the incremental ScoringEngine against the reference's
    incremental engine and the port's stateless engine; ROOServer with the
    user-tower cache against the reference's.

Tolerances. Cross-package: 1e-5 on attention and K/V caches (fp32 on both
sides, summation order differs) and 1e-4 on scores; never bitwise, as
the reference itself drifts by 1 ulp between its incremental and full
paths (ROADMAP queue C). Within the port on the CPU: bitwise
(``assert_array_equal``) for incremental against full recompute — the row
projections are row-count invariant, masked cells contribute exact zeros
and the 1/n factor is pinned to the full sequence length.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hstu import HSTUConfig as JaxHSTUConfig
from repro.core.hstu import hstu_attention_chunked as jax_full_chunked
from repro.core.joiner import ROOSample as JaxSample
from repro.core.masks import prefix_spec as jax_prefix_spec
from repro.core.masks import roo_spec as jax_roo_spec
from repro.data.batcher import BatcherConfig as JaxBatcherConfig
from repro.data.batcher import ROOBatcher as JaxBatcher
from repro.kernels import dispatch as jax_dispatch
from repro.models import gr as jax_gr
from repro.serve import user_cache as jax_uc
from repro.serve.adapter import ServeAdapter as JaxAdapter
from repro.serve.engine import EnginePolicy as JaxPolicy
from repro.serve.engine import ScoringEngine as JaxEngine
from repro.serve.serving import ROOServer as JaxServer
from repro.serve.serving import ServeConfig as JaxServeConfig
from repro_torch.core.hstu import HSTUConfig, hstu_attention_chunked
from repro_torch.core.joiner import ROOSample
from repro_torch.core.masks import prefix_spec, roo_spec
from repro_torch.data.batcher import BatcherConfig, ROOBatcher
from repro_torch.interop import (gr_state_from_numpy, gr_state_to_numpy,
                                 params_from_numpy)
from repro_torch.kernels import dispatch
from repro_torch.kernels import hstu_attention as b1
from repro_torch.kernels import hstu_attention_prefix as b4
from repro_torch.models import gr
from repro_torch.serve import user_cache as uc
from repro_torch.serve.adapter import ServeAdapter
from repro_torch.serve.engine import EnginePolicy, ScoringEngine
from repro_torch.serve.serving import ROOServer, ServeConfig

ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)

# tiny GR as in the reference's tests/test_incremental.py: 2 layers and 2
# heads of real HSTU, small enough to run quickly on the CPU
TINY = gr.GRConfig(
    n_items=60,
    hstu=HSTUConfig(d_model=16, n_heads=2, d_qk=8, d_v=8, n_layers=2,
                    max_rel_pos=8),
    hist_len=8, m_targets=4)
JAX_TINY = jax_gr.GRConfig(
    n_items=60,
    hstu=JaxHSTUConfig(d_model=16, n_heads=2, d_qk=8, d_v=8, n_layers=2,
                       max_rel_pos=8),
    hist_len=8, m_targets=4)


def mk_req(make, uid, hist, items):
    hist = [int(x) for x in hist]
    return make(
        request_id=uid, user_id=uid,
        ro_dense=np.full((4,), float(uid), np.float32),
        ro_idlist=[uid % 7 + 1],
        history_ids=hist, history_actions=[h % 4 for h in hist],
        item_ids=[int(i) for i in items],
        item_dense=[np.full((4,), float(i), np.float32) for i in items],
        item_idlist=[[int(i) % 5 + 1] for i in items],
        labels=[{"click": 0.0, "view_sec": 0.0} for _ in items])


def both(uid, hist, items):
    """(port request, reference request) with the same payload."""
    return mk_req(ROOSample, uid, hist, items), mk_req(JaxSample, uid, hist,
                                                       items)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

# (B, H, n_hist, n_new, m, Dqk, Dv, max_rel, scale_len)
CASES = {
    "serve": (3, 2, 16, 8, 4, 8, 8, 16, 20),
    # no length is a multiple of the 8-row tiles or the 4-row chunks
    "ragged": (4, 2, 21, 5, 3, 12, 10, 6, 24),
    # extend-only: no target rows or columns
    "extend": (3, 2, 16, 8, 0, 8, 8, 16, 20),
}


def prefix_inputs(case, seed=0):
    """Random inputs with ragged per-request prefixes honoring the engine
    contract prefix + new <= n_hist (zeros included)."""
    b, h, n_hist, n_new, m, dqk, dv, max_rel, scale_len = CASES[case]
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, h, n_new + m, dqk)).astype(np.float32)
    k = r.normal(size=(b, h, n_hist + m, dqk)).astype(np.float32)
    v = r.normal(size=(b, h, n_hist + m, dv)).astype(np.float32)
    rab = (0.5 * r.normal(size=(h, 2 * max_rel + 1))).astype(np.float32)
    hl = r.integers(0, n_hist + 1, size=b)
    hl[0] = n_hist
    pfx = np.array([r.integers(0, x + 1) for x in hl])
    pfx[-1] = 0
    new = np.minimum(hl - pfx, n_new)
    tgt = r.integers(0, m + 1, size=b)
    return dict(q=q, k=k, v=v, rab=rab, n_hist=n_hist, n_new=n_new,
                max_rel=max_rel, scale_len=scale_len,
                pfx=pfx.astype(np.int32), new=new.astype(np.int32),
                tgt=tgt.astype(np.int32))


def port_spec(x):
    return prefix_spec(torch.from_numpy(x["pfx"]), torch.from_numpy(x["new"]),
                       torch.from_numpy(x["tgt"]), x["n_hist"], x["n_new"])


def jax_spec(x):
    return jax_prefix_spec(jnp.asarray(x["pfx"]), jnp.asarray(x["new"]),
                           jnp.asarray(x["tgt"]), x["n_hist"], x["n_new"])


def port_prefix(x, backend, use_rab, **kw):
    t = {key: torch.from_numpy(x[key]) for key in ("q", "k", "v", "rab")}
    return dispatch.hstu_attention_prefix(
        t["q"], t["k"], t["v"], t["rab"] if use_rab else None, port_spec(x),
        backend=backend, scale_len=x["scale_len"], max_rel_pos=x["max_rel"],
        **kw).numpy()


def jax_prefix(x, backend, use_rab, **kw):
    return np.asarray(jax_dispatch.hstu_attention_prefix(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.asarray(x["rab"]) if use_rab else None, jax_spec(x),
        backend=backend, scale_len=x["scale_len"], max_rel_pos=x["max_rel"],
        **kw))


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("case", sorted(CASES))
class TestPrefixAttention:
    def test_dense_matches_jnp_dense(self, case, use_rab):
        x = prefix_inputs(case)
        np.testing.assert_allclose(port_prefix(x, "torch-dense", use_rab),
                                   jax_prefix(x, "jnp-dense", use_rab),
                                   **ATTN_TOL)

    def test_chunked_matches_jnp_chunked(self, case, use_rab):
        x = prefix_inputs(case, seed=1)
        np.testing.assert_allclose(
            port_prefix(x, "torch-chunked", use_rab, chunk=4),
            jax_prefix(x, "jnp-chunked", use_rab, block_q=4), **ATTN_TOL)

    def test_matches_pallas_interpret(self, case, use_rab):
        x = prefix_inputs(case, seed=2)
        want = jax_prefix(x, "pallas-interpret", use_rab, block_q=8,
                          block_k=8)
        for backend in ("torch-dense", "torch-chunked"):
            np.testing.assert_allclose(port_prefix(x, backend, use_rab),
                                       want, **ATTN_TOL, err_msg=backend)

    def test_invalid_rows_exactly_zero(self, case, use_rab):
        # rows past a request's new/target count are padding: exact zeros
        x = prefix_inputs(case, seed=3)
        n_new = x["n_new"]
        for backend in ("torch-dense", "torch-chunked"):
            out = port_prefix(x, backend, use_rab)
            assert np.all(np.isfinite(out))
            for bi in range(out.shape[0]):
                assert np.all(out[bi, :, x["new"][bi]:n_new] == 0.0)
                assert np.all(out[bi, :, n_new + x["tgt"][bi]:] == 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_mask_equals_reference(case):
    x = prefix_inputs(case, seed=4)
    n_rows, n_cols = x["q"].shape[2], x["k"].shape[2]
    np.testing.assert_array_equal(
        port_spec(x).dense(n_rows, n_cols).numpy(),
        np.asarray(jax_spec(x).dense(n_rows, n_cols)))


@pytest.mark.parametrize("chunk", [1, 3, 8, 128])
def test_prefix_chunk_size_independence(chunk):
    x = prefix_inputs("ragged", seed=5)
    np.testing.assert_allclose(
        port_prefix(x, "torch-chunked", True, chunk=chunk),
        port_prefix(x, "torch-dense", True), **ATTN_TOL)


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
def test_unified_fallback_equals_full_attention(use_rab):
    # prefix 0 and n_new == n_hist: the prefix path IS the full ROO forward
    # (within the port: bitwise; against the reference's full chunked path
    # at the attention tolerance)
    r = np.random.default_rng(6)
    b, h, n_hist, m, d, max_rel = 3, 2, 16, 4, 8, 16
    q, k, v = (r.normal(size=(b, h, n_hist + m, d)).astype(np.float32)
               for _ in range(3))
    rab = r.normal(size=(h, 2 * max_rel + 1)).astype(np.float32)
    hl = np.array([16, 0, 9], np.int32)
    tc = np.array([4, 2, 0], np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    trab = torch.from_numpy(rab) if use_rab else None
    spec = prefix_spec(torch.zeros(b, dtype=torch.int32), torch.from_numpy(hl),
                       torch.from_numpy(tc), n_hist, n_hist)
    full = hstu_attention_chunked(
        *t, trab, roo_spec(torch.from_numpy(hl), torch.from_numpy(tc),
                           n_hist), max_rel_pos=max_rel, chunk=8)
    inc = dispatch.hstu_attention_prefix(
        *t, trab, spec, backend="torch-chunked", scale_len=n_hist + m,
        max_rel_pos=max_rel, chunk=8)
    np.testing.assert_array_equal(inc.numpy(), full.numpy())
    want = jax_full_chunked(
        *(jnp.asarray(a) for a in (q, k, v)),
        jnp.asarray(rab) if use_rab else None,
        jax_roo_spec(jnp.asarray(hl), jnp.asarray(tc), n_hist),
        max_rel_pos=max_rel, chunk=8)
    np.testing.assert_allclose(inc.numpy(), np.asarray(want), **ATTN_TOL)


def test_prefix_wrapper_cpu_takes_plain_version(monkeypatch):
    # the entry the model calls: auto on a CPU tensor runs a plain version
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    x = prefix_inputs("serve", seed=7)
    before = b4.launch_count
    got = port_prefix(x, None, True)
    t = {key: torch.from_numpy(x[key]) for key in ("q", "k", "v", "rab")}
    plain = b4.hstu_attention_prefix_plain(
        t["q"], t["k"], t["v"], t["rab"], x["n_hist"], x["n_new"],
        torch.from_numpy(x["pfx"]), torch.from_numpy(x["new"]),
        torch.from_numpy(x["tgt"]), x["scale_len"], x["max_rel"])
    np.testing.assert_allclose(got, plain.numpy(), **ATTN_TOL)
    np.testing.assert_array_equal(got, port_prefix(x, "torch-chunked", True))
    assert b4.launch_count == before      # the CPU path launches nothing
    assert b4.hstu_attention_prefix_plain is \
        b4.hstu_attention_prefix_ref


def test_prefix_cuda_backend_on_cpu_raises():
    x = prefix_inputs("serve")
    with pytest.raises(ValueError, match="CUDA"):
        port_prefix(x, "cuda", True)
    t = {key: torch.from_numpy(x[key]) for key in ("q", "k", "v", "rab")}
    with pytest.raises(ValueError, match="CUDA"):
        b4.hstu_attention_prefix_cuda(
            t["q"], t["k"], t["v"], t["rab"], x["n_hist"], x["n_new"],
            torch.from_numpy(x["pfx"]), torch.from_numpy(x["new"]),
            torch.from_numpy(x["tgt"]), x["scale_len"], x["max_rel"])


def test_prefix_kernel_module_imports_without_nvcc():
    # importing (done above) compiled and loaded nothing; B4 has its own
    # source beside B1's and a library named after it
    assert b4._lib is None
    assert b4.SOURCE.exists() and b4.SOURCE.suffix == ".cu"
    assert b4.SOURCE != b1.SOURCE and b4.SOURCE.parent == b1.SOURCE.parent
    text = b4.SOURCE.read_text()
    assert "_prefix_fwd_kernel" in text and 'extern "C"' in text


# ---------------------------------------------------------------------------
# GR state functions
# ---------------------------------------------------------------------------

GR_REQS = [(1, [], [5, 6]),                          # empty history
           (2, [3, 1, 4, 1, 5], [7]),
           (3, [2, 7, 1, 8, 2, 8, 1, 8], [9, 10, 11]),  # full window
           (4, [1, 2], [12, 13, 14, 15])]


@pytest.fixture(scope="module")
def jax_params():
    return jax_gr.gr_init(jax.random.PRNGKey(0), JAX_TINY)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")


@pytest.fixture(scope="module")
def batches():
    port = next(ROOBatcher(BatcherConfig(b_ro=4, b_nro=16, hist_len=8),
                           device="cpu").batches(
        [mk_req(ROOSample, *a) for a in GR_REQS]))
    ref = next(JaxBatcher(JaxBatcherConfig(b_ro=4, b_nro=16, hist_len=8))
               .batches([mk_req(JaxSample, *a) for a in GR_REQS]))
    return port, ref


def empty_states(b_ro):
    one = gr.gr_state_init(TINY, device="cpu")
    return gr.GRUserState(*(torch.stack([a] * b_ro) for a in one))


def half_batches(batches):
    port, ref = batches
    lengths = np.minimum(port.history_lengths.numpy(), TINY.hist_len)
    half = (lengths // 2).astype(np.int32)
    return (dataclasses.replace(port, history_lengths=torch.from_numpy(half)),
            dataclasses.replace(ref, history_lengths=jnp.asarray(half)),
            lengths)


def test_gr_state_init_matches_reference():
    mine = gr_state_to_numpy(gr.gr_state_init(TINY, device="cpu"))
    ref = jax.tree.map(np.asarray, jax_gr.gr_state_init(JAX_TINY))
    for a, b in zip(mine, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_extend_from_empty_is_full_forward(port_params, jax_params, batches):
    pb, rb = batches
    want = gr.gr_ranking_logits(port_params, TINY, pb)
    got, st = gr.gr_score_from_state(port_params, TINY, pb,
                                     empty_states(pb.b_ro),
                                     n_new=TINY.hist_len)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        st.length.numpy(), np.minimum(pb.history_lengths.numpy(), 8))
    ref = np.asarray(jax_gr.gr_ranking_logits(jax_params, JAX_TINY, rb))
    np.testing.assert_allclose(got.numpy(), ref, **SCORE_TOL)


def test_two_step_incremental_is_exact(port_params, batches):
    pb, _ = batches
    pb1, _, lengths = half_batches(batches)
    want = gr.gr_ranking_logits(port_params, TINY, pb)
    st1 = gr.gr_extend_user_state(port_params, TINY, pb1,
                                  empty_states(pb.b_ro), n_new=TINY.hist_len)
    np.testing.assert_array_equal(st1.length.numpy(), lengths // 2)
    got, st2 = gr.gr_score_from_state(port_params, TINY, pb, st1,
                                      n_new=TINY.hist_len)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(st2.length.numpy(), lengths)


def test_two_step_cache_matches_one_shot_cache(port_params, batches):
    pb, _ = batches
    pb1, _, lengths = half_batches(batches)
    _, st_full = gr.gr_score_from_state(port_params, TINY, pb,
                                        empty_states(pb.b_ro),
                                        n_new=TINY.hist_len)
    st1 = gr.gr_extend_user_state(port_params, TINY, pb1,
                                  empty_states(pb.b_ro), n_new=TINY.hist_len)
    _, st2 = gr.gr_score_from_state(port_params, TINY, pb, st1,
                                    n_new=TINY.hist_len)
    for bi, n in enumerate(lengths):
        np.testing.assert_array_equal(st2.k[bi, :, :n].numpy(),
                                      st_full.k[bi, :, :n].numpy())
        np.testing.assert_array_equal(st2.v[bi, :, :n].numpy(),
                                      st_full.v[bi, :, :n].numpy())


def test_extend_caches_match_reference(port_params, jax_params, batches):
    pb1, rb1, lengths = half_batches(batches)
    mine = gr.gr_extend_user_state(port_params, TINY, pb1,
                                   empty_states(pb1.b_ro), n_new=8)
    ref_empty = jax.tree.map(lambda a: jnp.stack([a] * 4),
                             jax_gr.gr_state_init(JAX_TINY))
    ref = jax_gr.gr_extend_user_state(jax_params, JAX_TINY, rb1, ref_empty,
                                      n_new=8)
    np.testing.assert_array_equal(mine.length.numpy(), np.asarray(ref.length))
    for bi, n in enumerate(lengths // 2):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                getattr(mine, name)[bi, :, :n].numpy(),
                np.asarray(getattr(ref, name))[bi, :, :n], **ATTN_TOL)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_states_carry_across_packages(port_params, jax_params, batches,
                                      direction):
    # one warm state, scored by both packages: same logits and caches
    pb, rb = batches
    pb1, rb1, lengths = half_batches(batches)
    if direction == "reference_to_port":
        ref_empty = jax.tree.map(lambda a: jnp.stack([a] * 4),
                                 jax_gr.gr_state_init(JAX_TINY))
        warm = jax.tree.map(np.asarray, jax_gr.gr_extend_user_state(
            jax_params, JAX_TINY, rb1, ref_empty, n_new=8))
    else:
        warm = gr_state_to_numpy(gr.gr_extend_user_state(
            port_params, TINY, pb1, empty_states(4), n_new=8))
    got, got_st = gr.gr_score_from_state(
        port_params, TINY, pb, gr_state_from_numpy(warm, "cpu"), n_new=4)
    want, want_st = jax_gr.gr_score_from_state(
        jax_params, JAX_TINY, rb,
        jax_gr.GRUserState(*(jnp.asarray(a) for a in warm)), n_new=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    np.testing.assert_array_equal(got_st.length.numpy(),
                                  np.asarray(want_st.length))
    for bi, n in enumerate(lengths):
        np.testing.assert_allclose(got_st.k[bi, :, :n].numpy(),
                                   np.asarray(want_st.k)[bi, :, :n],
                                   **ATTN_TOL)


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------

def store_script(name):
    """A sequence of (op, args) on a UserStateStore, as the reference's
    TestUserStateStore drives it."""
    hist8 = list(range(1, 9))
    return {
        "miss_then_hit": (4, [("probe", 1, [3, 1, 4], 0), ("put", 1, 0),
                              ("probe", 1, [3, 1, 4], 0)]),
        "grown_history": (4, [("probe", 1, [3, 1, 4], 0), ("put", 1, 0),
                              ("probe", 1, [3, 1, 4, 1, 5], 0)]),
        "rewritten_history": (4, [("probe", 1, [3, 1, 4], 0), ("put", 1, 0),
                                  ("probe", 1, [9, 9, 9, 1], 0)]),
        "window_slide": (4, [("probe", 1, hist8, 0), ("put", 1, 0),
                             ("probe", 1, hist8 + [9], 0)]),
        "epoch_mismatch": (4, [("probe", 1, [3, 1], 0), ("put", 1, 0),
                               ("probe", 1, [3, 1], 1)]),
        "invalidate_epoch": (8, [("probe", 0, [1], 0), ("put", 0, 0),
                                 ("probe", 1, [2], 0), ("put", 1, 0),
                                 ("probe", 2, [3], 0), ("put", 2, 0),
                                 ("invalidate_epoch", 1)]),
        "lru_eviction": (2, [("probe", 1, [1], 0), ("put", 1, 0),
                             ("probe", 2, [2], 0), ("put", 2, 0),
                             ("probe", 1, [1], 0),
                             ("probe", 3, [3], 0), ("put", 3, 0),
                             ("invalidate_user", 1),
                             ("invalidate_user", 9)]),
    }[name]


def run_store_script(mod, make, name):
    capacity, ops = store_script(name)
    store = mod.UserStateStore(capacity=capacity)
    trace, last = [], None
    for op in ops:
        if op[0] == "probe":
            _, uid, hist, epoch = op
            last = store.probe(mk_req(make, uid, hist, [9]), epoch, 8)
            trace.append(("probe", last.prefix_len, last.state is not None,
                          last.eff_len, last.digest))
        elif op[0] == "put":
            _, uid, epoch = op
            store.put(uid, epoch, last.eff_len, last.digest, f"state{uid}")
        elif op[0] == "invalidate_epoch":
            trace.append(("dropped", store.invalidate_epoch(op[1])))
        else:
            trace.append(("dropped", store.invalidate_user(op[1])))
    snap = store.stats.snapshot()
    return trace, snap, sorted(u for u in range(10) if u in store), len(store)


@pytest.mark.parametrize("name", ["miss_then_hit", "grown_history",
                                  "rewritten_history", "window_slide",
                                  "epoch_mismatch", "invalidate_epoch",
                                  "lru_eviction"])
def test_state_store_matches_reference(name):
    mine = run_store_script(uc, ROOSample, name)
    ref = run_store_script(jax_uc, JaxSample, name)
    assert mine == ref
    trace, snap, users, _ = mine
    if name == "rewritten_history" or name == "window_slide":
        assert snap["prefix_mismatches"] == 1 and 1 not in users
    if name == "grown_history":
        assert trace[-1][1:4] == (3, True, 5)
    if name == "lru_eviction":
        assert snap["evictions"] == 1 and users == [3]


@pytest.mark.parametrize("hist", [[], [3, 1, 4], list(range(200))])
def test_digests_equal_reference(hist):
    port, ref = both(7, hist, [1, 2])
    assert uc.request_key(port) == jax_uc.request_key(ref)
    assert uc.history_digest(hist, [h % 4 for h in hist]) == \
        jax_uc.history_digest(hist, [h % 4 for h in hist])
    assert uc.history_digest([1, 2], [0, 1]) != \
        uc.history_digest([2, 1], [0, 1])


def test_user_tower_cache_matches_reference():
    trace = []
    for mod in (uc, jax_uc):
        cache = mod.UserTowerCache(capacity=2)
        ka, kb, kc = ((i, b"k%d" % i) for i in range(3))
        cache.put(ka, np.ones(3))
        cache.put(kb, np.ones(3) * 2)
        got = [cache.get(ka) is not None]
        cache.put(kc, np.ones(3) * 3, epoch=0)     # evicts kb (LRU)
        got += [cache.get(kb) is None, cache.get(ka) is not None,
                cache.get(ka, epoch=1) is None, ka in cache]
        cache.put((1, b"x"), np.ones(2), epoch=1)
        got += [cache.invalidate_epoch(1), cache.invalidate_user(2),
                len(cache)]
        trace.append((got, cache.snapshot()))
    assert trace[0] == trace[1]
    assert trace[0][1]["evictions"] == 2


def test_user_tower_cache_put_copies_rows():
    cache = uc.UserTowerCache(capacity=4)
    big = np.ones((64, 8), np.float32)
    cache.put((1, b"k"), big[3])               # a view into `big`
    row = cache.get((1, b"k"))
    assert row.base is None                    # owns its memory
    big[3] = 0.0
    np.testing.assert_array_equal(row, 1.0)


def test_request_key_tracks_ro_payload_only():
    a, _ = both(1, [1, 2, 3], [1, 2, 3])
    b, _ = both(1, [1, 2, 3], [7, 8])          # same RO side, new items
    assert uc.request_key(a) == uc.request_key(b)
    c = dataclasses.replace(a, history_ids=[9, 9, 9])
    assert uc.request_key(a) != uc.request_key(c)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def port_adapter(cfg=TINY):
    return ServeAdapter(
        score=lambda p, b: gr.gr_ranking_logits(p, cfg, b),
        init_user_state=lambda: gr.gr_state_init(cfg, device="cpu"),
        extend_user_state=lambda p, b, s, *, n_new:
            gr.gr_extend_user_state(p, cfg, b, s, n_new=n_new),
        score_from_state=lambda p, b, s, *, n_new:
            gr.gr_score_from_state(p, cfg, b, s, n_new=n_new),
        state_hist_len=cfg.hist_len)


def jax_adapter(cfg=JAX_TINY):
    return JaxAdapter(
        score=lambda p, b: jax_gr.gr_ranking_logits(p, cfg, b),
        init_user_state=lambda: jax_gr.gr_state_init(cfg),
        extend_user_state=lambda p, b, s, *, n_new:
            jax_gr.gr_extend_user_state(p, cfg, b, s, n_new=n_new),
        score_from_state=lambda p, b, s, *, n_new:
            jax_gr.gr_score_from_state(p, cfg, b, s, n_new=n_new),
        state_hist_len=cfg.hist_len)


class Engines:
    """The port's stateless and incremental engines and the reference's
    incremental engine, over the same params."""

    def __init__(self, port_params, jax_params, capacity=32):
        kw = dict(max_requests=4, max_impressions=32, hist_len=8)
        self.full = ScoringEngine(port_params, adapter=port_adapter(),
                                  policy=EnginePolicy(**kw), device="cpu")
        self.inc = ScoringEngine(port_params, adapter=port_adapter(),
                                 policy=EnginePolicy(**kw), device="cpu",
                                 state_store=uc.UserStateStore(capacity))
        self.ref = JaxEngine(jax_params, adapter=jax_adapter(),
                             policy=JaxPolicy(**kw),
                             state_store=jax_uc.UserStateStore(capacity))

    def serve(self, specs):
        """Score ``specs`` (uid, hist, items) through all three engines and
        hold them against each other; returns the incremental scores."""
        port_reqs = [mk_req(ROOSample, *a) for a in specs]
        before = b4.launch_count
        got = self.inc.score_requests(port_reqs)
        assert b4.launch_count == before            # CPU: no launches
        want = self.full.score_requests(port_reqs)
        ref = self.ref.score_requests([mk_req(JaxSample, *a) for a in specs])
        assert len(got) == len(want) == len(ref) == len(specs)
        for g, w, r in zip(got, want, ref):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_allclose(g, np.asarray(r), **SCORE_TOL)
        assert self.store_stats() == self.ref.state_store.stats.snapshot()
        return got

    def store_stats(self):
        return self.inc.state_store.stats.snapshot()


class TestIncrementalEngine:
    def test_cold_traffic(self, port_params, jax_params):
        e = Engines(port_params, jax_params)
        e.serve([(1, [], [5, 6]), (2, [3, 1, 4], [7]),
                 (3, list(range(1, 9)), [9, 10])])
        assert e.inc.stats.n_incremental_batches > 0
        assert e.store_stats()["misses"] == 3

    def test_repeat_waves_extend_state(self, port_params, jax_params):
        e = Engines(port_params, jax_params)
        hists = {1: [3, 1], 2: [2, 7, 1]}
        e.serve([(u, h, [u + 5]) for u, h in hists.items()])
        for wave in range(3):                       # each wave appends
            for u in hists:
                hists[u] = hists[u] + [wave + 1]
            e.serve([(u, h, [u + 5, u + 6]) for u, h in hists.items()])
        assert e.store_stats()["hits"] == 6         # 2 users x 3 waves
        assert e.store_stats()["prefix_mismatches"] == 0

    def test_single_event_extends(self, port_params, jax_params):
        e = Engines(port_params, jax_params)
        e.serve([(1, [3, 1, 4], [5])])
        got = e.serve([(1, [3, 1, 4, 1], [5, 6])])
        assert got[0].shape == (2, TINY.n_tasks)
        assert e.store_stats()["hits"] == 1

    def test_eviction_recompute_recache(self, port_params, jax_params):
        e = Engines(port_params, jax_params, capacity=1)
        r1, r2 = (1, [3, 1, 4], [5]), (2, [2, 7], [6])
        for _ in range(3):                          # alternate: evict
            e.serve([r1])
            e.serve([r2])
        assert e.store_stats()["evictions"] >= 4
        e.serve([r2])                               # re-cached: a hit
        assert e.store_stats()["hits"] >= 1

    def test_param_hot_swap_invalidates_and_matches(self, port_params,
                                                    jax_params):
        e = Engines(port_params, jax_params)
        reqs = [(1, [3, 1, 4], [5]), (2, [2], [6, 7])]
        e.serve(reqs)
        assert len(e.inc.state_store) == 2
        new_jax = jax_gr.gr_init(jax.random.PRNGKey(7), JAX_TINY)
        new_port = params_from_numpy(jax.tree.map(np.asarray, new_jax),
                                     "cpu")
        e.full.params = new_port
        e.inc.params = new_port
        e.ref.params = new_jax
        assert len(e.inc.state_store) == 0          # stale states dropped
        assert e.inc.param_epoch == 1 and e.inc.params is new_port
        e.serve(reqs)                               # recomputed, new params

    def test_window_slide_falls_back_to_recompute(self, port_params,
                                                  jax_params):
        e = Engines(port_params, jax_params)
        hist = list(range(1, 9))                    # exactly hist_len
        e.serve([(1, hist, [5])])
        e.serve([(1, hist + [9, 10], [5, 6])])      # the window slides
        assert e.store_stats()["prefix_mismatches"] == 1
        e.serve([(1, hist + [9, 10], [7])])         # re-usable again
        assert e.store_stats()["hits"] >= 1

    def test_snapshot_covers_state_store(self, port_params, jax_params):
        e = Engines(port_params, jax_params)
        e.serve([(1, [3], [5])])
        snap = e.inc.snapshot()
        assert snap["param_epoch"] == 0
        assert snap["state_store"]["size"] == 1
        assert snap["state_store"]["misses"] == 1
        assert snap["stats"]["n_incremental_batches"] == 1
        assert "cache" not in snap


# engine arguments the constructor must refuse, given (stateful adapter,
# adapter class, store module, policy class) of one package
INVALID = {
    "stateless_adapter": lambda ad, adapter_cls, mod, policy_cls: dict(
        adapter=adapter_cls(score=ad.score), state_store=mod.UserStateStore(4)),
    "with_user_cache": lambda ad, adapter_cls, mod, policy_cls: dict(
        adapter=ad, policy=policy_cls(hist_len=8),
        cache=mod.UserTowerCache(4), state_store=mod.UserStateStore(4)),
    "hist_len_mismatch": lambda ad, adapter_cls, mod, policy_cls: dict(
        adapter=ad, policy=policy_cls(hist_len=16),
        state_store=mod.UserStateStore(4)),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_engine_validation_matches_reference(port_params, jax_params, case):
    with pytest.raises(ValueError):
        ScoringEngine(port_params, device="cpu", **INVALID[case](
            port_adapter(), ServeAdapter, uc, EnginePolicy))
    with pytest.raises(ValueError):
        JaxEngine(jax_params, **INVALID[case](
            jax_adapter(), JaxAdapter, jax_uc, JaxPolicy))


# ---------------------------------------------------------------------------
# ROOServer with the user-tower cache
# ---------------------------------------------------------------------------

CACHE_REQS = [(i % 5, list(range(1, 2 + i % 7)), [10 * i + j
                                                  for j in range(1 + i % 3)])
              for i in range(14)]


def test_cached_server_matches_reference(port_params, jax_params):
    port_reqs = [mk_req(ROOSample, *a) for a in CACHE_REQS]
    ref_reqs = [mk_req(JaxSample, *a) for a in CACHE_REQS]
    kw = dict(b_ro=4, b_nro=8, hist_len=8, cache_user_tower=True)
    port = ROOServer(
        port_params, lambda p, b: gr.gr_ranking_logits(p, TINY, b),
        ServeConfig(**kw),
        user_fn=lambda p, b: gr.gr_history_repr(p, TINY, b),
        score_from_user=lambda p, b, u:
            gr.gr_ranking_logits_from_history(p, TINY, b, u),
        device="cpu")
    ref = JaxServer(
        jax_params, lambda p, b: jax_gr.gr_ranking_logits(p, JAX_TINY, b),
        JaxServeConfig(**kw),
        user_fn=lambda p, b: jax_gr.gr_history_repr(p, JAX_TINY, b),
        score_from_user=lambda p, b, u:
            jax_gr.gr_ranking_logits_from_history(p, JAX_TINY, b, u))
    plain = ROOServer(
        port_params, lambda p, b: gr.gr_ranking_logits(p, TINY, b),
        ServeConfig(b_ro=4, b_nro=8, hist_len=8), device="cpu")
    want = plain.score_requests(port_reqs)
    for _ in range(2):                          # the second pass: all hits
        before = port.stats.n_batches
        full_before = port.stats.n_full_cache_batches
        got = dict(port.score_requests_iter(port_reqs))
        ref_got = ref.score_requests(ref_reqs)
        for i, (w, r) in enumerate(zip(want, ref_got)):
            np.testing.assert_array_equal(got[i], w)
            np.testing.assert_allclose(got[i], np.asarray(r), **SCORE_TOL)
        assert port.cache.stats.snapshot() == ref.cache.stats.snapshot()
        assert port.stats.n_full_cache_batches == \
            ref.stats.n_full_cache_batches
    assert port.stats.n_full_cache_batches - full_before == \
        port.stats.n_batches - before > 0
    port.params = port_params                   # weight refresh
    assert len(port.cache) == 0 and port.engine.param_epoch == 1


def test_cache_requires_split_entry_points():
    with pytest.raises(ValueError):
        ScoringEngine(None, lambda p, b: b.item_ids, device="cpu",
                      cache=uc.UserTowerCache(4))
