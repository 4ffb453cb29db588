"""bf16 HSTU models in the port held against the JAX reference on the CPU.

The reference's inits take ``dtype=`` and its HSTU kernels are
dtype-generic; a bf16 model of the port goes through the same public entry
points. The same seeded inputs (and the reference's bf16 ``gr_init`` params,
carried across with ``interop``) go through both packages:

  * serving — ``ROOServer`` stateless and with the user-tower cache, and the
    incremental ``ScoringEngine``, over the f32 tests' requests: every
    request scored, no failed batch, scores within ``SCORE_TOL`` of the
    reference's; within the port the cache path equals the stateless engine
    bit for bit, and the incremental engine is within ``SCORE_TOL`` of it:
    the f32 contract (bit for bit) does not hold in bf16 on the CPU, since
    torch's CPU bf16 ``rsqrt`` (in the LayerNorm) rounds an element in the
    vectorized body of a call otherwise than in its scalar tail, so a row's
    LayerNorm depends on how many rows the call has (an extend call has
    fewer than the full one) and a flipped bf16 rounding propagates; the
    engine's host copies of bf16 rows come back bit for bit;
  * the kernels' plain versions — B1's and B4's dense oracles in bf16
    against the reference's Pallas kernels in interpret mode, and on the
    operands' fp32 values, rounded once (the CUDA kernels' function),
    against the same; the backward oracle and torch autograd of the chunked
    route against ``jax.grad`` of the reference's ``jnp-chunked`` route
    (its Pallas-interpret rab backward raises on this jax: ROADMAP C);
    ``HSTUAttentionFn`` with its CUDA entry points swapped for their plain
    versions keeps bf16 through the forward and the backward;
  * the other models — roo-lsr ``userarch_hstu`` and the two-tower
    ``"hstu"`` user tower (the same kernels) with bf16 params, and MIND,
    DIEN and BERT4Rec, against the reference's logits: where jnp promotes a
    product of fp32 features and bf16 weights to fp32, the port does too;
  * training — bf16 hstu-gr ``Trainer`` steps against the reference's;
  * the wrappers' dtype contract — float16 and float64 raise TypeError.

Tolerances. bf16 keeps 8 significant bits, and the packages round at other
places (the port's CPU products sum in fp32 and round once, XLA's may
round partial sums), so results agree to a few bf16 ulps, not to fp32's
summation order: ``SCORE_TOL`` (2e-2 + 2e-2 |x|) is the reference's own
bf16 kernel tolerance (tests/test_kernels.py), about four ulps at |x| 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import roo_models as jax_rm
from repro.core import joiner as jax_joiner
from repro.core.hstu import hstu_attention_chunked as jax_chunked
from repro.core.joiner import ROOSample as JaxSample
from repro.core.masks import roo_spec as jax_roo_spec
from repro.data import batcher as jax_batcher
from repro.data import events as jax_events
from repro.kernels import dispatch as jax_dispatch
from repro.kernels.hstu_attention import hstu_attention as jax_pallas
from repro.models import gr as jax_gr
from repro.serve import serving as jax_serving
from repro.serve import user_cache as jax_uc
from repro.serve.adapter import ServeAdapter as JaxAdapter
from repro.serve.engine import EnginePolicy as JaxPolicy
from repro.serve.engine import ScoringEngine as JaxEngine
from repro.train import loop as jax_loop
from repro.train import optim as jax_optim
from repro_torch.configs import roo_models as rm
from repro_torch.core import joiner
from repro_torch.core.joiner import ROOSample
from repro_torch.core.masks import roo_spec
from repro_torch.data import batcher, events
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels import hstu_attention as kmod
from repro_torch.kernels import hstu_attention_bwd as bmod
from repro_torch.kernels import hstu_attention_prefix as pmod
from repro_torch.kernels.ref import as_f32
from repro_torch.models import gr
from repro_torch.serve import engine as port_engine
from repro_torch.serve import serving
from repro_torch.serve import user_cache as uc
from repro_torch.serve.adapter import ServeAdapter
from repro_torch.serve.engine import EnginePolicy, ScoreError, ScoringEngine
from repro_torch import tree
from repro_torch.train import loop, optim
from test_torch_gr_serving import STREAM, make_requests
from test_torch_incremental import JAX_TINY, TINY, mk_req
from test_torch_incremental import prefix_inputs as prefix_case

BF16 = torch.bfloat16
SCORE_TOL = dict(atol=2e-2, rtol=2e-2)
STEP_TOL = dict(atol=0.0, rtol=2e-3)    # one step's loss, same params
DRIFT_TOL = dict(atol=0.0, rtol=1e-2)   # free-running bf16 training


def bf(a: np.ndarray):
    """One fp32 numpy array as the same bf16 values in both packages."""
    return torch.from_numpy(a).to(BF16), jnp.asarray(a, jnp.bfloat16)


def f32(x) -> np.ndarray:
    """A port tensor or a reference array (any float dtype) as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_scores_close(got, want, n_imps):
    """Aligned score lists: no ScoreError, (n, 2) float32 arrays, within
    SCORE_TOL of the reference's."""
    assert len(got) == len(want) == len(n_imps)
    for g, w, n in zip(got, want, n_imps):
        assert not isinstance(g, ScoreError), g
        assert g.dtype == np.float32 and g.shape == (n, 2)
        np.testing.assert_allclose(g, f32(w), **SCORE_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gr_params():
    """hstu-gr at gr_config width with bf16 params: (reference, port)."""
    jcfg = jax_rm.gr_config(attn_backend="jnp-chunked")
    jp = jax_gr.gr_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert pp["hstu"]["layers"][0]["w_uvqk"].dtype == BF16
    return jcfg, jp, pp


@pytest.fixture(scope="module")
def gr_requests():
    """The 40 requests of tests/test_torch_gr_serving.py: (port, ref)."""
    samples = joiner.RequestLevelJoiner().join(list(events.EventSimulator(
        events.EventStreamConfig(**STREAM)).stream()))
    jsamples = jax_joiner.RequestLevelJoiner().join(list(
        jax_events.EventSimulator(
            jax_events.EventStreamConfig(**STREAM)).stream()))
    return (make_requests(samples, joiner.ROOSample),
            make_requests(jsamples, jax_joiner.ROOSample))


def gr_servers(gr_params, cache: bool):
    """(port server, reference server) for hstu-gr in bf16."""
    jcfg, jp, pp = gr_params
    cfg = rm.gr_config()
    kw = dict(b_ro=8, b_nro=64, cache_user_tower=cache)
    split = dict(
        user_fn=lambda p, b: gr.gr_history_repr(p, cfg, b),
        score_from_user=lambda p, b, u:
            gr.gr_ranking_logits_from_history(p, cfg, b, u)) if cache else {}
    jsplit = dict(
        user_fn=lambda p, b: jax_gr.gr_history_repr(p, jcfg, b),
        score_from_user=lambda p, b, u:
            jax_gr.gr_ranking_logits_from_history(p, jcfg, b, u)
    ) if cache else {}
    port = serving.ROOServer(pp, lambda p, b: gr.gr_ranking_logits(p, cfg, b),
                             serving.ServeConfig(**kw), device="cpu", **split)
    ref = jax_serving.ROOServer(
        jp, lambda p, b: jax_gr.gr_ranking_logits(p, jcfg, b),
        jax_serving.ServeConfig(attn_backend="jnp-chunked", **kw), **jsplit)
    return port, ref


def test_stateless_server_bf16_matches_reference(gr_params, gr_requests):
    """Before the engine kept bf16 rows as their bits, every bf16 batch
    failed here (numpy has no bfloat16) and the breaker opened."""
    preqs, rreqs = gr_requests
    port, ref = gr_servers(gr_params, cache=False)
    got, want = port.score_requests(preqs), ref.score_requests(rreqs)
    assert_scores_close(got, want, [r.num_impressions for r in preqs])
    st = port.stats
    assert st.n_failed_batches == st.n_failed_requests == 0
    assert st.n_shed_requests == st.n_breaker_opens == 0
    assert st.n_batches == ref.stats.n_batches


def test_cached_server_bf16_matches_reference(gr_params, gr_requests):
    preqs, rreqs = gr_requests
    stateless, _ = gr_servers(gr_params, cache=False)
    plain = stateless.score_requests(preqs)
    port, ref = gr_servers(gr_params, cache=True)
    for _ in range(2):                          # the second pass: all hits
        before = port.stats.n_batches
        full_before = port.stats.n_full_cache_batches
        got, want = port.score_requests(preqs), ref.score_requests(rreqs)
        assert_scores_close(got, want, [r.num_impressions for r in preqs])
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(g, p)
        assert port.cache.stats.snapshot() == ref.cache.stats.snapshot()
    assert port.stats.n_full_cache_batches - full_before == \
        port.stats.n_batches - before > 0
    assert port.stats.n_failed_batches == 0
    row = next(iter(port.cache._data.values()))
    assert row.dtype == port_engine.BF16_BITS and row.itemsize == 2


def adapters():
    """The incremental adapters of tests/test_torch_incremental.py, their
    user states in bf16: (port, reference)."""
    port = ServeAdapter(
        score=lambda p, b: gr.gr_ranking_logits(p, TINY, b),
        init_user_state=lambda: gr.gr_state_init(TINY, dtype=BF16,
                                                 device="cpu"),
        extend_user_state=lambda p, b, s, *, n_new:
            gr.gr_extend_user_state(p, TINY, b, s, n_new=n_new),
        score_from_state=lambda p, b, s, *, n_new:
            gr.gr_score_from_state(p, TINY, b, s, n_new=n_new),
        state_hist_len=TINY.hist_len)
    ref = JaxAdapter(
        score=lambda p, b: jax_gr.gr_ranking_logits(p, JAX_TINY, b),
        init_user_state=lambda: jax_gr.gr_state_init(JAX_TINY,
                                                     dtype=jnp.bfloat16),
        extend_user_state=lambda p, b, s, *, n_new:
            jax_gr.gr_extend_user_state(p, JAX_TINY, b, s, n_new=n_new),
        score_from_state=lambda p, b, s, *, n_new:
            jax_gr.gr_score_from_state(p, JAX_TINY, b, s, n_new=n_new),
        state_hist_len=JAX_TINY.hist_len)
    return port, ref


def test_incremental_engine_bf16_matches_reference():
    jp = jax_gr.gr_init(jax.random.PRNGKey(0), JAX_TINY, dtype=jnp.bfloat16)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(max_requests=4, max_impressions=32, hist_len=8)
    port_ad, ref_ad = adapters()
    full = ScoringEngine(pp, adapter=port_ad, policy=EnginePolicy(**kw),
                         device="cpu")
    inc = ScoringEngine(pp, adapter=port_ad, policy=EnginePolicy(**kw),
                        device="cpu", state_store=uc.UserStateStore(32))
    ref = JaxEngine(jp, adapter=ref_ad, policy=JaxPolicy(**kw),
                    state_store=jax_uc.UserStateStore(32))
    hists = {1: [3, 1], 2: [2, 7, 1], 3: []}
    for wave in range(3):                       # each wave appends
        if wave:
            for u in hists:
                hists[u] = hists[u] + [wave + 1, (u + wave) % 9 + 1]
        specs = [(u, h, [u + 5, u + 6 + wave]) for u, h in hists.items()]
        preqs = [mk_req(ROOSample, *a) for a in specs]
        got = inc.score_requests(preqs)
        assert_scores_close(got, ref.score_requests(
            [mk_req(JaxSample, *a) for a in specs]),
            [r.num_impressions for r in preqs])
        for g, w in zip(got, full.score_requests(preqs)):
            np.testing.assert_allclose(g, w, **SCORE_TOL)
        assert inc.state_store.stats.snapshot() == \
            ref.state_store.stats.snapshot()
    assert inc.state_store.stats.hits == 6      # 3 users x 2 repeat waves
    assert inc.stats.n_failed_batches == 0
    assert inc.stats.n_incremental_batches == inc.stats.n_batches > 0
    state = inc.state_store._data[1].state
    assert state.k.dtype == port_engine.BF16_BITS
    assert state.k.nbytes == 2 * state.k.size   # two bytes an element


@pytest.mark.parametrize("dtype", [torch.float32, BF16],
                         ids=["f32", "bf16"])
def test_host_copies_round_trip_bit_for_bit(dtype):
    t = (torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(0))
         * 1e3).to(dtype)
    host = port_engine.host_copy(t)
    assert host.nbytes == t.numel() * t.element_size()
    stacked = np.stack([host, host[::-1]])       # as the state store does
    back = port_engine.device_copy(stacked, "cpu")
    assert back.dtype == dtype
    assert torch.equal(back[0], t) and torch.equal(back[1], t.flip(0))
    assert torch.equal(back[0].view(-1).view(torch.uint8),
                       t.reshape(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

# tests/test_kernels.py's shapes: (B, H, S, Dqk, Dv, n_hist)
KERNEL_SHAPES = [(1, 1, 128, 32, 32, 96), (2, 2, 256, 64, 64, 192),
                 (2, 4, 256, 64, 128, 224)]


def attention_case(shape, seed, max_rel=128):
    b, h, s, dqk, dv, n_hist = shape
    rng = np.random.default_rng(seed)
    x = dict(q=rng.normal(size=(b, h, s, dqk)), k=rng.normal(
        size=(b, h, s, dqk)), v=rng.normal(size=(b, h, s, dv)),
        rab=0.1 * rng.normal(size=(h, 2 * max_rel + 1)),
        g=rng.normal(size=(b, h, s, dv)))
    x = {key: a.astype(np.float32) for key, a in x.items()}
    x.update(n_hist=n_hist, max_rel=max_rel,
             hl=rng.integers(0, n_hist + 1, size=b).astype(np.int32),
             tc=rng.integers(1, s - n_hist + 1, size=b).astype(np.int32))
    return x


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES,
                         ids=["s128", "s256", "s256-dv128"])
def test_b1_plain_bf16_matches_pallas_interpret(shape, use_rab):
    x = attention_case(shape, seed=sum(shape))
    (q, jq), (k, jk), (v, jv), (rab, jrab) = (bf(x[n]) for n in
                                              ("q", "k", "v", "rab"))
    hl, tc = torch.from_numpy(x["hl"]), torch.from_numpy(x["tc"])
    want = jax_pallas(jq, jk, jv, jrab if use_rab else None, x["n_hist"],
                      jnp.asarray(x["hl"]), jnp.asarray(x["tc"]),
                      x["max_rel"], block_q=64, block_k=64, interpret=True)
    assert want.dtype == jnp.bfloat16
    args = (x["n_hist"], hl, tc, x["max_rel"])
    plain = kmod.hstu_attention_plain(q, k, v, rab if use_rab else None,
                                      *args)
    # the CUDA kernel's function: fp32 on the operands' values, one rounding
    kernel_fn = kmod.hstu_attention_plain(
        *as_f32(q, k, v, rab if use_rab else None), *args).to(BF16)
    assert plain.dtype == kernel_fn.dtype == BF16
    for got in (plain, kernel_fn):
        np.testing.assert_allclose(f32(got), f32(want), **SCORE_TOL)


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("case", ["serve", "ragged", "extend"])
def test_b4_plain_bf16_matches_pallas_interpret(case, use_rab):
    x = prefix_case(case, seed=11)
    rab_np = x["rab"] if use_rab else None
    ops = [bf(x[n]) for n in ("q", "k", "v")] + (
        [bf(rab_np)] if use_rab else [(None, None)])
    (q, jq), (k, jk), (v, jv), (rab, jrab) = ops
    want = jax_dispatch.hstu_attention_prefix(
        jq, jk, jv, jrab, _jax_prefix_spec(x), backend="pallas-interpret",
        scale_len=x["scale_len"], max_rel_pos=x["max_rel"], block_q=8,
        block_k=8)
    assert want.dtype == jnp.bfloat16
    args = (x["n_hist"], x["n_new"], torch.from_numpy(x["pfx"]),
            torch.from_numpy(x["new"]), torch.from_numpy(x["tgt"]),
            x["scale_len"], x["max_rel"])
    plain = pmod.hstu_attention_prefix_plain(q, k, v, rab, *args)
    kernel_fn = pmod.hstu_attention_prefix_plain(
        *as_f32(q, k, v, rab), *args).to(BF16)
    assert plain.dtype == BF16
    for got in (plain, kernel_fn):
        np.testing.assert_allclose(f32(got), f32(want), **SCORE_TOL)


def _jax_prefix_spec(x):
    from repro.core.masks import prefix_spec as jax_prefix_spec
    return jax_prefix_spec(jnp.asarray(x["pfx"]), jnp.asarray(x["new"]),
                           jnp.asarray(x["tgt"]), x["n_hist"], x["n_new"])


# (B, H, S, Dqk, Dv, n_hist, max_rel): hstu-gr's sequence, a clip case
BWD_SHAPES = [(2, 2, 80, 32, 32, 64, 64), (3, 2, 48, 16, 24, 32, 8)]


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=["gr80", "clip48"])
def test_bwd_plain_bf16_matches_jnp_chunked_grads(shape, use_rab):
    b, h, s, dqk, dv, n_hist, max_rel = shape
    x = attention_case((b, h, s, dqk, dv, n_hist), seed=s + dqk,
                       max_rel=max_rel)
    names = ("q", "k", "v", "rab") if use_rab else ("q", "k", "v")
    port_ops, jax_ops = zip(*(bf(x[n]) for n in names))
    g, jg = bf(x["g"])
    hl, tc = torch.from_numpy(x["hl"]), torch.from_numpy(x["tc"])
    jspec = jax_roo_spec(jnp.asarray(x["hl"]), jnp.asarray(x["tc"]), n_hist)

    def jloss(*ops):
        rab_ = ops[3] if use_rab else None
        out = jax_chunked(ops[0], ops[1], ops[2], rab_, jspec,
                          max_rel_pos=max_rel, chunk=32)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(*jax_ops)
    rab = port_ops[3] if use_rab else None
    plain = bmod.hstu_attention_bwd_plain(*port_ops[:3], rab, n_hist, hl, tc,
                                          max_rel, g)
    leaves = [t.clone().requires_grad_(True) for t in port_ops]
    out = dispatch.hstu_attention(
        *leaves[:3], leaves[3] if use_rab else None, roo_spec(hl, tc, n_hist),
        backend="torch-chunked", max_rel_pos=max_rel, chunk=32)
    autograd = torch.autograd.grad(out, leaves, g)
    for i, name in enumerate(names):
        assert plain[i].dtype == autograd[i].dtype == BF16
        scale = float(np.abs(f32(want[i])).max())
        for got, what in ((plain[i], "oracle"), (autograd[i], "autograd")):
            np.testing.assert_allclose(
                f32(got), f32(want[i]), rtol=SCORE_TOL["rtol"],
                atol=SCORE_TOL["atol"] * max(scale, 1.0),
                err_msg=f"{what} d{name}")


def test_function_keeps_bf16(monkeypatch):
    """``HSTUAttentionFn`` (what dispatch's cuda rung runs) with its two
    CUDA entry points swapped for their plain versions: bf16 operands give
    a bf16 output and bf16 gradients, each the plain backward's."""
    monkeypatch.setattr(kmod, "hstu_attention_cuda",
                        kmod.hstu_attention_plain)
    monkeypatch.setattr(bmod, "hstu_attention_bwd_cuda",
                        bmod.hstu_attention_bwd_plain)
    x = attention_case((2, 2, 80, 32, 32, 64), seed=3, max_rel=64)
    ops = [bf(x[n])[0].requires_grad_(True) for n in ("q", "k", "v", "rab")]
    hl, tc = torch.from_numpy(x["hl"]), torch.from_numpy(x["tc"])
    out = bmod.HSTUAttentionFn.apply(*ops, 64, hl, tc, 64)
    g = bf(x["g"])[0]
    grads = torch.autograd.grad(out, ops, g)
    assert out.dtype == BF16 and all(t.dtype == BF16 for t in grads)
    want = bmod.hstu_attention_bwd_plain(*(t.detach() for t in ops), 64, hl,
                                         tc, 64, g)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)


# ---------------------------------------------------------------------------
# the other models whose user tower reaches the HSTU kernels
# ---------------------------------------------------------------------------

def test_lsr_userarch_hstu_bf16_matches_reference():
    """roo-lsr ``userarch_hstu`` with bf16 params: ROO logits and the loss
    against the reference's on the same batch (tests/test_torch_lsr.py's
    small config)."""
    from repro.models import lsr as jax_lsr
    from repro_torch.models import lsr
    from test_torch_lsr import BATCH as LSR_BATCH
    from test_torch_lsr import STREAM as LSR_STREAM
    from test_torch_lsr import cfgs as lsr_cfgs
    cfg, jcfg = lsr_cfgs("userarch_hstu")
    jp = jax_lsr.lsr_init(jax.random.PRNGKey(2), jcfg, dtype=jnp.bfloat16)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pb, jb = _batches(LSR_STREAM, LSR_BATCH)
    for b, j in zip(pb[:2], jb[:2]):
        got = lsr.lsr_logits_roo(pp, cfg, b)
        want = jax_lsr.lsr_logits_roo(jp, jcfg, j)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(f32(got), f32(want), **SCORE_TOL)
        np.testing.assert_allclose(
            float(lsr.lsr_loss(pp, cfg, b)),
            float(jax_lsr.lsr_loss(jp, jcfg, j)), **STEP_TOL)


def test_two_tower_hstu_bf16_matches_reference():
    """The two-tower ``"hstu"`` user tower (roo-esr) with bf16 params: user
    representations and ESR logits against the reference's."""
    from repro.models import two_tower as jax_tt
    from repro_torch.models import two_tower as tt
    from test_torch_two_tower import BATCH as TT_BATCH
    from test_torch_two_tower import STREAM as TT_STREAM
    from test_torch_two_tower import cfgs as tt_cfgs
    cfg, jcfg = tt_cfgs("esr", True)
    jp = jax_tt.two_tower_init(jax.random.PRNGKey(0), jcfg,
                               dtype=jnp.bfloat16)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pb, jb = _batches(dict(TT_STREAM, n_items=cfg.n_items), TT_BATCH)
    for b, j in zip(pb[:2], jb[:2]):
        u, ju = tt.user_tower(pp, cfg, b), jax_tt.user_tower(jp, jcfg, j)
        assert str(u.dtype).split(".")[-1] == str(ju.dtype)
        np.testing.assert_allclose(f32(u), f32(ju), **SCORE_TOL)
        np.testing.assert_allclose(f32(tt.esr_logits_roo(pp, cfg, b)),
                                   f32(jax_tt.esr_logits_roo(jp, jcfg, j)),
                                   **SCORE_TOL)


@pytest.mark.parametrize("name", ["mind", "dien", "bert4rec"])
def test_recsys_archs_bf16_score_like_reference(name):
    """MIND, DIEN and BERT4Rec with bf16 params score a batch as the
    reference does (MIND's routing mixes fp32 weights into bf16 capsules:
    jnp promotes, the port multiplies through ``core.promote``)."""
    import test_torch_recsys_archs as archs
    a = archs.arch(name)
    jp = a.jinit(jax.random.PRNGKey(1), a.jcfg, dtype=jnp.bfloat16)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pb, jb = _batches(archs.STREAM, archs.BATCH)
    got, want = a.score(pp, a.cfg, pb[0]), a.jscore(jp, a.jcfg, jb[0])
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(f32(got), f32(want), **SCORE_TOL)


def _batches(stream, batch):
    """The same ROOBatcher batches of one simulated stream in both
    packages."""
    ps = joiner.RequestLevelJoiner().join(list(events.EventSimulator(
        events.EventStreamConfig(**stream)).stream()))
    js = jax_joiner.RequestLevelJoiner().join(list(jax_events.EventSimulator(
        jax_events.EventStreamConfig(**stream)).stream()))
    return (list(batcher.ROOBatcher(batcher.BatcherConfig(**batch),
                                    device="cpu").batches(ps)),
            list(jax_batcher.ROOBatcher(
                jax_batcher.BatcherConfig(**batch)).batches(js)))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def to_jax_tree(params):
    """The port's params as the reference's arrays, bf16 by its bits."""
    def leaf(t):
        t = t.detach()
        if t.dtype == BF16:
            return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
        return jnp.asarray(t.numpy())
    return tree.tree_map(leaf, params)


def test_trainer_bf16_steps_match_reference():
    """bf16 hstu-gr Trainer steps with the scenario's optimizer (Adam on
    dense leaves, row-wise Adagrad on the tables) on the same batches. Each
    step's loss equals the reference's loss on the same params and batch
    within STEP_TOL (the forwards round at other places); the free-running
    losses stay within DRIFT_TOL of the reference's for five steps: a bf16
    weight moves only when an Adam step (~1e-3) rounds to a new bf16 value
    (an ulp is ~4e-3 at |w| 0.5), and the packages round those updates at
    other places, so the runs part by a few ulps a step."""
    stream = dict(n_requests=120, n_users=40, n_items=rm.N_ITEMS,
                  hist_init_max=48, seed=0)
    kw = dict(b_ro=16, b_nro=96, hist_len=64)
    samples = joiner.RequestLevelJoiner().join(list(events.EventSimulator(
        events.EventStreamConfig(**stream)).stream()))
    jsamples = jax_joiner.RequestLevelJoiner().join(list(
        jax_events.EventSimulator(
            jax_events.EventStreamConfig(**stream)).stream()))
    pb = list(batcher.ROOBatcher(batcher.BatcherConfig(**kw),
                                 device="cpu").batches(samples))
    jb = list(jax_batcher.ROOBatcher(
        jax_batcher.BatcherConfig(**kw)).batches(jsamples))
    jcfg, cfg = jax_rm.gr_config(attn_backend="jnp-chunked"), rm.gr_config()
    jparams = jax_gr.gr_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    np_params = jax.tree.map(np.asarray, jparams)
    steps, free = 8, 5
    jt = jax_loop.Trainer(
        lambda p, b, r: jax_gr.gr_ranking_loss(p, jcfg, b),
        jax_optim.make_mixed(jax_optim.adam(1e-3),
                             jax_optim.rowwise_adagrad(0.05),
                             jax_optim.default_is_embedding),
        jax_loop.TrainLoopConfig(total_steps=free, log_every=1),
        lambda: jparams)
    seen = []

    def loss_fn(p, b, r):
        seen.append(tree.tree_map(lambda t: t.detach().clone(), p))
        return gr.gr_ranking_loss(p, cfg, b)

    pt = loop.Trainer(
        loss_fn, optim.make_mixed(optim.adam(1e-3),
                                  optim.rowwise_adagrad(0.05),
                                  optim.default_is_embedding),
        loop.TrainLoopConfig(total_steps=steps, log_every=1),
        lambda: params_from_numpy(np_params, "cpu"), device="cpu")
    jt.run(lambda i: (jb[j % len(jb)] for j in range(i, 10 ** 6)),
           jax.random.PRNGKey(0))
    state = pt.run(lambda i: (pb[j % len(pb)] for j in range(i, 10 ** 6)), 0)
    assert len(pt.history) == len(seen) == steps
    jloss = jax.jit(lambda p, b: jax_gr.gr_ranking_loss(p, jcfg, b))
    for i, row in enumerate(pt.history):
        assert row["skipped"] == 0
        same = float(jloss(to_jax_tree(seen[i]), jb[i % len(jb)]))
        np.testing.assert_allclose(row["loss"], same, **STEP_TOL,
                                   err_msg=f"loss at step {row['step']}")
    for a, b in zip(pt.history, jt.history):
        np.testing.assert_allclose(a["loss"], b["loss"], **DRIFT_TOL,
                                   err_msg=f"free-running, step {a['step']}")
    leaf = state["params"]["hstu"]["layers"][0]["w_uvqk"]
    assert leaf.dtype == BF16 and bool(torch.isfinite(leaf.float()).all())


# ---------------------------------------------------------------------------
# the wrappers' dtype contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float16, torch.float64],
                         ids=["float16", "float64"])
def test_check_operand_refuses_other_dtypes(dtype):
    cpu = torch.device("cpu")
    with pytest.raises(TypeError, match=str(dtype)):
        kmod.check_operand("q", torch.zeros(4, dtype=dtype), cpu)
    with pytest.raises(TypeError, match=str(dtype)):
        kmod.rab_operand(torch.zeros(2, 3, dtype=dtype), BF16, cpu)


def test_operands_share_one_dtype_and_rab_is_cast():
    cpu = torch.device("cpu")
    for dtype in kmod.DTYPES:
        kmod.check_operand("k", torch.zeros(4, dtype=dtype), cpu, dtype)
    with pytest.raises(TypeError, match="one dtype"):
        kmod.check_operand("k", torch.zeros(4), cpu, BF16)
    rab = torch.randn(2, 9)
    cast = kmod.rab_operand(rab, BF16, cpu)
    assert cast.dtype == BF16 and torch.equal(cast, rab.to(BF16))
    assert kmod.rab_operand(rab, torch.float32, cpu) is rab
    assert kmod.rab_operand(None, BF16, cpu) is None
    assert kmod.symbol("hstu_attention_fwd", BF16) == \
        "hstu_attention_fwd_bf16"
    assert kmod.symbol("hstu_attention_fwd", torch.float32) == \
        "hstu_attention_fwd"


def test_scores_come_back_float32():
    """A bf16 model's scores reach the caller as float32 numpy, widened on
    the host (exactly: every bf16 value is an fp32 value)."""
    params = gr.gr_init(torch.Generator().manual_seed(0), TINY, dtype=BF16,
                        device="cpu")
    reqs = [mk_req(ROOSample, u, [1, 2, u + 1], [u + 3, u + 4])
            for u in range(3)]
    eng = ScoringEngine(params, lambda p, b: gr.gr_ranking_logits(p, TINY, b),
                        policy=EnginePolicy(hist_len=8), device="cpu")
    got = eng.score_requests(reqs)
    assert all(s.dtype == np.float32 and s.shape == (2, 2) for s in got)
    bits = np.stack(got).view(np.uint32) & 0xFFFF
    assert not bits.any()                       # bf16 values, widened
