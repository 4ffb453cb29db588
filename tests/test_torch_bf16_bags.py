"""The bag models with bf16 tables in the port, held against the JAX
reference on the CPU.

dlrm-mlperf, roo-lsr in its bag modes (``baseline``, ``userarch``) and the
two-tower ``"mlp"`` user tower take ``dtype=`` in both packages; the
reference's bf16 params are carried across (``interop``) and the same
seeded batches go through both:

  * dlrm (both configs of ``test_torch_dlrm.py``): ROO logits and every
    leaf's BCE gradient, on the plain path and through
    ``GroupedEmbeddingBagFn`` and ``DotInteractionFn`` (their CUDA
    forwards swapped for the plain versions); the gradients come out bit
    for bit;
  * the interaction's operands (C10): a bf16 dlrm's bottom MLP promotes to
    fp32 (its input features are fp32) while its bags stay bf16. The
    reference concatenates the two, which promotes them; the port casts
    both to fp32 before B7, whose wrapper refuses mixed dtypes. The
    impression-level forward, through ``DotInteractionFn`` with a stand-in
    forward that refuses what the CUDA wrapper refuses, matches the
    reference; the output is fp32 and the gradients come back in each
    leaf's own dtype;
  * a bf16 sparse-row dlrm trajectory (``test_torch_sparse_train``'s
    case): each step's loss against the reference's sparse
    value_and_grad on the port's params, the free-running losses against
    the reference's run, and the tables bf16 after their in-place row
    updates;
  * roo-lsr ``baseline`` / ``userarch``: ROO and impression-level logits
    and the loss gradients through ``GroupedEmbeddingBagFn``;
  * the two-tower ``"mlp"`` tower (roo-esr, roo-retrieval): user
    representations, logits and loss gradients.

Tolerance: the reference's bf16 tolerance (``tests/test_kernels.py``),
2e-2 + 2e-2 |x|, or bit for bit where the CPU gives it.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.embeddings import sparse as jax_sp
from repro.models import dlrm as jax_dlrm
from repro.models import lsr as jax_lsr
from repro.models import two_tower as jax_tt
from repro_torch import tree
from repro_torch.embeddings import collection as ec
from repro_torch.embeddings import sparse as sp
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dot_interaction as di
from repro_torch.kernels import embedding_bag as eb
from repro_torch.models import dlrm, lsr
from repro_torch.models import two_tower as tt
from repro_torch.train import loop, metrics
from test_torch_bf16 import _batches
from test_torch_dlrm import (CONFIGS, impression_args, jax_batches,
                             jax_spec, port_spec, roo_args)
from test_torch_lsr import BATCH as LSR_BATCH
from test_torch_lsr import STREAM as LSR_STREAM
from test_torch_lsr import cfgs as lsr_cfgs
from test_torch_sparse_train import dlrm_case as sparse_dlrm_case
from test_torch_sparse_train import jax_trajectory, run_steps
from test_torch_two_tower import BATCH as TT_BATCH
from test_torch_two_tower import STREAM as TT_STREAM
from test_torch_two_tower import cfgs as tt_cfgs

BF16 = torch.bfloat16
TOL = dict(atol=2e-2, rtol=2e-2)
FREE_STEPS = 6          # free-running bf16 steps held against the reference


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def to_ref(params):
    """The port's params as the reference's arrays, bf16 by its bits."""
    def leaf(t):
        t = t.detach()
        if t.dtype == BF16:
            return jnp.asarray(t.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    return tree.tree_map(leaf, params)


def same_kind(a, b) -> bool:
    """A port tensor and a reference array of the same dtype."""
    return str(a.dtype).split(".")[-1] == str(b.dtype)


def check_grads(grads, jgrads, bitwise=False) -> None:
    """Leaf for leaf: the same dtype, values within TOL (or the same bits)."""
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(tree.leaves(grads))
    for (path, a), b in zip(tree.flatten_with_path(grads), jl):
        assert same_kind(a, b), (path, a.dtype, b.dtype)
        if bitwise and a.dtype == BF16:
            np.testing.assert_array_equal(
                a.detach().view(torch.int16).numpy(),
                np.asarray(b).view(np.int16), err_msg=str(path))
        else:
            np.testing.assert_allclose(f32(a), f32(b), **TOL,
                                       err_msg=str(path))


def bag_functions(monkeypatch):
    """Bags through ``GroupedEmbeddingBagFn`` on CPU tensors (a lookup's
    fields as one group, one table a group of one), its CUDA forward
    swapped for the plain version."""
    monkeypatch.setattr(eb, "embedding_bag_grouped_fwd_cuda",
                        lambda ts, i, n, p: eb.embedding_bag_grouped_plain(
                            ts, i, n, p))
    monkeypatch.setattr(ec, "embedding_bag",
                        lambda t, i, n, p, backend=None:
                            eb.GroupedEmbeddingBagFn.apply(
                                i[:, None], n[:, None], p, t).squeeze(1))
    monkeypatch.setattr(ec, "embedding_bag_grouped",
                        lambda ts, i, n, p, backend=None:
                            eb.GroupedEmbeddingBagFn.apply(i, n, p, *ts))


def refuse_mixed(d: torch.Tensor, s: torch.Tensor) -> None:
    """What ``dot_interaction_cuda`` refuses before it launches B7."""
    if d.dtype not in di.DTYPES or s.dtype != d.dtype:
        raise TypeError(f"dense_out and sparse_embs must share one dtype, "
                        f"fp32 or bf16; got {d.dtype} and {s.dtype}")


def dot_function(monkeypatch) -> list:
    """The interaction through ``DotInteractionFn``, its CUDA forward
    swapped for a stand-in that refuses what the wrapper refuses and then
    runs the plain version; returns the operand dtypes it saw."""
    seen = []

    def forward(d, s, self_interaction=False):
        seen.append((d.dtype, s.dtype))
        refuse_mixed(d, s)
        return di.dot_interaction_plain(d, s, self_interaction)
    monkeypatch.setattr(di, "dot_interaction_cuda", forward)
    monkeypatch.setattr(di, "dot_interaction",
                        lambda d, s, self_interaction=False, backend=None:
                            di.DotInteractionFn.apply(d, s,
                                                      self_interaction))
    return seen


# ---------------------------------------------------------------------------
# dlrm-mlperf
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CONFIGS))
def setup(request):
    """Per config: both configs, the reference's bf16 params and the same
    values in the port, and both packages' batches."""
    cfg = dlrm.DLRMConfig(**CONFIGS[request.param])
    jcfg = jax_dlrm.DLRMConfig(**CONFIGS[request.param])
    jp = jax_dlrm.dlrm_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert pp["tables"]["t0"].dtype == BF16
    return dict(cfg=cfg, jcfg=jcfg, pp=pp, jp=jp,
                pb=_dlrm_batches(cfg), jb=jax_batches(jax_spec(), jcfg,
                                                      n_batches=2))


def _dlrm_batches(cfg):
    from repro_torch.scenario.build import synthetic_dlrm_batches
    return synthetic_dlrm_batches(port_spec(), cfg, n_batches=2,
                                  device="cpu")


def bce_loss(logits_fn):
    return lambda p, b, gen: metrics.bce(logits_fn(p, b), b["y"])


def jax_bce(logits, y):
    return jnp.mean(jnp.maximum(logits, 0) - logits * y
                    + jnp.log1p(jnp.exp(-jnp.abs(logits))))


@pytest.mark.parametrize("path", ["plain", "function"])
def test_dlrm_bf16_logits_and_grads_match_reference(setup, monkeypatch,
                                                    path):
    if path == "function":
        bag_functions(monkeypatch)
        seen = dot_function(monkeypatch)
    cfg, jcfg, pb, jb = setup["cfg"], setup["jcfg"], setup["pb"], setup["jb"]
    got = dlrm.dlrm_forward_roo(setup["pp"], cfg, *roo_args(pb[0]))
    want = jax_dlrm.dlrm_forward_roo(setup["jp"], jcfg, *roo_args(jb[0]))
    assert same_kind(got, want)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    loss, grads = loop.value_and_grad(bce_loss(
        lambda p, b: dlrm.dlrm_forward_roo(p, cfg, *roo_args(b))))(
        setup["pp"], pb[1], None)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_bce(
        jax_dlrm.dlrm_forward_roo(p, jcfg, *roo_args(jb[1])),
        jb[1]["y"]))(setup["jp"])
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    check_grads(grads, jgrads, bitwise=True)
    assert grads["tables"]["t0"].dtype == BF16
    if path == "function":
        assert seen and all(d == s for d, s in seen)


def test_dlrm_impression_bf16_reaches_b7_in_one_dtype(setup, monkeypatch):
    bag_functions(monkeypatch)
    seen = dot_function(monkeypatch)
    cfg, jcfg, pb, jb = setup["cfg"], setup["jcfg"], setup["pb"], setup["jb"]
    forward = lambda p, b: dlrm.dlrm_forward_impression(  # noqa: E731
        p, cfg, *impression_args(b, torch))
    got = forward(setup["pp"], pb[0])
    want = jax_dlrm.dlrm_forward_impression(setup["jp"], jcfg,
                                            *impression_args(jb[0], jnp))
    assert seen == [(torch.float32, torch.float32)]
    assert same_kind(got, want)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(
        f32(got), f32(dlrm.dlrm_forward_roo(setup["pp"], cfg,
                                            *roo_args(pb[0]))), **TOL)
    _, grads = loop.value_and_grad(bce_loss(forward))(setup["pp"], pb[1],
                                                      None)
    _, jgrads = jax.value_and_grad(lambda p: jax_bce(
        jax_dlrm.dlrm_forward_impression(p, jcfg,
                                         *impression_args(jb[1], jnp)),
        jb[1]["y"]))(setup["jp"])
    check_grads(grads, jgrads)


def test_dot_wrapper_refuses_mixed_operands():
    dense = torch.randn(4, 8)
    sparse = torch.randn(4, 3, 8).to(BF16)
    before = di.launch_count
    with pytest.raises(TypeError, match="one dtype"):
        di.dot_interaction_cuda(dense, sparse)
    with pytest.raises(TypeError, match="one dtype"):
        di.dot_interaction_cuda(dense.to(BF16), sparse.float())
    assert di.launch_count == before


def test_dlrm_sparse_bf16_trajectory_matches_reference():
    kw, batches = sparse_dlrm_case()
    cfg, jcfg = dlrm.DLRMConfig(**kw), jax_dlrm.DLRMConfig(**kw)
    jp = jax_dlrm.dlrm_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    args = ("ro_dense", "ro_ids", "ro_len", "nro_ids", "nro_len", "seg")
    loss = bce_loss(lambda p, b: dlrm.dlrm_forward_roo(
        p, cfg, *(b[k] for k in args)))
    jloss = lambda p, b, r: jax_bce(  # noqa: E731
        jax_dlrm.dlrm_forward_roo(p, jcfg, *(b[k] for k in args)), b["y"])
    vag = sp.make_sparse_value_and_grad(
        loss, lambda b: dlrm.dlrm_table_ids(cfg, b["ro_ids"], b["nro_ids"]))
    jvag = jax_sp.make_sparse_value_and_grad(
        jloss, lambda b: jax_dlrm.dlrm_table_ids(jcfg, b["ro_ids"],
                                                 b["nro_ids"]))
    seen = []

    def recording(p, b, gen):
        seen.append(to_ref(tree.tree_map(torch.clone, p)))
        return vag(p, b, gen)
    n = 20
    ms, state = run_steps(pp, pb, recording, 1, n, loss)
    losses = np.asarray([float(m["loss"]) for m in ms])
    jvag = jax.jit(jvag)
    same = [float(jvag(p, jb[i % len(jb)], None)[0])
            for i, p in enumerate(seen)]
    np.testing.assert_allclose(losses, same, **TOL)
    jlosses, _ = jax_trajectory(jloss, jp, jb, jvag)
    np.testing.assert_allclose(losses[:FREE_STEPS], jlosses[:FREE_STEPS],
                               **TOL)
    for t in tree.leaves(state["params"]["tables"]):
        assert t.dtype == BF16
    moved = state["params"]["tables"]["t0"] != pp["tables"]["t0"]
    assert 0 < int(moved.any(1).sum()) < cfg.vocabs[0]


# ---------------------------------------------------------------------------
# roo-lsr in its bag modes, and the two-tower "mlp" tower
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lsr_batches():
    return _batches(LSR_STREAM, LSR_BATCH)


@pytest.mark.parametrize("mode", ["baseline", "userarch"])
def test_lsr_bf16_bags_match_reference(lsr_batches, monkeypatch, mode):
    bag_functions(monkeypatch)
    cfg, jcfg = lsr_cfgs(mode)
    jp = jax_lsr.lsr_init(jax.random.PRNGKey(2), jcfg, dtype=jnp.bfloat16)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert pp["item_emb"].dtype == BF16
    pb, jb = lsr_batches
    for fn, jfn in ((lsr.lsr_logits_roo, jax_lsr.lsr_logits_roo),
                    (lsr.lsr_logits_impression,
                     jax_lsr.lsr_logits_impression)):
        got, want = fn(pp, cfg, pb[0]), jfn(jp, jcfg, jb[0])
        assert same_kind(got, want)
        np.testing.assert_allclose(f32(got), f32(want), **TOL)
    loss, grads = loop.value_and_grad(
        lambda p, b, g: lsr.lsr_loss(p, cfg, b))(pp, pb[1], None)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_lsr.lsr_loss(p, jcfg, jb[1]))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    check_grads(grads, jgrads)
    assert grads["item_emb"].dtype == BF16
    assert float(grads["item_emb"].float().abs().sum()) > 0


@pytest.mark.parametrize("kind", ["esr", "retrieval"])
def test_mlp_tower_bf16_matches_reference(monkeypatch, kind):
    bag_functions(monkeypatch)
    cfg, jcfg = tt_cfgs(kind, False)
    jp = jax_tt.two_tower_init(jax.random.PRNGKey(0), jcfg,
                               dtype=jnp.bfloat16)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    pb, jb = _batches(dict(TT_STREAM, n_items=cfg.n_items), TT_BATCH)
    u, ju = tt.user_tower(pp, cfg, pb[0]), jax_tt.user_tower(jp, jcfg, jb[0])
    assert same_kind(u, ju)
    np.testing.assert_allclose(f32(u), f32(ju), **TOL)
    loss_fn, jloss_fn = {
        "esr": (tt.esr_loss_roo, jax_tt.esr_loss_roo),
        "retrieval": (tt.retrieval_loss_roo, jax_tt.retrieval_loss_roo)}[kind]
    loss, grads = loop.value_and_grad(
        lambda p, b, g: loss_fn(p, cfg, b))(pp, pb[1], None)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, jb[1]))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    check_grads(grads, jgrads)
