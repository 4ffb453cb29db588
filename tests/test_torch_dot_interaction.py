"""The port's DLRM dot interaction (kernel B7's plain version and
``DotInteractionFn``) held against the JAX reference.

The same numpy std-1 inputs go through both packages:

  * the plain version against the reference's oracle
    (``kernels.ref.dot_interaction_ref``) and its Pallas kernel in
    interpret mode, at ``tests/test_kernels.py``'s shapes (atol 1e-4,
    rtol 1e-5: sums of up to 128 products of O(1) terms, summed in another
    order);
  * ``models.interactions.dot_interaction`` with and without the
    diagonal against the reference's;
  * the output width and the tril order (1,0), (2,0), (2,1), ...;
  * ``DotInteractionFn`` with its CUDA forward swapped for the plain
    version (the kernel runs only on the card, in ``chip_smoke.py``): its
    gradients against ``jax.vjp`` of the reference's function (1e-5) and
    ``torch.autograd.gradcheck`` in float64;
  * the dispatch ladder (``REPRO_TORCH_DOT_BACKEND``) and the raw
    wrapper's refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dot_interaction as jax_dot
from repro.kernels import ref as jax_ref
from repro.models import interactions as jax_inter
from repro_torch.kernels import dispatch
from repro_torch.kernels import dot_interaction as di
from repro_torch.kernels import hstu_attention as b1
from repro_torch.models import interactions

TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(128, 26, 128), (256, 8, 64), (128, 13, 32)]


def case(seed, b, f, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(dtype),
            rng.normal(size=(b, f, d)).astype(dtype))


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture
def plain_forward(monkeypatch):
    """``DotInteractionFn`` on CPU tensors: its CUDA forward swapped for the
    plain version, with the launch count left alone."""
    monkeypatch.setattr(di, "dot_interaction_cuda",
                        lambda d, s, self_interaction=False:
                            di.dot_interaction_plain(d, s, self_interaction))


@pytest.mark.parametrize("b,f,d", SHAPES)
def test_plain_matches_reference_and_pallas(b, f, d):
    dense, sparse = case(b + f + d, b, f, d)
    got = di.dot_interaction_plain(torch.from_numpy(dense),
                                   torch.from_numpy(sparse))
    oracle = jax_ref.dot_interaction_ref(jnp.asarray(dense),
                                         jnp.asarray(sparse))
    pallas = jax_dot.dot_interaction(jnp.asarray(dense), jnp.asarray(sparse),
                                     interpret=True)
    assert got.shape == (b, d + (f + 1) * f // 2) and got.dtype == torch.float32
    np.testing.assert_allclose(np_(got), np_(oracle), **TOL)
    np.testing.assert_allclose(np_(got), np_(pallas), **TOL)
    np.testing.assert_array_equal(np_(got)[:, :d], dense)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_model_function_matches_reference(self_interaction):
    dense, sparse = case(1, 37, 5, 24)
    got = interactions.dot_interaction(torch.from_numpy(dense),
                                       torch.from_numpy(sparse),
                                       self_interaction)
    want = jax_inter.dot_interaction(jnp.asarray(dense), jnp.asarray(sparse),
                                     self_interaction)
    assert got.shape == want.shape
    np.testing.assert_allclose(np_(got), np_(want), **TOL)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_width_and_tril_order(self_interaction):
    b, f, d = 3, 4, 6
    dense, sparse = case(2, b, f, d)
    got = np_(di.dot_interaction_plain(torch.from_numpy(dense),
                                       torch.from_numpy(sparse),
                                       self_interaction))
    f1 = f + 1
    assert got.shape == (b, d + di.n_pairs(f1, self_interaction))
    assert di.n_pairs(27) == 351 and di.n_pairs(27, True) == 378
    t = np.concatenate([dense[:, None], sparse], axis=1).astype(np.float64)
    rows, cols = np.tril_indices(f1, k=0 if self_interaction else -1)
    assert list(zip(rows[:3], cols[:3])) == (
        [(0, 0), (1, 0), (1, 1)] if self_interaction
        else [(1, 0), (2, 0), (2, 1)])
    for p, (i, j) in enumerate(zip(rows, cols)):
        np.testing.assert_allclose(got[:, d + p],
                                   np.sum(t[:, i] * t[:, j], axis=-1),
                                   rtol=1e-5, atol=1e-5)


def test_plain_bf16_casts_once():
    dense, sparse = case(3, 16, 7, 32)
    d16 = torch.from_numpy(dense).to(torch.bfloat16)
    s16 = torch.from_numpy(sparse).to(torch.bfloat16)
    got = di.dot_interaction_plain(d16, s16)
    want = di.dot_interaction_plain(d16.float(), s16.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[:, :32], d16)
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("self_interaction", [False, True])
def test_function_grads_match_jax(plain_forward, self_interaction):
    dense, sparse = case(4, 9, 6, 16)
    f1 = 7
    width = 16 + di.n_pairs(f1, self_interaction)
    g = np.random.default_rng(5).normal(size=(9, width)).astype(np.float32)
    pd = torch.from_numpy(dense).requires_grad_(True)
    ps = torch.from_numpy(sparse).requires_grad_(True)
    before = di.launch_count
    out = di.DotInteractionFn.apply(pd, ps, self_interaction)
    gd, gs = torch.autograd.grad(out, (pd, ps), torch.from_numpy(g))
    assert di.launch_count == before
    _, vjp = jax.vjp(lambda a, s: jax_inter.dot_interaction(
        a, s, self_interaction), jnp.asarray(dense), jnp.asarray(sparse))
    jd, js = vjp(jnp.asarray(g))
    np.testing.assert_allclose(np_(out), np_(jax_inter.dot_interaction(
        jnp.asarray(dense), jnp.asarray(sparse), self_interaction)), **TOL)
    np.testing.assert_allclose(np_(gd), np_(jd), **GRAD_TOL)
    np.testing.assert_allclose(np_(gs), np_(js), **GRAD_TOL)
    # unique scatter indices, no atomics: a second backward is bit-equal
    gd2, gs2 = torch.autograd.grad(
        di.DotInteractionFn.apply(pd, ps, self_interaction), (pd, ps),
        torch.from_numpy(g))
    assert torch.equal(gd, gd2) and torch.equal(gs, gs2)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_function_gradcheck(plain_forward, self_interaction):
    gen = torch.Generator().manual_seed(0)
    dense = torch.randn((3, 4), generator=gen, dtype=torch.float64,
                        requires_grad=True)
    sparse = torch.randn((3, 2, 4), generator=gen, dtype=torch.float64,
                         requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, s: di.DotInteractionFn.apply(a, s, self_interaction),
        (dense, sparse))


def test_dispatch_ladder(monkeypatch):
    monkeypatch.delenv(dispatch.DOT_ENV_VAR, raising=False)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dispatch.DOT_ENV_VAR == "REPRO_TORCH_DOT_BACKEND"
    assert dispatch.resolve_dot_backend(None, cpu) == "torch"      # auto
    assert dispatch.resolve_dot_backend(None, cuda) == "cuda"
    assert dispatch.resolve_dot_backend() == "torch"
    monkeypatch.setenv(dispatch.DOT_ENV_VAR, "cuda")
    assert dispatch.resolve_dot_backend(None, cpu) == "cuda"       # env
    assert dispatch.resolve_dot_backend("torch", cuda) == "torch"  # arg
    with dispatch.use_dot_backend("torch"):                     # scope > env
        assert dispatch.resolve_dot_backend(None, cuda) == "torch"
        assert dispatch.resolve_dot_backend("cuda", cpu) == "cuda"  # arg
    with dispatch.use_dot_backend(None):                        # no-op
        assert dispatch.resolve_dot_backend(None, cpu) == "cuda"
    dispatch.set_default_dot_backend("torch")                   # default > env
    try:
        assert dispatch.resolve_dot_backend(None, cuda) == "torch"
        with dispatch.use_dot_backend("cuda"):                  # scope > default
            assert dispatch.resolve_dot_backend(None, cpu) == "cuda"
    finally:
        dispatch.set_default_dot_backend(None)
    assert dispatch.resolve_dot_backend(None, cpu) == "cuda"       # env again
    for bad in ("pallas", "jnp"):
        with pytest.raises(ValueError):
            dispatch.resolve_dot_backend(bad)
    # the other ladders are separate knobs
    monkeypatch.delenv(dispatch.DOT_ENV_VAR)
    with dispatch.use_emb_backend("cuda"):
        assert dispatch.resolve_dot_backend(None, cpu) == "torch"


def test_entry_point_on_cpu_takes_plain_version(monkeypatch):
    monkeypatch.delenv(dispatch.DOT_ENV_VAR, raising=False)
    dense, sparse = (torch.from_numpy(a) for a in case(6, 5, 3, 8))
    before = di.launch_count
    for self_interaction in (False, True):
        got = di.dot_interaction(dense, sparse,
                                 self_interaction=self_interaction)
        assert torch.equal(got, di.dot_interaction_plain(dense, sparse,
                                                         self_interaction))
    assert di.launch_count == before
    with pytest.raises(ValueError, match="CUDA"):
        di.dot_interaction(dense, sparse, backend="cuda")
    # the plain version on a CPU tensor is differentiable
    a = dense.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(di.dot_interaction(a, sparse).sum(), [a])
    assert grad.shape == a.shape


def test_raw_wrapper_refuses_grad_before_device():
    dense, sparse = (torch.from_numpy(a) for a in case(7, 4, 3, 8))
    before = di.launch_count
    with pytest.raises(RuntimeError, match="requires grad"):
        di.dot_interaction_cuda(dense.clone().requires_grad_(True), sparse)
    with pytest.raises(RuntimeError, match="requires grad"):
        di.dot_interaction_cuda(dense, sparse.clone().requires_grad_(True))
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx(), pytest.raises(ValueError, match="CUDA device"):
            di.dot_interaction_cuda(dense, sparse)
    assert di.launch_count == before


def test_kernel_module_imports_without_nvcc():
    # importing compiled and loaded nothing; the source sits beside B1's
    assert di._lib is None
    assert di.SOURCE.exists() and di.SOURCE.parent == b1.SOURCE.parent
    text = di.SOURCE.read_text()
    for name in ("dot_interaction.py:_kernel", 'extern "C"',
                 "dot_interaction_fwd", "dot_interaction_error_string"):
        assert name in text
