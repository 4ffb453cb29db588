"""The port's ``kernels/ops.py`` held against the reference's ``ops`` on the
CPU: ``use_pallas="never"`` and ``"auto"`` of each wrapper (HSTU attention,
the embedding bag in its three poolings, the dot interaction) on the same
numpy inputs, at the shapes of ``tests/test_kernels.py``'s ops case.
``"auto"`` resolves to the plain torch path on a CPU tensor, as the
reference's resolves to its jnp path (the dot interaction's to its
Pallas-interpret kernel) off the TPU; ``"always"`` names the CUDA kernel,
which a CPU tensor refuses (dispatch's rule). Tolerances: atol = rtol =
1e-5 (the dot interaction's Pallas kernel, 1e-4 as
``tests/test_kernels.py`` holds it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops

TOL = 1e-5


def assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def attention_inputs():
    r = np.random.RandomState(0)
    b, h, s, d, n_hist = 2, 2, 64, 16, 48
    q, k, v = (r.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    rab = (r.normal(size=(h, 2 * 32 + 1)) * 0.1).astype(np.float32)
    hl = np.array([30, 48], np.int32)
    tc = np.array([16, 5], np.int32)
    return (q, k, v, rab, hl, tc), dict(n_hist=n_hist, max_rel_pos=32)


def bag_inputs():
    r = np.random.RandomState(3)
    table = r.normal(size=(64, 16)).astype(np.float32)
    ids = r.randint(0, 64, (8, 4)).astype(np.int32)
    lengths = np.array([4, 0, 1, 3, 4, 2, 4, 1], np.int32)
    return table, ids, lengths


@pytest.mark.parametrize("use_pallas", ["never", "auto"])
def test_hstu_attention(use_pallas):
    args, kw = attention_inputs()
    want = ref_ops.hstu_attention(*map(jnp.asarray, args), **kw,
                                  use_pallas=use_pallas)
    got = ops.hstu_attention(*map(torch.from_numpy, args), **kw,
                             use_pallas=use_pallas)
    assert_close(got, want)


@pytest.mark.parametrize("use_pallas", ["never", "auto"])
@pytest.mark.parametrize("pooling", ["sum", "mean", "max"])
def test_embedding_bag(pooling, use_pallas):
    args = bag_inputs()
    want = ref_ops.embedding_bag(*map(jnp.asarray, args), pooling=pooling,
                                 use_pallas=use_pallas)
    got = ops.embedding_bag(*map(torch.from_numpy, args), pooling=pooling,
                            use_pallas=use_pallas)
    assert_close(got, want)


@pytest.mark.parametrize("use_pallas", ["never", "auto"])
def test_dot_interaction(use_pallas):
    r = np.random.RandomState(4)
    dense = r.normal(size=(16, 32)).astype(np.float32)
    sparse = r.normal(size=(16, 5, 32)).astype(np.float32)
    want = ref_ops.dot_interaction(jnp.asarray(dense), jnp.asarray(sparse),
                                   use_pallas=use_pallas)
    got = ops.dot_interaction(torch.from_numpy(dense),
                              torch.from_numpy(sparse), use_pallas=use_pallas)
    assert_close(got, want, 1e-4 if use_pallas == "auto" else TOL)


def test_always_names_the_kernel_and_a_cpu_tensor_refuses_it():
    args, kw = attention_inputs()
    with pytest.raises(ValueError, match="cuda"):
        ops.hstu_attention(*map(torch.from_numpy, args), **kw,
                           use_pallas="always")
    with pytest.raises(ValueError, match="cuda"):
        ops.embedding_bag(*map(torch.from_numpy, bag_inputs()),
                          use_pallas="always")
    with pytest.raises(ValueError, match="cuda"):
        ops.dot_interaction(torch.zeros((2, 8)), torch.zeros((2, 3, 8)),
                            use_pallas="always")
    with pytest.raises(ValueError, match="use_pallas"):
        ops.dot_interaction(torch.zeros((2, 8)), torch.zeros((2, 3, 8)),
                            use_pallas="sometimes")
    assert jax.default_backend() == "cpu"
