"""The port's HSTU attention (repro_torch) held against the JAX reference.

Same numpy inputs go through the reference's dense oracle, its chunked jnp
path and its Pallas forward (interpret mode, as the reference's own tests
run it on the CPU), and through the port's ``torch-dense`` and
``torch-chunked`` backends, which dispatch's auto rung picks on the CPU. The
CUDA kernel itself is checked on the card by ``chip_smoke.py``.

Tolerance: atol = rtol = 1e-5 (fp32 on both sides; only summation order
differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hstu import hstu_attention_chunked as jax_chunked
from repro.core.masks import roo_spec as jax_roo_spec
from repro.kernels.hstu_attention import hstu_attention as jax_pallas
from repro.kernels.ref import hstu_attention_ref as jax_ref
from repro_torch.core.masks import causal_spec, roo_spec
from repro_torch.kernels import dispatch
from repro_torch.kernels import hstu_attention as kmod

TOL = dict(atol=1e-5, rtol=1e-5)

# (B, H, S, Dqk, Dv, n_hist, max_rel, hist_lengths, target_counts)
CASES = {
    # hstu-gr's full-width sequence: S = 64 history + 16 targets
    "gr80": (2, 2, 80, 32, 32, 64, 64, [64, 0], [16, 5]),
    # S = 100 is no multiple of the chunk (32); ragged lengths incl. zeros
    "ragged100": (3, 2, 100, 16, 24, 70, 32, [0, 70, 23], [0, 30, 7]),
    # pure causal: a history-only sequence with no target slots
    "causal48": (2, 1, 48, 8, 8, 48, 16, [48, 11], [0, 0]),
}


def make_inputs(case, seed=0):
    b, h, s, dqk, dv, n_hist, max_rel, hl, tc = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, dqk)).astype(np.float32)
    k = rng.normal(size=(b, h, s, dqk)).astype(np.float32)
    v = rng.normal(size=(b, h, s, dv)).astype(np.float32)
    rab = (0.5 * rng.normal(size=(h, 2 * max_rel + 1))).astype(np.float32)
    return dict(q=q, k=k, v=v, rab=rab, n_hist=n_hist, max_rel=max_rel,
                hl=np.asarray(hl, np.int32), tc=np.asarray(tc, np.int32))


def to_torch(x):
    return {key: torch.from_numpy(val) if isinstance(val, np.ndarray)
            else val for key, val in x.items()}


def torch_spec(t):
    if t["n_hist"] == t["q"].shape[2] and not bool(t["tc"].any()):
        return causal_spec(t["hl"], t["n_hist"])
    return roo_spec(t["hl"], t["tc"], t["n_hist"])


def port(x, backend, use_rab, **kw):
    t = to_torch(x)
    out = dispatch.hstu_attention(
        t["q"], t["k"], t["v"], t["rab"] if use_rab else None, torch_spec(t),
        backend=backend, max_rel_pos=t["max_rel"], **kw)
    return out.numpy()


def jax_args(x, use_rab):
    return (jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
            jnp.asarray(x["rab"]) if use_rab else None)


def valid_rows(x):
    """(B, S) bool: rows the ROO mask keeps."""
    s = x["q"].shape[2]
    pos = np.arange(s)
    return np.where(pos[None] < x["n_hist"], pos[None] < x["hl"][:, None],
                    (pos[None] - x["n_hist"]) < x["tc"][:, None])


@pytest.mark.parametrize("use_rab", [True, False], ids=["rab", "norab"])
@pytest.mark.parametrize("case", sorted(CASES))
class TestAgainstReference:
    def test_dense_matches_jnp_oracle(self, case, use_rab):
        x = make_inputs(case)
        q, k, v, rab = jax_args(x, use_rab)
        want = np.asarray(jax_ref(q, k, v, rab, x["n_hist"],
                                  jnp.asarray(x["hl"]), jnp.asarray(x["tc"]),
                                  x["max_rel"]))
        np.testing.assert_allclose(port(x, "torch-dense", use_rab), want,
                                   **TOL)

    def test_chunked_matches_jnp_chunked(self, case, use_rab):
        x = make_inputs(case, seed=1)
        q, k, v, rab = jax_args(x, use_rab)
        spec = jax_roo_spec(jnp.asarray(x["hl"]), jnp.asarray(x["tc"]),
                            x["n_hist"])
        want = np.asarray(jax_chunked(q, k, v, rab, spec,
                                      max_rel_pos=x["max_rel"], chunk=32))
        got = port(x, "torch-chunked", use_rab, chunk=32)
        np.testing.assert_allclose(got, want, **TOL)

    def test_matches_pallas_interpret(self, case, use_rab):
        x = make_inputs(case, seed=2)
        q, k, v, rab = jax_args(x, use_rab)
        want = np.asarray(jax_pallas(q, k, v, rab, x["n_hist"],
                                     jnp.asarray(x["hl"]),
                                     jnp.asarray(x["tc"]), x["max_rel"],
                                     interpret=True))
        for backend in ("torch-dense", "torch-chunked"):
            np.testing.assert_allclose(port(x, backend, use_rab), want,
                                       **TOL, err_msg=backend)

    def test_masked_rows_exactly_zero(self, case, use_rab):
        x = make_inputs(case, seed=3)
        dead = ~valid_rows(x)
        assert dead.any()
        for backend in ("torch-dense", "torch-chunked"):
            out = port(x, backend, use_rab)
            assert np.all(out.transpose(0, 2, 1, 3)[dead] == 0.0), backend
            assert np.all(np.isfinite(out))


@pytest.mark.parametrize("chunk", [1, 7, 32, 80, 128])
def test_chunk_size_independence(chunk):
    x = make_inputs("gr80", seed=4)
    want = port(x, "torch-dense", True)
    np.testing.assert_allclose(port(x, "torch-chunked", True, chunk=chunk),
                               want, **TOL)


def test_kernel_wrapper_cpu_takes_plain_version(monkeypatch):
    # the entry the model calls: auto on a CPU tensor runs a plain version
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    x = make_inputs("ragged100", seed=5)
    t = to_torch(x)
    before = kmod.launch_count
    got = port(x, None, True)
    plain = kmod.hstu_attention_plain(t["q"], t["k"], t["v"], t["rab"],
                                      t["n_hist"], t["hl"], t["tc"],
                                      t["max_rel"])
    np.testing.assert_allclose(got, plain.numpy(), **TOL)
    assert kmod.launch_count == before      # the CPU path launches nothing
    assert kmod.hstu_attention_plain is kmod.hstu_attention_ref


def test_kernel_module_imports_without_nvcc():
    # importing (done above) compiled and loaded nothing
    assert kmod._lib is None
    assert kmod.SOURCE.exists()
    assert kmod.SOURCE.suffix == ".cu"


def test_cuda_backend_on_cpu_raises():
    x = make_inputs("gr80")
    with pytest.raises(ValueError, match="CUDA"):
        port(x, "cuda", True)
    t = to_torch(x)
    with pytest.raises(ValueError, match="CUDA"):
        kmod.hstu_attention_cuda(t["q"], t["k"], t["v"], t["rab"],
                                 t["n_hist"], t["hl"], t["tc"], t["max_rel"])


def test_auto_on_cpu_resolves_to_torch_chunked(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert dispatch.resolve_backend(None, torch.device("cpu")) == \
        "torch-chunked"
    assert dispatch.resolve_backend(None, torch.device("cuda")) == "cuda"
    x = make_inputs("gr80")
    np.testing.assert_array_equal(port(x, None, True),
                                  port(x, "torch-chunked", True))


def test_backend_ladder_and_env_split(monkeypatch):
    # the reference's env var never reaches the port
    monkeypatch.setenv("REPRO_HSTU_BACKEND", "pallas-interpret")
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert dispatch.resolve_backend(None, torch.device("cpu")) == \
        "torch-chunked"
    monkeypatch.setenv(dispatch.ENV_VAR, "torch-dense")
    assert dispatch.resolve_backend(None, torch.device("cpu")) == \
        "torch-dense"
    with dispatch.use_backend("torch-chunked"):       # scope beats env
        assert dispatch.resolve_backend() == "torch-chunked"
        assert dispatch.resolve_backend("cuda") == "cuda"   # arg beats all
    dispatch.set_default_backend("torch-chunked")
    try:                                              # default beats env
        assert dispatch.get_default_backend() == "torch-chunked"
        assert dispatch.resolve_backend() == "torch-chunked"
        with dispatch.use_backend("torch-dense"):     # scope beats default
            assert dispatch.resolve_backend() == "torch-dense"
    finally:
        dispatch.set_default_backend(None)
    assert dispatch.get_default_backend() is None
    monkeypatch.setenv(dispatch.ENV_VAR, "pallas")
    with pytest.raises(ValueError):
        dispatch.resolve_backend()
