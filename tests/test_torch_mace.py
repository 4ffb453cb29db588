"""The port's GNN family (``repro_torch/models/gnn/{irreps,mace,sampler}.py``
and ``configs/mace.py``) held against the JAX reference on the CPU:

  * the irreps: every real Clebsch–Gordan block, the path list, the numpy
    spherical harmonics, ``wigner_d_from_sh`` and ``random_rotation``
    equal to the reference's exactly (the numpy half is a copy); the torch
    spherical harmonics against the numpy ones;
  * ``mace_forward`` on both gather routes (``hoist_gathers`` off and on,
    and on with bf16 messages) with the reference's ``mace_init`` params
    carried across: energies and node outputs, and the gradient of
    ``mace_energy_loss`` per leaf; both routes equal in the port;
  * the energy invariant under a rotation plus a translation;
  * the port's fixed-order segment sum against ``np.add.at`` (out-of-range
    ids dropped, as ``jax.ops.segment_sum`` drops them);
  * the neighbour sampler: the same subgraph from the same ``RandomState``.

Tolerances: energies and node outputs atol = rtol = 1e-5; gradients 1e-4
(summed in other orders); bf16 messages 2e-2; invariance 2e-4 (the
reference's bound, ``tests/test_models_smoke.py``). The reference runs
jitted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import irreps as ref_irreps
from repro.models.gnn import mace as ref_mace
from repro.models.gnn import sampler as ref_sampler
from repro_torch.configs.registry import get_arch
from repro_torch.interop import params_from_numpy
from repro_torch.models.gnn import irreps, mace, sampler
from repro_torch.tree import leaves, unflatten

TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
INVARIANCE_TOL = 2e-4


def graph(n=20, e=50, g=2, f=8, seed=0):
    """A batch as the reference's smoke test draws it, with one masked
    edge, one self-loop and the node ids unsorted by graph."""
    r = np.random.RandomState(seed)
    edge_index = r.randint(0, n, (e, 2)).astype(np.int32)
    edge_index[7] = (3, 3)
    edge_mask = np.ones((e,), bool)
    edge_mask[11] = False
    return dict(node_feat=r.normal(size=(n, f)).astype(np.float32),
                positions=r.normal(size=(n, 3)).astype(np.float32),
                edge_index=edge_index, edge_mask=edge_mask,
                graph_ids=r.randint(0, g, n).astype(np.int32))


def setup(channels=16, n_out=3):
    rc = ref_mace.MACEConfig(channels=channels, n_feat_in=8, n_out=n_out)
    pc = mace.MACEConfig(**dataclasses.asdict(rc))
    rp = ref_mace.mace_init(jax.random.PRNGKey(0), rc)
    return rc, pc, rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def test_irreps_equal_reference_exactly():
    assert irreps.cg_paths() == ref_irreps.cg_paths()
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(3):
                np.testing.assert_array_equal(irreps.cg_real(l1, l2, l3),
                                              ref_irreps.cg_real(l1, l2, l3))
    v = np.random.RandomState(0).normal(size=(40, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    want = ref_irreps.spherical_harmonics_np(v)
    got_np = irreps.spherical_harmonics_np(v)
    got = irreps.spherical_harmonics(torch.from_numpy(v.astype(np.float32)))
    for l in range(3):
        np.testing.assert_array_equal(got_np[l], want[l])
        assert_close(got[l], want[l], 1e-6, f"l={l}")
    rot = ref_irreps.random_rotation(5)
    np.testing.assert_array_equal(irreps.random_rotation(5), rot)
    for l in range(3):
        np.testing.assert_array_equal(irreps.wigner_d_from_sh(l, rot),
                                      ref_irreps.wigner_d_from_sh(l, rot))


@pytest.mark.parametrize("route", ["per-path", "hoisted", "hoisted-bf16"])
def test_forward_and_grads_match_reference(route):
    rc, pc, rp, pp = setup()
    batch, g = graph(), 2
    kw = dict(hoist_gathers=route != "per-path")
    ref_kw, port_kw = dict(kw), dict(kw)
    if route == "hoisted-bf16":
        ref_kw["msg_dtype"], port_kw["msg_dtype"] = jnp.bfloat16, \
            torch.bfloat16
    tol = BF16_TOL if route == "hoisted-bf16" else TOL
    targets = np.random.RandomState(1).normal(size=(g, 3)).astype(np.float32)

    def ref_loss(p):     # mace_energy_loss, with the forward's outputs
        out = ref_mace.mace_forward(p, rc, **ref(batch), n_graphs=g,
                                    **ref_kw)
        return jnp.mean((out["energy"] - jnp.asarray(targets)) ** 2), out
    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(
        ref_loss, has_aux=True))(rp)

    got = mace.mace_forward(pp, pc, **port(batch), n_graphs=g, **port_kw)
    for key in ("energy", "node_out"):
        assert_close(got[key], want[key], tol, key)
    flat = [p.detach().requires_grad_(True) for p in leaves(pp)]
    loss = mace.mace_energy_loss(unflatten(pp, flat), pc, dict(
        port(batch), n_graphs=g, **port_kw), torch.from_numpy(targets))
    assert_close(loss.detach(), want_loss, tol)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    for (path, w), gr, p in zip(jax.tree_util.tree_flatten_with_path(
            want_grads)[0], grads, flat):
        gr = torch.zeros_like(p) if gr is None else gr
        np.testing.assert_allclose(
            gr.numpy(), np.asarray(w), err_msg=jax.tree_util.keystr(path),
            atol=BF16_TOL if route == "hoisted-bf16" else GRAD_TOL,
            rtol=BF16_TOL if route == "hoisted-bf16" else GRAD_TOL)


def test_routes_agree_and_energy_is_invariant():
    _, pc, _, pp = setup(channels=8, n_out=1)
    batch = graph(n=16, e=40, g=1, seed=1)
    batch["graph_ids"][:] = 0
    per_path = mace.mace_forward(pp, pc, **port(batch), n_graphs=1)
    hoisted = mace.mace_forward(pp, pc, **port(batch), n_graphs=1,
                                hoist_gathers=True)
    for key in ("energy", "node_out"):
        assert_close(hoisted[key], per_path[key], TOL, key)
    rot = irreps.random_rotation(5).astype(np.float32)
    moved = dict(batch, positions=batch["positions"] @ rot.T + 2.0)
    again = mace.mace_forward(pp, pc, **port(moved), n_graphs=1)
    assert_close(again["energy"], per_path["energy"], INVARIANCE_TOL)


def test_segment_sum_drops_out_of_range_ids():
    r = np.random.RandomState(2)
    ids = r.randint(-2, 8, 60)
    rows = r.normal(size=(60, 3, 2)).astype(np.float32)
    want = np.zeros((6, 3, 2), np.float32)
    keep = (ids >= 0) & (ids < 6)
    np.add.at(want, ids[keep], rows[keep])
    perm, lengths = mace.segment_layout(torch.from_numpy(ids), 6)
    got = mace.segment_sum(torch.from_numpy(rows)[perm], lengths, 6)
    assert_close(got, want, 1e-6)


def test_sampler_gives_the_reference_subgraph():
    g_ref = ref_sampler.random_graph(500, 8, seed=0)
    g = sampler.random_graph(500, 8, seed=0)
    np.testing.assert_array_equal(g.indptr, g_ref.indptr)
    np.testing.assert_array_equal(g.indices, g_ref.indices)
    want = ref_sampler.sample_subgraph(g_ref, np.arange(16), [15, 10], 300,
                                       2000, np.random.RandomState(3))
    got = sampler.sample_subgraph(g, np.arange(16), [15, 10], 300, 2000,
                                  np.random.RandomState(3))
    assert got.n_nodes == want.n_nodes
    for field in ("node_ids", "edge_index", "edge_mask", "seed_mask"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_config_module():
    mod = get_arch("mace")
    assert (mod.ARCH_ID, mod.FAMILY) == ("mace", "gnn")
    # the dry-run cells (A10b): the reference's shapes, a Cell per shape
    from repro.configs.mace import SHAPES as ref_shapes
    from repro_torch.configs.base import Cell
    from repro_torch.distributed.sharding import replicated_plan
    assert mod.SHAPES == ref_shapes
    for shape in mod.SHAPES:
        cell = mod.build_cell(shape, replicated_plan())
        assert isinstance(cell, Cell) and cell.kind == "train"
