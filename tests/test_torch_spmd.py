"""The port's sharding plan and placement rules (``distributed/sharding.py``,
``distributed/spmd.py``), its mesh parser and the shard-aware batcher,
against the reference's pure functions, with no process group.

  * ``param_spec`` / ``state_shardings`` of the port equal the reference's
    ``param_spec`` (normalised: ``'data'`` vs ``('data',)``, trailing
    Nones) on every leaf of the lsr, gr and dlrm training states
    ``{params, opt, step, comms_ef}`` at meshes 2 x 2, 1 x 4 and
    2 x 1 x 2 (abstract meshes: shapes only), leaf paths equal;
  * ``table_is_sharded`` and ``batch_spec`` equal the reference's;
  * ``place_batch`` cuts a batch packed for 2 data shards into each rank's
    block and rebases ``segment_ids``: block k equals the reference
    batcher's ``local_segment_ids=True`` batch's block k, field by field
    (jagged features whole);
  * the port's ``ROOBatcher`` with ``n_shards`` / ``local_segment_ids``
    equals the reference's batches and plans field by field;
  * ``make_mesh_from_spec`` refuses a mesh larger than the world before
    making one, and a malformed spec; ``jax_treedef_pickle`` unpickles to
    the reference's ``PyTreeDef``.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import joiner as jax_joiner
from repro.data import batcher as jax_batcher
from repro.data import events as jax_events
from repro.distributed import comms as jax_comms
from repro.distributed import spmd as jax_spmd
from repro.distributed.sharding import ShardingPlan as JaxPlan
from repro.models import dlrm as jax_dlrm
from repro.models import gr as jax_gr
from repro.models import lsr as jax_lsr
from repro.train import optim as jax_optim
from repro_torch.core import joiner as port_joiner
from repro_torch.data import events as port_events
from repro_torch.data.batcher import BatcherConfig, ROOBatcher
from repro_torch.data.jagged import JaggedTensor
from repro_torch.distributed import comms, spmd
from repro_torch.distributed.sharding import (Mesh, abstract_mesh,
                                              normalize_spec, plan_for_mesh)
from repro_torch.interop import params_from_numpy
from repro_torch.launch.mesh import make_mesh_from_spec, parse_mesh_spec
from repro_torch.train.checkpoint import jax_treedef_pickle
from repro_torch.train.optim import (adam, default_is_embedding, make_mixed,
                                     rowwise_adagrad)
from repro_torch.tree import flatten_with_path, leaves

MESHES = [(2, 2), (1, 4), (2, 1, 2)]


def plans(dims):
    mesh = abstract_mesh(dims)
    jplan = JaxPlan(mesh=mesh, batch_axes=tuple(mesh.axis_names[:-1]),
                    fsdp_axis=("pod", "data") if len(dims) == 3 else "data")
    return plan_for_mesh(mesh), jplan


def _jax_params(arch):
    key = jax.random.PRNGKey(0)
    if arch == "lsr":
        from repro.core.hstu import HSTUConfig
        cfg = jax_lsr.LSRConfig(
            n_items=512, n_user_cats=64, n_item_cats=64, embed_dim=32,
            n_ro_dense=16, n_item_dense=8, hist_len=16, mode="userarch_hstu",
            lce_n_out=4, lce_d_out=32, n_cross_layers=2, top_mlp=(64,),
            hstu=HSTUConfig(d_model=32, n_heads=2, d_qk=16, d_v=16,
                            n_layers=1, max_rel_pos=16))
        return jax_lsr.lsr_init(key, cfg)
    if arch == "gr":
        from repro.core.hstu import HSTUConfig
        return jax_gr.gr_init(key, jax_gr.GRConfig(
            n_items=512, hist_len=16, m_targets=8,
            hstu=HSTUConfig(d_model=32, n_heads=2, d_qk=16, d_v=16,
                            n_layers=1, max_rel_pos=24)))
    return jax_dlrm.dlrm_init(key, jax_dlrm.DLRMConfig(
        n_dense=4, embed_dim=32, bot_mlp=(4, 32, 32), top_mlp=(64, 32, 1),
        vocabs=(256, 128, 64, 8), n_ro_fields=2, multi_hot=2))


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("arch", ["lsr", "gr", "dlrm"])
def test_state_specs_equal_the_reference(arch, dims):
    plan, jplan = plans(dims)
    jparams = _jax_params(arch)
    jopt = jax_optim.make_mixed(jax_optim.adam(1e-3),
                                jax_optim.rowwise_adagrad(0.05),
                                jax_optim.default_is_embedding)
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32),
              "comms_ef": jax_comms.ef_init(jparams, jplan)}
    want = [(tuple(str(k) for k in kp),
             normalize_spec(jax_spmd.param_spec(
                 tuple(str(k) for k in kp), jnp.shape(leaf), jplan)))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    opt = make_mixed(adam(1e-3), rowwise_adagrad(0.05), default_is_embedding)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32),
             "comms_ef": comms.ef_init(params, plan)}
    specs = spmd.state_shardings(state, plan)
    got = [(path, normalize_spec(s)) for (path, _), s in zip(
        flatten_with_path(state), leaves(specs, is_leaf=spmd.is_spec))]
    assert got == want
    # the reference's test_tables_actually_sharded, on the port's specs
    assert normalize_spec(spmd.param_spec(("['item_emb']",), (512, 32),
                                          plan)) != () or arch == "dlrm"
    assert state["comms_ef"] and any(
        s and s[0] == "model" for s in leaves(
            specs["comms_ef"], is_leaf=spmd.is_spec))


@pytest.mark.parametrize("dims", MESHES)
def test_table_and_batch_rules_equal_the_reference(dims):
    plan, jplan = plans(dims)
    for vocab in (4, 63, 64, 65, 66, 100, 128, 512, 1000):
        assert spmd.table_is_sharded(plan, vocab) == \
            jax_spmd.table_is_sharded(jplan, vocab)
    for shape in ((8, 16), (32,), (6, 3), (3, 8), (0, 4), (2, 8, 4)):
        for bd in (0, 1):
            assert normalize_spec(spmd.batch_spec(shape, plan, bd)) == \
                normalize_spec(jax_spmd.batch_spec(shape, jplan, bd))
    assert spmd.data_shard_count(plan) == jax_spmd.data_shard_count(jplan)
    assert spmd.data_shard_count(None) == 1


def test_normalize_spec():
    assert normalize_spec(("data", None)) == normalize_spec((("data",),))
    assert normalize_spec(()) == normalize_spec((None, None)) == ()
    assert normalize_spec((("pod", "data"), "model")) == \
        (("pod", "data"), "model")


class _Coords:
    """A stand-in DeviceMesh answering this rank's coordinates."""

    def __init__(self, **coords):
        self.coords = coords

    def get_local_rank(self, axis):
        return self.coords[axis]


def _samples(pkg_events, pkg_joiner):
    stream = pkg_events.EventStreamConfig(n_requests=60, n_items=512,
                                          hist_init_max=12, seed=0)
    return pkg_joiner.RequestLevelJoiner().join(
        list(pkg_events.EventSimulator(stream).stream()))


BCFG = dict(b_ro=8, b_nro=32, hist_len=16, ro_idlist_capacity=256,
            item_idlist_capacity=512)


def _fields(batch):
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if v is None:
            continue
        if hasattr(v, "features"):                     # KeyedJagged
            for name, jt in sorted(v.features.items()):
                out[f"{f.name}/{name}/values"] = np.asarray(jt.values)
                out[f"{f.name}/{name}/lengths"] = np.asarray(jt.lengths)
        else:
            out[f.name] = np.asarray(v)
    return out


def _same_fields(ours, theirs):
    a, b = _fields(ours), _fields(theirs)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n_shards,local", [(2, False), (2, True),
                                            (4, False)])
def test_shard_aware_batcher_equals_the_reference(n_shards, local):
    ours = list(ROOBatcher(BatcherConfig(**BCFG, n_shards=n_shards,
                                         local_segment_ids=local),
                           device="cpu").batches_with_plan(
        _samples(port_events, port_joiner)))
    theirs = list(jax_batcher.ROOBatcher(jax_batcher.BatcherConfig(
        **BCFG, n_shards=n_shards, local_segment_ids=local))
        .batches_with_plan(_samples(jax_events, jax_joiner)))
    assert len(ours) == len(theirs) > 1
    for (b, p), (jb, jp) in zip(ours, theirs):
        _same_fields(b, jb)
        assert [dataclasses.astuple(r) for r in p.requests] == \
            [dataclasses.astuple(r) for r in jp.requests]
    with pytest.raises(ValueError, match="divisible by n_shards"):
        ROOBatcher(BatcherConfig(**dict(BCFG, b_ro=6), n_shards=4))


@pytest.mark.parametrize("k", [0, 1])
def test_place_batch_cuts_and_rebases_segment_ids(k):
    mesh = Mesh(("data", "model"), (2, 2), _Coords(data=k, model=1))
    plan = plan_for_mesh(mesh)
    glob = list(ROOBatcher(BatcherConfig(**BCFG, n_shards=2),
                           device="cpu").batches(
        _samples(port_events, port_joiner)))
    local = list(jax_batcher.ROOBatcher(jax_batcher.BatcherConfig(
        **BCFG, n_shards=2, local_segment_ids=True)).batches(
        _samples(jax_events, jax_joiner)))
    for gb, lb in zip(glob, local):
        mine = spmd.place_batch(gb, plan)
        want = _fields(lb)
        for name, v in _fields(mine).items():
            if "sparse" in name:                 # jagged: whole
                np.testing.assert_array_equal(v, want[name], err_msg=name)
            else:
                m = want[name].shape[0] // 2
                np.testing.assert_array_equal(
                    v, want[name][k * m:(k + 1) * m], err_msg=name)
        assert isinstance(mine.ro_sparse["user_ids"], JaggedTensor)
    assert spmd.place_batch(glob[0], None) is glob[0]
    # with the microbatch axis first, dim 1 is cut
    stacked = torch.stack([glob[0].ro_dense, glob[1].ro_dense])
    assert tuple(spmd.place_batch(stacked, plan, batch_dim=1).shape) == \
        (2, 4, stacked.shape[-1])


def test_mesh_spec_refusals_need_no_world():
    assert parse_mesh_spec("2x4") == ((2, 4), ("data", "model"))
    assert parse_mesh_spec("2×2×2") == ((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="DATAxMODEL"):
        parse_mesh_spec("2x2x2x2")
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="needs 4 ranks but the "
                                               "world has 1"):
            make_mesh_from_spec("2x2")
        assert not dist.is_initialized()


@pytest.mark.parametrize("tree", [
    {"params": {"a": 1, "b": [1, 2]}, "step": 0, "x": None},
    ((1, 2), [3], {"z": 4, "a": 5}, None), {}, [[], {"k": [1]}]])
def test_treedef_pickle_is_the_references(tree):
    assert pickle.loads(jax_treedef_pickle(tree)) == \
        jax.tree_util.tree_structure(tree)


def test_restore_resharded_cuts_by_explicit_specs(tmp_path):
    from repro_torch.train.checkpoint import CheckpointManager
    state = {"params": {"item_emb": torch.arange(512 * 4, dtype=torch.float32)
                        .reshape(512, 4),
                        "w": torch.ones(8, 4)},
             "step": torch.tensor(3)}
    CheckpointManager(str(tmp_path)).save(3, state)
    plan = plan_for_mesh(Mesh(("data", "model"), (1, 2),
                              _Coords(data=0, model=1)))
    specs = spmd.state_shardings(state, plan)
    got = CheckpointManager(str(tmp_path)).restore_resharded(specs, plan, 3)
    torch.testing.assert_close(got["params"]["item_emb"],
                               state["params"]["item_emb"][256:])
    # a dense leaf is cut by its TP spec (None, model): model rank 1's
    # columns
    assert specs["params"]["w"] == (None, "model")
    torch.testing.assert_close(got["params"]["w"],
                               state["params"]["w"][:, 2:])
    assert int(got["step"]) == 3
