"""bf16 state at rest in the port, held against the JAX reference on the
CPU: host copies, ``interop`` and checkpoints, bit for bit.

numpy has no bfloat16; the reference gets one from ``ml_dtypes`` and writes
a bf16 leaf into a checkpoint as its bytes (``uint8``) under a
``sharding.json`` entry of dtype ``bfloat16``. The port has no
``ml_dtypes``: it holds a bf16 leaf on the host as its bits
(``repro_torch.host.BF16_BITS``) and writes and reads the reference's
layout. Each case below goes through both packages on inputs made from a
seed:

  * ``interop``: a bf16 tree and a bf16 ``GRUserState`` to numpy and back,
    and the reference's ``ml_dtypes`` arrays in, bit for bit;
  * Trainer checkpoints of bf16 hstu-gr and dlrm (the scenario's mixed
    optimizer: Adam moments and row-wise Adagrad accumulators in bf16
    beside fp32 counters), written by one package and restored by the
    other, both ways, bit for bit: params, opt and step;
  * a bf16 Trainer stopped after step 2 and restarted from its checkpoint
    gives the uninterrupted run's losses and final state bit for bit;
  * a bf16 qwen3-style LM tree (``param_dtype="bfloat16"``) both ways;
  * a bf16 roo-lsr state saved under a 1 x 2 plan by two spawned gloo
    ranks (``torch_spmd_ranks.bf16_ckpt_rank``: row blocks of the tables,
    column blocks of the dense leaves, each a byte view) is read by the
    reference's ``CheckpointManager.restore()`` and by both of the port's
    sharded restores on the ranks, bit for bit.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import qwen3_moe_235b_a22b as jax_qwen
from repro.core import joiner as jax_joiner
from repro.data import batcher as jax_batcher
from repro.data import events as jax_events
from repro.models import dlrm as jax_dlrm
from repro.models import gr as jax_gr
from repro.models.lm import transformer as jax_lm
from repro.train import loop as jax_loop
from repro.train import optim as jax_optim
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch import tree
from repro_torch.configs import qwen3_moe_235b_a22b as qwen
from repro_torch.core import joiner
from repro_torch.data import batcher, events
from repro_torch.interop import (gr_state_from_numpy, gr_state_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.launch.hostdevices import spawn
from repro_torch.models import dlrm, gr
from repro_torch.models.lm import transformer as lm
from repro_torch.serve.engine import BF16_BITS
from repro_torch.train import loop, metrics, optim
from repro_torch.train.checkpoint import CheckpointManager
from test_torch_incremental import JAX_TINY, TINY
from torch_port_state import one_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(__file__))
import torch_spmd_ranks as R  # noqa: E402

BF16 = torch.bfloat16
STREAM = dict(n_requests=40, n_users=10, n_items=TINY.n_items,
              hist_init_max=6, seed=0)
BATCH = dict(b_ro=4, b_nro=16, hist_len=TINY.hist_len)
DLRM_KW = dict(n_dense=4, embed_dim=16, bot_mlp=(4, 32, 16),
               top_mlp=(64, 32, 1), vocabs=(512, 256, 64, 32),
               n_ro_fields=2, multi_hot=2)
STEPS = 4
KEYS = ("params", "opt", "step")


def is_bf16(a: np.ndarray) -> bool:
    """A host array of bf16 values: the port's bits or ml_dtypes'."""
    return a.dtype == BF16_BITS or a.dtype.name == "bfloat16"


def bits(x) -> np.ndarray:
    """A leaf of either package as numpy: bf16 as its bits (uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == BF16 else x.numpy())
    a = np.asarray(x)
    return (np.ascontiguousarray(a).view(np.uint16).reshape(a.shape)
            if is_bf16(a) else a)


def is_bf16_leaf(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype == BF16
    return is_bf16(np.asarray(x))


def assert_same_bits(port_tree, ref_tree):
    """The two trees leaf for leaf in flatten order: the same dtype kind
    (bf16 on both sides or neither) and the same bits."""
    pl, rl = tree.leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(pl) == len(rl)
    n_bf16 = 0
    for (path, a), b in zip(tree.flatten_with_path(port_tree), rl):
        assert is_bf16_leaf(a) == is_bf16_leaf(b), path
        n_bf16 += is_bf16_leaf(a)
        assert bits(a).shape == bits(b).shape, path
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=str(path))
    assert n_bf16 > 0


def to_ref(tree_np):
    """numpy leaves from the port (bf16 as ``BF16_BITS``) -> the
    reference's arrays (bf16 as ``ml_dtypes.bfloat16``)."""
    return jax.tree.map(
        lambda a: jnp.asarray(bits(a).view(ml_dtypes.bfloat16)
                              if is_bf16(a) else a), tree_np)


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------

def test_params_to_numpy_takes_bf16_bit_for_bit():
    params = gr.gr_init(torch.Generator().manual_seed(0), TINY, dtype=BF16,
                        device="cpu")
    params["scale"] = torch.randn((), generator=torch.Generator().manual_seed(
        1)).to(BF16)
    params["f32"] = torch.randn(3, 2)
    host = params_to_numpy(params)
    assert host["scale"].dtype == BF16_BITS and host["scale"].shape == ()
    assert host["f32"].dtype == np.float32
    back = params_from_numpy(host, "cpu")
    assert_same_bits(back, host)
    assert_same_bits(params, to_ref(host))
    # the reference's ml_dtypes arrays cross by their bits too
    again = params_from_numpy(jax.tree.map(np.asarray, to_ref(host)), "cpu")
    assert_same_bits(again, host)
    assert tree.leaves(again)[0].dtype == BF16


def test_gr_state_round_trip_bf16():
    gen = torch.Generator().manual_seed(2)
    state = gr.gr_state_init(TINY, dtype=BF16, device="cpu")
    state = state._replace(
        k=torch.randn(state.k.shape, generator=gen).to(BF16),
        v=torch.randn(state.v.shape, generator=gen).to(BF16),
        length=torch.tensor(5, dtype=state.length.dtype))
    host = gr_state_to_numpy(state)
    assert host.k.dtype == BF16_BITS and host.v.dtype == BF16_BITS
    ref = jax_gr.GRUserState(*to_ref(list(host)))
    assert ref.k.dtype == jnp.bfloat16
    back = gr_state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    for a, b in zip(back, state):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert_same_bits(list(state), list(ref))


# ---------------------------------------------------------------------------
# Trainer checkpoints, both ways
# ---------------------------------------------------------------------------

def gr_case():
    ps = joiner.RequestLevelJoiner().join(list(events.EventSimulator(
        events.EventStreamConfig(**STREAM)).stream()))
    js = jax_joiner.RequestLevelJoiner().join(list(
        jax_events.EventSimulator(
            jax_events.EventStreamConfig(**STREAM)).stream()))
    return dict(
        pb=list(batcher.ROOBatcher(batcher.BatcherConfig(**BATCH),
                                   device="cpu").batches(ps)),
        jb=list(jax_batcher.ROOBatcher(
            jax_batcher.BatcherConfig(**BATCH)).batches(js)),
        jp=jax_gr.gr_init(jax.random.PRNGKey(0), JAX_TINY,
                          dtype=jnp.bfloat16),
        loss=lambda p, b, g: gr.gr_ranking_loss(p, TINY, b),
        jloss=lambda p, b, r: jax_gr.gr_ranking_loss(p, JAX_TINY, b))


def dlrm_case():
    cfg, jcfg = dlrm.DLRMConfig(**DLRM_KW), jax_dlrm.DLRMConfig(**DLRM_KW)
    r = np.random.RandomState(0)
    b_ro, b_nro = 8, 32
    batches = [{
        "ro_dense": r.normal(size=(b_ro, 4)).astype(np.float32),
        "ro_ids": r.randint(0, 512, (b_ro, 2, 2)).astype(np.int32),
        "ro_len": np.full((b_ro, 2), 2, np.int32),
        "nro_ids": r.randint(0, 32, (b_nro, 2, 2)).astype(np.int32),
        "nro_len": np.full((b_nro, 2), 2, np.int32),
        "seg": np.repeat(np.arange(b_ro, dtype=np.int32), b_nro // b_ro),
        "y": (r.uniform(size=(b_nro,)) < 0.3).astype(np.float32)}
        for _ in range(3)]
    args = ("ro_dense", "ro_ids", "ro_len", "nro_ids", "nro_len", "seg")

    def jloss(p, b, r=None):
        logits = jax_dlrm.dlrm_forward_roo(p, jcfg, *(b[k] for k in args))
        y = b["y"]
        return jnp.mean(jnp.maximum(logits, 0) - logits * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))
    return dict(
        pb=[{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
        jb=[jax.tree.map(jnp.asarray, b) for b in batches],
        jp=jax_dlrm.dlrm_init(jax.random.PRNGKey(0), jcfg,
                              dtype=jnp.bfloat16),
        loss=lambda p, b, g: metrics.bce(dlrm.dlrm_forward_roo(
            p, cfg, *(b[k] for k in args)), b["y"]),
        jloss=jloss)


CASES = {"hstu-gr": gr_case, "dlrm": dlrm_case}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    c = CASES[request.param]()
    assert any(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(c["jp"]))
    c["np_params"] = jax.tree.map(np.asarray, c["jp"])
    return c


def cycling(batches):
    return lambda start: (batches[i % len(batches)]
                          for i in range(start, 10 ** 6))


def port_run(c, ckpt_dir=None, stop_after=None, ckpt_every=STEPS):
    trainer = loop.Trainer(
        c["loss"], optim.make_mixed(optim.adam(1e-3),
                                    optim.rowwise_adagrad(0.05),
                                    optim.default_is_embedding),
        loop.TrainLoopConfig(total_steps=STEPS, log_every=1,
                             ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
        lambda: params_from_numpy(c["np_params"], "cpu"), device="cpu")
    state = trainer.run(cycling(c["pb"]), 0, stop_after=stop_after)
    return trainer, state


def test_port_checkpoint_restores_in_reference(case, tmp_path, one_thread):
    _, state = port_run(case, ckpt_dir=str(tmp_path))
    for x in tree.leaves(state["params"]):
        assert x.dtype == BF16
    meta_entries = JaxCheckpointManager(str(tmp_path))._load_manifest(
        str(tmp_path / f"step_{STEPS:012d}"))
    assert {e["dtype"] for e in meta_entries.values()} == {"bfloat16"}
    got = JaxCheckpointManager(str(tmp_path)).restore(STEPS)
    assert_same_bits({k: state[k] for k in KEYS}, {k: got[k] for k in KEYS})
    # and in the port itself, dtypes intact
    back = CheckpointManager(str(tmp_path)).restore(STEPS)
    assert_same_bits({k: back[k] for k in KEYS}, {k: got[k] for k in KEYS})


def test_reference_checkpoint_restores_in_port(case, tmp_path):
    jt = jax_loop.Trainer(
        case["jloss"],
        jax_optim.make_mixed(jax_optim.adam(1e-3),
                             jax_optim.rowwise_adagrad(0.05),
                             jax_optim.default_is_embedding),
        jax_loop.TrainLoopConfig(total_steps=STEPS, log_every=1,
                                 ckpt_dir=str(tmp_path), ckpt_every=STEPS),
        lambda: case["jp"])
    jstate = jt.run(cycling(case["jb"]), jax.random.PRNGKey(0))
    got = CheckpointManager(str(tmp_path)).restore(STEPS)
    assert_same_bits({k: got[k] for k in KEYS}, {k: jstate[k] for k in KEYS})


def test_bf16_trainer_restart_is_bit_for_bit(case, tmp_path, one_thread):
    whole, full = port_run(case)
    port_run(case, ckpt_dir=str(tmp_path), stop_after=2, ckpt_every=2)
    resumed, state = port_run(case, ckpt_dir=str(tmp_path), ckpt_every=2)
    assert [r["step"] for r in resumed.history] == [3, 4]
    assert [r["loss"] for r in resumed.history] == \
        [r["loss"] for r in whole.history[2:]]
    for (path, a), b in zip(tree.flatten_with_path(
            {k: state[k] for k in KEYS}), tree.leaves(
            {k: full[k] for k in KEYS})):
        assert a.dtype == b.dtype and torch.equal(a, b), path


# ---------------------------------------------------------------------------
# the LM at param_dtype="bfloat16"
# ---------------------------------------------------------------------------

def test_lm_bf16_tree_round_trips(tmp_path):
    cfg = dataclasses.replace(qwen.smoke_config(), param_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_qwen.smoke_config(),
                               param_dtype="bfloat16")
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    # a 0-d bf16 leaf: two raw bytes in npz, as the reference keeps one
    scale = torch.tensor(1.5, dtype=BF16)
    CheckpointManager(str(tmp_path / "port")).save(
        1, {"params": params, "scale": scale})
    got = JaxCheckpointManager(str(tmp_path / "port")).restore(1)
    assert_same_bits(params, got["params"])
    assert got["scale"].dtype == jnp.bfloat16 and float(got["scale"]) == 1.5
    jparams = jax_lm.lm_init(jax.random.PRNGKey(0), jcfg)
    JaxCheckpointManager(str(tmp_path / "ref")).save(
        1, {"params": jparams, "scale": jnp.asarray(1.5, jnp.bfloat16)})
    back = CheckpointManager(str(tmp_path / "ref")).restore(1)
    assert_same_bits(back["params"], jparams)
    assert back["scale"].dtype == BF16 and back["scale"].shape == () \
        and float(back["scale"]) == 1.5
    assert_same_bits(params_from_numpy(params_to_numpy(params), "cpu"),
                     to_ref(params_to_numpy(params)))


# ---------------------------------------------------------------------------
# a sharded bf16 save under a 1 x 2 plan
# ---------------------------------------------------------------------------

def test_sharded_bf16_checkpoint_read_by_the_reference(tmp_path):
    spawn(R.bf16_ckpt_rank, 2, args=(str(tmp_path),), threads=1,
          timeout_s=600)
    saved = np.load(tmp_path / "bf16_ckpt.npz")
    mgr = JaxCheckpointManager(str(tmp_path / "ck"))
    step = mgr.all_steps()[-1]
    entries = mgr._load_manifest(str(tmp_path / "ck" / f"step_{step:012d}"))
    split = [e for e in entries.values() if e["dtype"] == "bfloat16"
             and len(e["shards"]) > 1]
    assert split, "no bf16 leaf was cut into blocks"
    restored = mgr.restore(step)
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                {k: restored[k] for k in KEYS})[0]}
    assert set(flat) == set(saved.files)
    n_bf16 = 0
    for k, want in saved.items():
        got = np.asarray(flat[k])
        n_bf16 += got.dtype == jnp.bfloat16
        np.testing.assert_array_equal(bits(got), want, err_msg=k)
    assert n_bf16 > 0
    for rank in range(2):
        same = np.load(tmp_path / f"bf16_restores_r{rank}.npz")["same"]
        assert same.tolist() == [True, True], rank
