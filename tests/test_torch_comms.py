"""The port's compressed exchange (``distributed/comms.py``) and gradient
compression (``train/compression.py``) against the reference's, on the
same numpy inputs.

Quantization is elementwise fp32 arithmetic in the same order in both
packages (max-abs scale, divide, round half to even, clip, multiply), so
every comparison here is bit for bit: per-block int8 ``(q, scale)``,
``fake_quant`` in all three modes, ``wire_bytes``, ``CommsStats``
snapshots after the same records, one error-feedback step on dense and on
``SparseRows`` gradients, ``ef_paths`` / ``ef_init``, and
``ef_compress_grads`` / ``compressed_bytes``. ``wire_transform`` is the
quantized value forward and the identity backward (a straight-through
``autograd.Function``); the spec's ``comms_*`` knobs land on the port's
ladder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import comms as jax_comms
from repro.distributed.sharding import ShardingPlan as JaxPlan
from repro.embeddings import sparse as jax_sparse
from repro.models import lsr as jax_lsr
from repro.train import compression as jax_compression
from repro_torch.configs.registry import scenario
from repro_torch.distributed import comms
from repro_torch.distributed.sharding import ShardingPlan, abstract_mesh
from repro_torch.embeddings.sparse import SparseRows
from repro_torch.interop import params_from_numpy
from repro_torch.train import compression
from repro_torch.tree import flatten_with_path

from torch_port_state import port_state  # noqa: F401

SHAPES = [(4, 256), (3, 5, 64), (7, 30), (2, 128)]
BLOCKS = [128, 32, 0]


def inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    x = (r.normal(size=shape) * r.uniform(0.01, 10.0)).astype(np.float32)
    x.reshape(-1)[:3] = [0.0, -0.0, 1e-30]       # zeros and a tiny value
    return x


def same(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert port.numpy().dtype == ref.dtype, (port.dtype, ref.dtype)
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", BLOCKS)
def test_int8_blocks_bit_for_bit(shape, block):
    x = inputs(shape)
    q, s = comms.quantize_int8(torch.from_numpy(x), block)
    jq, js = jax_comms.quantize_int8(jnp.asarray(x), block)
    same(q, jq)
    same(s, js)
    same(comms.dequantize_int8(q, s, shape),
         jax_comms.dequantize_int8(jq, js, shape))


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fake_quant_bit_for_bit(mode, shape):
    x = inputs(shape, seed=1)
    same(comms.fake_quant(torch.from_numpy(x), mode, 32),
         jax_comms.fake_quant(jnp.asarray(x), mode, 32))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_wire_transform_is_straight_through(mode):
    x = torch.from_numpy(inputs((6, 64), seed=2)).requires_grad_(True)
    cot = torch.from_numpy(inputs((6, 64), seed=3))
    y = comms.wire_transform(x, mode, 32)
    torch.testing.assert_close(y.detach(), comms.fake_quant(x.detach(),
                                                            mode, 32),
                               rtol=0, atol=0)
    torch.sum(y * cot).backward()
    torch.testing.assert_close(x.grad, cot, rtol=0, atol=0)
    assert comms.wire_transform(x, "none", 32) is x


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("block", BLOCKS)
def test_wire_bytes(mode, block):
    for shape in SHAPES + [(0, 8), (16,)]:
        assert comms.wire_bytes(shape, mode, block) == \
            jax_comms.wire_bytes(shape, mode, block)


def _record(stats):
    stats.record_exchange("lookup:seq:V512xB8xL16xD32", (8, 16, 32),
                          mode="int8", block=32, dedup=True)
    stats.record_exchange("lookup:bag_rs:V512xB8xD32", (8, 32), mode="bf16",
                          collective="psum_scatter")
    stats.record_exchange("grad:item_emb", (40, 32), mode="int8", block=128,
                          kind="grad", collective="coo", dedup=True)
    stats.record_exchange("lookup:bag:V512xB8xD32", (8, 32), mode="none")
    stats.record_overlap(2, True)


def test_comms_stats_snapshot_equals_the_reference():
    ours, theirs = comms.CommsStats(), jax_comms.CommsStats()
    _record(ours)
    _record(theirs)
    assert ours.snapshot() == theirs.snapshot()
    ours.reset()
    theirs.reset()
    assert ours.snapshot() == theirs.snapshot()


def test_comms_stats_mirror_into_obs():
    from repro_torch.obs import metrics as obs_metrics
    comms.STATS.reset()
    _record(comms.STATS)
    snap = obs_metrics.snapshot()["components"]["distributed.comms"]
    assert snap["exchanges"] == 4 and snap["dedup_exchanges"] == 2
    assert snap["compression_ratio"] == comms.STATS.snapshot()[
        "compression_ratio"]


def _lsr_params():
    cfg = jax_lsr.LSRConfig(n_items=512, n_user_cats=64, n_item_cats=60,
                            embed_dim=32, hist_len=16, mode="userarch",
                            top_mlp=(64,))
    return jax.tree.map(np.asarray, jax_lsr.lsr_init(jax.random.PRNGKey(0),
                                                     cfg))


@pytest.mark.parametrize("dims", [None, (2, 2), (1, 4), (2, 1, 2)])
def test_ef_paths_and_init_equal_the_reference(dims):
    params = _lsr_params()
    plan = jplan = None
    if dims is not None:
        mesh = abstract_mesh(dims)
        plan = ShardingPlan(mesh=mesh, batch_axes=mesh.axis_names[:-1])
        jplan = JaxPlan(mesh=mesh, batch_axes=mesh.axis_names[:-1])
    ours = comms.ef_paths(params_from_numpy(params, "cpu"), plan)
    assert ours == jax_comms.ef_paths(params, jplan)
    assert ours            # item_emb and user_cat_emb compress
    ef = comms.ef_init(params_from_numpy(params, "cpu"), plan)
    jef = jax_comms.ef_init(params, jplan)
    assert [(p, tuple(v.shape)) for p, v in flatten_with_path(ef)] == \
        [(p, tuple(v.shape)) for p, v in flatten_with_path(
            jax.tree.map(np.asarray, jef))]


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_ef_compress_step_dense_and_sparse(mode):
    r = np.random.RandomState(4)
    vocab, d = 96, 32
    g_dense = r.normal(size=(vocab, d)).astype(np.float32)
    e_dense = (r.normal(size=(vocab, d)) * 1e-3).astype(np.float32)
    ids = r.randint(0, vocab + 1, (40,)).astype(np.int32)   # vocab: padding
    rows = r.normal(size=(40, d)).astype(np.float32)
    e_sparse = (r.normal(size=(vocab, d)) * 1e-3).astype(np.float32)
    grads = {"emb": {"a": torch.from_numpy(g_dense),
                     "b": SparseRows(torch.from_numpy(ids),
                                     torch.from_numpy(rows), vocab)},
             "w": torch.ones(3)}
    res = {"emb": {"a": torch.from_numpy(e_dense),
                   "b": torch.from_numpy(e_sparse)}}
    jgrads = {"emb": {"a": jnp.asarray(g_dense),
                      "b": jax_sparse.SparseRows(jnp.asarray(ids),
                                                 jnp.asarray(rows), vocab)},
              "w": jnp.ones(3)}
    jres = jax.tree.map(jnp.asarray, {"emb": {"a": e_dense, "b": e_sparse}})
    sent, new_res = comms.ef_compress_step(grads, res, mode, 32)
    jsent, jnew = jax_comms.ef_compress_step(jgrads, jres, mode, 32)
    same(sent["emb"]["a"], jsent["emb"]["a"])
    same(sent["emb"]["b"].ids, jsent["emb"]["b"].ids)
    same(sent["emb"]["b"].rows, jsent["emb"]["b"].rows)
    assert sent["emb"]["b"].unique and jsent["emb"]["b"].unique
    same(new_res["emb"]["a"], jnew["emb"]["a"])
    same(new_res["emb"]["b"], jnew["emb"]["b"])
    assert sent["w"] is grads["w"]
    assert comms.ef_compress_step(grads, res, "none", 32) == (grads, res)


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_gradient_compression_equals_the_reference(mode):
    r = np.random.RandomState(5)
    grads = {"a": r.normal(size=(8, 16)).astype(np.float32),
             "b": [r.normal(size=(5,)).astype(np.float32)]}
    err = {"a": (r.normal(size=(8, 16)) * 1e-2).astype(np.float32),
           "b": [(r.normal(size=(5,)) * 1e-2).astype(np.float32)]}
    sent, new_err = compression.ef_compress_grads(
        params_from_numpy(grads, "cpu"), params_from_numpy(err, "cpu"), mode)
    jsent, jerr = jax_compression.ef_compress_grads(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, err),
        mode)
    same(sent["a"], jsent["a"])
    same(sent["b"][0], jsent["b"][0])
    same(new_err["a"], jerr["a"])
    same(new_err["b"][0], jerr["b"][0])
    assert compression.compressed_bytes(params_from_numpy(grads, "cpu"),
                                        mode) == \
        jax_compression.compressed_bytes(jax.tree.map(jnp.asarray, grads),
                                         mode)
    zeros = compression.ef_init(params_from_numpy(grads, "cpu"))
    assert float(zeros["a"].abs().sum()) == 0.0 and zeros["a"].dtype == \
        torch.float32


def test_spec_installs_the_comms_knobs():
    assert comms.compress_mode() == "none" and not comms.overlap_enabled()
    scenario("hstu-gr", {"knobs.comms_compress": "int8",
                         "knobs.comms_overlap": "on",
                         "knobs.comms_block": 64}).apply()
    assert comms.compress_mode() == "int8" and comms.overlap_enabled()
    assert comms.block_size() == 64
    assert comms.COMPRESS_KNOB.env_var == "REPRO_TORCH_COMMS_COMPRESS"
