"""The port's row-sharded lookups (``embeddings/sharded.py`` through the
collection's ``plan=`` routes) on a spawned 2 x 2 gloo world on the CPU.

One world of four ranks runs ``torch_spmd_ranks.lookups_rank`` once for the
module; rank 0 writes each route's whole-batch output (gathered over the
data ranks, an RS output's chunks over the model ranks too) and its whole
table gradient (summed over the data ranks, gathered over the model
ranks) for a fixed cotangent. The test process holds them against:

  * the port's unsharded lookups (seq, row, padded sum / mean bags, the
    reduce-scatter bag, jagged sum / mean bags), forward and table
    gradient by autograd, to 1e-6; forced dedup composes with the sum
    (bit for bit the direct gather);
  * under ``comms_compress`` bf16 / int8, the sum over the two row blocks
    of the reference's ``fake_quant(_local_partial_bag(block k, ...))``,
    computed on one device, to 1e-6;
  * the reference's replicated ``dlrm_forward_roo`` at its
    ``TestDLRMShardedLookups`` config (tables of 256 / 128 / 64 rows
    row-sharded and taking the reduce-scatter, the 8-row table replicated
    and sliced, B7's plain version on D slices of 16), rtol 2e-5 / atol
    1e-5;
  * the lsr loss with dedup forced, through the sums, against the
    unsharded loss with dedup off (rtol 2e-5);
  * the exchange sites ``comms.STATS`` records, named by the global batch.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import comms as jax_comms
from repro.embeddings import sharded as jax_sharded
from repro.models import dlrm as jax_dlrm
from repro_torch.data.jagged import JaggedTensor
from repro_torch.embeddings import collection as ec
from repro_torch.interop import params_to_numpy
from repro_torch.launch.hostdevices import spawn
from repro_torch.models.dlrm import dlrm_forward_impression, dlrm_init

sys.path.insert(0, os.path.dirname(__file__))
import torch_spmd_ranks as R  # noqa: E402
from torch_port_state import port_state  # noqa: E402,F401

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    out = tmp_path_factory.mktemp("spmd_lookups")
    spawn(R.lookups_rank, 4, args=(str(out),), threads=1, timeout_s=300)
    return dict(np.load(out / "lookups.npz")), json.loads(
        (out / "sites.json").read_text())


def _unsharded(name, x):
    """The port's one-device lookup and its table gradient."""
    table = x["table"].clone().requires_grad_(True)
    jag = JaggedTensor(x["jag_values"], x["jag_lens"])
    fns = {
        "seq": lambda: ec.seq_lookup(table, x["ids"], vocab=R.VOCAB),
        "seq_dedup": lambda: ec.seq_lookup(table, x["dup_ids"],
                                           vocab=R.VOCAB, dedup=False),
        "row": lambda: ec.row_lookup(table, x["ids"][:, 0], vocab=R.VOCAB),
        "bag_sum": lambda: ec.bag_lookup_dense(table, x["ids"], x["lengths"],
                                               "sum", vocab=R.VOCAB),
        "bag_mean": lambda: ec.bag_lookup_dense(table, x["ids"],
                                                x["lengths"], "mean",
                                                vocab=R.VOCAB),
        "bag_rs": lambda: ec.bag_lookup_dense(table, x["ids"], x["lengths"],
                                              "sum", vocab=R.VOCAB),
        "jagged_sum": lambda: ec.bag_lookup(table, jag, "sum"),
        "jagged_mean": lambda: ec.bag_lookup(table, jag, "mean"),
    }
    y = fns[name]()
    cot = (x["cot_seq"] if name.startswith("seq") else
           x["cot_seq"][:, 0] if name == "row" else x["cot_bag"])
    torch.sum(y * cot).backward()
    return y.detach().numpy(), table.grad.numpy()


@pytest.mark.parametrize("name", ["seq", "seq_dedup", "row", "bag_sum",
                                  "bag_mean", "bag_rs", "jagged_sum",
                                  "jagged_mean"])
def test_sharded_route_equals_the_unsharded_lookup(got, name):
    res, _ = got
    x = {k: torch.from_numpy(v) for k, v in R.lookup_inputs().items()}
    out, grad = _unsharded(name, x)
    if name.startswith("seq"):
        # one block holds each row, the other adds zeros: bit for bit
        np.testing.assert_array_equal(res[f"{name}/out"], out)
    np.testing.assert_allclose(res[f"{name}/out"], out, **TOL)
    np.testing.assert_allclose(res[f"{name}/grad"], grad, **TOL)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_compressed_bag_is_the_sum_of_quantized_partials(got, mode, pooling):
    res, _ = got
    x = R.lookup_inputs()
    ids = jnp.clip(jnp.asarray(x["ids"], jnp.int32), 0, R.VOCAB - 1)
    rows = R.VOCAB // 2
    want = sum(jax_comms.fake_quant(jax_sharded._local_partial_bag(
        jnp.asarray(x["table"][k * rows:(k + 1) * rows]), ids,
        jnp.asarray(x["lengths"]), R.VOCAB, 2, jnp.int32(k), pooling),
        mode, 128) for k in range(2))
    np.testing.assert_allclose(res[f"{mode}_{pooling}/out"], np.asarray(want),
                               **TOL)


def test_dlrm_forward_under_the_plan_matches_the_reference(got):
    res, _ = got
    cfg, args = R.dlrm_inputs()
    params = params_to_numpy(dlrm_init(torch.Generator().manual_seed(0), cfg,
                                       device="cpu"))
    jcfg = jax_dlrm.DLRMConfig(n_dense=4, embed_dim=32, bot_mlp=(4, 32, 32),
                               top_mlp=(64, 32, 1), vocabs=(256, 128, 64, 8),
                               n_ro_fields=2, multi_hot=2)
    want = jax_dlrm.dlrm_forward_roo(jax.tree.map(jnp.asarray, params), jcfg,
                                     *map(jnp.asarray, args))
    np.testing.assert_allclose(res["dlrm/out"], np.asarray(want), rtol=2e-5,
                               atol=1e-5)


def test_dlrm_impression_forward_under_the_plan(got):
    """``dlrm_forward_impression(plan=...)`` on the 2 x 2 world (its bags
    through the sharded lookups, B7 on the D slice) against the unsharded
    forward on the same params, and against the reference's."""
    res, _ = got
    cfg, _ = R.dlrm_inputs()
    params = dlrm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    args = R.dlrm_impression_inputs()
    with torch.no_grad():
        want = dlrm_forward_impression(params, cfg,
                                       *map(torch.from_numpy, args))
    np.testing.assert_allclose(res["dlrm_impression/out"], want.numpy(),
                               atol=1e-4, rtol=0)
    jcfg = jax_dlrm.DLRMConfig(n_dense=4, embed_dim=32, bot_mlp=(4, 32, 32),
                               top_mlp=(64, 32, 1), vocabs=(256, 128, 64, 8),
                               n_ro_fields=2, multi_hot=2)
    ref = jax_dlrm.dlrm_forward_impression(
        jax.tree.map(jnp.asarray, params_to_numpy(params)), jcfg,
        *map(jnp.asarray, args))
    np.testing.assert_allclose(res["dlrm_impression/out"], np.asarray(ref),
                               atol=1e-4, rtol=0)


def test_lsr_loss_with_dedup_forced_composes_with_the_sums(got):
    res, _ = got
    params, loss = R.model("lsr")
    ec.set_dedup_policy("never")
    try:
        with torch.no_grad():
            want = float(loss(params, R.batches()[0], None))
    finally:
        ec.set_dedup_policy(None)
    np.testing.assert_allclose(float(res["lsr_dedup/loss"]), want, rtol=2e-5)


def test_exchange_sites_name_the_global_batch(got):
    _, sites = got
    assert sites == ["lookup:bag:V512xB8xD32", "lookup:bag_rs:V512xB8xD32",
                     "lookup:jagged:V512xB8xD32",
                     "lookup:seq:V512xB8xL16xD32",
                     "lookup:seq:V512xB8xL1xD32"]
