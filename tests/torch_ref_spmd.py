"""The reference's own sharded runs, the oracle of the port's FSDP / TP
tests (``test_torch_fsdp.py``, ``test_torch_lm_spmd.py``).

Run as a subprocess: ``python tests/torch_ref_spmd.py JOB OUT_DIR``. It
forces 4 host devices before JAX starts and builds the 2 x 2 mesh with
**Auto** axes (``jax.make_mesh(..., axis_types=(AxisType.Auto,) * 2)``):
the reference's ``launch/mesh.py`` calls ``jax.make_mesh`` without axis
types, which on this JAX gives Explicit axes, where
``with_sharding_constraint`` refuses to run. On Auto axes the reference's
SPMD path runs as written. Nothing of ``src/repro`` is changed.

Jobs:
  * ``recsys``: lsr ``userarch_hstu`` and gr (the shapes of
    ``torch_spmd_ranks``) with the port's init params carried across:
    each dense leaf's shard index at every mesh coordinate of the
    reference's ``place_state``, and step 0's loss and gradients of its
    sharded ``jax.value_and_grad``;
  * ``lm``: the phi3 and granite smoke configs at f32 compute (granite at
    ``capacity_factor`` 0.5, so tokens drop) with the reference's init:
    ``lm_forward`` and ``jax.grad(lm_loss)`` under the plan (phi3 on both
    layer routes; the reference's ``_layer_spmd`` has no MoE branch), and
    ``prefill`` + 4 ``serve_step``s under both ``lm_cells`` cache layouts.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

LM_ARCHS = ("phi3-medium-14b", "granite-moe-3b-a800m")
LM_BATCH, LM_SEQ, PROMPT, S_MAX, STEPS = 4, 16, 8, 16, 4


def auto_mesh():
    return jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def keyed(tree) -> dict:
    """"a/b"-keyed numpy leaves (the tests' ``flat`` keys)."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def coords(mesh, sharding, shape) -> dict:
    """mesh coordinate "d,m" -> [[start, stop], ...] of its shard."""
    out = {}
    for dev, idx in sharding.devices_indices_map(shape).items():
        d, m = (int(i) for i in np.argwhere(mesh.devices == dev)[0])
        out[f"{d},{m}"] = [[s.start or 0, n if s.stop is None else s.stop]
                           for s, n in zip(idx, shape)]
    return out


def lm_config(arch):
    from repro.configs.registry import get_arch
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    return cfg


def lm_tokens(vocab):
    return np.random.RandomState(7).randint(
        0, vocab, (LM_BATCH, LM_SEQ)).astype(np.int32)


def run_lm(out):
    from repro.distributed.sharding import plan_for_mesh
    from repro.models.lm import decode
    from repro.models.lm.transformer import (lm_forward, lm_init, lm_loss,
                                             lm_param_specs)
    mesh = auto_mesh()
    plan = plan_for_mesh(mesh)
    res = {}
    for arch in LM_ARCHS:
        cfg = lm_config(arch)
        params = lm_init(jax.random.PRNGKey(0), cfg)
        res.update({f"{arch}/p/{k}": v for k, v in keyed(params).items()})
        toks = lm_tokens(cfg.vocab)
        with mesh:
            placed = jax.device_put(params, jax.tree.map(
                lambda s: NamedSharding(mesh, s), lm_param_specs(cfg, plan)))
            t = jax.device_put(jnp.asarray(toks),
                               NamedSharding(mesh, P("data", None)))
            routes = (False, True) if cfg.moe is None else (False,)
            for spmd_layer in routes:
                c = dataclasses.replace(cfg, use_spmd_layer=spmd_layer)
                tag = f"{arch}/{int(spmd_layer)}"
                res[f"{tag}/hidden"] = np.asarray(jax.jit(
                    lambda p, tt: lm_forward(p, c, tt, plan))(placed, t))
                loss, grads = jax.jit(jax.value_and_grad(
                    lambda p, tt: lm_loss(p, c, tt, tt, plan)))(placed, t)
                res[f"{tag}/loss"] = np.asarray(loss)
                res.update({f"{tag}/g/{k}": v
                            for k, v in keyed(grads).items()})
            for name, cs in (
                    ("seq", decode.CacheSpec(("data",), "model")),
                    ("long", decode.CacheSpec(None, ("data", "model")))):
                logits, cache = jax.jit(lambda p, tt: decode.prefill(
                    p, cfg, tt, plan, s_max=S_MAX, cs=cs))(
                        placed, jnp.asarray(toks[:, :PROMPT]))
                res[f"{arch}/{name}/0"] = np.asarray(logits)
                step = jax.jit(lambda p, ch, tt: decode.serve_step(
                    p, cfg, ch, tt, plan, cs=cs))
                for i in range(STEPS):
                    logits, cache = step(placed, cache, jnp.asarray(
                        toks[:, PROMPT + i:PROMPT + i + 1]))
                    res[f"{arch}/{name}/{i + 1}"] = np.asarray(logits)
    np.savez(os.path.join(out, "ref_lm.npz"), **res)


def jax_cfg_and_loss(arch):
    """The reference's config and loss of ``torch_spmd_ranks.model(arch)``
    (``test_torch_distributed_train._jax_cfg``)."""
    from repro.core.hstu import HSTUConfig
    from repro.models import gr, lsr
    hstu = dict(d_model=32, n_heads=2, d_qk=16, d_v=16, n_layers=1,
                attn_backend="jnp-dense")
    if arch == "lsr":
        return lsr.LSRConfig(
            n_items=512, n_user_cats=64, n_item_cats=64, embed_dim=32,
            n_ro_dense=16, n_item_dense=8, hist_len=16,
            mode="userarch_hstu", lce_n_out=4, lce_d_out=32,
            n_cross_layers=2, top_mlp=(64,),
            hstu=HSTUConfig(max_rel_pos=16, **hstu)), lsr.lsr_loss
    return gr.GRConfig(n_items=512, hist_len=16, m_targets=8,
                       hstu=HSTUConfig(max_rel_pos=24, **hstu)), \
        gr.gr_ranking_loss


def jax_batch0():
    """``torch_spmd_ranks.batches()[0]`` from the reference's batcher."""
    from repro.core import joiner
    from repro.data import batcher, events
    stream = events.EventStreamConfig(n_requests=60, n_items=512,
                                      hist_init_max=12, seed=0)
    samples = joiner.RequestLevelJoiner().join(
        list(events.EventSimulator(stream).stream()))
    cfg = batcher.BatcherConfig(b_ro=8, b_nro=32, hist_len=16, n_shards=2,
                                ro_idlist_capacity=256,
                                item_idlist_capacity=512)
    return next(iter(batcher.ROOBatcher(cfg).batches(samples)))


def run_recsys(out):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_spmd_ranks as R
    from repro.distributed import spmd as jspmd
    from repro.distributed.sharding import plan_for_mesh
    from repro_torch.interop import params_to_numpy
    mesh = auto_mesh()
    plan = plan_for_mesh(mesh)
    res, blocks = {}, {}
    for arch in ("lsr", "gr"):
        params, _ = R.model(arch)
        jparams = jax.tree.map(jnp.asarray, params_to_numpy(params))
        cfg, loss = jax_cfg_and_loss(arch)
        batch = jax_batch0()
        with mesh:
            placed = jspmd.place_state(jparams, plan)
            shard = jspmd.state_shardings(jparams, plan)
            blocks[arch] = {
                k: coords(mesh, s, v.shape)
                for (k, v), s in zip(keyed(jparams).items(),
                                     jax.tree.leaves(shard))
                if v.ndim >= 2}
            b = jspmd.place_batch(batch, plan)
            value, grads = jax.jit(jax.value_and_grad(
                lambda p, bb: loss(p, cfg, bb, plan=plan)))(placed, b)
        res[f"{arch}/loss"] = np.asarray(value)
        res.update({f"{arch}/g/{k}": v for k, v in keyed(grads).items()})
    np.savez(os.path.join(out, "ref_recsys.npz"), **res)
    with open(os.path.join(out, "ref_blocks.json"), "w") as f:
        json.dump(blocks, f)


if __name__ == "__main__":
    job, out = sys.argv[1], sys.argv[2]
    {"lm": run_lm, "recsys": run_recsys}[job](out)
    print(f"REF_{job.upper()}_DONE")
