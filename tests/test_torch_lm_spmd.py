"""The LM under a 2 x 2 SPMD plan (FSDP over ``data``, Megatron TP and
sequence parallelism over ``model``) held against the reference's own
sharded run.

The reference runs in a subprocess on 4 forced host devices over a mesh of
Auto axes (``torch_ref_spmd.py``, job ``lm``); the port in a spawned
2 x 2 gloo world (``torch_spmd_ranks.lm_rank``) on the reference's init
params, carried across and cut to each rank's blocks by
``lm_param_specs``. The phi3 (dense, 10 heads over 2) and granite (MoE at
``capacity_factor`` 0.5, so tokens drop; the capacity is per rank, as the
reference's) smoke configs at f32 compute, 4 x 16 tokens:

  * each rank holds only its block of every leaf the mesh divides;
  * the hidden state and the loss within 1e-5 and every gradient leaf
    within 1e-4 (atol = rtol) on both ``use_spmd_layer`` routes (the
    reference's ``_layer_spmd`` has no MoE branch: granite's explicit
    route is held against its GSPMD route);
  * ``prefill`` of 8 tokens into ``s_max`` 16 and 4 ``serve_step``s with
    ``CacheSpec(("data",), "model")`` and ``CacheSpec(None, ("data",
    "model"))``: the prefill's logits within 1e-5 of the reference's and
    each step's within 3e-5 (the cache is bf16 in both packages: a K or V
    entry that the two runs round to neighbouring bf16 values, from f32
    inputs 1e-7 apart, moves a logit by ~1e-5), each rank's cache its
    (batch, sequence) block;
  * a head count the model axis does not divide (5 heads over 2): every
    head on every model rank (``wq`` / ``wo`` gathered over ``model``, the
    block output cut back to the rank's sequence chunk), the loss within
    1e-5 and the gradients within 1e-4 of the port's one-process run.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models.lm.transformer import lm_init
from repro_torch.interop import params_to_numpy
from repro_torch.launch.hostdevices import spawn
from repro_torch.models.lm import transformer as port_lm
from repro_torch.train.loop import value_and_grad

sys.path.insert(0, os.path.dirname(__file__))
import torch_ref_spmd as REF  # noqa: E402
import torch_spmd_ranks as R  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 3e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_spmd")
    # the reference's init, one device: the sharded subprocess draws the
    # same values
    params = {}
    for arch in R.LM_ARCHS:
        p = lm_init(jax.random.PRNGKey(0), REF.lm_config(arch))
        params.update({f"{arch}/p/{k}": v for k, v in REF.keyed(p).items()})
    np.savez(out / "params.npz", **params)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_ref_spmd.py"),
         "lm", str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        spawn(R.lm_rank, 4, args=(str(out), str(out / "params.npz")),
              threads=1, timeout_s=600)
    finally:
        stdout, stderr = ref.communicate(timeout=600)
    assert "REF_LM_DONE" in stdout, stderr[-3000:]
    return out


def close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("arch", R.LM_ARCHS)
def test_ranks_hold_their_blocks(runs, arch):
    cfg = R.lm_config(arch)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    for rank in range(4):
        blocks = json.loads((runs / f"lm_blocks_r{rank}.json").read_text())
        got = blocks[arch]
        assert got["embed"] == [cfg.vocab // 2, d // 2]
        assert got["layers/wq"] == [cfg.n_layers, d // 2, h * dh // 2]
        assert got["layers/wkv"] == [cfg.n_layers, d // 2,
                                     2 * cfg.n_kv_heads * dh]
        assert got["layers/wo"] == [cfg.n_layers, h * dh // 2, d // 2]
        assert got["layers/attn_norm"] == [cfg.n_layers, d]
        if cfg.moe is not None:
            e, fe = cfg.moe.n_experts_padded, cfg.moe.d_ff_expert
            assert got["layers/w1e"] == [cfg.n_layers, e // 2, d // 2, fe]
            assert got["layers/w2e"] == [cfg.n_layers, e // 2, fe, d // 2]
            assert got["layers/router"] == [cfg.n_layers, d, e]
        else:
            assert got["layers/w1"] == [cfg.n_layers, d // 2, cfg.d_ff // 2]
            assert got["layers/w2"] == [cfg.n_layers, cfg.d_ff // 2, d // 2]
        # the cache: batch over data (or whole) and the sequence over
        # model (or over data x model)
        kv = [cfg.n_kv_heads, dh]
        assert blocks[f"{arch}/seq/cache"] == [
            cfg.n_layers, R.LM_BATCH // 2, R.S_MAX // 2] + kv
        assert blocks[f"{arch}/long/cache"] == [
            cfg.n_layers, R.LM_BATCH, R.S_MAX // 4] + kv


@pytest.mark.parametrize("arch,spmd_layer", [
    ("phi3-medium-14b", 0), ("phi3-medium-14b", 1),
    ("granite-moe-3b-a800m", 0), ("granite-moe-3b-a800m", 1)])
def test_forward_loss_and_grads_match_the_sharded_reference(
        runs, arch, spmd_layer):
    got = np.load(runs / "lm.npz")
    want = np.load(runs / "ref_lm.npz")
    ref_tag = f"{arch}/{spmd_layer if f'{arch}/1/loss' in want else 0}"
    tag = f"{arch}/{spmd_layer}"
    close(got[f"{tag}/hidden"], want[f"{ref_tag}/hidden"], F32_TOL, "hidden")
    close(got[f"{tag}/loss"], want[f"{ref_tag}/loss"], F32_TOL, "loss")
    names = [k[len(ref_tag) + 3:] for k in want.files
             if k.startswith(f"{ref_tag}/g/")]
    assert names and sorted(names) == sorted(
        k[len(tag) + 3:] for k in got.files if k.startswith(f"{tag}/g/"))
    for k in names:
        close(got[f"{tag}/g/{k}"], want[f"{ref_tag}/g/{k}"], GRAD_TOL, k)


@pytest.mark.parametrize("arch", R.LM_ARCHS)
@pytest.mark.parametrize("layout", ["seq", "long"])
def test_decode_matches_the_sharded_reference(runs, arch, layout):
    got = np.load(runs / "lm.npz")
    want = np.load(runs / "ref_lm.npz")
    for i in range(R.STEPS + 1):
        key = f"{arch}/{layout}/{i}"
        close(got[key], want[key], STEP_TOL if i else F32_TOL, key)


def test_heads_the_model_axis_does_not_divide(runs):
    got = np.load(runs / "lm.npz")
    blocks = json.loads((runs / "lm_blocks_r0.json").read_text())
    cfg = R.odd_heads_config()
    # wq's 40 columns split over model, its 5 heads do not
    assert blocks["odd_heads/wq"] == [cfg.n_layers, cfg.d_model // 2,
                                      cfg.n_heads * cfg.d_head // 2]
    params = port_lm.lm_init(torch.Generator().manual_seed(3), cfg,
                             device="cpu")
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab, (R.LM_BATCH, R.LM_SEQ)).astype(np.int64))
    loss, grads = value_and_grad(
        lambda p, b, g: port_lm.lm_loss(p, cfg, toks, toks))(params, None,
                                                            None)
    close(got["odd_heads/loss"], loss.numpy(), F32_TOL, "loss")
    want = R._np_tree(params_to_numpy(grads))
    assert sorted(want) == sorted(k[len("odd_heads/g/"):] for k in got.files
                                  if k.startswith("odd_heads/g/"))
    for k, v in want.items():
        close(got[f"odd_heads/g/{k}"], v, GRAD_TOL, k)
