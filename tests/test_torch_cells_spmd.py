"""The dry-run cells' plan routes, run for real on a spawned 2 x 2 gloo
world (``torch_spmd_ranks.cells_rank``) at small configs (the production
widths with a 4,096-row catalog and batches of 8 requests / 32
impressions):

  * the MIND, BERT4Rec and DIEN cell losses and gradients (train) and
    outputs (serve, retrieval) under the plan equal the one-process run
    and the reference's own sharded run (``torch_ref_cells.py spmd`` on a
    2 x 2 mesh of Auto axes, the same params and inputs) within 1e-5;
  * MACE under the plan (node and edge arrays split over every axis)
    equals the one-process run within 1e-5 on both gather routes, for the
    energy and the node task;
  * dlrm ``opt2``'s (id, grad) all-gather and ``opt``'s table-sized deltas
    equal the one-process sparse row update;
  * C5: an ``adam(grad_clip=...)`` step that binds under a 1 x 2 plan
    equals the one-process step within 1e-6 (the clip norm is the whole
    gradient's).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch.hostdevices import spawn

sys.path.insert(0, os.path.dirname(__file__))
import torch_spmd_ranks as R  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=0)


def _inputs_npz(out):
    arrays = {}
    for arch, shape in R.REF_CELLS:
        pre = f"{arch}/{shape}/"
        arrays.update({pre + "p/" + k: v for k, v in
                       R._np_tree(R.cell_params(arch)).items()})
        arrays.update({pre + "i/" + k: v for k, v in
                       R.cell_inputs(arch, shape).items()})
    np.savez(out / "inputs.npz", **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells_spmd")
    _inputs_npz(out)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_ref_cells.py"),
         "spmd", str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        spawn(R.cells_rank, 4, args=(str(out),), threads=1, timeout_s=600)
    finally:
        stdout, stderr = ref.communicate(timeout=600)
    assert "REF_SPMD_DONE" in stdout, stderr[-3000:]
    return {"port": dict(np.load(out / "cells_2x2.npz")),
            "ref": dict(np.load(out / "ref_spmd.npz"))}


def _compare(got: dict, want: dict, pre: str):
    keys = sorted(k for k in want if k.startswith(pre))
    assert keys and keys == sorted(k for k in got if k.startswith(pre))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


@pytest.mark.parametrize("arch,shape", R.REF_CELLS)
def test_plan_equals_one_process(runs, arch, shape):
    one = R.port_cell_run(arch, shape, None)
    _compare(runs["port"], one, f"{arch}/{shape}/")


@pytest.mark.parametrize("arch,shape", R.REF_CELLS)
def test_plan_equals_the_sharded_reference(runs, arch, shape):
    _compare(runs["port"], runs["ref"], f"{arch}/{shape}/")


@pytest.mark.parametrize("task", ["energy", "node"])
@pytest.mark.parametrize("level", ["baseline", "hoist"])
def test_mace_plan_equals_one_process(runs, task, level):
    one = R.mace_run(None)
    _compare(runs["port"], one, f"mace/{task}/{level}/")


@pytest.mark.parametrize("table", ["big", "tiny"])
@pytest.mark.parametrize("level", ["opt", "opt2"])
def test_dlrm_exchange_equals_local_update(runs, table, level):
    want = R.exchange_run(None)[f"x/{table}/local"]
    np.testing.assert_allclose(runs["port"][f"x/{table}/{level}"], want,
                               atol=1e-6, rtol=0)


def test_clip_norm_is_the_whole_gradients(runs):
    losses, params = R.clip_run(None)
    np.testing.assert_allclose(runs["port"]["clip/losses"], losses,
                               atol=1e-6, rtol=0)
    got = {k[len("clip/p/"):]: v for k, v in runs["port"].items()
           if k.startswith("clip/p/")}
    assert set(got) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0, err_msg=k)
