"""FSDP / TP storage of the recsys archs' dense leaves in the port, on a
spawned 2 x 2 gloo world, held against the reference's own sharded run.

The reference runs in a subprocess on 4 forced host devices over a mesh of
Auto axes (``torch_ref_spmd.py``, job ``recsys``) on the port's init
params; the port in ``torch_spmd_ranks.fsdp_rank``. lsr
``userarch_hstu`` and gr at the sizes of ``test_torch_distributed_train``:

  * each rank's block of every leaf of >= 2 dims equals the reference's
    shard at the same mesh coordinate (``devices_indices_map``, by the
    device's place in the mesh, not by its id);
  * step 0's loss and every gradient leaf (the dense ones reduce-scattered
    by their gather's backward, then gathered) against the reference's
    sharded ``jax.value_and_grad``, to 1e-5;
  * 20 Trainer steps against the port's one-process run, at
    ``test_torch_distributed_train``'s tolerances (losses rtol 2e-4 / atol
    1e-6, final params rtol 5e-3 / atol 2e-4);
  * a checkpoint of 2-D (data x model) blocks read by the reference's
    ``CheckpointManager.restore()`` bit for bit, and resumed on 1 x 2.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.interop import params_to_numpy
from repro_torch.launch.hostdevices import spawn

sys.path.insert(0, os.path.dirname(__file__))
import torch_spmd_ranks as R  # noqa: E402
from test_torch_distributed_train import (LOSS_TOL, PARAM_TOL, flat,  # noqa: E402
                                          prefixed)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_ref_spmd.py"),
         "recsys", str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        spawn(R.fsdp_rank, 4, args=(str(out),), threads=1, timeout_s=600)
    finally:
        stdout, stderr = ref.communicate(timeout=600)
    assert "REF_RECSYS_DONE" in stdout, stderr[-3000:]
    return out


@pytest.mark.parametrize("arch", ["lsr", "gr"])
def test_blocks_are_the_reference_shards_at_each_coordinate(runs, arch):
    want = flat(params_to_numpy(R.model(arch)[0]))
    index = json.loads((runs / "ref_blocks.json").read_text())[arch]
    split = 0
    for rank in range(4):
        got = np.load(runs / f"fsdp_blocks_r{rank}.npz")
        coord = ",".join(map(str, got["coord"]))
        for k, by_coord in index.items():
            sl = tuple(slice(a, b) for a, b in by_coord[coord])
            np.testing.assert_array_equal(got[f"{arch}/{k}"], want[k][sl],
                                          err_msg=f"{k} at {coord}")
            split += got[f"{arch}/{k}"].size < want[k].size
    # dense leaves are split, not only the tables
    assert split > 4 * 2


@pytest.mark.parametrize("arch", ["lsr", "gr"])
def test_step0_matches_the_sharded_reference(runs, arch):
    got = prefixed(np.load(runs / "fsdp.npz"), f"{arch}/")
    want = np.load(runs / "ref_recsys.npz")
    np.testing.assert_allclose(got["loss"], want[f"{arch}/loss"], atol=1e-5)
    names = [k[len(arch) + 3:] for k in want.files
             if k.startswith(f"{arch}/g/")]
    assert sorted(names) == sorted(k[2:] for k in got if k.startswith("g/"))
    for k in names:
        np.testing.assert_allclose(got[f"g/{k}"], want[f"{arch}/g/{k}"],
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ["lsr", "gr"])
def test_20_steps_as_one_process(runs, arch):
    got = prefixed(np.load(runs / "fsdp.npz"), f"{arch}/")
    losses, _, state = R.train(arch, None)
    np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
    want = flat(params_to_numpy(state["params"]))
    mine = {k[2:]: v for k, v in got.items() if k.startswith("p/")}
    assert set(mine) == set(want)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], **PARAM_TOL, err_msg=k)


def test_2d_block_checkpoint_read_by_the_reference(runs):
    live = prefixed(np.load(runs / "fsdp.npz"), "s/")
    mgr = JaxCheckpointManager(str(runs / "ck_2x2"))
    assert mgr.all_steps() == [8]
    specs = [s for s in mgr.saved_specs(8).values() if s]
    assert ["data", "model"] in specs and ["model", None] in specs
    restored = flat(jax.tree.map(np.asarray, mgr.restore(8)))
    got = {k: v for k, v in restored.items()
           if k.split("/")[0] in ("params", "opt", "step")}
    assert set(got) == set(live)
    for k, v in live.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_2d_block_checkpoint_resumed_on_1x2(runs):
    got = np.load(runs / "fsdp.npz")["resumed"]
    losses, _, _ = R.train("lsr", None, 16)
    np.testing.assert_allclose(got, losses[8:], **LOSS_TOL)
