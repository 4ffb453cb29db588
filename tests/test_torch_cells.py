"""The port's dry-run cells against the reference's (``configs/``):

  * ``ASSIGNED`` and ``all_cells()`` are the reference's 40 pairs in order;
  * every cell and opt level (``build_lm_cell`` directly for the LM's) on
    ``replicated_plan()``: ``kind``, ``notes`` and ``model_flops`` equal
    the reference's exactly, ``input_specs()`` and ``abstract_state()``
    equal by tree path in shape and dtype;
  * on the 16 x 16 plan, the state's and the inputs' specs, normalized
    (``sharding.normalize_spec``), equal the reference's by tree path.

Both sides run in subprocesses: the reference (``torch_ref_cells.py
cells``) on 256 forced host devices with Auto axes, building plans only,
no compile; the port (``torch_spmd_ranks.port_cells``) on a fake world of
256 ranks.
"""
import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_spmd_ranks as R  # noqa: E402
from repro_torch.configs import registry  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = [f"{a}/{s}/{lv}" for a, s, lv in R.all_levels(registry)]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_ref_cells.py"),
         "cells", str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import torch_spmd_ranks as R; R.port_cells(sys.argv[1])")
    port = subprocess.run([sys.executable, "-c", code, str(out)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    stdout, stderr = ref.communicate(timeout=600)
    assert "REF_CELLS_DONE" in stdout, stderr[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    return (json.loads((out / "port_cells.json").read_text()),
            json.loads((out / "ref_cells.json").read_text()))


def test_assigned_and_all_cells_are_the_references():
    from repro.configs import registry as ref_registry
    assert registry.ASSIGNED == ref_registry.ASSIGNED
    assert registry.all_cells() == ref_registry.all_cells()
    assert len(registry.all_cells()) == 40


def test_every_opt_level_is_covered(tables):
    port, ref = tables
    assert sorted(port) == sorted(ref) == sorted(LEVELS)


@pytest.mark.parametrize("tag", LEVELS)
def test_cell_on_replicated_plan(tables, tag):
    port, ref = tables
    got, want = port[tag], ref[tag]
    assert got["kind"] == want["kind"]
    assert got["notes"] == want["notes"]
    assert got["model_flops"] == want["model_flops"]
    assert got["inputs"] == want["inputs"]
    assert got["state"] == want["state"]


@pytest.mark.parametrize("tag", LEVELS)
def test_specs_on_16x16(tables, tag):
    port, ref = tables
    assert port[tag]["state_specs"] == ref[tag]["state_specs"]
    assert port[tag]["input_specs"] == ref[tag]["input_specs"]


@pytest.mark.parametrize("tag", LEVELS)
def test_every_input_has_a_filler(tag):
    from repro_torch.distributed.sharding import replicated_plan
    from repro_torch.launch.dryrun import build_cell
    arch, shape, level = tag.split("/")
    cell = build_cell(arch, shape, replicated_plan(), level)
    assert set(cell.input_specs()) <= set(cell.fill)


@pytest.mark.parametrize("arch,shape,level", [
    ("phi3-medium-14b", "train_4k", "impression"),
    ("mind", "train_batch", "flash"),
    ("dlrm-mlperf", "train_batch", "flash"),
    ("mace", "molecule", "flash")])
def test_unknown_opt_level_is_refused(arch, shape, level):
    from repro_torch.distributed.sharding import replicated_plan
    from repro_torch.launch.dryrun import build_cell
    with pytest.raises(ValueError, match=level):
        build_cell(arch, shape, replicated_plan(), level)


def test_inputs_mean_what_the_cell_reads():
    """Cell.inputs at small configs: ids below each vocab, lengths in
    [1, L], segment ids in request order; an input with no filler is
    refused."""
    import torch

    from repro_torch.configs.recsys_cells import (build_dlrm_cell,
                                                  build_mind_cell)
    from repro_torch.distributed.sharding import replicated_plan
    from repro_torch.launch.dryrun import materialize
    from repro_torch.models.dlrm import DLRMConfig
    from repro_torch.models.mind import MINDConfig
    plan = replicated_plan()
    mind = build_mind_cell("serve_p99", plan,
                           cfg=MINDConfig(n_items=1024, hist_len=8))
    state, x = materialize(mind, "cpu", seed=3)
    assert state["params"]["item_emb"].shape == (1024, 64)
    assert 0 <= int(x["history_ids"].min()) and \
        int(x["history_ids"].max()) < 1024
    assert int(x["history_lengths"].min()) >= 1 and \
        int(x["history_lengths"].max()) <= 8
    seg = x["segment_ids"]
    assert torch.equal(seg, torch.sort(seg).values)
    assert int(seg[0]) == 0 and int(seg[-1]) == 127
    vocabs = (7, 50, 3000) * 8 + (11, 13)
    cfg = DLRMConfig(vocabs=vocabs, embed_dim=16, bot_mlp=(13, 32, 16),
                     top_mlp=(64, 1))
    dlrm = build_dlrm_cell("serve_p99", plan, cfg=cfg)
    x = dlrm.inputs(torch.Generator().manual_seed(0), "cpu")
    ids = torch.cat([x["ro_ids"].amax((0, 2)), x["nro_ids"].amax((0, 2))])
    assert (ids < torch.tensor(vocabs)).all()
    assert (ids >= torch.tensor(vocabs) // 2).all()     # the whole range
    dlrm.fill.pop("segment_ids")
    with pytest.raises(KeyError, match="segment_ids"):
        dlrm.inputs(torch.Generator(), "cpu")
