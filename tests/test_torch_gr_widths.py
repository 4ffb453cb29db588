"""hstu-gr at chosen HSTU widths through the port's scenario, on the CPU.

The scenario's ``model`` section carries the widths (``d_model``,
``n_heads``, ``d_qk``, ``d_v``, ``n_layers``, ``max_rel_pos``) into the
model's ``GRConfig``; at the defaults it builds what it built before and
writes the reference's bytes. The HSTU layers open ``hstu.layer`` spans,
and the ROO mask's kept cells are counted without a sync
(``kernels/hstu_attention_bwd.kept_cells``, ``span.set_later``)."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import roo_models as rm
from repro_torch.configs.registry import scenario
from repro_torch.core.hstu import HSTUConfig, hstu_apply, hstu_init
from repro_torch.core.masks import roo_batch_mask, roo_spec
from repro_torch.kernels.hstu_attention_bwd import kept_cells
from repro_torch.models import gr
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import OBS_KNOB
from repro_torch.scenario import build
from repro_torch.scenario.spec import (PORT_MODEL_FIELDS, ScenarioSpec,
                                       ScenarioValidationError)
from repro_torch.tree import flatten_with_path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_state import port_state  # noqa: E402,F401

WIDTHS = {"model.d_model": 128, "model.n_heads": 1, "model.d_qk": 128,
          "model.d_v": 128, "model.n_layers": 3, "model.max_rel_pos": 90}
SMALL = {"model.n_items": 500, "model.hist_len": 32, "model.m_targets": 8}


def params_equal(a, b) -> bool:
    fa, fb = flatten_with_path(a), flatten_with_path(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def test_default_widths_build_what_they_built_before():
    spec = scenario("hstu-gr", SMALL)
    bundle = build.build_model(spec, torch.Generator().manual_seed(3),
                               device="cpu")
    before = dataclasses.replace(rm.gr_config(hist_len=32, m_targets=8),
                                 n_items=500)
    assert bundle.cfg == before
    assert bundle.cfg.hstu == HSTUConfig(d_model=64, n_heads=2, d_qk=32,
                                         d_v=32, n_layers=2, max_rel_pos=32)
    assert params_equal(bundle.params, gr.gr_init(
        torch.Generator().manual_seed(3), before, device="cpu"))


def test_the_spec_carries_the_widths_into_the_model():
    spec = scenario("hstu-gr", {**SMALL, **WIDTHS})
    bundle = build.build_model(spec, torch.Generator().manual_seed(3),
                               device="cpu", sparse=True)
    assert bundle.cfg.hstu == HSTUConfig(d_model=128, n_heads=1, d_qk=128,
                                         d_v=128, n_layers=3,
                                         max_rel_pos=90)
    layers = bundle.params["hstu"]["layers"]
    assert len(layers) == 3 and layers[0]["rab"].shape == (1, 181)
    assert bundle.params["item_emb"].shape == (500, 128)
    assert bundle.vag_fn is not None


@pytest.mark.parametrize("over,want", [({}, 32), ({"model.n_layers": 4}, 32),
                                       ({"model.max_rel_pos": 40}, 40)])
def test_max_rel_pos_defaults_to_the_window(over, want):
    spec = scenario("hstu-gr", {**SMALL, **over})
    cfg = build.build_model(spec, torch.Generator(), device="cpu").cfg
    assert cfg.hstu.max_rel_pos == want


def test_widths_leave_the_wire_format_until_set():
    base = scenario("hstu-gr")
    wire = base.to_json()
    assert not set(PORT_MODEL_FIELDS) & set(wire["model"])
    wide = scenario("hstu-gr", WIDTHS)
    got = wide.to_json()["model"]
    assert {f: got[f] for f in PORT_MODEL_FIELDS} == {
        k.split(".")[1]: v for k, v in WIDTHS.items()}
    back = ScenarioSpec.from_json(json.loads(wide.to_json_str()))
    assert back == wide and back.content_hash() == wide.content_hash()
    assert wide.content_hash() != base.content_hash()
    assert wide.data_hash() == base.data_hash()      # no stream field


@pytest.mark.parametrize("arch,over", [
    ("roo-lsr", {"model.d_model": 128}),
    ("dien", {"model.n_layers": 3}),
    ("hstu-gr", {"model.n_heads": -1})])
def test_widths_an_arch_does_not_read_are_refused(arch, over):
    with pytest.raises(ScenarioValidationError):
        scenario(arch, over)


def test_build_model_takes_given_params():
    spec = scenario("hstu-gr", SMALL)
    drawn = build.build_model(spec, torch.Generator().manual_seed(1),
                              device="cpu").params
    bundle = build.build_model(spec, torch.Generator().manual_seed(2),
                               device="cpu", params=drawn)
    assert bundle.params is drawn


@pytest.mark.parametrize("n_hist,hl,tc", [(16, [16, 5, 0], [4, 0, 3]),
                                          (8, [9, 8, 1], [2, 5, 2])])
def test_kept_cells_count_the_roo_mask(n_hist, hl, tc):
    m, heads = 4, 3
    s = n_hist + m
    hl_t, tc_t = torch.tensor(hl), torch.tensor(tc)
    mask = roo_batch_mask(hl_t, tc_t, n_hist, m)
    got = kept_cells(n_hist, hl_t, tc_t, heads, s)
    assert got.dim() == 0 and int(got) == heads * int(mask.sum())


def test_layers_open_spans_in_trace_mode(port_state):
    OBS_KNOB.set_default("trace")
    cfg = HSTUConfig(d_model=16, n_heads=2, d_qk=8, d_v=8, n_layers=3,
                     max_rel_pos=12)
    params = hstu_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn(2, 12, 16)
    spec = roo_spec(torch.tensor([8, 3]), torch.tensor([4, 1]), 8)
    out = hstu_apply(params, cfg, x, spec)
    spans = [e for e in obs_trace.get_tracer().events()
             if e["name"] == "hstu.layer"]
    assert [(s["args"]["layer"], s["args"]["B"], s["args"]["S"])
            for s in spans] == [(0, 2, 12), (1, 2, 12), (2, 2, 12)]
    OBS_KNOB.set_default("off")
    assert torch.equal(out, hstu_apply(params, cfg, x, spec))


def test_set_later_fills_a_host_value_at_once(port_state):
    OBS_KNOB.set_default("trace")
    with obs_trace.span("probe", device=True) as sp:
        sp.set_later("cells", torch.tensor(41) + 1, counter="probe.cells")
    with obs_trace.span("probe", device=True) as sp:
        sp.set_later("cells", torch.tensor(8), counter="probe.cells")
    got = [e["args"]["cells"] for e in obs_trace.get_tracer().events()
           if e["name"] == "probe"]
    assert got == [42, 8]
    assert obs_metrics.counter("probe.cells").value() == 50
    OBS_KNOB.set_default("off")
    with obs_trace.span("probe") as sp:      # the shared no-op
        sp.set_later("cells", torch.tensor(1), counter="probe.cells")
    assert obs_metrics.counter("probe.cells").value() == 50
