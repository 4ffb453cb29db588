"""hstu-gr training at the HSTU paper's widths on a CUDA card: B1, B2 and
B3 at the ``gr-train-long`` cell's attention shape (B 2, H 8, S 8,256,
D 128, ``max_rel_pos`` 8,256, one full and one partial history) against
the plain version head by head, and bit for bit on repeat; and one
sparse-row training step of the cell's configuration through its driver's
scenario, pool and the program's ``Trainer``, with the launches it must
make and the spans it must open.

Every test here is marked ``chip`` and skips without a card. The file
imports no JAX, so it runs on the card as

    PYTHONPATH=src:. python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gr_train_device.py -m chip
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import hstu_attention as fwd
from repro_torch.kernels import hstu_attention_bwd as bwd
from repro_torch.kernels import segment_merge as sm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import OBS_KNOB

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_state import port_state  # noqa: E402,F401

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

B, H, S, D = chip_smoke.GR_LONG[:4]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.chip
def test_kernels_at_the_cells_shape(cuda_card):
    """Each kernel's output and gradients against float64, head by head,
    within ``chip_smoke.GR_LONG_TOL`` of the largest value; one launch
    each, bit for bit on repeat (``chip_smoke.gr_long_kernel_errors``)."""
    worst = chip_smoke.gr_long_kernel_errors(
        fwd, bwd, chip_smoke.gr_long_inputs(cuda_card))
    assert len(worst) == 5 * H
    bad = {key: e for key, e in worst.items()
           if not e <= chip_smoke.GR_LONG_TOL}
    assert not bad, bad


@pytest.mark.chip
def test_one_cell_step_launches_and_spans(cuda_card, port_state):
    OBS_KNOB.set_default("trace")
    fwd.reset_launch_count()
    bwd.reset_launch_count()
    sm.reset_launch_count()
    cfg, grp = chip_smoke.gr_long_step(cuda_card, 1 << 20)
    n = cfg["n_layers"]
    # B1 once a layer (no logging forward in one step), B2 and B3 once
    # each a layer, the history's item merge (16,384 ids) on the segment
    # route and no other merge there
    assert (fwd.launch_count, bwd.dq_launch_count,
            bwd.dkv_launch_count) == (n, n, n)
    assert sm.launch_count == 1
    events = obs_trace.get_tracer().events()

    def named(name):
        return [e for e in events if e["name"] == name]
    layers = named("hstu.layer")
    assert [e["args"]["layer"] for e in layers] == list(range(n))
    assert all(e["args"]["S"] == S and e["args"]["B"] == B for e in layers)
    hists = [len(r["hist"]) for r in grp]
    tgts = [len(r["items"]) for r in grp]
    cells = H * sum(h * (h + 1) // 2 + t * h + t
                    for h, t in zip(hists, tgts))
    for name in ("hstu.attention", "hstu.attention_bwd"):
        spans = named(name)
        assert len(spans) == n, name
        for e in spans:
            a = e["args"]
            assert (a["B"], a["H"], a["S"], a["D"], a["Dv"]) == \
                (B, H, S, D, D)
            assert a["kept_cells"] == cells and a["device_ms"] > 0
    assert obs_metrics.counter("hstu.kept_cells").value() == n * cells
    OBS_KNOB.set_default("off")
