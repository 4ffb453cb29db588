"""A whole run of each cell on the CPU at a tiny size (the harness's look
for a card skipped): sound, ``correct`` is true; with the timed path broken
underneath, once for each fault the cell can have, it is false. One chip:
no exchange between chips to leave out."""
import time

import pytest
import roobench_tiny as tiny
import torch

from roobench import harness

SEED = 2 ** 31 + 77


def run(cell):
    torch.manual_seed(0)
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu",
                            t_start=time.perf_counter(), bench=tiny.bench(),
                            config=tiny.config(cell),
                            traffic=tiny.traffic(cell))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {
        m["name"] for m in harness.cell_metrics(tiny.bench(), cell, False)}


def test_train_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.train import optim
    real = optim.make_mixed

    def stale(*a, **kw):
        opt = real(*a, **kw)
        return optim.Optimizer(opt.init, lambda g, s, p, **k: (p, s))
    monkeypatch.setattr(optim, "make_mixed", stale)
    assert not run("dlrm-train-zipf")["correct"]


def test_train_half_the_batch_left_out(monkeypatch):
    from repro_torch.train import metrics
    real = metrics.bce
    monkeypatch.setattr(metrics, "bce", lambda x, y: real(
        x[:len(x) // 2], y[:len(y) // 2]))
    line = run("dlrm-train-zipf")
    assert not line["correct"]
    assert line["checks"]["loss_gap"]["value"] > \
        line["checks"]["loss_gap"]["limit"]


def altered(fn):
    """``fn`` with one answer changed where it is produced."""
    def wrapped(*a, **kw):
        out = fn(*a, **kw).clone()
        out.view(-1)[0] += 0.01 * out.abs().mean()
        return out
    return wrapped


def test_score_an_answer_altered(monkeypatch):
    from repro_torch.models import dlrm
    monkeypatch.setattr(dlrm, "dlrm_forward_roo",
                        altered(dlrm.dlrm_forward_roo))
    assert not run("dlrm-score-bulk")["correct"]


def test_serve_an_answer_altered(monkeypatch):
    from repro_torch.models import gr
    monkeypatch.setattr(gr, "gr_ranking_logits",
                        altered(gr.gr_ranking_logits))
    assert not run(tiny.SERVE)["correct"]
