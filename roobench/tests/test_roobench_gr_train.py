"""The ``gr-train-long`` cell on the CPU at tiny sizes: the program's
sparse-row hstu-gr training steps held to the plain reference
(``reference/hstu_gr_train.py``); a whole run of the cell through the
harness is ``correct``, and each planted fault (half the batch, a stale
state) fails it; its yardstick counts and readers."""
import json
import time

import numpy as np
import pytest
import torch

from roobench import harness, yardstick as Y, yardstick_gr_train as YT
from roobench.drivers import gr_train

CELL = "gr-train-long"
SEED = 2 ** 31 + 36
CONFIG = harness.resolve(harness.load_bench(), CELL)[1]


def config(d_model=64, n_heads=2, head=32) -> dict:
    """The cell's configuration at a tiny size: its limits, rates and laws
    kept, S = 64 + 16 = 80."""
    c = json.loads(json.dumps(CONFIG))
    c.update(d_model=d_model, n_heads=n_heads, d_qk=head, d_v=head,
             n_layers=2, hist_len=64, m_targets=16, max_rel_pos=80,
             n_items=5000)
    return c


def traffic() -> dict:
    t = harness.resolve(harness.load_bench(), CELL)[2]
    t.update(history_len={"law": "log_uniform_int", "lo": 32, "hi": 64},
             impressions_per_request={"law": "uniform_int", "lo": 2,
                                      "hi": 16},
             pool_batches=4)
    return t


def run(cfg=None, seconds=0.3):
    torch.manual_seed(0)
    return harness.run_cell(CELL, SEED, seconds, False, device="cpu",
                            t_start=time.perf_counter(),
                            config=cfg or config(), traffic=traffic())


# the program's numbers against the reference's at the same size and
# precision: the sums run in other orders, nothing else differs (at this
# size the loss is not the chaotic one of the published widths, so it is
# checked too)
CLOSE = {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-3}


@pytest.mark.parametrize("shape", [(64, 2, 32), (128, 1, 128)],
                         ids=["d64-2x32", "d128-1x128"])
def test_training_steps_match_the_reference(shape):
    """Loss of each of the 3 checked steps, the first step's gradient norm
    of every leaf, and every leaf's change after the 3 steps."""
    cfg = config(*shape)
    cfg["limits"]["train"].update(CLOSE)
    line = run(cfg)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(CLOSE)


def test_sound_run_reports_the_cells_metrics():
    line = run()
    assert line["correct"] and line["attempted"] > 0 and not line["failed"]
    assert set(line["metrics"]) == {"train_imps_per_s", "setup_s"}
    # every number the driver compares has its limit
    assert list(line["checks"]) == list(gr_train.NUMBERS)


@pytest.mark.parametrize("number", gr_train.NUMBERS)
def test_a_configuration_without_a_limit_is_refused(number):
    cfg = config()
    del cfg["limits"]["train"][number]
    with pytest.raises(ValueError, match=number):
        run(cfg)


def test_a_step_that_returns_its_state_unchanged_fails(monkeypatch):
    from repro_torch.train import optim
    real = optim.make_mixed

    def stale(*a, **kw):
        opt = real(*a, **kw)
        return optim.Optimizer(opt.init, lambda g, s, p, **k: (p, s))
    monkeypatch.setattr(optim, "make_mixed", stale)
    line = run()
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] > \
        line["checks"]["change_gap"]["limit"]


def test_half_the_batch_left_out_fails(monkeypatch):
    """The loss over the first half of each step's impressions."""
    from repro_torch.core.roo_batch import ROOBatch
    real = ROOBatch.impression_mask

    def first_half(self):
        m = real(self)
        return m & (torch.cumsum(m.long(), 0) <= int(m.sum()) // 2)
    monkeypatch.setattr(ROOBatch, "impression_mask", first_half)
    line = run()
    assert not line["correct"]
    assert line["checks"]["grad_gap"]["value"] > \
        line["checks"]["grad_gap"]["limit"]


def test_variants_fail_the_limits_the_cell_states():
    """The reference put in the program's place with each planted fault
    fails some limit of the cell's configuration (the TF32 control is a
    no-op on the CPU)."""
    _, ctx, out = harness.execute(CELL, SEED, 0.2, False, device="cpu",
                                  t_start=time.perf_counter(),
                                  config=config(), traffic=traffic())
    lim = CONFIG["limits"]["train"]
    for name in ("half_batch", "stale_state"):
        got = out.variants(name)
        assert any(v > lim[k] for k, v in got.items() if k in lim), \
            (name, got)


def test_pool_packs_a_step_a_batch_through_the_batcher():
    cfg, tr = config(), traffic()
    spec = gr_train.spec(cfg, tr)
    batches, groups, infos = gr_train.pool(SEED, cfg, tr, spec)
    assert len(batches) == len(groups) == tr["pool_batches"]
    for b, grp, info in zip(batches, groups, infos):
        n = tr["requests_per_step"]
        assert b.b_ro == n and b.b_nro == n * cfg["m_targets"]
        assert b.history_lengths.tolist() == [len(r["hist"]) for r in grp]
        assert b.num_impressions.tolist() == info["targets"]
        for row, r in enumerate(grp):
            k = len(r["hist"])
            assert b.history_ids[row, :k].tolist() == r["hist"].tolist()
        assert info["train_flops"] == sum(
            3 * Y.gr_fwd_flops(cfg, h, t)
            for h, t in zip(info["hists"], info["targets"]))
    # the same seed draws the same pool
    again = gr_train.requests(SEED, cfg, tr)
    assert all(np.array_equal(a["hist"], r["hist"])
               for a, r in zip(again, sum(groups, [])))


def test_scenario_carries_the_configurations_widths():
    cfg = CONFIG
    spec = gr_train.spec(cfg, json.load(open(
        harness.PKG / "traffic" / "gr-train-long.json")))
    m = spec.model
    assert (m.d_model, m.n_heads, m.d_qk, m.d_v, m.n_layers,
            m.max_rel_pos) == (1024, 8, 128, 128, 24, 8256)
    assert (m.hist_len, m.m_targets, m.n_items) == (8192, 64, 4194304)
    assert spec.train.sparse_emb and spec.batcher.b_ro == 2


def test_backward_counts():
    cfg = CONFIG
    cells = Y.hstu_kept_cells(5000, 40)
    # q k^T and g v^T once, dS k, dS^T q and A^T g: 2.5x the forward's
    # two products at Dqk = Dv
    assert YT.bwd_flops(cfg, 5000, 40) == 8 * cells * (6 * 128 + 4 * 128)
    assert 2 * YT.bwd_flops(cfg, 5000, 40) == 5 * Y.hstu_attn_flops(
        cfg, 5000, 40)
    assert YT.bwd_bytes(cfg, 5000, 40) == 8 * 5040 * 7 * 128 * 4
    step = YT.attention_step(cfg, [5000, 6000], [40, 8])
    assert set(step) == {"b1_flops", "b1_bytes", "bwd_flops", "bwd_bytes"}
    assert step["b1_flops"] == 24 * (Y.hstu_attn_flops(cfg, 5000, 40)
                                     + Y.hstu_attn_flops(cfg, 6000, 8))
    assert step["bwd_bytes"] == 24 * (YT.bwd_bytes(cfg, 5000, 40)
                                      + YT.bwd_bytes(cfg, 6000, 8)
                                      + 2 * Y.hstu_rab_bytes(cfg))
    assert YT.least_seconds(Y.FP32_ACCURATE_FLOP_S, 0) == 1.0
    assert YT.least_seconds(0, Y.HBM_BYTES_S) == 1.0


class _Trace:
    window_s = 2.0
    busy_s = 1.5

    def __init__(self, kernels):
        self._k = kernels

    def kernel_seconds(self, parts):
        return sum(s for n, s in self._k.items()
                   if any(p in n for p in parts))


def test_readers():
    counts = {"train_flops": Y.FP32_ACCURATE_FLOP_S,
              "b1_flops": Y.FP32_ACCURATE_FLOP_S, "b1_bytes": 0,
              "bwd_flops": 0, "bwd_bytes": 2 * Y.HBM_BYTES_S}
    trace = _Trace({"void hstu_fwd_kernel<128, float>": 2.0,
                    "void hstu_bwd_dq_kernel<128, float>": 2.0,
                    "void hstu_bwd_dkv_kernel<128, float>": 2.0,
                    "hstu_prefix_fwd_kernel": 5.0})
    layer = harness.Layer(trace, [], counts)
    assert harness.load_reader("step_mfu.gr_train").read(layer) == 50.0
    # no backward FLOPs: no reading
    assert harness.load_reader("hstu_roofline.gr_train").read(layer) is None
    # the backward's least time is read at the memory peak here, once for
    # B2 and B3 together, over all three kernels' time (not the prefix's)
    counts["bwd_flops"] = 1.0
    assert harness.load_reader("hstu_roofline.gr_train").read(layer) == \
        pytest.approx(100.0 * 3.0 / 6.0)
    assert harness.load_reader("device_idle_share.gr_train").read(
        layer) == 25.0
    spans = [{"name": "train.step", "ts": 0, "dur": 100, "args": {}},
             {"name": "hstu.attention", "ts": 10, "dur": 5,
              "args": {"device_ms": 1.0}},
             {"name": "hstu.attention_bwd", "ts": 50, "dur": 5,
              "args": {"device_ms": 2.5}},
             {"name": "train.step", "ts": 200, "dur": 100, "args": {}},
             {"name": "hstu.attention", "ts": 210, "dur": 5,
              "args": {"device_ms": 1.5}},
             {"name": "hstu.attention_bwd", "ts": 250, "dur": 5,
              "args": {"device_ms": 2.5}},
             {"name": "train.step", "ts": 400, "dur": 100, "args": {}},
             {"name": "hstu.attention", "ts": 410, "dur": 5, "args": {}}]
    ms = harness.load_reader("hstu_attention_ms.gr_train").read(
        harness.Layer(None, spans, {}))
    assert ms == pytest.approx(3.75)      # the third step is not timed
