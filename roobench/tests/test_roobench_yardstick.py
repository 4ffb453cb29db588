"""The frozen roofline and FLOP arithmetic against hand counts, the trace
helpers, and the metric readers on hand-made traces."""
import json
import os

import pytest
import roobench_tiny as tiny

from roobench import harness
from roobench import trace as TR
from roobench import yardstick as Y


def cfg(name):
    with open(os.path.join(harness.PKG, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_peaks():
    assert Y.FP32_ACCURATE_FLOP_S == 165e12          # 3xTF32: 495 / 3
    assert Y.FP32_CUDA_CORE_FLOP_S == 67e12
    assert Y.HBM_BYTES_S == 3.35e12


def test_dlrm_flops_by_hand():
    c = cfg("dlrm-mlperf-share4")
    b_ro, b_nro = 16384, 65536
    bot = 13 * 512 + 512 * 256 + 256 * 128                    # MACs
    # MLPerf's top MLP: the interaction's 479 wide input, then its five
    # published layers
    top = (479 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256
           + 256 * 1)
    pairs = 27 * 26 // 2
    fwd = 2 * b_ro * bot + 2 * b_nro * top + 2 * pairs * 128 * b_nro
    assert Y.dlrm_top_dims(c) == [479, 1024, 1024, 512, 256, 1]
    assert Y.dlrm_fwd_flops(c, b_ro, b_nro) == fwd
    # backward: dW and dX of every layer, less the dense input's dX; the
    # interaction's two operand gradients
    bwd = (2 * 2 * b_ro * bot - 2 * b_ro * 13 * 512
           + 2 * 2 * b_nro * top + 2 * 2 * pairs * 128 * b_nro)
    assert Y.dlrm_train_flops(c, b_ro, b_nro) == fwd + bwd


def test_bag_bytes_by_hand():
    # 1,000 distinct rows of 128 fp32 named by 4,096 one-id bags
    assert Y.bag_fwd_bytes(1000, 4096, 4096, 128) == (
        1000 * 512 + 4096 * 4 + 4096 * 4 + 4096 * 512)
    assert Y.bag_bwd_bytes(4096, 4096, 128) == (
        4096 * 512 + 4096 * 4 + 4096 * 4 + 4096 * 512)


def test_hstu_counts_by_hand():
    c = tiny.gr()
    # 3 history events, 2 targets: 6 causal + 2 x 3 + 2 kept cells
    assert Y.hstu_kept_cells(3, 2) == 14
    assert Y.hstu_attn_flops(c, 3, 2) == 2 * (32 + 32) * 2 * 14
    assert Y.hstu_attn_bytes(c, 3, 2) == 2 * 5 * (32 + 32 + 32 + 32) * 4
    assert Y.hstu_rab_bytes(c) == 2 * 129 * 4
    rows = 5
    layer = (2 * rows * 64 * 256 + Y.hstu_attn_flops(c, 3, 2)
             + 2 * rows * 64 * 64)
    assert Y.gr_fwd_flops(c, 3, 2) == 2 * layer + 2 * 2 * (64 * 128 + 128 * 2)


def test_roofline_share_at_the_bound_is_100():
    # a split-TF32 kernel doing 165 TFLOP in one second sits on its bound
    assert Y.roofline_share(165e12, 1.0, 1.0) == pytest.approx(100.0)
    assert Y.roofline_share(0.0, 3.35e12, 2.0) == pytest.approx(50.0)


def test_union_gaps_and_labels():
    busy = TR.union_ns([(0, 10), (5, 20), (30, 40), (40, 45), (50, 60)])
    assert busy == [(0, 20), (30, 45), (50, 60)]
    gaps = TR.gaps_ns(busy)
    assert gaps == [(20, 30), (45, 50)]
    host = [("outer", 0, 100), ("aten::to", 18, 32), ("short", 44, 51)]
    idle = TR.label_gaps(gaps, host)
    assert idle == {"aten::to": 10 / 1e9, "short": 5 / 1e9}


def trace_of(kernels, window_s):
    return TR.DeviceTrace(kernels, [("host", 0, 10 ** 10)], window_s)


def test_readers_on_a_hand_made_trace():
    tr = trace_of([("void embedding_bag_fwd_grouped_kernel<float>", 0,
                    1_000_000),
                   ("void embedding_bag_bwd_coo_grouped_kernel", 2_000_000,
                    3_000_000),
                   ("void hstu_fwd_kernel<32, float>", 3_000_000, 4_000_000),
                   ("sgemm", 5_000_000, 9_000_000)], 0.01)
    assert tr.busy_s == pytest.approx(0.007)
    spans = [{"name": "engine.flush", "dur": 2000}]
    counts = {"bag_bytes": 3.35e12 * 0.001, "b5_bytes": 3.35e12 * 0.0005,
              "train_flops": 165e12 * 0.001, "fwd_flops": 165e12 * 0.002,
              "b1_flops": 165e12 * 0.0005, "b1_bytes": 1.0, "batches": 4,
              "fill_requests": 64, "max_requests": 64}
    layer = harness.Layer(tr, spans, counts)
    read = lambda m: harness.load_reader(m).read(layer)  # noqa: E731
    assert read("engine_flush_ms.serve") == pytest.approx(2.0)
    assert read("bag_roofline.train") == pytest.approx(50.0)
    assert read("bag_roofline.score") == pytest.approx(50.0)
    assert read("hstu_roofline.serve") == pytest.approx(50.0)
    assert read("step_mfu.train") == pytest.approx(10.0)
    assert read("step_mfu.score") == pytest.approx(20.0)
    assert read("step_mfu.serve") == pytest.approx(20.0)
    assert read("batch_fill.serve") == pytest.approx(25.0)
    for m in ("device_idle_share.train", "device_idle_share.score",
              "device_idle_share.serve"):
        assert read(m) == pytest.approx(30.0)
    # a kernel that did not run leaves its roofline silent, never 0
    quiet = harness.Layer(trace_of([("sgemm", 0, 10)], 0.01), [], counts)
    assert harness.load_reader("bag_roofline.train").read(quiet) is None
    assert harness.load_reader("hstu_roofline.serve").read(quiet) is None
