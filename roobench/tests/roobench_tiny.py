"""Tiny configurations and traffic for CPU tests: the benchmark's dlrm
cells' own files with their sizes cut and their limits kept, and a tiny
hstu-gr serving cell for the ``serve_open`` driver, which no cell of
``BENCHMARK.json`` runs yet."""
import copy
import json
import os

PKG = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def load(kind: str, name: str) -> dict:
    with open(os.path.join(PKG, kind, f"{name}.json")) as f:
        return json.load(f)


def dlrm() -> dict:
    c = load("configs", "dlrm-mlperf-share4")
    c["vocabs"] = [3000 if v > 100000 else min(v, 300) for v in c["vocabs"]]
    c.update(embed_dim=16, bot_mlp=[13, 32, 16], top_mlp=[64, 32, 1])
    return c


def gr() -> dict:
    """hstu-gr at the repo's ``gr_config`` widths over a 64-event window
    and a 5,000-item catalog."""
    return {
        "name": "hstu-gr-tiny", "d_model": 64, "n_heads": 2, "d_qk": 32,
        "d_v": 32, "n_layers": 2, "m_targets": 16, "n_tasks": 2,
        "n_actions": 4, "eps": 1e-06, "hist_len": 64, "max_rel_pos": 64,
        "n_items": 5000, "dtype": "float32", "tf32": False,
        "engine": {"max_requests": 64, "max_impressions": 512,
                   "max_delay_ms": 2.0},
        "limits": {"serve": {"score_gap": 0.00015}}}


SERVE = "gr-serve-tiny"


def serve_traffic() -> dict:
    return {
        "driver": "serve_open",
        "arrivals": {"law": "poisson", "rate_per_s": 100.0},
        "history_len": {"law": "log_uniform_int", "lo": 4, "hi": 256},
        "impressions_per_request": {"law": "uniform_int", "lo": 1,
                                    "hi": 16},
        "item_ids": {"law": "zipf", "s": 1.0},
        "actions": {"law": "uniform_int", "lo": 0, "hi": 3},
        "history_pool": 32, "check_longest": 4, "check_sample": 16}


def bench() -> dict:
    """``BENCHMARK.json`` with the tiny serving cell and its metrics."""
    from roobench import harness
    b = copy.deepcopy(harness.load_bench())
    b["workloads"].append({"name": SERVE, "config": "hstu-gr-tiny",
                           "traffic": "serve-tiny", "chips": 1,
                           "why": "CPU tests of the serve_open driver"})
    b["end_to_end"].append({"name": "serve_p95_ms", "unit": "ms",
                            "better": "lower", "bound": 0.25,
                            "source": "host_clock", "workloads": [SERVE]})
    for name, unit in (("engine_flush_ms.serve", "ms"),
                       ("batch_fill.serve", "%"), ("step_mfu.serve", "%"),
                       ("hstu_roofline.serve", "%"),
                       ("device_idle_share.serve", "%")):
        b["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                               "source": "device_trace", "layer": "serving",
                               "moves": "serve_p95_ms",
                               "workloads": [SERVE]})
    return b


def traffic(cell: str) -> dict:
    if cell == "dlrm-train-zipf":
        t = load("traffic", "train-zipf")
        t.update(impressions_per_step=256, pool_batches=4)
    elif cell == "dlrm-score-bulk":
        t = load("traffic", "score-bulk")
        t.update(impressions_per_step=256, pool_batches=4)
    else:
        t = serve_traffic()
    return t


def config(cell: str) -> dict:
    return gr() if cell == SERVE else dlrm()


CELLS = ("dlrm-train-zipf", "dlrm-score-bulk", SERVE)
