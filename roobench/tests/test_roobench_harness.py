"""The harness finds cells, configurations, traffic, drivers and metric
readers by name from BENCHMARK.json, and the file keeps to its contract."""
import importlib
import os
import re
import subprocess
import sys

import pytest

from roobench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.load_bench()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["roobench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    wl, cfg, tr = harness.resolve(BENCH, cell)
    assert wl["chips"] in (1, 4)
    assert NAME.match(wl["name"]) and NAME.match(wl["traffic"])
    assert len(wl["why"]) <= 200 and "\n" not in wl["why"]
    assert cfg["name"] == wl["config"]
    drv = importlib.import_module(f"roobench.drivers.{tr['driver']}")
    assert callable(drv.run)
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    layer = harness.cell_metrics(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    # every per-layer metric a cell reports moves an end-to-end metric the
    # cell reports
    for m in layer:
        assert m["moves"] in e2e


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("roobench/")
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and len(c["source"]) <= 200
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not (key.endswith("_dim") or key.endswith("_rank"))


READERS = sorted(f[:-3] for f in os.listdir(harness.PKG / "metrics")
                 if f.endswith(".py"))


def test_every_per_layer_metric_has_a_reader():
    assert {m["name"] for m in BENCH["per_layer"]} <= set(READERS)


@pytest.mark.parametrize("metric", READERS)
def test_metric_reader_found_by_name(metric):
    reader = harness.load_reader(metric)
    assert callable(reader.read)
    empty = harness.Layer(trace=None, spans=[], counts={})
    assert reader.read(empty) is None       # nothing to read: no number


@pytest.mark.parametrize("stated", [{"dtype": "bfloat16", "tf32": False},
                                    {"dtype": "float32", "tf32": True},
                                    {}])
def test_a_precision_the_drivers_do_not_run_is_refused(stated):
    cfg = {"name": "x", **stated}
    with pytest.raises(SystemExit):
        harness.check_precision(cfg)
    harness.check_precision({"dtype": "float32", "tf32": False})


def test_metric_entries_keep_the_contract():
    names = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["name"] not in names
            names.add(m["name"])
            assert set(m.get("workloads", [])) <= cells
            if group == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
                assert m["moves"] in e2e and "\n" not in m["layer"]
                if m["name"].endswith("_roofline") or "mfu" in m["name"]:
                    assert m["unit"] == "%"


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.resolve(BENCH, "no-such-cell")


def test_run_refuses_without_a_card():
    """No CUDA card: a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "roobench.run", "--workload",
         "dlrm-score-bulk", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(["repro_torch.models", "roobench",
                                      "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(["repro.models.gr", "jax.numpy",
                                      "flax"]) == ["flax", "jax", "repro"]
