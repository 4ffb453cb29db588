"""The port's training launcher (``python -m repro_torch.launch.train``)
and smoke runner (``python -m repro_torch.scenario.smoke``) on the CPU
(``--device cpu``): a memory-source arch (hstu-gr) and the synthetic-source
one (dlrm-mlperf), ``--dump-config`` / ``--config`` replay bit for bit,
fewer steps than ``log_every`` (the run says that none was logged),
``--obs`` / ``--trace-out`` / ``--obs-export`` with the report reading the
JSONL, fault injection announced, ``--data disk --shard-dir``, and the
flags the port cannot run yet refused with the slice that brings them.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch.train import main
from repro_torch.obs import report
from repro_torch.scenario.smoke import smoke_one

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_state import one_thread, port_state  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--set", "model.n_items=2000", "--set", "data.n_requests=40"]


@pytest.mark.parametrize("arch,extra", [("hstu-gr", SMALL),
                                        ("dlrm-mlperf", [])])
def test_dump_config_replays_bit_for_bit(arch, extra, tmp_path, capsys,
                                         one_thread):
    cfg = str(tmp_path / "spec.json")
    flags = ["--arch", arch, "--steps", "4", "--set", "train.log_every=2",
             "--device", "cpu"] + extra
    assert main(flags + ["--dump-config", cfg]) is None
    assert "config-dumped" in capsys.readouterr().out
    spec = json.loads(Path(cfg).read_text())
    assert spec["model"]["arch"] == arch and spec["train"]["steps"] == 4
    tr_a, st_a = main(flags)
    tr_b, st_b = main(["--config", cfg, "--device", "cpu"])
    assert int(st_a["step"]) == int(st_b["step"]) == 4
    assert [r["loss"] for r in tr_a.history] == \
        [r["loss"] for r in tr_b.history]
    assert len(tr_a.history) == 2
    out = capsys.readouterr().out
    assert out.count("[launch] train-done") == 2 and "device=cpu" in out
    with pytest.raises(SystemExit, match="contradicts"):
        main(["--config", cfg, "--arch", "roo-esr", "--device", "cpu"])


def test_fewer_steps_than_log_every(capsys):
    trainer, state = main(["--arch", "mind", "--steps", "3", "--device",
                           "cpu"] + SMALL)
    assert int(state["step"]) == 3 and trainer.history == []
    out = capsys.readouterr().out
    assert "train-done" in out and "logged=none" in out


def test_obs_trace_and_export(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    tel = tmp_path / "tel.jsonl"
    main(["--arch", "roo-esr", "--steps", "2", "--set", "train.log_every=1",
          "--trace-out", str(trace), "--obs-export", str(tel),
          "--set", "knobs.faults=seed=1;train.batch:nan@0.5x1",
          "--halt-after-skips", "5", "--device", "cpu"] + SMALL)
    out = capsys.readouterr().out
    assert "fault-injection-active plan=seed=1;train.batch:nan@0.5x1" in out
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"train.step", "train.data", "train.compute",
            "train.log"} <= names
    lines = report.load_lines(str(tel))
    assert [x["source"] for x in lines][-1] == "train.final"
    assert all(x["snapshot"]["mode"] == "trace" for x in lines)
    report.main([str(tel)])
    assert "span.train.step" in capsys.readouterr().out


@pytest.mark.parametrize("argv,slice_", [
    (["--arch", "starcoder2-15b"], "A10"),
    (["--arch", "mace"], "A10"),
    (["--arch", "roo-lsr", "--mesh", "2x4"], "A9"),
    (["--arch", "roo-lsr", "--comms-compress", "int8"], "A9")])
def test_unported_flags_name_their_slice(argv, slice_):
    with pytest.raises(SystemExit, match=slice_):
        main(argv + ["--device", "cpu"])


def test_data_disk_runs(tmp_path, capsys):
    """``--data disk --shard-dir D`` trains from shards (built on the first
    run, reused on the second, without the prefetch thread there);
    without ``--shard-dir`` it exits naming the flag."""
    shards = str(tmp_path / "shards")
    argv = ["--arch", "hstu-gr", "--steps", "2", "--data", "disk",
            "--shard-dir", shards, "--requests-per-shard", "20",
            "--device", "cpu"] + SMALL
    trainer, state = main(argv)
    assert int(state["step"]) == 2
    out = capsys.readouterr().out
    assert "shards-built" in out and "train-done" in out
    assert sorted(os.listdir(shards)) == ["cursors", "manifest.json"] + [
        f"shard_{i:06d}.roos" for i in range(2)]
    main(argv + ["--no-prefetch", "--strict-shards"])
    assert "shards-reused" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="shard-dir"):
        main(["--arch", "hstu-gr", "--data", "disk", "--device", "cpu"])


def test_reference_backend_names_refused():
    with pytest.raises(SystemExit):
        main(["--arch", "hstu-gr", "--attn-backend", "pallas"])
    with pytest.raises(SystemExit, match="pass --arch"):
        main([])


def test_smoke_one_on_the_cpu():
    from repro_torch.configs.registry import scenario
    row = smoke_one(scenario("roo-retrieval", {"model.n_items": 2000,
                                               "data.n_requests": 40}),
                    steps=2, trace=True, device="cpu")
    assert row["steps"] == 2 and row["served_impressions"] > 0
    assert row["loss"] is not None


def test_report_cli_runs_as_a_module(tmp_path):
    path = tmp_path / "t.jsonl"
    path.write_text(json.dumps({"elapsed_s": 0.0, "source": "x",
                                "scenario_hash": None,
                                "snapshot": {"mode": "off"}}) + "\n")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(path)],
        capture_output=True, text=True, cwd=ROOT, check=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.stdout.startswith("telemetry: 1 lines")
