"""Cells, configurations, traffic and metrics found by name from
``BENCHMARK.json``; one run of one cell; its result line.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
configuration is ``roobench/configs/<config>.json`` (``BENCHMARK.json``'s
``file``), the traffic ``roobench/traffic/<traffic>.json``, which names
its driver, a module ``roobench/drivers/<driver>.py`` with ``run(ctx) ->
Outcome``. A per-layer metric is read by ``roobench/metrics/<metric>.py``
(``read(layer) -> float | None``). Adding a cell, a configuration, a
traffic mix or a metric adds files and entries; nothing here changes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent

# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


@dataclasses.dataclass
class Check:
    """One number the correctness comparison reads, beside its limit
    (``value <= limit`` passes)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Ctx:
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: str
    t_start: float                 # perf_counter at process start

    def log(self, *parts) -> None:
        print(f"[{self.workload}]", *parts, file=sys.stderr, flush=True)

    def phase(self, name: str) -> None:
        """Log how far into the process a set-up phase ended."""
        self.log(f"{name}: {time.perf_counter() - self.t_start:.3f} s")


@dataclasses.dataclass
class Layer:
    """What a per-layer metric reader gets: the device trace of the
    window, the program's spans in it, the driver's counts, the cell's
    configuration and traffic, and the ``_info`` of each batch the window
    ran (its shapes and the yardstick's FLOPs and bytes), so that a new
    reader can count its own work from shapes."""
    trace: object
    spans: List[dict]
    counts: Dict[str, float]
    config: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)
    batches: List[dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""
    e2e: Dict[str, float]
    setup_s: float
    attempted: int
    failed: int
    checks: List[Check]
    counts: Dict[str, float]
    memory_peak_bytes: int
    trace: object = None           # trace.DeviceTrace of a traced run
    spans: List[dict] = dataclasses.field(default_factory=list)
    batches: List[dict] = dataclasses.field(default_factory=list)
    # variant name -> the check's numbers with the reference, computed that
    # way, put in the program's place (``roobench.control`` reads them)
    variants: Optional[Callable[[str], Dict[str, float]]] = None


def load_bench(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> dict:
    """The ``workloads`` entry of a workload name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    return cells[workload]


def resolve(bench: dict, workload: str):
    """(cell, configuration, traffic) of a workload name."""
    cell = cell_of(bench, workload)
    configs = {c["name"]: c for c in bench["configs"]}
    with open(ROOT / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(PKG / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def cell_metrics(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics a run of this cell reports: the end-to-end ones without
    tracing, the per-layer ones with."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(metric: str):
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"roobench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prepare_env() -> None:
    """The program on the path, its caches inside the checkout, and the
    obs mode off unless a traced run turns it on."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["REPRO_TORCH_OBS"] = "off"


def check_precision(config: dict) -> None:
    """Refuse a configuration whose stated precision the drivers do not
    run: they make float32 weights and turn TF32 off, as the references
    compute."""
    if config.get("dtype") != "float32" or config.get("tf32") is not False:
        raise SystemExit(
            f"configuration {config.get('name')!r} states dtype "
            f"{config.get('dtype')!r}, tf32 {config.get('tf32')!r}; the "
            f"benchmark runs float32 with TF32 off only")


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (by default the
    modules this process holds), compared whole."""
    tops = {n.split(".", 1)[0] for n in list(names or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def window_spans(t0: float, t1: float) -> List[dict]:
    """The program's own spans (``repro_torch.obs.trace``, microseconds
    of ``perf_counter``) that lie inside the window [t0, t1] (seconds)."""
    from repro_torch.obs import trace as obs_trace
    lo, hi = t0 * 1e6, t1 * 1e6
    return [e for e in obs_trace.get_tracer().events()
            if e.get("ph") == "X" and lo <= e["ts"] and
            e["ts"] + e["dur"] <= hi]


def execute(workload: str, seed: int, seconds: float, traced: bool, *,
            device: str = "cuda", t_start: float, bench: dict = None,
            config: dict = None, traffic: dict = None):
    """One run of one cell: (cell, ctx, the driver's Outcome). ``config`` /
    ``traffic`` replace the cell's files (tests drive tiny ones on the
    CPU)."""
    bench = bench or load_bench()
    if config is None or traffic is None:
        cell, cfg, tr = resolve(bench, workload)
        config, traffic = config or cfg, traffic or tr
    else:
        cell = cell_of(bench, workload)
    check_precision(config)
    ctx = Ctx(workload, config, traffic, seed, seconds, traced, device,
              t_start)
    prepare_env()
    if traced:
        os.environ["REPRO_TORCH_OBS"] = "trace"
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(f"roobench.drivers.{ctx.traffic['driver']}")
    return cell, ctx, driver.run(ctx)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             bench: dict = None, **kw) -> dict:
    """One run of one cell; returns the result line (``execute``'s
    keywords)."""
    import torch
    bench = bench or load_bench()
    cell, ctx, out = execute(workload, seed, seconds, traced, bench=bench,
                             **kw)
    device = ctx.device
    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        if traced:
            value = load_reader(m["name"]).read(
                Layer(out.trace, out.spans, out.counts, ctx.config,
                      ctx.traffic, out.batches))
        elif m["name"] == "setup_s":
            value = out.setup_s
        else:
            value = out.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell["chips"],
               "memory_peak_bytes": out.memory_peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    line = {"correct": all(c.ok for c in out.checks) and bool(out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if traced and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


@contextlib.contextmanager
def tf32(on: bool):
    """A scope in which float32 products run as TF32 (or not)."""
    import torch
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def print_checks(line: dict) -> None:
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr, flush=True)
