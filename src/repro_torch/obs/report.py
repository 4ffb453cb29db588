"""Summarize a telemetry JSONL run file: rates and per-phase latencies
(torch port of ``repro/obs/report.py``, framework-free).

    PYTHONPATH=src python -m repro_torch.obs.report telemetry.jsonl

Reads the first and last snapshot lines, prints counter deltas as
rates over the covered wall interval, gauge final values, and one row
per histogram (the ``span.*`` families are the per-phase request/step
latencies) with count / mean / p50 / p99 / max estimated from the fixed
bucket ladder. Component mirrors from the final snapshot are printed as
a nested tree.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple


def load_lines(path: str) -> List[dict]:
    lines = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            try:
                lines.append(json.loads(raw))
            except json.JSONDecodeError:
                # a killed run can leave a torn final line; skip it
                continue
    return lines


def _hist_quantile(h: dict, q: float) -> Optional[float]:
    """Quantile from a snapshot histogram dict (upper bucket edge)."""
    total = h.get("count", 0)
    if not total:
        return None
    edges_counts: List[Tuple[float, int]] = sorted(
        (float(k[3:]), c) for k, c in h.get("buckets", {}).items())
    rank = q * total
    cum = 0
    for edge, c in edges_counts:
        cum += c
        if cum >= rank:
            return edge
    return h.get("max")   # all remaining mass is in overflow


def _fmt_ms(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v >= 1000:
        return "%.2fs" % (v / 1000)
    if v >= 1:
        return "%.3gms" % v
    return "%.3gus" % (v * 1000)


def summarize(lines: List[dict], out=None) -> None:
    """Print the run summary to ``out`` (default: the current stdout)."""
    out = sys.stdout if out is None else out
    if not lines:
        print("empty telemetry file", file=out)
        return
    first, last = lines[0], lines[-1]
    dt = max(last.get("elapsed_s", 0) - first.get("elapsed_s", 0), 0.0)
    snap0 = first.get("snapshot", {}).get("metrics", {})
    snap1 = last.get("snapshot", {}).get("metrics", {})
    print(f"telemetry: {len(lines)} lines over {dt:.3f}s "
          f"(mode={last.get('snapshot', {}).get('mode')}, "
          f"scenario={last.get('scenario_hash')})", file=out)

    counters0: Dict[str, float] = snap0.get("counters", {})
    counters1: Dict[str, float] = snap1.get("counters", {})
    if counters1:
        print("\ncounters (delta over file, rate/s):", file=out)
        for name in sorted(counters1):
            delta = counters1[name] - counters0.get(name, 0)
            rate = f"{delta / dt:10.2f}/s" if dt > 0 else " " * 12
            print(f"  {name:<48} {counters1[name]:>10} "
                  f"(+{delta}) {rate}", file=out)

    gauges = snap1.get("gauges", {})
    if gauges:
        print("\ngauges (final):", file=out)
        for name in sorted(gauges):
            print(f"  {name:<48} {gauges[name]:>10}", file=out)

    hists = snap1.get("histograms", {})
    if hists:
        print("\nlatencies (ms ladder):", file=out)
        print(f"  {'name':<40}{'count':>8}{'mean':>10}{'p50':>10}"
              f"{'p99':>10}{'max':>10}", file=out)
        for name in sorted(hists):
            h = hists[name]
            count = h.get("count", 0)
            mean = h.get("sum", 0) / count if count else None
            print(f"  {name:<40}{count:>8}{_fmt_ms(mean):>10}"
                  f"{_fmt_ms(_hist_quantile(h, 0.5)):>10}"
                  f"{_fmt_ms(_hist_quantile(h, 0.99)):>10}"
                  f"{_fmt_ms(h.get('max')):>10}", file=out)

    components = last.get("snapshot", {}).get("components", {})
    if components:
        print("\ncomponents (final snapshot):", file=out)
        for comp in sorted(components):
            print(f"  {comp}:", file=out)
            _print_tree(components[comp], indent=4, out=out)


def _print_tree(d, indent: int, out) -> None:
    pad = " " * indent
    if not isinstance(d, dict):
        print(f"{pad}{d}", file=out)
        return
    for k in sorted(d):
        v = d[k]
        if isinstance(v, dict):
            print(f"{pad}{k}:", file=out)
            _print_tree(v, indent + 2, out=out)
        else:
            print(f"{pad}{k}={v}", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a telemetry JSONL file into rates and "
                    "per-phase p50/p99.")
    ap.add_argument("path", help="telemetry .jsonl written by a run with "
                                 "obs export enabled")
    args = ap.parse_args(argv)
    summarize(load_lines(args.path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
