"""Where a traced benchmark cell's device time and idle time fall among the
program's spans.

    python3 scripts/trace_attribution.py --workload dlrm-train-zipf \
        --seed 2147700000 [--seconds 51] [--out chiprun_out/attr.json]

Runs one traced run of the cell through the benchmark's harness on the
card, keeps the profiler's raw events and the program's spans
(``repro_torch.obs.trace``, moved onto the profiler's clock by
``Tracer.profiler_ns``), and prints, besides the run's result line:

* the device seconds of each kernel holding at least ``KERNEL_MIN_SHARE``
  of the window's kernel time, by the innermost span whose host interval
  holds the kernel's launch (spans of autograd's device thread included:
  they nest by time);
* the window's device idle gaps, split into those in which the host sat in
  a synchronising CUDA runtime call as the card ran dry and the rest, each
  by the innermost span that launched the kernel ending the gap;
* the synchronising runtime calls inside the window's ``train.step`` spans,
  per step, beside the program's own count (``host_syncs.train``).
"""
import argparse
import bisect
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# CUDA runtime calls that block the host until the card is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
KERNEL_MIN_SHARE = 0.001   # of the window's kernel seconds: a kernel listed


def innermost(spans, times):
    """For each time (sorted ascending), the name of the innermost span
    holding it, or None; ``spans``: (lo, hi, name), nested by time."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def attribute(prof, tracer, t0, t1):
    from torch._C._autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    launches, kernels, syncs = {}, [], []
    for ev in events:
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            kernels.append((ev.name(), s, e, ev.correlation_id()))
        elif ev.name().startswith("cu"):
            launches[ev.correlation_id()] = s
            if ev.name() in SYNC_CALLS:
                syncs.append((s, e))
    syncs.sort()
    lo_w, hi_w = tracer.profiler_ns(t0 * 1e6), tracer.profiler_ns(t1 * 1e6)
    kernels = sorted((k for k in kernels if lo_w <= k[1] and k[2] <= hi_w),
                     key=lambda k: k[1])
    spans = [(tracer.profiler_ns(e["ts"]),
              tracer.profiler_ns(e["ts"] + e["dur"]), e["name"])
             for e in tracer.events() if e.get("ph") == "X"]

    # kernel seconds by the span that launched them
    order = sorted(range(len(kernels)),
                   key=lambda i: launches.get(kernels[i][3], -1))
    at = innermost(spans, [launches.get(kernels[i][3], -1) for i in order])
    owner = dict(zip(order, at))
    by_kernel, total = {}, {}
    for i, (name, s, e, corr) in enumerate(kernels):
        where = owner[i] if corr in launches else "(launch not seen)"
        d = by_kernel.setdefault(name[:90], {})
        d[where] = d.get(where, 0.0) + (e - s) / 1e9
        total[name[:90]] = total.get(name[:90], 0.0) + (e - s) / 1e9
    floor = KERNEL_MIN_SHARE * sum(total.values())
    busiest = sorted((n for n in total if total[n] >= floor),
                     key=lambda n: -total[n])
    kernel_table = {n: {"total_s": total[n], "by_span": dict(sorted(
        by_kernel[n].items(), key=lambda kv: -kv[1]))} for n in busiest}

    # idle gaps between the union of busy intervals
    busy = []
    for _, s, e, corr in kernels:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e, corr])       # start, end, its first kernel
    gaps = [(a[1], b[0], b[2]) for a, b in zip(busy[:-1], busy[1:])]
    sync_starts = [s for s, _ in syncs]
    gap_owner = innermost(spans, sorted(launches.get(c, -1)
                                        for _, _, c in gaps))
    by_launch = sorted(range(len(gaps)),
                       key=lambda i: launches.get(gaps[i][2], -1))
    owner = dict(zip(by_launch, gap_owner))
    idle = {"sync_s": 0.0, "other_s": 0.0, "by_span": {}}
    for i, (gs, ge, _) in enumerate(gaps):
        j = bisect.bisect_right(sync_starts, gs) - 1
        kind = "sync_s" if j >= 0 and syncs[j][1] >= gs else "other_s"
        idle[kind] += (ge - gs) / 1e9
        d = idle["by_span"].setdefault(str(owner[i]), {"sync_s": 0.0,
                                                      "other_s": 0.0})
        d[kind] += (ge - gs) / 1e9
    idle["by_span"] = dict(sorted(idle["by_span"].items(),
                                  key=lambda kv: -sum(kv[1].values())))

    # synchronising runtime calls inside the window's steps
    steps = [(tracer.profiler_ns(e["ts"]),
              tracer.profiler_ns(e["ts"] + e["dur"]))
             for e in tracer.events() if e["name"] == "train.step"
             and t0 * 1e6 <= e["ts"] and e["ts"] + e["dur"] <= t1 * 1e6]
    in_steps = sum(1 for s, e in syncs for lo, hi in steps
                   if lo <= s and e <= hi)
    return {"kernels": kernel_table, "idle": idle,
            "busy_s": sum(e - s for s, e, _ in busy) / 1e9,
            "launch_matched_share": sum(k[3] in launches for k in kernels)
            / max(len(kernels), 1),
            "steps": len(steps),
            "sync_calls_per_step": in_steps / len(steps) if steps else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from roobench import harness
    from roobench import trace as rtrace
    kept = {}
    read_profile = rtrace.read_profile

    def keep(prof, window_s):
        kept["prof"] = prof
        return read_profile(prof, window_s)
    rtrace.read_profile = keep
    opened = rtrace.Window.open

    def open_(self):
        kept["window"] = self
        return opened(self)
    rtrace.Window.open = open_
    line = harness.run_cell(args.workload, args.seed, args.seconds, True,
                            device="cuda", t_start=T_START)
    from repro_torch.obs import trace as obs_trace
    win = kept["window"]
    got = attribute(kept["prof"], obs_trace.get_tracer(), win.t0, win.t1)
    got["line"] = line
    text = json.dumps(got, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
