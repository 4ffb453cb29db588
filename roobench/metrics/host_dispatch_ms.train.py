"""The host's own time in a training step's dispatch: the median over the
window's ``train.step`` spans of the host ms of the ``train.compute`` span
inside each, less the time the profiler saw in CUDA runtime calls (host
ops named ``cuda*``: syncs, copies, launches) inside it, once the span is
on the profiler's clock (``Tracer.profiler_ns``). None without the
device trace or that clock."""
import bisect
import statistics


def read(layer):
    if layer.trace is None:
        return None
    from repro_torch.obs import trace as obs_trace
    to_prof = getattr(obs_trace.get_tracer(), "profiler_ns", None)
    if to_prof is None:
        return None
    steps = sorted((s["ts"], s["ts"] + s["dur"]) for s in layer.spans
                   if s["name"] == "train.step")
    step_starts = [lo for lo, _ in steps]
    calls = sorted((s, e) for n, s, e in layer.trace.host_ops
                   if n.startswith("cuda"))
    call_starts = [s for s, _ in calls]
    per_step = []
    for c in layer.spans:
        if c["name"] != "train.compute":
            continue
        i = bisect.bisect_right(step_starts, c["ts"]) - 1
        if i < 0 or c["ts"] + c["dur"] > steps[i][1]:
            continue
        lo, hi = to_prof(c["ts"]), to_prof(c["ts"] + c["dur"])
        j = bisect.bisect_left(call_starts, lo)
        runtime_ns = 0
        while j < len(calls) and calls[j][0] < hi:
            if calls[j][1] <= hi:
                runtime_ns += calls[j][1] - calls[j][0]
            j += 1
        per_step.append(c["dur"] / 1e3 - runtime_ns / 1e6)
    return statistics.median(per_step) if per_step else None
