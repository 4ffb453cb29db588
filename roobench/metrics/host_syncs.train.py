"""The card's syncs a training step: the ``syncs`` args (the program's
sync counter, ``obs.trace``) of the spans inside the window's
``train.step`` spans, the steps' own included, over the number of steps.
None where the program counts no syncs."""
import bisect


def read(layer):
    steps = sorted((s["ts"], s["ts"] + s["dur"]) for s in layer.spans
                   if s["name"] == "train.step")
    if not steps:
        return None
    from repro_torch.obs import trace as obs_trace
    if not getattr(obs_trace.get_tracer(), "counting_syncs", False):
        return None
    starts = [lo for lo, _ in steps]
    n = 0
    for s in layer.spans:
        i = bisect.bisect_right(starts, s["ts"]) - 1
        if i >= 0 and s["ts"] + s["dur"] <= steps[i][1]:
            n += s["args"].get("syncs", 0)
    return n / len(steps)
