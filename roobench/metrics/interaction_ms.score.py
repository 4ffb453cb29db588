"""The card's time of a scored batch's interaction: the median
``device_ms`` of the program's ``dlrm.interaction`` spans
(``models/dlrm.py``: the two concatenations, the fanout and B7). The
scoring driver hands no spans, so this reads the program's tracer and
keeps the spans that lie, on the profiler's clock
(``Tracer.profiler_ns``), inside the extent of the traced window's host
ops. None without the device trace or that clock."""
import statistics


def read(layer):
    if layer.trace is None or not layer.trace.host_ops:
        return None
    from repro_torch.obs import trace as obs_trace
    tracer = obs_trace.get_tracer()
    to_prof = getattr(tracer, "profiler_ns", None)
    if to_prof is None:
        return None
    lo = min(s for _, s, _ in layer.trace.host_ops)
    hi = max(e for _, _, e in layer.trace.host_ops)
    ms = [s["args"]["device_ms"] for s in tracer.events()
          if s.get("name") == "dlrm.interaction"
          and "device_ms" in s["args"] and lo <= to_prof(s["ts"])
          and to_prof(s["ts"] + s["dur"]) <= hi]
    return statistics.median(ms) if ms else None
