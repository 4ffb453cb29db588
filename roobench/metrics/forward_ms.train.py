"""The card's time of a training step's forward: the median over the
window's ``train.step`` spans of the summed ``device_ms`` of the
``train.forward`` spans inside each (``train/loop.py`` and
``embeddings/sparse.py``, one a microbatch). ``phase_ms`` serves the
trainer's other phase readers."""
import bisect
import statistics


def phase_ms(spans, name):
    """The median over the ``train.step`` spans of the summed ``device_ms``
    of the ``name`` spans that lie inside each, by time (spans of
    autograd's backward carry another thread's id). A step with a span the
    card had not timed gives no number; None without any."""
    steps = sorted((s["ts"], s["ts"] + s["dur"]) for s in spans
                   if s["name"] == "train.step")
    own = sorted(((s["ts"], s["ts"] + s["dur"], s["args"].get("device_ms"))
                  for s in spans if s["name"] == name), key=lambda o: o[0])
    starts = [o[0] for o in own]
    per_step = []
    for lo, hi in steps:
        inside = [ms for _, end, ms in own[bisect.bisect_left(starts, lo):
                                           bisect.bisect_right(starts, hi)]
                  if end <= hi]
        if inside and None not in inside:
            per_step.append(sum(inside))
    return statistics.median(per_step) if per_step else None


def read(layer):
    return phase_ms(layer.spans, "train.forward")
