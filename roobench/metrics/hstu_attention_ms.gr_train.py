"""The card's time of a training step's HSTU attention: the median over
the window's ``train.step`` spans of the summed ``device_ms`` of the
``hstu.attention`` (B1, one a layer) and ``hstu.attention_bwd`` (B2, the
drab sum and B3, one a layer) spans inside each, by time (the backward's
run on autograd's thread). A step with a span the card had not timed
gives no number; None without any."""
import bisect
import statistics

NAMES = ("hstu.attention", "hstu.attention_bwd")


def read(layer):
    spans = layer.spans
    steps = sorted((s["ts"], s["ts"] + s["dur"]) for s in spans
                   if s["name"] == "train.step")
    own = sorted((s["ts"], s["ts"] + s["dur"], s["args"].get("device_ms"))
                 for s in spans if s["name"] in NAMES)
    starts = [o[0] for o in own]
    per_step = []
    for lo, hi in steps:
        inside = [ms for _, end, ms in own[bisect.bisect_left(starts, lo):
                                           bisect.bisect_right(starts, hi)]
                  if end <= hi]
        if inside and None not in inside:
            per_step.append(sum(inside))
    return statistics.median(per_step) if per_step else None
