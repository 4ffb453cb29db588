"""The scored requests' forward model FLOPs on their real rows
(``yardstick.gr_fwd_flops``) over the traced window, as a share of the
card's fastest fp32-accurate rate."""
from roobench import yardstick as Y


def read(layer):
    flops = layer.counts.get("fwd_flops")
    if not flops or layer.trace is None:
        return None
    return 100.0 * flops / (layer.trace.window_s * Y.FP32_ACCURATE_FLOP_S)
