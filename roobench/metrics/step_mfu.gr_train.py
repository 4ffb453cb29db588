"""The hstu-gr training steps' model FLOPs over the traced window, as a
share of the card's fastest fp32-accurate rate: forward and backward on
each request's real rows and the mask's kept cells, padding not counted
(``yardstick_gr_train.gr_train_flops``)."""
from roobench import yardstick as Y


def read(layer):
    flops = layer.counts.get("train_flops")
    if not flops or layer.trace is None:
        return None
    return 100.0 * flops / (layer.trace.window_s * Y.FP32_ACCURATE_FLOP_S)
