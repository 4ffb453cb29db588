"""The training steps' model FLOPs (forward and backward, counted from
the shapes by ``yardstick.dlrm_train_flops``) over the traced window, as a
share of the card's fastest fp32-accurate rate."""
from roobench import yardstick as Y


def read(layer):
    flops = layer.counts.get("train_flops")
    if not flops or layer.trace is None:
        return None
    return 100.0 * flops / (layer.trace.window_s * Y.FP32_ACCURATE_FLOP_S)
