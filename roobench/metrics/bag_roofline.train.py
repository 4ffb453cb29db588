"""B5 and B6 (``kernels/csrc/embedding_bag.cu``) in training: the least
time their bytes need at the memory peak over their device time."""
from roobench import yardstick as Y

KERNELS = ("embedding_bag_fwd", "embedding_bag_bwd")


def read(layer):
    if layer.trace is None or not layer.counts.get("bag_bytes"):
        return None
    t = layer.trace.kernel_seconds(KERNELS)
    return Y.roofline_share(0, layer.counts["bag_bytes"], t) if t > 0 else None
