"""B5 (``kernels/csrc/embedding_bag.cu``) in scoring: the least time its
bytes need at the memory peak over its device time."""
from roobench import yardstick as Y

KERNELS = ("embedding_bag_fwd",)


def read(layer):
    if layer.trace is None or not layer.counts.get("b5_bytes"):
        return None
    t = layer.trace.kernel_seconds(KERNELS)
    return Y.roofline_share(0, layer.counts["b5_bytes"], t) if t > 0 else None
