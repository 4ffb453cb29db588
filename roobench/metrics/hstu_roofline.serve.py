"""B1 (``kernels/csrc/hstu_attention_fwd.cu``) in serving: the least time
of the window's B1 launches taken together (the larger of their kept
cells' FLOPs at the split-TF32 peak and their bytes at the memory peak)
over B1's device time."""
from roobench import yardstick as Y

KERNELS = ("hstu_fwd_kernel",)


def read(layer):
    c = layer.counts
    if layer.trace is None or not c.get("b1_flops"):
        return None
    t = layer.trace.kernel_seconds(KERNELS)
    return Y.roofline_share(c["b1_flops"], c["b1_bytes"], t) if t > 0 else None
