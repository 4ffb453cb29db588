"""B1, B2 and B3 (``kernels/csrc/hstu_attention_{fwd,bwd}.cu``) in hstu-gr
training: the least time of the window's attention forward (B1) and
backward (B2 and B3 together: what the backward needs once, not what each
kernel recomputes), each the larger of its kept cells' FLOPs at the
split-TF32 peak and its bytes at the memory peak (``yardstick_gr_train``),
summed, over the three kernels' device time."""
from roobench import yardstick_gr_train as YT

KERNELS = ("hstu_fwd_kernel", "hstu_bwd_dq_kernel", "hstu_bwd_dkv_kernel")
PARTS = ("b1", "bwd")


def read(layer):
    c = layer.counts
    if layer.trace is None or not all(c.get(f"{k}_flops") for k in PARTS):
        return None
    t = layer.trace.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    least = sum(YT.least_seconds(c[f"{k}_flops"], c[f"{k}_bytes"])
                for k in PARTS)
    return 100.0 * least / t
