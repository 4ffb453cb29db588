"""The yardstick's counts for hstu-gr training, from shapes alone: a
training step's model FLOPs and the least FLOPs and bytes of the
attention's backward (B2: dq and drab, B3: dk and dv, counted together). Peaks and the byte
rule are ``yardstick.py``'s (each input byte read once, each output byte
written once); nothing here reads the program.

Counts are for one ranking request on its real rows (``hist`` history
events, ``targets`` impressions) and one layer, as ``yardstick.py``'s
forward counts are, except where a name says a whole step.
"""
from __future__ import annotations

from roobench import yardstick as Y


def gr_train_flops(cfg: dict, hist: int, targets: int) -> int:
    """Model FLOPs of one request in a training step, all layers and the
    task head: the forward (``yardstick.gr_fwd_flops``) and a backward of
    twice it. Each GEMM's backward is its weight and its input gradient
    (the embeddings take gradients, so the first layer's input too); the
    attention's is four products on the kept cells (g V^T, A^T g, dS K,
    dS^T Q). What a kernel computes again (B2 and B3 recompute the
    scores) is not model work and is not counted."""
    return 3 * Y.gr_fwd_flops(cfg, hist, targets)


def bwd_flops(cfg: dict, hist: int, targets: int) -> int:
    """The attention backward's least FLOPs for one request and layer,
    every head, whatever kernels compute it: on each kept cell the scores
    q k^T once (the forward keeps no S x S residual), g v^T once, and
    dS k, dS^T q and A^T g. B2 and B3 each recompute the scores and g v^T
    (B2 4 Dqk + 2 Dv, B3 4 (Dqk + Dv) a cell, 1.4x this at Dqk = Dv);
    that duplicate is the split's cost, not work the backward needs."""
    return ((6 * cfg["d_qk"] + 4 * cfg["d_v"]) * cfg["n_heads"]
            * Y.hstu_kept_cells(hist, targets))


def bwd_bytes(cfg: dict, hist: int, targets: int) -> int:
    """The attention backward's rows for one request and layer, every
    head: q, k, v and g of the real rows read once, dq, dk and dv
    written once."""
    per_row = (4 * cfg["d_qk"] + 3 * cfg["d_v"]) * Y.F32
    return cfg["n_heads"] * (hist + targets) * per_row


def attention_step(cfg: dict, hists, targets) -> dict:
    """The attention's forward (B1) and backward (B2 and B3 together)
    over one training step of requests with these history and target
    counts, all layers: ``{"b1_flops", "b1_bytes", "bwd_flops",
    "bwd_bytes"}``. A layer's forward reads the rab row once; its
    backward reads it once and writes drab once."""
    rab = Y.hstu_rab_bytes(cfg)
    pairs = list(zip(hists, targets))
    one = {
        "b1_flops": sum(Y.hstu_attn_flops(cfg, h, t) for h, t in pairs),
        "b1_bytes": sum(Y.hstu_attn_bytes(cfg, h, t) for h, t in pairs)
        + rab,
        "bwd_flops": sum(bwd_flops(cfg, h, t) for h, t in pairs),
        "bwd_bytes": sum(bwd_bytes(cfg, h, t) for h, t in pairs) + 2 * rab}
    return {k: cfg["n_layers"] * v for k, v in one.items()}


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time of a piece of work: the larger of its FLOPs at the
    fp32-accurate compute peak and its bytes at the memory peak."""
    return max(flops / Y.FP32_ACCURATE_FLOP_S, nbytes / Y.HBM_BYTES_S)
