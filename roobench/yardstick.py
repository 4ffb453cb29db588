"""The benchmark's frozen yardstick: the card's peaks and the operations and
bytes each measured piece of work needs, computed from shapes alone.

Nothing here reads the program: a later change to the program cannot move
the ruler it is measured with.

Peaks are NVIDIA's published dense rates for one H100 SXM at its full 700 W
power limit (the run prints the card's own limit beside every number).

- ``FP32_ACCURATE_FLOP_S`` (165 TFLOP/s) is the fastest rate at which the
  card computes a float32-accurate product: three TF32 tensor-core products
  per model product (495 / 3). The port's split-TF32 kernels (B1-B4, B7)
  compute this way, and an fp32 GEMM with TF32 off runs on the CUDA cores
  at ``FP32_CUDA_CORE_FLOP_S`` (67 TFLOP/s), below it. So every fp32 model
  FLOP is bounded at 165 TFLOP/s and no share of it can pass 100 %.
- ``HBM_BYTES_S``: 3.35 TB/s.

Byte counts follow one rule: each input byte the work needs is read once
and each output byte is written once, whatever a kernel reads again.
"""
from __future__ import annotations

from typing import Sequence

TF32_FLOP_S = 495e12
FP32_ACCURATE_FLOP_S = TF32_FLOP_S / 3
FP32_CUDA_CORE_FLOP_S = 67e12
BF16_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12

F32 = 4
I32 = 4


# ---------------------------------------------------------------------------
# dense layers
# ---------------------------------------------------------------------------

def mlp_fwd_flops(dims: Sequence[int], rows: int) -> int:
    """2 x MACs of ``x @ w`` through the layers ``dims[0] -> ... -> dims[-1]``
    at ``rows`` rows (biases and activations not counted)."""
    return 2 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def mlp_bwd_flops(dims: Sequence[int], rows: int,
                  input_grad: bool) -> int:
    """Backward of :func:`mlp_fwd_flops`: each layer's weight gradient and
    its input gradient (the first layer's only when ``input_grad``)."""
    fwd = [2 * rows * a * b for a, b in zip(dims[:-1], dims[1:])]
    return 2 * sum(fwd) - (0 if input_grad else fwd[0])


# ---------------------------------------------------------------------------
# dlrm
# ---------------------------------------------------------------------------

def dlrm_n_pairs(n_sparse: int) -> int:
    """Pairs of the strict lower triangle of the (n_sparse + 1)^2 Gram."""
    f1 = n_sparse + 1
    return f1 * (f1 - 1) // 2


def dlrm_top_dims(cfg: dict) -> list:
    """The top MLP's widths from its input on: the interaction's width
    (the dense output and the pairs) and then every published layer size
    (MLPerf's ``--arch-mlp-top``)."""
    return [cfg["embed_dim"] + dlrm_n_pairs(len(cfg["vocabs"]))] + list(
        cfg["top_mlp"])


def dlrm_fwd_flops(cfg: dict, b_ro: int, b_nro: int) -> int:
    """Forward of the request-only DLRM: the bottom MLP at B_RO, the dot
    interaction's needed pairs (2 * pairs * D an impression) and the top
    MLP at B_NRO."""
    inter = 2 * dlrm_n_pairs(len(cfg["vocabs"])) * cfg["embed_dim"] * b_nro
    return (mlp_fwd_flops(cfg["bot_mlp"], b_ro) + inter
            + mlp_fwd_flops(dlrm_top_dims(cfg), b_nro))


def dlrm_train_flops(cfg: dict, b_ro: int, b_nro: int) -> int:
    """Forward and backward of one training step: every GEMM's weight and
    input gradients (not the dense features' own gradient) and the
    interaction's two operand gradients."""
    inter = 2 * dlrm_n_pairs(len(cfg["vocabs"])) * cfg["embed_dim"] * b_nro
    top = dlrm_top_dims(cfg)
    return (dlrm_fwd_flops(cfg, b_ro, b_nro) + 2 * inter
            + mlp_bwd_flops(cfg["bot_mlp"], b_ro, input_grad=False)
            + mlp_bwd_flops(top, b_nro, input_grad=True))


def bag_fwd_bytes(distinct_rows: int, n_slots: int, n_bags: int, dim: int,
                  elem: int = F32) -> int:
    """B5: each distinct row its valid slots name, the ids, the lengths,
    and the pooled output."""
    return (distinct_rows * dim * elem + n_slots * I32 + n_bags * I32
            + n_bags * dim * elem)


def bag_bwd_bytes(n_slots: int, n_bags: int, dim: int,
                  elem: int = F32) -> int:
    """B6: the output gradient g, the ids, the lengths, and one COO row a
    slot written (all B * L * D rows)."""
    return (n_bags * dim * elem + n_slots * I32 + n_bags * I32
            + n_slots * dim * elem)


# ---------------------------------------------------------------------------
# hstu-gr
# ---------------------------------------------------------------------------

def hstu_kept_cells(hist: int, targets: int) -> int:
    """Cells the ROO mask keeps for one request and head: the history's
    causal triangle, every target against the history, each target
    against itself."""
    return hist * (hist + 1) // 2 + targets * hist + targets


def hstu_attn_flops(cfg: dict, hist: int, targets: int) -> int:
    """B1's model FLOPs for one request and layer: Q K^T and A V on the
    kept cells, every head."""
    return (2 * (cfg["d_qk"] + cfg["d_v"]) * cfg["n_heads"]
            * hstu_kept_cells(hist, targets))


def hstu_attn_bytes(cfg: dict, hist: int, targets: int) -> int:
    """B1's bytes for one request and layer: q, k and v of the rows the
    mask keeps read once, their output rows written once, every head."""
    rows = hist + targets
    per_row = (2 * cfg["d_qk"] + 2 * cfg["d_v"]) * F32
    return cfg["n_heads"] * rows * per_row


def hstu_rab_bytes(cfg: dict) -> int:
    """The relative-position bias row each B1 launch reads, every head."""
    return cfg["n_heads"] * (2 * cfg["max_rel_pos"] + 1) * F32


def gr_fwd_flops(cfg: dict, hist: int, targets: int) -> int:
    """Forward FLOPs of one ranking request on its real rows: per layer the
    fused U/V/Q/K projection, the attention's kept cells and the output
    projection, then the task head on the targets."""
    h, dqk, dv, d = cfg["n_heads"], cfg["d_qk"], cfg["d_v"], cfg["d_model"]
    rows = hist + targets
    per_layer = (2 * rows * d * h * (2 * dv + 2 * dqk)
                 + hstu_attn_flops(cfg, hist, targets)
                 + 2 * rows * h * dv * d)
    head = mlp_fwd_flops([d, 2 * d, cfg["n_tasks"]], targets)
    return cfg["n_layers"] * per_layer + head


def roofline_share(flops: float, nbytes: float, seconds: float,
                   flop_s: float = FP32_ACCURATE_FLOP_S) -> float:
    """Least time (the larger of FLOPs over the compute peak and bytes over
    the memory peak) over the measured device time, in %."""
    return 100.0 * max(flops / flop_s, nbytes / HBM_BYTES_S) / seconds
