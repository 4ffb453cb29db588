"""Feature interactions: the DLRM dot interaction and the DCNv2 cross
network (torch port of ``repro/models/interactions.py``).

``dot_interaction`` is the MLPerf-DLRM op (pairwise dots between the dense
output and the sparse embeddings, lower triangle flattened, dense output
first). The reference computes it with a plain einsum, the oracle of its
Pallas kernel; the port routes it through the kernel's entry point
(``kernels/dot_interaction.py``), so on a CUDA tensor it runs B7 and on a
CPU tensor the plain version. The reference concatenates the two operands
first, which promotes them: a bf16 DLRM's fp32 bottom-MLP output beside
its bf16 bags interacts in fp32. The port casts both to the promoted dtype
before the kernel, whose operands share one dtype; the cast's backward
hands each operand its gradient in its own dtype, as the reference's does.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.hstu import normal_init
from repro_torch.core.promote import matmul, promoted
from repro_torch.kernels import dot_interaction as _dot


def dot_interaction(dense_out: torch.Tensor, sparse_embs: torch.Tensor,
                    self_interaction: bool = False) -> torch.Tensor:
    """dense_out: (B, D); sparse_embs: (B, F, D) with the same D.

    Returns (B, D + F'*(F'+offset)//2) where F' = F+1 (dense row included),
    offset -1 (strict lower triangle) or 0 under ``self_interaction``.
    """
    dense_out, sparse_embs = promoted(dense_out, sparse_embs)
    return _dot.dot_interaction(dense_out, sparse_embs,
                                self_interaction=self_interaction)


def dcnv2_init(gen: torch.Generator, dim: int, n_layers: int, rank: int = 0,
               dtype=torch.float32, device="cuda") -> Dict:
    """DCNv2 cross network; rank > 0 uses the low-rank (DCN-Mix) variant."""
    layers = []
    for _ in range(n_layers):
        if rank and rank < dim:
            layers.append({
                "u": normal_init(gen, (dim, rank), dim ** -0.5, dtype,
                                 device),
                "v": normal_init(gen, (rank, dim), rank ** -0.5, dtype,
                                 device),
                "b": torch.zeros((dim,), dtype=dtype, device=device)})
        else:
            layers.append({
                "w": normal_init(gen, (dim, dim), dim ** -0.5, dtype, device),
                "b": torch.zeros((dim,), dtype=dtype, device=device)})
    return {"layers": layers}


def dcnv2_apply(params: Dict, x0: torch.Tensor) -> torch.Tensor:
    """x_{l+1} = x0 * (W x_l + b) + x_l."""
    x = x0
    for lyr in params["layers"]:
        if "u" in lyr:
            wx = matmul(matmul(x, lyr["u"]), lyr["v"]) + lyr["b"]
        else:
            wx = matmul(x, lyr["w"]) + lyr["b"]
        x = x0 * wx + x
    return x
