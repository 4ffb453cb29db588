"""Feature interactions: the DCNv2 cross network (torch port of
``repro/models/interactions.py``). The DLRM dot interaction comes with its
kernel (B7).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.hstu import normal_init


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
            wx = (x @ lyr["u"]) @ lyr["v"] + lyr["b"]
        else:
            wx = x @ lyr["w"] + lyr["b"]
        x = x0 * wx + x
    return x
