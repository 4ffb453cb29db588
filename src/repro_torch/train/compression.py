"""Gradient compression with error feedback for a cross-pod all-reduce
(torch port of ``repro/train/compression.py``).

bf16 halves and int8 (one per-tensor scale) quarters the bytes of a dense
gradient's all-reduce; error feedback (Karimireddy et al. 2019) carries
the quantization residual so compression adds no bias.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def ef_init(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compress_bf16(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.bfloat16)


def decompress_bf16(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.float32)


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_grads(grads: Any, error: Any,
                      mode: str = "bf16") -> Tuple[Any, Any]:
    """``(sent grads, new error)``: what the all-reduce would transport,
    and ``error' = (g + error) - decompress(compress(g + error))``."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        if mode == "bf16":
            sent = decompress_bf16(compress_bf16(g32))
        elif mode == "int8":
            sent = decompress_int8(*compress_int8(g32))
        else:
            sent = g32
        return sent, g32 - sent

    pairs = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return (unflatten(grads, [p[0] for p in pairs]),
            unflatten(error, [p[1] for p in pairs]))


def compressed_bytes(grads: Any, mode: str = "bf16") -> int:
    per = {"bf16": 2, "int8": 1, "none": 4}[mode]
    return sum(x.numel() * per for x in leaves(grads))
