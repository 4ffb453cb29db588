"""Plain MLP + initializer (torch port of ``repro/models/mlp.py``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.hstu import normal_init
from repro_torch.core.promote import matmul


def mlp_init(gen: torch.Generator, dims: Sequence[int], dtype=torch.float32,
             device="cuda") -> Dict:
    """dims = [in, h1, ..., out]; weights (in, out), ``x @ w + b``."""
    layers = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        w = normal_init(gen, (fan_in, fan_out),
                        (2.0 / (fan_in + fan_out)) ** 0.5, dtype, device)
        layers.append({"w": w, "b": torch.zeros((fan_out,), dtype=dtype,
                                                device=device)})
    return {"layers": layers}


def mlp_apply(params: Dict, x: torch.Tensor,
              activation: Callable = torch.relu,
              final_activation: Optional[Callable] = None) -> torch.Tensor:
    n = len(params["layers"])
    for i, lyr in enumerate(params["layers"]):
        x = matmul(x, lyr["w"]) + lyr["b"]
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


def mlp_flops(dims: Sequence[int], batch: int) -> int:
    return 2 * batch * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
