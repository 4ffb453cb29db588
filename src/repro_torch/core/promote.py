"""jnp's type promotion for the products torch will not mix.

A bf16 model's weights meet fp32 operands in the reference's products
(the batch's dense features, sums that jnp promoted before), and jnp
computes such a product in the promoted dtype: fp32 against bf16 is fp32.
torch's ``@`` and ``einsum`` refuse mixed dtypes, so the port's models
multiply through these two. On operands of one dtype they are ``@`` and
``torch.einsum`` themselves. :func:`promoted` casts operands to that dtype
for an op that takes one dtype, such as the dot interaction's kernel B7
(the reference concatenates its operands, which promotes them).
"""
from __future__ import annotations

import functools

import torch


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the two operands' promoted dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def promoted(*operands: torch.Tensor) -> tuple:
    """The operands cast to their promoted dtype (each one that has it
    already is returned as it is)."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return tuple(o.to(dt) for o in operands)


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' promoted dtype."""
    return torch.einsum(equation, *promoted(*operands))
