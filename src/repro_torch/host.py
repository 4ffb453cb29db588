"""Host copies of tensors: numpy arrays, bfloat16 by its bits.

numpy has no bfloat16 (the reference gets one from ``ml_dtypes``, which the
port does not use), so a bf16 tensor's host copy holds its bits, two bytes
an element, under :data:`BF16_BITS`, a one-field dtype that names them. The
serving engine keeps user states and cached rows so, checkpoints and
``interop`` carry bf16 leaves so, and :func:`device_copy` puts the same
bits back. :func:`bf16_bits` also takes the reference's ``ml_dtypes``
arrays (dtype name ``bfloat16``) by their bits.
"""
from __future__ import annotations

import numpy as np
import torch

BF16_BITS = np.dtype([("bfloat16", np.uint16)])


def is_bf16(a: np.ndarray) -> bool:
    """True for a host array of bf16 values: :data:`BF16_BITS` or the
    reference's ``ml_dtypes.bfloat16``."""
    return a.dtype == BF16_BITS or a.dtype.name == "bfloat16"


def host_copy(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy (a bf16 tensor as its bits, in
    :data:`BF16_BITS`). A CPU tensor's copy is a view of its memory."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """A bf16 host array (either kind :func:`is_bf16` takes) as its bits,
    ``uint16`` of the same shape (0-d stays 0-d)."""
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    return a.view(np.uint16)


def device_copy(a: np.ndarray, device) -> torch.Tensor:
    """The inverse of :func:`host_copy`, onto ``device``: the same bits. A
    CPU result shares ``a``'s memory where ``a`` is contiguous."""
    if is_bf16(a):
        return torch.from_numpy(bf16_bits(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)
