"""DLRM dot interaction: the hand-written CUDA kernel B7 (forward), its build
and binding, its plain torch version, and :class:`DotInteractionFn`, the
autograd Function that runs it on the card.

Port of ``repro/kernels/dot_interaction.py:_kernel`` (the Pallas TPU
kernel). The kernel source is ``csrc/dot_interaction.cu``; its header
comment says what bounds it on an H100 and what the design does about it.
It is built and loaded like the other kernels
(``hstu_attention.build_library``: nvcc ``sm_90a`` into ``build/kernels/``
at first use, plain C interface, ``ctypes``); nothing is built at import
time, so the CPU tests import this module.

:func:`dot_interaction_cuda` launches B7 on CUDA tensors or raises; there
is no fallback. It refuses inputs that require grad under grad mode, so
autograd reaches the kernel only through :class:`DotInteractionFn`.
``launch_count`` counts its launches. The plain version it is held against
is :func:`dot_interaction_plain` (the oracle of ``kernels/ref.py``).

:func:`dot_interaction` is the entry point: it resolves the backend through
``kernels/dispatch.py`` (``cuda`` on a CUDA tensor, the plain ``torch``
path on a CPU tensor or by explicit choice).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.hstu_attention import build_library, refuse_grad
from repro_torch.kernels.ref import dot_interaction_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "dot_interaction.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# a warp holds its share of a sample's rows in registers, up to 4 row
# blocks of 16
MAX_D = 256              # largest embedding width the kernel takes
MAX_F1 = 64              # largest number of rows of T = [dense; sparse]

# the plain torch version the kernel is held against
dot_interaction_plain = dot_interaction_ref

launch_count = 0         # B7 launches since the last reset
_lib = None              # the loaded ctypes library


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def build() -> Tuple[Path, str]:
    """Compile the kernel (see ``hstu_attention.build_library``)."""
    return build_library(SOURCE)


def _load():
    global _lib
    if _lib is None:
        import ctypes
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dot_interaction_fwd.argtypes = [vp] * 3 + [i] * 5 + [vp]
        lib.dot_interaction_fwd.restype = i
        lib.dot_interaction_fwd_samples_per_block.argtypes = [i] * 5
        lib.dot_interaction_fwd_samples_per_block.restype = i
        lib.dot_interaction_fwd_warps_per_sample.argtypes = [i] * 3
        lib.dot_interaction_fwd_warps_per_sample.restype = i
        lib.dot_interaction_error_string.argtypes = [i]
        lib.dot_interaction_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def n_pairs(f1: int, self_interaction: bool = False) -> int:
    """Kept pairs of an (F1, F1) Gram matrix: the strict lower triangle, or
    with its diagonal."""
    return f1 * (f1 + 1) // 2 if self_interaction else f1 * (f1 - 1) // 2


def samples_per_block(b: int, f: int, d: int, self_interaction: bool = False,
                      dtype: torch.dtype = torch.float32) -> int:
    """The samples a block B7 uses at this shape, as the built library
    chooses them (builds and loads it: card only)."""
    return _load().dot_interaction_fwd_samples_per_block(
        b, f, d, int(self_interaction), DTYPES[dtype])


def warps_per_sample(b: int, f: int, d: int) -> int:
    """The warps a sample B7 uses at this shape (the k split), as the built
    library chooses them (builds and loads it: card only)."""
    return _load().dot_interaction_fwd_warps_per_sample(b, f, d)


def dot_interaction_cuda(dense_out: torch.Tensor, sparse_embs: torch.Tensor,
                         self_interaction: bool = False) -> torch.Tensor:
    """Launch B7: ``(B, D + P)`` = dense_out ++ the kept pairwise dots of
    T = [dense_out; sparse_embs], for ``dense_out (B, D)`` and
    ``sparse_embs (B, F, D)``, both contiguous, of one dtype (fp32 or
    bf16), on one CUDA device. Same contract as
    :func:`dot_interaction_plain`; raises on anything the kernel does not
    take and on an input that requires grad under grad mode."""
    global launch_count
    refuse_grad("dot_interaction_cuda", dense_out, sparse_embs)
    # no quiet cast: a caller that mixes dtypes promotes first, as
    # models/interactions.py does
    if dense_out.dtype not in DTYPES or sparse_embs.dtype != dense_out.dtype:
        raise TypeError(f"dense_out and sparse_embs must share one dtype, "
                        f"fp32 or bf16; got {dense_out.dtype} and "
                        f"{sparse_embs.dtype}")
    if dense_out.device.type != "cuda" or sparse_embs.device != \
            dense_out.device:
        raise ValueError(f"the dot-interaction CUDA kernel needs both inputs "
                         f"on one CUDA device, got {dense_out.device} and "
                         f"{sparse_embs.device}")
    if dense_out.dim() != 2 or sparse_embs.dim() != 3 \
            or sparse_embs.shape[0] != dense_out.shape[0] \
            or sparse_embs.shape[2] != dense_out.shape[1]:
        raise ValueError(f"dense_out must be (B, D) and sparse_embs (B, F, D), "
                         f"got {tuple(dense_out.shape)} and "
                         f"{tuple(sparse_embs.shape)}")
    if not (dense_out.is_contiguous() and sparse_embs.is_contiguous()):
        raise ValueError("dense_out and sparse_embs must be contiguous")
    b, d = dense_out.shape
    f1 = sparse_embs.shape[1] + 1
    if not 1 <= d <= MAX_D or f1 > MAX_F1:
        raise ValueError(f"D={d}, F+1={f1}: the kernel holds a sample's rows "
                         f"in registers, up to 4 row blocks of 16, and takes "
                         f"1 <= D <= {MAX_D} and F+1 <= {MAX_F1}")
    if b >= 2 ** 31:
        raise ValueError("too many samples for the kernel's grid")
    width = d + n_pairs(f1, self_interaction)
    out = torch.empty((b, width), device=dense_out.device,
                      dtype=dense_out.dtype)
    if b == 0:
        return out
    lib = _load()
    with torch.cuda.device(dense_out.device):
        stream = torch.cuda.current_stream(dense_out.device).cuda_stream
        err = lib.dot_interaction_fwd(
            dense_out.data_ptr(), sparse_embs.data_ptr(), out.data_ptr(), b,
            f1 - 1, d, int(self_interaction), DTYPES[dense_out.dtype], stream)
    if err != 0:
        msg = lib.dot_interaction_error_string(err).decode()
        raise RuntimeError(f"dot_interaction_fwd launch failed: {msg} ({err})")
    launch_count += 1
    return out


class DotInteractionFn(torch.autograd.Function):
    """The dot interaction as one differentiable op on the card: forward
    B7, backward plain torch. The reference has no backward kernel for
    this op (its gradient is autodiff of the einsum), so the backward's
    ``torch.bmm`` is a plain product outside any kernel, as the reference
    leaves it to XLA. With g = (g_dense, g_pairs), the pairs' gradient is
    scattered into the kept triangle G (B, F1, F1); then dT = (G + Gᵀ) T,
    d_dense = g_dense + dT[:, 0] and d_sparse = dT[:, 1:], in fp32 (fp64
    for fp64 inputs, which only the tests' stand-in forward takes). The
    scatter's indices are unique and nothing uses atomics, so two backward
    calls give the same bits.

    ``apply(dense_out, sparse_embs, self_interaction)``; inputs contiguous,
    fp32 or bf16, on a CUDA device.
    """

    @staticmethod
    def forward(ctx, dense_out, sparse_embs, self_interaction):
        out = dot_interaction_cuda(dense_out, sparse_embs, self_interaction)
        ctx.save_for_backward(dense_out, sparse_embs)
        ctx.self_interaction = self_interaction
        return out

    @staticmethod
    def backward(ctx, grad_out):
        dense_out, sparse_embs = ctx.saved_tensors
        b, d = dense_out.shape
        f1 = sparse_embs.shape[1] + 1
        acc = torch.promote_types(dense_out.dtype, torch.float32)
        t = torch.cat([dense_out[:, None, :], sparse_embs], dim=1).to(acc)
        i, j = torch.tril_indices(f1, f1, offset=0 if ctx.self_interaction
                                  else -1, device=t.device)
        g = torch.zeros((b, f1, f1), device=t.device, dtype=acc)
        g[:, i, j] = grad_out[:, d:].to(acc)
        dt = torch.bmm(g + g.transpose(1, 2), t)
        d_dense = (grad_out[:, :d].to(acc) + dt[:, 0]).to(dense_out.dtype)
        return d_dense, dt[:, 1:].to(sparse_embs.dtype), None


def dot_interaction(dense_out: torch.Tensor, sparse_embs: torch.Tensor, *,
                    self_interaction: bool = False,
                    backend: Optional[str] = None) -> torch.Tensor:
    """dense_out: (B, D); sparse_embs: (B, F, D). Returns (B, D + P):
    dense_out, then the dots of T = [dense_out; sparse_embs] below the
    diagonal (on it too under ``self_interaction``) in row-major tril
    order. Differentiable w.r.t. both inputs on every backend. ``backend``
    resolves through ``kernels/dispatch.py`` when None (``cuda`` on a CUDA
    tensor, ``torch`` otherwise; ``REPRO_TORCH_DOT_BACKEND`` honored)."""
    from repro_torch.kernels import dispatch
    be = dispatch.resolve_dot_backend(backend, dense_out.device)
    if be == "torch":
        return dot_interaction_plain(dense_out, sparse_embs, self_interaction)
    if dense_out.device.type != "cuda":
        raise ValueError(f"dot-interaction backend 'cuda' needs CUDA "
                         f"tensors, got {dense_out.device}")
    return DotInteractionFn.apply(dense_out.contiguous(),
                                  sparse_embs.contiguous(), self_interaction)
