"""Embedding bag: the hand-written CUDA kernels B5 (pooled forward) and B6
(COO-row backward), their build and binding, their plain torch versions,
and :class:`EmbeddingBagFn`, the autograd Function that runs both behind
one op.

Ports of ``repro/kernels/embedding_bag.py:_sum_kernel``/``_max_kernel``
(the Pallas TPU forward) and ``:_bwd_coo_kernel`` (its backward), and of the
``custom_vjp`` around them (``_bag_fused``). The kernel source is
``csrc/embedding_bag.cu``; its header comment says what bounds the kernels
on an H100 and what the design does about it. It is built and loaded like
the HSTU kernels (``hstu_attention.build_library``: nvcc ``sm_90a`` into
``build/kernels/`` at first use, plain C interface, ``ctypes``); nothing is
built at import time, so the CPU tests import this module.

:func:`embedding_bag_fwd_cuda` (B5) and :func:`embedding_bag_coo_rows_cuda`
(B6) launch one kernel each on CUDA tensors or raise; there is no fallback.
Both refuse inputs that require grad under grad mode, so autograd reaches
the kernels only through :class:`EmbeddingBagFn`. ``fwd_launch_count`` and
``coo_launch_count`` count their launches. The plain versions they are held
against are ``embedding_bag_fwd_plain`` and ``embedding_bag_coo_rows_plain``
(the oracles of ``kernels/ref.py``). Max pooling's backward is plain torch
on every device, as it is jnp code outside the Pallas kernel in the
reference.

:func:`embedding_bag` is the entry point: it resolves the backend through
``kernels/dispatch.py`` (``cuda`` on a CUDA table, the plain ``torch`` path
on a CPU table).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.embeddings.sparse import SparseRows
from repro_torch.kernels.hstu_attention import build_library, refuse_grad
from repro_torch.kernels.ref import (embedding_bag_coo_rows_ref,
                                     embedding_bag_max_coo_rows_ref,
                                     embedding_bag_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
POOLINGS = ("sum", "mean", "max")       # codes 0, 1, 2 in the source
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the plain torch versions the kernels are held against
embedding_bag_fwd_plain = embedding_bag_ref
embedding_bag_coo_rows_plain = embedding_bag_coo_rows_ref

fwd_launch_count = 0     # B5 launches since the last reset
coo_launch_count = 0     # B6 launches since the last reset
_lib = None              # the loaded ctypes library


def reset_launch_count() -> None:
    global fwd_launch_count, coo_launch_count
    fwd_launch_count = coo_launch_count = 0


def build() -> Tuple[Path, str]:
    """Compile both kernels (see ``hstu_attention.build_library``)."""
    return build_library(SOURCE)


def _load():
    global _lib
    if _lib is None:
        import ctypes
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.embedding_bag_fwd.argtypes = [vp] * 4 + [i] * 6 + [vp]
        lib.embedding_bag_bwd_coo.argtypes = [vp] * 5 + [i] * 6 + [vp]
        lib.embedding_bag_fwd.restype = i
        lib.embedding_bag_bwd_coo.restype = i
        lib.embedding_bag_error_string.argtypes = [i]
        lib.embedding_bag_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _index_operands(name: str, ids: torch.Tensor, lengths: torch.Tensor,
                    device: torch.device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(B, L) ids and (B,) lengths as contiguous int32 on ``device``."""
    if ids.dim() != 2 or lengths.shape != ids.shape[:1]:
        raise ValueError(f"{name}: ids must be (B, L) and lengths (B,), got "
                         f"{tuple(ids.shape)} and {tuple(lengths.shape)}")
    if ids.is_floating_point() or lengths.is_floating_point():
        raise TypeError(f"{name}: ids and lengths must be integers")
    if ids.numel() >= 2 ** 31:
        raise ValueError(f"{name}: too many ids for the kernel's indexing")
    return (ids.to(device=device, dtype=torch.int32).contiguous(),
            lengths.to(device=device, dtype=torch.int32).contiguous())


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.embedding_bag_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def embedding_bag_fwd_cuda(table: torch.Tensor, ids: torch.Tensor,
                           lengths: torch.Tensor,
                           pooling: str = "sum") -> torch.Tensor:
    """Launch B5: ``(B, D)`` pooled rows of ``table (V, D)`` (fp32 or bf16,
    contiguous, on a CUDA device) for ``ids (B, L)`` and ``lengths (B,)``.
    Same contract as :func:`embedding_bag_fwd_plain`; raises on anything the
    kernel does not take and on a table that requires grad under grad
    mode."""
    global fwd_launch_count
    refuse_grad("embedding_bag_fwd_cuda", table)
    if table.device.type != "cuda":
        raise ValueError(f"the embedding-bag CUDA kernel needs CUDA tensors, "
                         f"got {table.device}")
    if pooling not in POOLINGS:
        raise ValueError(f"unknown pooling {pooling!r}")
    if table.dim() != 2 or table.dtype not in DTYPES \
            or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous (V, D) fp32 or bf16 "
                         f"tensor, got {tuple(table.shape)} {table.dtype}")
    v, d = table.shape
    if not 0 < v < 2 ** 31 - 1 or d >= 2 ** 31:
        raise ValueError(f"table{tuple(table.shape)}: the kernel takes "
                         f"1..2**31-2 rows")
    ids32, len32 = _index_operands("embedding_bag_fwd_cuda", ids, lengths,
                                   table.device)
    b, l = ids32.shape
    out = torch.empty((b, d), device=table.device, dtype=table.dtype)
    if out.numel() == 0:
        return out
    _launch("embedding_bag_fwd", table.device, table.data_ptr(),
            ids32.data_ptr(), len32.data_ptr(), out.data_ptr(), b, l, v, d,
            POOLINGS.index(pooling), DTYPES[table.dtype])
    fwd_launch_count += 1
    return out


def embedding_bag_coo_rows_cuda(g: torch.Tensor, ids: torch.Tensor,
                                lengths: torch.Tensor, vocab: int,
                                pooling: str = "sum"
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B6: the COO gradient of a sum or mean bag, ``(ids (B*L,)
    int32, rows (B*L, D))`` for the output gradient ``g (B, D)`` (fp32 or
    bf16, contiguous, on a CUDA device). Same contract as
    :func:`embedding_bag_coo_rows_plain`."""
    global coo_launch_count
    refuse_grad("embedding_bag_coo_rows_cuda", g)
    if g.device.type != "cuda":
        raise ValueError(f"the embedding-bag CUDA kernel needs CUDA tensors, "
                         f"got {g.device}")
    if pooling not in ("sum", "mean"):
        raise ValueError(f"the COO-row kernel takes sum or mean pooling, got "
                         f"{pooling!r}")
    if g.dim() != 2 or g.dtype not in DTYPES or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous (B, D) fp32 or bf16 "
                         f"tensor, got {tuple(g.shape)} {g.dtype}")
    if not 0 < vocab < 2 ** 31 - 1:
        raise ValueError(f"vocab={vocab}: the kernel takes 1..2**31-2")
    ids32, len32 = _index_operands("embedding_bag_coo_rows_cuda", ids,
                                   lengths, g.device)
    b, l = ids32.shape
    d = g.shape[1]
    if g.shape[0] != b:
        raise ValueError(f"g{tuple(g.shape)} does not match ids{(b, l)}")
    if b * l * d >= 2 ** 62:
        raise ValueError("too many rows for the kernel's indexing")
    rows = torch.empty((b * l, d), device=g.device, dtype=g.dtype)
    out_ids = torch.empty((b * l,), device=g.device, dtype=torch.int32)
    if rows.numel() == 0:
        return out_ids.fill_(vocab), rows
    _launch("embedding_bag_bwd_coo", g.device, g.data_ptr(), ids32.data_ptr(),
            len32.data_ptr(), rows.data_ptr(), out_ids.data_ptr(), b, l,
            vocab, d, int(pooling == "mean"), DTYPES[g.dtype])
    coo_launch_count += 1
    return out_ids, rows


def embedding_bag_coo_grad(pooling: str, table: torch.Tensor,
                           ids: torch.Tensor, lengths: torch.Tensor,
                           out: torch.Tensor, g: torch.Tensor) -> SparseRows:
    """The bag's backward in its native form: COO row gradients keyed by
    the slot ids, invalid slots at the ``vocab`` sentinel. Sum and mean
    launch B6 on a CUDA ``g`` and take the plain version on a CPU one; max
    pooling (the even tie split over the slots that hold each maximum) is
    plain torch on every device. ``out`` is the forward's output."""
    v = table.shape[0]
    if pooling == "max":
        cids, rows = embedding_bag_max_coo_rows_ref(table, ids, lengths, out,
                                                    g)
    elif g.device.type == "cuda":
        cids, rows = embedding_bag_coo_rows_cuda(g, ids, lengths, v, pooling)
    else:
        cids, rows = embedding_bag_coo_rows_plain(g, ids, lengths, v, pooling)
    return SparseRows(cids, rows, v)


class EmbeddingBagFn(torch.autograd.Function):
    """The embedding bag as one differentiable op on the card: forward B5,
    backward B6 (or the max rule) then the densify, the port of the
    reference's ``_bag_fused`` custom_vjp. The table gets a dense (V, D)
    gradient (``SparseRows.to_dense``, which sums duplicate ids in a fixed
    order, without float atomics), so two backward calls give the same
    bits; ids and lengths get none.

    ``apply(table, ids, lengths, pooling)``; table contiguous fp32 or bf16
    on a CUDA device.
    """

    @staticmethod
    def forward(ctx, table, ids, lengths, pooling):
        out = embedding_bag_fwd_cuda(table, ids, lengths, pooling)
        ctx.save_for_backward(table, ids, lengths, out)
        ctx.pooling = pooling
        return out

    @staticmethod
    def backward(ctx, grad_out):
        table, ids, lengths, out = ctx.saved_tensors
        coo = embedding_bag_coo_grad(ctx.pooling, table, ids, lengths, out,
                                     grad_out.contiguous())
        return coo.to_dense(), None, None, None


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  lengths: torch.Tensor, pooling: str = "sum",
                  backend: Optional[str] = None) -> torch.Tensor:
    """table: (V, D); ids: (B, L) int; lengths: (B,). Returns (B, D) pooled
    embeddings (sum | mean | max); empty bags give zeros. Differentiable
    w.r.t. ``table`` on every backend. ``backend`` resolves through
    ``kernels/dispatch.py`` when None (``cuda`` on a CUDA table, ``torch``
    otherwise; ``REPRO_TORCH_EMB_BACKEND`` honored)."""
    from repro_torch.kernels import dispatch
    be = dispatch.resolve_emb_backend(backend, table.device)
    if pooling not in POOLINGS:
        raise ValueError(f"unknown pooling {pooling!r}")
    if be == "torch":
        return embedding_bag_fwd_plain(table, ids, lengths, pooling)
    if table.device.type != "cuda":
        raise ValueError(f"embedding-bag backend 'cuda' needs CUDA tensors, "
                         f"got {table.device}")
    return EmbeddingBagFn.apply(table.contiguous(), ids, lengths, pooling)
