"""HSTU pointwise attention backward: the hand-written CUDA kernels B2
(dq + drab) and B3 (dk + dv), their build and binding, their plain torch
version, and :class:`HSTUAttentionFn`, the autograd Function that runs the
forward kernel (B1) and these two behind one op.

Ports of ``repro/kernels/hstu_attention.py:_bwd_dq_kernel`` and
``:_bwd_dkv_kernel`` (the Pallas TPU backward) and of the ``custom_vjp``
around them (``_hstu_fused``). The kernel source is
``csrc/hstu_attention_bwd.cu``; its header comment says what bounds the
kernels on an H100 and how the drab reduction stays free of float atomics.
They are built and loaded like the forward (``hstu_attention.build_library``:
nvcc ``sm_90a`` into ``build/kernels/`` at first use, plain C interface,
``ctypes``); nothing is built at import time.

:func:`hstu_attention_bwd_dq_cuda` (B2) and :func:`hstu_attention_bwd_dkv_cuda`
(B3) launch one kernel each on CUDA tensors or raise — there is no fallback;
:func:`hstu_attention_bwd_cuda` runs both and returns ``(dq, dk, dv, drab)``.
``dq_launch_count`` and ``dkv_launch_count`` count their launches.
:func:`hstu_attention_bwd_plain` (the dense oracle of ``kernels/ref.py``:
fp32 inside, each gradient rounded once to its operand's dtype) is what
they are held against. Dtypes as the forward's (``hstu_attention``'s
module note): q, k, v and g fp32 or bf16, one dtype; dq, dk and dv come
back in it and drab in rab's dtype; bf16 through the ``_bf16`` entry
points.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import hstu_attention as fwd
from repro_torch.kernels.hstu_attention import (MAX_D, MAX_REL_POS,
                                                MAX_SMEM_BYTES, build_library,
                                                check_operand, rab_operand,
                                                symbol)
from repro_torch.kernels.ref import hstu_attention_bwd_ref
from repro_torch.obs import trace as obs_trace

SOURCE = Path(__file__).resolve().parent / "csrc" / "hstu_attention_bwd.cu"
ROWS = 16                # q rows (B2) / k columns (B3) per warp; a block
                         # covers 1-4 of them (``rows_per_block``)

# the plain torch version the kernels are held against
hstu_attention_bwd_plain = hstu_attention_bwd_ref

dq_launch_count = 0      # B2 launches since the last reset
dkv_launch_count = 0     # B3 launches since the last reset
_lib = None              # the loaded ctypes library


def reset_launch_count() -> None:
    global dq_launch_count, dkv_launch_count
    dq_launch_count = dkv_launch_count = 0


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
        for name in ("hstu_attention_bwd_dq", "hstu_attention_bwd_dkv",
                     "hstu_attention_bwd_dq_bf16",
                     "hstu_attention_bwd_dkv_bf16"):
            getattr(lib, name).argtypes = [vp] * 9 + [i] * 8 + [vp]
            getattr(lib, name).restype = i
            smem = getattr(lib, name + "_smem_bytes")
            smem.argtypes = [i] * 4
            smem.restype = ctypes.c_longlong
        lib.hstu_attention_bwd_rows_per_block.argtypes = [ctypes.c_longlong,
                                                          i]
        lib.hstu_attention_bwd_rows_per_block.restype = i
        lib.hstu_attention_bwd_error_string.argtypes = [i]
        lib.hstu_attention_bwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _checked(q, k, v, rab, n_hist, hist_lengths, target_counts, max_rel_pos,
             g):
    """Validate the operands both kernels take; returns rab in q's dtype
    (``rab_operand``) and the int32 lengths."""
    if q.device.type != "cuda":
        raise ValueError(f"the HSTU backward CUDA kernels need CUDA tensors, "
                         f"got {q.device}")
    device = q.device
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3] or g.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} g{tuple(g.shape)}")
    b, h, s, dqk = q.shape
    dv = v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        check_operand(name, t, device, q.dtype)
    if not (0 < dqk <= MAX_D and 0 < dv <= MAX_D):
        raise ValueError(f"Dqk={dqk}, Dv={dv}: the kernels take 1..{MAX_D}")
    if not 0 <= n_hist <= s:
        raise ValueError(f"n_hist={n_hist} outside [0, S={s}]")
    if not 0 <= max_rel_pos <= MAX_REL_POS:
        raise ValueError(f"max_rel_pos={max_rel_pos} outside "
                         f"[0, {MAX_REL_POS}]")
    if b * h > 2 ** 31 - 1 or (s + ROWS - 1) // ROWS > 65535 \
            or b * h * s * max(dqk, dv) >= 2 ** 62:
        raise ValueError("tensor too large for the kernels' indexing")
    rab = rab_operand(rab, q.dtype, device)
    if rab is not None and tuple(rab.shape) != (h, 2 * max_rel_pos + 1):
        raise ValueError(f"rab{tuple(rab.shape)} != "
                         f"({h}, {2 * max_rel_pos + 1})")
    if hist_lengths.shape != (b,) or target_counts.shape != (b,):
        raise ValueError("hist_lengths / target_counts must be (B,)")
    return (rab,
            hist_lengths.to(device=device, dtype=torch.int32).contiguous(),
            target_counts.to(device=device, dtype=torch.int32).contiguous())


def _launch(name: str, dqk: int, dv: int, max_rel_pos: int, use_rab: bool,
            device, *args) -> None:
    """Launch kernel ``name`` (its C entry point for the operands' dtype)."""
    lib = _load()
    smem = getattr(lib, name + "_smem_bytes")(dqk, dv, max_rel_pos,
                                              int(use_rab))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name} needs {smem} B of shared memory per block")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.hstu_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def rows_per_block(n_heads: int, s: int) -> int:
    """Output rows one block of B2 or B3 covers at this shape (16 x the
    header's ``tile_config`` rb, from (B*H, S) alone); B2 writes one drab
    partial table per block."""
    return _load().hstu_attention_bwd_rows_per_block(n_heads, s)


def hstu_attention_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, rab: Optional[torch.Tensor],
                               n_hist: int, hist_lengths: torch.Tensor,
                               target_counts: torch.Tensor, max_rel_pos: int,
                               g: torch.Tensor
                               ) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """Launch B2: ``(dq (B, H, S, Dqk), drab (H, 2*max_rel_pos+1) or
    None)``. The ROO mask keeps only cells with i >= j, so only drab's bins
    of deltas 0..max_rel_pos (the last max_rel_pos + 1) can be nonzero: the
    kernel writes one partial table of those per (b, h, row block) into an
    (H, max_rel_pos + 1, B * row blocks) buffer; they are summed here over
    its last axis in a fixed order (the reference's ``.sum(0)`` over its
    per-(b, h) partials) beside exact zeros for the other bins, in rab's
    dtype."""
    global dq_launch_count
    rab_in, hl, tc = _checked(q, k, v, rab, n_hist, hist_lengths,
                              target_counts, max_rel_pos, g)
    b, h, s, dqk = q.shape
    dv = v.shape[-1]
    use_rab = rab is not None
    nrab = 2 * max_rel_pos + 1
    n_blocks = -(-s // rows_per_block(b * h, s))
    dq = torch.empty_like(q)
    part = torch.empty((h, max_rel_pos + 1, b * n_blocks) if use_rab
                       else (0,), device=q.device, dtype=torch.float32)
    if dq.numel() == 0:
        return dq, (torch.zeros((h, nrab), device=q.device, dtype=rab.dtype)
                    if use_rab else None)
    _launch(symbol("hstu_attention_bwd_dq", q.dtype), dqk, dv, max_rel_pos,
            use_rab, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            rab_in.data_ptr() if use_rab else None, g.data_ptr(),
            hl.data_ptr(), tc.data_ptr(), dq.data_ptr(),
            part.data_ptr() if use_rab else None, b, h, s, dqk, dv, n_hist,
            max_rel_pos, int(use_rab))
    dq_launch_count += 1
    if not use_rab:
        return dq, None
    drab = torch.zeros((h, nrab), device=q.device, dtype=rab.dtype)
    drab[:, max_rel_pos:] = part.sum(-1).to(rab.dtype)
    return dq, drab


def hstu_attention_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, rab: Optional[torch.Tensor],
                                n_hist: int, hist_lengths: torch.Tensor,
                                target_counts: torch.Tensor,
                                max_rel_pos: int, g: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B3: ``(dk (B, H, S, Dqk), dv (B, H, S, Dv))``."""
    global dkv_launch_count
    rab, hl, tc = _checked(q, k, v, rab, n_hist, hist_lengths,
                           target_counts, max_rel_pos, g)
    b, h, s, dqk = q.shape
    dv_dim = v.shape[-1]
    use_rab = rab is not None
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _launch(symbol("hstu_attention_bwd_dkv", q.dtype), dqk, dv_dim,
            max_rel_pos, use_rab, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), rab.data_ptr() if use_rab else None, g.data_ptr(),
            hl.data_ptr(), tc.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
            s, dqk, dv_dim, n_hist, max_rel_pos, int(use_rab))
    dkv_launch_count += 1
    return dk, dv


def hstu_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, rab: Optional[torch.Tensor],
                            n_hist: int, hist_lengths: torch.Tensor,
                            target_counts: torch.Tensor, max_rel_pos: int,
                            g: torch.Tensor):
    """B2 then B3 on the same operands: ``(dq, dk, dv, drab)``, drab None
    when rab is None. Same signature as :func:`hstu_attention_bwd_plain`.
    Operands: fp32 or bf16, contiguous, on one CUDA device."""
    args = (q, k, v, rab, n_hist, hist_lengths, target_counts, max_rel_pos,
            g)
    dq, drab = hstu_attention_bwd_dq_cuda(*args)
    dk, dv = hstu_attention_bwd_dkv_cuda(*args)
    return dq, dk, dv, drab


def kept_cells(n_hist: int, hist_lengths: torch.Tensor,
               target_counts: torch.Tensor, n_heads: int,
               s: int) -> torch.Tensor:
    """The cells the ROO mask keeps over the batch and its heads, a
    one-element tensor on the lengths' device: per request, the valid
    history's causal triangle, each valid target against that history and
    against itself (the kernels' ``RooMask``)."""
    hist = hist_lengths.long().clamp(0, n_hist)
    tgt = target_counts.long().clamp(0, s - n_hist)
    return n_heads * torch.sum(hist * (hist + 1) // 2 + tgt * hist + tgt)


def fwd_tiles(n_hist: int, hist_lengths: torch.Tensor,
              target_counts: torch.Tensor, n_heads: int,
              s: int) -> torch.Tensor:
    """The 16 x 16 tiles B1 multiplies over the batch and its heads, a
    one-element tensor on the lengths' device: those that hold a kept cell
    (``RooMask::live`` is exact). Per request, with ``nh`` row tiles
    holding valid history rows and the target rows' tiles ``t0..t1``: a
    history row tile r outside ``t0..t1`` multiplies the r + 1 tiles up to
    its diagonal, a target row tile the ``nh`` history tiles and its own
    diagonal tile where that lies past them. Only a tile that both kinds of
    row share (``n_hist`` off the tile grid) is counted once less."""
    hist = hist_lengths.long().clamp(0, n_hist)
    tgt = target_counts.long().clamp(0, s - n_hist)
    nh = (hist + ROWS - 1) // ROWS
    t0 = n_hist // ROWS
    n_tt = torch.where(tgt > 0, (n_hist + tgt - 1) // ROWS - t0 + 1, 0)
    shared = (tgt > 0) & (nh == t0 + 1)
    tiles = nh * (nh + 1) // 2 + n_tt * (nh + 1) \
        - torch.where(shared, nh + 1, 0)
    return n_heads * torch.sum(tiles)


def _span_args(q: torch.Tensor, v: torch.Tensor) -> dict:
    b, h, s, d = q.shape
    return {"B": b, "H": h, "S": s, "D": d, "Dv": v.shape[-1]}


class HSTUAttentionFn(torch.autograd.Function):
    """The ROO HSTU attention as one differentiable op: the forward kernel
    (B1) and the backward kernels (B2, B3), the port of the reference's
    ``_hstu_fused`` custom_vjp. Like the reference it saves only the inputs
    (no O(S²) residual) and recomputes the scores in the backward. The
    lengths get no gradient, and rab none when it is None.

    ``apply(q, k, v, rab, n_hist, hist_lengths, target_counts,
    max_rel_pos)``; q, k, v, rab contiguous fp32 or bf16 (one dtype for q,
    k and v) on one CUDA device; the output and the gradients in their
    dtypes.

    The forward runs in a device-timed ``hstu.attention`` span, the
    backward in ``hstu.attention_bwd`` (args ``B``, ``H``, ``S``, ``D``,
    ``Dv``); in ``trace`` mode each also gets ``kept_cells``
    (:func:`kept_cells`, read without a sync), which the forward adds to
    the counter ``hstu.kept_cells``, and the forward ``fwd_tiles``
    (:func:`fwd_tiles`, the same way; counter ``hstu.fwd_tiles``):
    ``kept_cells / (256 fwd_tiles)`` is the share of B1's tile work the
    mask keeps.
    """

    @staticmethod
    def forward(ctx, q, k, v, rab, n_hist, hist_lengths, target_counts,
                max_rel_pos):
        hl = hist_lengths.to(device=q.device, dtype=torch.int32).contiguous()
        tc = target_counts.to(device=q.device,
                              dtype=torch.int32).contiguous()
        ctx.save_for_backward(q, k, v, rab, hl, tc)
        ctx.n_hist, ctx.max_rel_pos = n_hist, max_rel_pos
        ctx.kept = tiles = None
        if obs_trace.tracing_enabled():
            ctx.kept = kept_cells(n_hist, hl, tc, q.shape[1], q.shape[2])
            tiles = fwd_tiles(n_hist, hl, tc, q.shape[1], q.shape[2])
        with obs_trace.span("hstu.attention", device=True,
                            **_span_args(q, v)) as sp:
            if ctx.kept is not None:
                sp.set_later("kept_cells", ctx.kept,
                             counter="hstu.kept_cells")
                sp.set_later("fwd_tiles", tiles, counter="hstu.fwd_tiles")
            return fwd.hstu_attention_cuda(q, k, v, rab, n_hist, hl, tc,
                                           max_rel_pos)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, rab, hl, tc = ctx.saved_tensors
        with obs_trace.span("hstu.attention_bwd", device=True,
                            **_span_args(q, v)) as sp:
            if ctx.kept is not None:
                sp.set_later("kept_cells", ctx.kept)
            dq, dk, dv, drab = hstu_attention_bwd_cuda(
                q, k, v, rab, ctx.n_hist, hl, tc, ctx.max_rel_pos,
                grad_out.contiguous())
        return dq, dk, dv, drab, None, None, None, None
