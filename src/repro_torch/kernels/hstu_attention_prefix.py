"""Cached-prefix HSTU attention forward (incremental serving): the
hand-written CUDA kernel, its build and binding, and its plain torch version.

Port of ``repro/kernels/hstu_attention.py:_prefix_fwd_kernel`` (the Pallas
TPU forward of the incremental path). The kernel source is
``csrc/hstu_attention_prefix_fwd.cu``: the prefix layout's row and column
maps and tile skip around the tile body it shares with the full forward
(``csrc/hstu_fwd_tile.cuh``); its header comment says what bounds it on an
H100.
It is built and loaded like that kernel (``hstu_attention.build_library``:
nvcc ``sm_90a`` into ``build/kernels/`` at first use, plain C interface,
``ctypes``); nothing is built at import time.

:func:`hstu_attention_prefix_cuda` is the kernel's wrapper: it launches the
kernel on CUDA tensors or raises — there is no fallback. Callers reach it
through ``dispatch.hstu_attention_prefix``, whose auto rung picks it for
CUDA tensors and the plain torch path for CPU tensors. The wrapper never
reads the counts back to the host: ``prefix + new <= n_hist`` is the
caller's contract (the engine checks it on host ints). Dtypes as the full
forward's (``hstu_attention``'s module note): fp32 or bf16 operands, the
output in their dtype, bf16 through ``hstu_attention_prefix_fwd_bf16``.
:func:`hstu_attention_prefix_plain` (the dense oracle of ``kernels/ref.py``)
is what the kernel is held against. ``launch_count`` counts its launches.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.hstu_attention import (MAX_D, MAX_GRID_Y,
                                                MAX_REL_POS, MAX_SMEM_BYTES,
                                                ROW_TILE, build_library,
                                                check_operand, rab_operand,
                                                refuse_grad, symbol)
from repro_torch.kernels.ref import hstu_attention_prefix_ref

SOURCE = (Path(__file__).resolve().parent / "csrc"
          / "hstu_attention_prefix_fwd.cu")

# the plain torch version the kernel is held against (on bf16 operands, on
# their fp32 values: ``kernels/ref.py``'s note)
hstu_attention_prefix_plain = hstu_attention_prefix_ref

launch_count = 0         # kernel launches since the last reset
_lib = None              # the loaded ctypes library


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def build() -> Tuple[Path, str]:
    """Compile this kernel (see ``hstu_attention.build_library``)."""
    return build_library(SOURCE)


def _load():
    global _lib
    if _lib is None:
        import ctypes
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        for name in ("hstu_attention_prefix_fwd",
                     "hstu_attention_prefix_fwd_bf16"):
            getattr(lib, name).argtypes = [vp] * 8 + [i] * 11 + [vp]
            getattr(lib, name).restype = i
            smem = getattr(lib, name + "_smem_bytes")
            smem.argtypes = [i] * 4
            smem.restype = ctypes.c_longlong
        lib.hstu_attention_prefix_fwd_error_string.argtypes = [i]
        lib.hstu_attention_prefix_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def hstu_attention_prefix_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, rab: Optional[torch.Tensor],
                               n_hist: int, n_new: int,
                               prefix_lengths: torch.Tensor,
                               new_counts: torch.Tensor,
                               target_counts: torch.Tensor, scale_len: int,
                               max_rel_pos: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel. q: (B, H, n_new + m, Dqk); k: (B, H,
    n_hist + m, Dqk); v: (B, H, n_hist + m, Dv); rab: (H, 2*max_rel_pos+1)
    or None; counts (B,). fp32 or bf16, contiguous, on one CUDA device;
    returns (B, H, n_new + m, Dv) in q's dtype. Raises on anything the
    kernel does not take. Forward only, as in the reference:
    raises on inputs that require grad under grad mode."""
    global launch_count
    refuse_grad("hstu_attention_prefix_cuda", q, k, v, rab)
    if q.device.type != "cuda":
        raise ValueError(f"the HSTU prefix CUDA kernel needs CUDA tensors, "
                         f"got {q.device}")
    device = q.device
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or v.shape[:3] != k.shape[:3] \
            or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, h, n_rows, dqk = q.shape
    n_cols, dv = k.shape[2], v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, device, q.dtype)
    if not (0 < dqk <= MAX_D and 0 < dv <= MAX_D):
        raise ValueError(f"Dqk={dqk}, Dv={dv}: the kernel takes 1..{MAX_D}")
    if not 0 <= n_new <= n_rows:
        raise ValueError(f"n_new={n_new} outside [0, R={n_rows}]")
    if not 0 <= n_hist <= n_cols:
        raise ValueError(f"n_hist={n_hist} outside [0, C={n_cols}]")
    if scale_len <= 0:
        raise ValueError(f"scale_len={scale_len} must be positive")
    if not 0 <= max_rel_pos <= MAX_REL_POS:
        raise ValueError(f"max_rel_pos={max_rel_pos} outside "
                         f"[0, {MAX_REL_POS}]")
    if b * h > 2 ** 31 - 1 or -(-n_rows // ROW_TILE) > MAX_GRID_Y \
            or b * h * max(n_rows, n_cols) * max(dqk, dv) >= 2 ** 62:
        raise ValueError("tensor too large for the kernel's indexing")
    rab = rab_operand(rab, q.dtype, device)
    use_rab = rab is not None
    if use_rab and tuple(rab.shape) != (h, 2 * max_rel_pos + 1):
        raise ValueError(f"rab{tuple(rab.shape)} != "
                         f"({h}, {2 * max_rel_pos + 1})")
    counts = []
    for name, t in (("prefix_lengths", prefix_lengths),
                    ("new_counts", new_counts),
                    ("target_counts", target_counts)):
        if t.shape != (b,):
            raise ValueError(f"{name} must be (B,) = ({b},), got "
                             f"{tuple(t.shape)}")
        counts.append(t.to(device=device, dtype=torch.int32).contiguous())
    out = torch.empty((b, h, n_rows, dv), device=device, dtype=q.dtype)
    if out.numel() == 0:
        return out
    lib = _load()
    name = symbol("hstu_attention_prefix_fwd", q.dtype)
    smem = getattr(lib, name + "_smem_bytes")(dqk, dv, max_rel_pos,
                                              int(use_rab))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"needs {smem} B of shared memory per block")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            rab.data_ptr() if use_rab else None, counts[0].data_ptr(),
            counts[1].data_ptr(), counts[2].data_ptr(), out.data_ptr(), b,
            h, n_rows, n_cols, dqk, dv, n_hist, n_new, int(scale_len),
            max_rel_pos, int(use_rab), stream)
    if err != 0:
        msg = lib.hstu_attention_prefix_fwd_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    launch_count += 1
    return out
