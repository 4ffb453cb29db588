"""HSTU pointwise attention forward: the hand-written CUDA kernel, its
build and binding, and its plain torch version.

Port of ``repro/kernels/hstu_attention.py:_fwd_kernel`` (the Pallas TPU
forward). The kernel source is ``csrc/hstu_attention_fwd.cu``; its header
comment says what bounds it on an H100 and what the design does about it.

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles
the source into a shared library with a plain C interface under
``build/kernels/`` at the repo root (listed in ``.gitignore``), named by a
hash of the source, the ``csrc/*.cuh`` headers it includes (the tile body
``hstu_fwd_tile.cuh`` that B1 shares with the cached-prefix forward) and
the flags, and ``ctypes`` loads it. Nothing CUDA- or
nvcc-related happens at import time, so the CPU tests import this module.

:func:`hstu_attention_cuda` is the kernel's wrapper: it launches the kernel
on CUDA tensors or raises — there is no fallback. Callers reach it through
``kernels/dispatch.py``, whose auto rung picks it for CUDA tensors (inside
``hstu_attention_bwd.HSTUAttentionFn``, which adds the backward kernels) and
the plain torch path for CPU tensors. It refuses inputs that require grad
under grad mode, so autograd can reach it only through that Function.
:func:`hstu_attention_plain` (the dense oracle of ``kernels/ref.py``) is
what the kernel is held against. ``launch_count`` counts the kernel's
launches.

Dtypes (:data:`DTYPES`): q, k and v are fp32 or bf16, all one dtype, and
the output comes back in it, as the reference's ``out_shape``. rab is taken
in that dtype; a table of the other one is cast (it is only (H, 2 *
max_rel_pos + 1)). bf16 operands launch the kernel's bf16 variant
(``hstu_attention_fwd_bf16`` in the same source: bf16 in, fp32 inside, one
rounding to bf16 at the store), one launch, no cast of q, k, v or the
output; it keeps the probabilities in fp32, as the reference's Pallas
kernel, so it is held against the plain version on the operands' fp32
values, rounded once (``kernels/ref.py``'s note). Any other dtype raises
``TypeError``.

:func:`hstu_attention` and :func:`hstu_attention_prefix` carry the names and
signatures of the reference module's two entry points (less its TPU
tiling knobs): on a CUDA tensor the first is
``hstu_attention_bwd.HSTUAttentionFn`` (B1 forward, B2 + B3 backward) and
the second the cached-prefix kernel (B4, forward only); on a CPU tensor
each is its plain torch version.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ref import hstu_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "hstu_attention_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
MAX_D = 128              # largest Dqk / Dv the kernel takes
ROW_TILE = 16            # q rows per warp: a grid row covers 1-4 tiles
MAX_GRID_Y = 65535
# the half of the rab row the masks read (deltas 0..max_rel_pos) lives in a
# block's shared memory, so each launch's check of its shared memory is the
# bound at a given D; this only keeps the indexing small
MAX_REL_POS = 16384
MAX_SMEM_BYTES = 227 * 1024
DTYPES = (torch.float32, torch.bfloat16)   # what the kernels take

# the plain torch version the kernel is held against (on bf16 operands, on
# their fp32 values: ``kernels/ref.py``'s note)
hstu_attention_plain = hstu_attention_ref

launch_count = 0         # kernel launches since the last reset
_lib = None              # the loaded ctypes library


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                  else []) + [shutil.which("nvcc") or "",
                              "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME); the HSTU CUDA "
                       "kernels are built on the machine with the card")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_digest(source: Path) -> str:
    """sha256 of the source, of every header it includes by ``#include
    "..."`` (relative to the including file, recursively) and of the flags:
    a change to a shared header alone rebuilds every library using it."""
    h = hashlib.sha256()
    seen, todo = set(), [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text + b"\0")
        todo.extend(path.parent / m.decode() for m in _INCLUDE.findall(text))
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build_library(source: Path) -> Tuple[Path, str]:
    """Compile one kernel source into ``build/kernels/`` (once per
    :func:`source_digest`); returns the library path and the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills)."""
    digest = source_digest(source)
    lib_path = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists() and log_path.exists():
        return lib_path, log_path.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, log


def build() -> Tuple[Path, str]:
    """Compile this kernel (see :func:`build_library`)."""
    return build_library(SOURCE)


def _load():
    global _lib
    if _lib is None:
        import ctypes
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        for name in ("hstu_attention_fwd", "hstu_attention_fwd_bf16"):
            getattr(lib, name).argtypes = [vp] * 7 + [i] * 8 + [vp]
            getattr(lib, name).restype = i
            smem = getattr(lib, name + "_smem_bytes")
            smem.argtypes = [i] * 4
            smem.restype = ctypes.c_longlong
        lib.hstu_attention_fwd_occupancy.argtypes = [i] * 7 + [vp] * 2
        lib.hstu_attention_fwd_occupancy.restype = i
        lib.hstu_attention_fwd_error_string.argtypes = [i]
        lib.hstu_attention_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def occupancy(b: int, h: int, s: int, dqk: int, dv: int,
              max_rel_pos: int) -> Tuple[int, int]:
    """(blocks an SM holds, a block's shared memory in bytes) for the fp32
    kernel at the configuration a launch of this shape takes: CUDA's
    occupancy query on the current card, after the launch's shared-memory
    attribute."""
    import ctypes
    lib = _load()
    blocks, smem = ctypes.c_int(), ctypes.c_longlong()
    err = lib.hstu_attention_fwd_occupancy(
        b, h, s, dqk, dv, max_rel_pos, 1, ctypes.byref(blocks),
        ctypes.byref(smem))
    if err != 0:
        msg = lib.hstu_attention_fwd_error_string(err).decode()
        raise RuntimeError(f"hstu_attention_fwd_occupancy: {msg} ({err})")
    return blocks.value, smem.value


def symbol(name: str, dtype: torch.dtype) -> str:
    """The C entry point of kernel ``name`` for operands of ``dtype``."""
    return name + "_bf16" if dtype == torch.bfloat16 else name


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  dtype: Optional[torch.dtype] = None) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` of a dtype in
    :data:`DTYPES` (and of ``dtype``, q's, when given)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got "
                        f"{t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype} but q is {dtype}: the "
                        f"operands share one dtype")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rab_operand(rab: Optional[torch.Tensor], dtype: torch.dtype,
                device: torch.device) -> Optional[torch.Tensor]:
    """rab in the operands' ``dtype``: a table of the other kernel dtype is
    cast (it is only (H, 2 * max_rel_pos + 1)), any other dtype raises."""
    if rab is None:
        return None
    check_operand("rab", rab, device)
    return rab.to(dtype)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would differentiate through a kernel call: the raw
    wrappers build their outputs outside the graph, so under grad mode an
    input that requires grad would silently get no gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad under grad mode, but the "
            f"kernel's output is outside the autograd graph (the "
            f"differentiable ops are dispatch.hstu_attention, "
            f"embedding_bag.embedding_bag, "
            f"embedding_bag.embedding_bag_grouped and "
            f"dot_interaction.dot_interaction; the cached-prefix attention "
            f"is forward only)")


def hstu_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rab: Optional[torch.Tensor], n_hist: int,
                        hist_lengths: torch.Tensor,
                        target_counts: torch.Tensor,
                        max_rel_pos: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel. q, k: (B, H, S, Dqk); v: (B, H, S, Dv);
    rab: (H, 2*max_rel_pos+1) or None; lengths (B,). fp32 or bf16 (module
    note), contiguous, on one CUDA device; returns (B, H, S, Dv) in q's
    dtype. Raises on anything the kernel does not take, and on
    inputs that require grad under grad mode (the output is outside the
    autograd graph: :class:`hstu_attention_bwd.HSTUAttentionFn` is the
    differentiable op)."""
    global launch_count
    refuse_grad("hstu_attention_cuda", q, k, v, rab)
    if q.device.type != "cuda":
        raise ValueError(f"the HSTU CUDA kernel needs CUDA tensors, got "
                         f"{q.device}")
    device = q.device
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, h, s, dqk = q.shape
    dv = v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, device, q.dtype)
    if not (0 < dqk <= MAX_D and 0 < dv <= MAX_D):
        raise ValueError(f"Dqk={dqk}, Dv={dv}: the kernel takes 1..{MAX_D}")
    if not 0 <= n_hist <= s:
        raise ValueError(f"n_hist={n_hist} outside [0, S={s}]")
    if not 0 <= max_rel_pos <= MAX_REL_POS:
        raise ValueError(f"max_rel_pos={max_rel_pos} outside "
                         f"[0, {MAX_REL_POS}]")
    if b * h > 2 ** 31 - 1 or -(-s // ROW_TILE) > MAX_GRID_Y \
            or b * h * s * max(dqk, dv) >= 2 ** 62:
        raise ValueError("tensor too large for the kernel's indexing")
    rab = rab_operand(rab, q.dtype, device)
    use_rab = rab is not None
    if use_rab and tuple(rab.shape) != (h, 2 * max_rel_pos + 1):
        raise ValueError(f"rab{tuple(rab.shape)} != "
                         f"({h}, {2 * max_rel_pos + 1})")
    if hist_lengths.shape != (b,) or target_counts.shape != (b,):
        raise ValueError("hist_lengths / target_counts must be (B,)")
    hl = hist_lengths.to(device=device, dtype=torch.int32).contiguous()
    tc = target_counts.to(device=device, dtype=torch.int32).contiguous()
    out = torch.empty((b, h, s, dv), device=device, dtype=q.dtype)
    if out.numel() == 0:
        return out
    lib = _load()
    name = symbol("hstu_attention_fwd", q.dtype)
    smem = getattr(lib, name + "_smem_bytes")(dqk, dv, max_rel_pos,
                                              int(use_rab))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"needs {smem} B of shared memory per block")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            rab.data_ptr() if use_rab else None, hl.data_ptr(),
            tc.data_ptr(), out.data_ptr(), b, h, s, dqk, dv, n_hist,
            max_rel_pos, int(use_rab), stream)
    if err != 0:
        msg = lib.hstu_attention_fwd_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    launch_count += 1
    return out


def hstu_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rab: Optional[torch.Tensor], n_hist: int,
                   hist_lengths: torch.Tensor, target_counts: torch.Tensor,
                   max_rel_pos: int = 128) -> torch.Tensor:
    """q, k: (B, H, S, Dqk); v: (B, H, S, Dv); rab: (H, 2*max_rel_pos+1) or
    None. Returns (B, H, S, Dv), differentiable w.r.t. q, k, v and rab: on
    the card the kernels (module note), on the CPU the plain version."""
    if q.device.type != "cuda":
        return hstu_attention_plain(q, k, v, rab, n_hist, hist_lengths,
                                    target_counts, max_rel_pos)
    from repro_torch.kernels.hstu_attention_bwd import HSTUAttentionFn
    return HSTUAttentionFn.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        None if rab is None else rab.contiguous(), n_hist, hist_lengths,
        target_counts, max_rel_pos)


def hstu_attention_prefix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          rab: Optional[torch.Tensor], n_hist: int,
                          n_new: int, prefix_lengths: torch.Tensor,
                          new_counts: torch.Tensor,
                          target_counts: torch.Tensor, scale_len: int,
                          max_rel_pos: int = 128) -> torch.Tensor:
    """Cached-prefix HSTU attention (forward only, a serving path): q (B, H,
    n_new + m, Dqk), k / v (B, H, n_hist + m, ·). On the card the B4
    kernel, on the CPU its plain version. Returns (B, H, n_new + m, Dv)."""
    from repro_torch.kernels import hstu_attention_prefix as pfx
    args = (n_hist, n_new, prefix_lengths, new_counts, target_counts,
            scale_len, max_rel_pos)
    if q.device.type != "cuda":
        return pfx.hstu_attention_prefix_plain(q, k, v, rab, *args)
    return pfx.hstu_attention_prefix_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(),
        None if rab is None else rab.contiguous(), *args)
