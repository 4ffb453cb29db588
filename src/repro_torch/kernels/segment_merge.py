"""The segmented merge: the hand-written CUDA kernel that sums a COO row
gradient into its dense table gradient on the card (the ``segment`` route
of ``embeddings/sparse.py``'s ``SparseRows.to_dense``), its build and
binding, and its plain torch version.

It replaces no TPU kernel: the reference's densify is one XLA scatter-add.
It exists because recommendation ids are skewed, and aten's sorted
``index_put_(..., accumulate=True)``, the route it takes over, adds each run
of one id row after row in one warp (the source's header comment,
``csrc/segment_merge.cu``, gives the numbers and the design). It is built
and loaded like the other kernels (``hstu_attention.build_library``: nvcc
``sm_90a`` into ``build/kernels/`` at first use, plain C interface,
``ctypes``); nothing is built at import time, so the CPU tests import this
module.

:func:`segment_merge_cuda` sorts the ids stably and launches the kernel's
two passes on CUDA tensors, or raises; there is no fallback. It refuses rows
that require grad under grad mode. ``launch_count`` counts its calls.
:func:`segment_merge_plain` is the plain version it is held against: the
same sums in the same order (chunk sums of :data:`CHUNK` sorted entries,
then a crossing run's partials in chunk order, rounded once), so on the
card the two give the same bits.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.hstu_attention import build_library, refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_merge.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64               # kChunk in the source: sorted entries a warp sums
                         # in pass 1 (the built library is asked too)

launch_count = 0         # calls that launched the kernel since the last reset
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
        lib.segment_merge.argtypes = [vp] * 5 + [i] * 5 + [vp]
        lib.segment_merge.restype = i
        lib.segment_merge_chunk.argtypes = []
        lib.segment_merge_chunk.restype = i
        lib.segment_merge_error_string.argtypes = [i]
        lib.segment_merge_error_string.restype = ctypes.c_char_p
        if lib.segment_merge_chunk() != CHUNK:
            raise RuntimeError(f"the built segmented merge sums chunks of "
                               f"{lib.segment_merge_chunk()} entries, "
                               f"CHUNK is {CHUNK}")
        _lib = lib
    return _lib


def lane_width(rows: torch.Tensor, out: torch.Tensor) -> int:
    """Elements a lane loads at once: 16 bytes' worth where the width is a
    multiple of them and ``rows`` and ``out`` start on 16-byte boundaries,
    else one."""
    vec = 16 // rows.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (rows, out))
    return vec if aligned and rows.shape[1] % vec == 0 else 1


def segment_merge_cuda(ids: torch.Tensor, rows: torch.Tensor,
                       vocab: int) -> torch.Tensor:
    """``(vocab, W)``: row v is the sum of ``rows[i]`` over ``ids[i] ==
    v``, ids outside ``[0, vocab)`` dropped, for ``ids (n,)`` int and
    ``rows (n, W)`` fp32 or bf16 on one CUDA device. Same contract and same
    bits as :func:`segment_merge_plain`; raises on anything the kernel does
    not take and on rows that require grad under grad mode."""
    global launch_count
    refuse_grad("segment_merge_cuda", rows)
    if rows.dtype not in DTYPES:
        raise TypeError(f"the segmented merge takes float32 or bfloat16 "
                        f"rows, got {rows.dtype}")
    if rows.device.type != "cuda" or ids.device != rows.device:
        raise ValueError(f"the segmented merge needs ids and rows on one "
                         f"CUDA device, got {ids.device} and {rows.device}")
    if ids.dim() != 1 or rows.dim() != 2 or rows.shape[0] != ids.shape[0]:
        raise ValueError(f"ids must be (n,) and rows (n, W), got "
                         f"{tuple(ids.shape)} and {tuple(rows.shape)}")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise TypeError(f"ids must be integers, got {ids.dtype}")
    n, w = rows.shape
    if max(n, w, vocab) >= 2 ** 31 or vocab < 0:
        raise ValueError(f"n={n}, W={w}, vocab={vocab}: the kernel indexes "
                         f"with 32-bit ids and counts")
    if n == 0 or w == 0 or vocab == 0:
        return rows.new_zeros((vocab, w))
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if ids.dtype != torch.int32:
        # ids are below 2**31 wherever they land in the table
        ids = ids.to(torch.int32)
    sid, pos = torch.sort(ids, stable=True)
    out = torch.empty((vocab, w), device=rows.device, dtype=rows.dtype)
    part = torch.empty((-(-n // CHUNK), 2, w), device=rows.device,
                       dtype=torch.float32)
    lib = _load()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.segment_merge(
            sid.data_ptr(), pos.data_ptr(), rows.data_ptr(), out.data_ptr(),
            part.data_ptr(), n, w, vocab, DTYPES[rows.dtype],
            lane_width(rows, out), stream)
    if err != 0:
        msg = lib.segment_merge_error_string(err).decode()
        raise RuntimeError(f"segment_merge launch failed: {msg} ({err})")
    launch_count += 1
    return out


def segment_merge_plain(ids: torch.Tensor, rows: torch.Tensor,
                        vocab: int) -> torch.Tensor:
    """The plain version, on any device, in the kernel's order: the ids
    sorted stably; each chunk of :data:`CHUNK` sorted entries adds each of
    its runs in fp32 in entry order (a run that crosses a chunk edge leaves
    one partial a chunk); a run's partials add in chunk order; each sum is
    rounded once to ``rows``' dtype. Ids outside ``[0, vocab)`` drop."""
    n, w = rows.shape
    out = rows.new_zeros((vocab, w))
    if n == 0 or w == 0 or vocab == 0:
        return out
    sid, pos = torch.sort(ids.to(torch.int32), stable=True)
    sid = sid.long()
    r = rows[pos].float()
    at = torch.arange(n, device=rows.device)
    # a piece: a run's entries inside one chunk
    starts = torch.ones(n, dtype=torch.bool, device=rows.device)
    starts[1:] = sid[1:] != sid[:-1]
    starts |= at % CHUNK == 0
    sums = torch.empty_like(r)
    acc = None
    for t in range(min(CHUNK, n)):
        idx = at[t::CHUNK]                   # entry t of each chunk
        x = r[idx]
        acc = x if t == 0 else torch.where(starts[idx, None], x,
                                           acc[:idx.numel()] + x)
        sums[idx] = acc
    ends = torch.ones(n, dtype=torch.bool, device=rows.device)
    ends[:-1] = starts[1:]
    last = at[ends]                          # each piece's last entry
    pid, val = sid[last], sums[last]
    first = torch.ones(pid.numel(), dtype=torch.bool, device=rows.device)
    first[1:] = pid[1:] != pid[:-1]
    head = torch.nonzero(first).reshape(-1)  # each id's first piece
    count = torch.diff(head, append=head.new_tensor([pid.numel()]))
    total = val[head]
    for k in range(1, int(count.max())):
        more = count > k
        total[more] = total[more] + val[head[more] + k]
    uid = pid[head]
    keep = (uid >= 0) & (uid < vocab)
    out[uid[keep]] = total[keep].to(rows.dtype)
    return out
