"""Embedding bag: the hand-written CUDA kernels B5 (pooled forward) and B6
(COO-row backward), each one grouped launch over the F fields of a lookup,
their build and binding, their plain torch versions, and the autograd
Function that runs both behind one op, :class:`GroupedEmbeddingBagFn` (one
table is a group of one field).

Ports of ``repro/kernels/embedding_bag.py:_sum_kernel``/``_max_kernel``
(the Pallas TPU forward) and ``:_bwd_coo_kernel`` (its backward), and of the
``custom_vjp`` around them (``_bag_fused``). The reference launches them
once per field; here one launch covers the fields of one lookup (dlrm's 13
fields of a side). The kernel source is ``csrc/embedding_bag.cu``; its
header comment says what bounds the kernels on an H100 and what the design
does about it. It is built and loaded like the HSTU kernels
(``hstu_attention.build_library``: nvcc ``sm_90a`` into ``build/kernels/``
at first use, plain C interface, ``ctypes``); nothing is built at import
time, so the CPU tests import this module.

:func:`embedding_bag_grouped_fwd_cuda` (B5) and
:func:`embedding_bag_grouped_coo_rows_cuda` (B6) launch one kernel each on
CUDA tensors or raise; there is no fallback. :func:`embedding_bag_fwd_cuda`
and :func:`embedding_bag_coo_rows_cuda` are their one-table (F = 1) calls.
All refuse inputs that require grad under grad mode, so autograd reaches
the kernels only through the Function. ``fwd_launch_count`` and
``coo_launch_count`` count their launches. The plain versions they are
held against are ``embedding_bag_fwd_plain`` and
``embedding_bag_coo_rows_plain`` (the oracles of ``kernels/ref.py``) and,
per group, :func:`embedding_bag_grouped_plain` and
:func:`embedding_bag_grouped_coo_rows_plain` (the same, field by field,
stacked). Max pooling's backward is plain torch on every device, as it is
jnp code outside the Pallas kernel in the reference.

:func:`embedding_bag_grouped` (a group) and :func:`embedding_bag` (one
table, its group of one field) are the entry points: they resolve the
backend through ``kernels/dispatch.py`` (``cuda`` on CUDA tables, the plain
``torch`` path on CPU ones).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.embeddings.sparse import SparseRows
from repro_torch.kernels.hstu_attention import build_library, refuse_grad
from repro_torch.kernels.ref import (embedding_bag_coo_rows_ref,
                                     embedding_bag_max_coo_rows_ref,
                                     embedding_bag_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
POOLINGS = ("sum", "mean", "max")       # codes 0, 1, 2 in the source
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_FIELDS = 64                         # kMaxFields in the source (a test
                                        # holds the two equal)

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
        ptrs, ints = ctypes.POINTER(vp), ctypes.POINTER(i)
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.embedding_bag_fwd_grouped.argtypes = [
            ptrs, ints, i, vp, strides, vp, strides, vp] + [i] * 5 + [vp]
        lib.embedding_bag_bwd_coo_grouped.argtypes = [
            vp, ints, i, vp, strides, vp, strides, vp, vp] + [i] * 5 + [vp]
        lib.embedding_bag_fwd_grouped.restype = i
        lib.embedding_bag_bwd_coo_grouped.restype = i
        lib.embedding_bag_fwd_plan.argtypes = [i] * 6 + [ints]
        lib.embedding_bag_fwd_plan.restype = i
        lib.embedding_bag_error_string.argtypes = [i]
        lib.embedding_bag_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fwd_plan(n_fields: int, b: int, l: int, d: int, dtype: torch.dtype,
             aligned: bool = True) -> dict:
    """The launch B5 makes for a group of ``n_fields`` fields, ``b`` bags of
    ``l`` slots and ``d`` columns of ``dtype``, its tables and output
    16-byte aligned or not (the source's ``fwd_plan``): ``vec`` (the
    elements a lane adds of a row), ``u`` (the rows a round loads before
    adding any), ``threads`` a block, ``blocks``, ``lanes`` a bag. Asks the
    built library, so it needs ``nvcc``; no launch."""
    import ctypes
    out = (ctypes.c_int * 5)()
    err = _load().embedding_bag_fwd_plan(n_fields, b, l, d, DTYPES[dtype],
                                         int(aligned), out)
    if err != 0:
        raise ValueError(f"embedding_bag_fwd_plan: {n_fields} fields, B {b}, "
                         f"L {l}, D {d}, {dtype}: error {err}")
    return dict(zip(("vec", "u", "threads", "blocks", "lanes"), out))


def _check_tables(name: str, tables: Sequence[torch.Tensor]
                  ) -> Tuple[torch.device, torch.dtype, int]:
    """The group's device, dtype and D: 1..MAX_FIELDS contiguous (V, D)
    fp32 or bf16 tables sharing D, dtype and device."""
    if not 1 <= len(tables) <= MAX_FIELDS:
        raise ValueError(f"{name}: {len(tables)} tables; one launch takes "
                         f"1..{MAX_FIELDS} (kMaxFields)")
    t0 = tables[0]
    for t in tables:
        if t.dim() != 2 or t.dtype not in DTYPES or not t.is_contiguous():
            raise ValueError(f"{name}: a table must be a contiguous (V, D) "
                             f"fp32 or bf16 tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.dtype != t0.dtype or t.shape[1] != t0.shape[1] \
                or t.device != t0.device:
            raise ValueError(f"{name}: the tables of a group share D, dtype "
                             f"and device, got {tuple(t0.shape)} {t0.dtype} "
                             f"{t0.device} and {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
        if not 0 < t.shape[0] < 2 ** 31 - 1:
            raise ValueError(f"{name}: table{tuple(t.shape)}: the kernel "
                             f"takes 1..2**31-2 rows")
    return t0.device, t0.dtype, t0.shape[1]


def _need_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"the embedding-bag CUDA kernel needs CUDA tensors, "
                         f"got {device}")


def _check_vocabs(name: str, vocabs: Sequence[int]) -> List[int]:
    vocabs = [int(v) for v in vocabs]
    if not 1 <= len(vocabs) <= MAX_FIELDS:
        raise ValueError(f"{name}: {len(vocabs)} fields; one launch takes "
                         f"1..{MAX_FIELDS} (kMaxFields)")
    if not all(0 < v < 2 ** 31 - 1 for v in vocabs):
        raise ValueError(f"{name}: vocabs {vocabs}: the kernel takes "
                         f"1..2**31-2")
    return vocabs


def _group_index(name: str, ids: torch.Tensor, lengths: torch.Tensor,
                 n_fields: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, F, L) ids and (B, F) lengths as int32 on ``device``, strided as
    given: converted only where the dtype or the device differs."""
    if ids.dim() != 3 or ids.shape[1] != n_fields \
            or tuple(lengths.shape) != tuple(ids.shape[:2]):
        raise ValueError(f"{name}: ids must be (B, F, L) and lengths (B, F) "
                         f"with F = {n_fields}, got {tuple(ids.shape)} and "
                         f"{tuple(lengths.shape)}")
    if ids.is_floating_point() or lengths.is_floating_point():
        raise TypeError(f"{name}: ids and lengths must be integers")
    if ids.shape[0] * ids.shape[2] >= 2 ** 31:
        raise ValueError(f"{name}: too many slots for the kernel's indexing")
    return tuple(x if x.dtype == torch.int32 and x.device == device
                 else x.to(device=device, dtype=torch.int32)
                 for x in (ids, lengths))


def _bag_views(name: str, ids: torch.Tensor, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One table's (B, L) ids and (B,) lengths as a one-field group."""
    if ids.dim() != 2 or tuple(lengths.shape) != tuple(ids.shape[:1]):
        raise ValueError(f"{name}: ids must be (B, L) and lengths (B,), got "
                         f"{tuple(ids.shape)} and {tuple(lengths.shape)}")
    return ids[:, None, :], lengths[:, None]


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.embedding_bag_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _c_array(ctype, values):
    values = list(values)
    return (ctype * len(values))(*values)


def embedding_bag_grouped_fwd_cuda(tables: Sequence[torch.Tensor],
                                   ids: torch.Tensor, lengths: torch.Tensor,
                                   pooling: str = "sum") -> torch.Tensor:
    """Launch B5 once over a group: ``(B, F, D)`` pooled rows, field f from
    ``tables[f] (V_f, D)`` (fp32 or bf16, contiguous, on one CUDA device;
    one D and dtype for all) for ``ids (B, F, L)`` and ``lengths (B, F)``,
    read through their strides. Same contract as
    :func:`embedding_bag_grouped_plain`; raises on anything the kernel does
    not take (more than ``MAX_FIELDS`` tables among it) and on a table that
    requires grad under grad mode."""
    import ctypes
    global fwd_launch_count
    name = "embedding_bag_grouped_fwd_cuda"
    refuse_grad(name, *tables)
    device, dtype, d = _check_tables(name, tables)
    _need_cuda(device)
    if pooling not in POOLINGS:
        raise ValueError(f"unknown pooling {pooling!r}")
    ids32, len32 = _group_index(name, ids, lengths, len(tables), device)
    b, f, l = ids32.shape
    out = torch.empty((b, f, d), device=device, dtype=dtype)
    if out.numel() == 0:
        return out
    _launch("embedding_bag_fwd_grouped", device,
            _c_array(ctypes.c_void_p, (t.data_ptr() for t in tables)),
            _c_array(ctypes.c_int, (t.shape[0] for t in tables)), f,
            ids32.data_ptr(), _c_array(ctypes.c_longlong, ids32.stride()),
            len32.data_ptr(), _c_array(ctypes.c_longlong, len32.stride()),
            out.data_ptr(), b, l, d, POOLINGS.index(pooling), DTYPES[dtype])
    fwd_launch_count += 1
    return out


def embedding_bag_grouped_coo_rows_cuda(g: torch.Tensor, ids: torch.Tensor,
                                        lengths: torch.Tensor,
                                        vocabs: Sequence[int],
                                        pooling: str = "sum"
                                        ) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Launch B6 once over a group: the COO gradients of its sum or mean
    bags, ``(ids (F, B*L) int32, rows (F, B*L, D))``, for the grouped
    output's gradient ``g (B, F, D)`` (fp32 or bf16, contiguous, on a CUDA
    device) and the fields' ``vocabs`` (the sentinel of each field's
    invalid slots). Same contract as
    :func:`embedding_bag_grouped_coo_rows_plain`."""
    import ctypes
    global coo_launch_count
    name = "embedding_bag_grouped_coo_rows_cuda"
    refuse_grad(name, g)
    vocabs = _check_vocabs(name, vocabs)
    _need_cuda(g.device)
    if pooling not in ("sum", "mean"):
        raise ValueError(f"the COO-row kernel takes sum or mean pooling, got "
                         f"{pooling!r}")
    if g.dim() != 3 or g.dtype not in DTYPES or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous (B, F, D) fp32 or bf16 "
                         f"tensor, got {tuple(g.shape)} {g.dtype}")
    ids32, len32 = _group_index(name, ids, lengths, len(vocabs), g.device)
    b, f, l = ids32.shape
    d = g.shape[2]
    if tuple(g.shape[:2]) != (b, f):
        raise ValueError(f"g{tuple(g.shape)} does not match ids{(b, f, l)}")
    if f * b * l * d >= 2 ** 62:
        raise ValueError("too many rows for the kernel's indexing")
    rows = torch.empty((f, b * l, d), device=g.device, dtype=g.dtype)
    out_ids = torch.empty((f, b * l), device=g.device, dtype=torch.int32)
    if b * l == 0:
        return out_ids, rows
    _launch("embedding_bag_bwd_coo_grouped", g.device, g.data_ptr(),
            _c_array(ctypes.c_int, vocabs), f, ids32.data_ptr(),
            _c_array(ctypes.c_longlong, ids32.stride()), len32.data_ptr(),
            _c_array(ctypes.c_longlong, len32.stride()), rows.data_ptr(),
            out_ids.data_ptr(), b, l, d, int(pooling == "mean"),
            DTYPES[g.dtype])
    coo_launch_count += 1
    return out_ids, rows


def embedding_bag_fwd_cuda(table: torch.Tensor, ids: torch.Tensor,
                           lengths: torch.Tensor,
                           pooling: str = "sum") -> torch.Tensor:
    """B5 on one table: ``(B, D)`` pooled rows of ``table (V, D)`` for
    ``ids (B, L)`` and ``lengths (B,)``, one grouped launch of one field.
    Same contract as :func:`embedding_bag_fwd_plain`."""
    refuse_grad("embedding_bag_fwd_cuda", table)
    ids3, len2 = _bag_views("embedding_bag_fwd_cuda", ids, lengths)
    return embedding_bag_grouped_fwd_cuda([table], ids3, len2,
                                          pooling)[:, 0, :]


def embedding_bag_coo_rows_cuda(g: torch.Tensor, ids: torch.Tensor,
                                lengths: torch.Tensor, vocab: int,
                                pooling: str = "sum"
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6 on one table: ``(ids (B*L,) int32, rows (B*L, D))`` for the
    output gradient ``g (B, D)``, one grouped launch of one field. Same
    contract as :func:`embedding_bag_coo_rows_plain`."""
    name = "embedding_bag_coo_rows_cuda"
    refuse_grad(name, g)
    ids3, len2 = _bag_views(name, ids, lengths)
    if g.dim() != 2:
        raise ValueError(f"{name}: g must be (B, D), got {tuple(g.shape)}")
    cids, rows = embedding_bag_grouped_coo_rows_cuda(g[:, None, :], ids3,
                                                     len2, [vocab], pooling)
    return cids[0], rows[0]


def embedding_bag_grouped_plain(tables: Sequence[torch.Tensor],
                                ids: torch.Tensor, lengths: torch.Tensor,
                                pooling: str = "sum") -> torch.Tensor:
    """The plain version of a group: :func:`embedding_bag_fwd_plain` per
    field, stacked to ``(B, F, D)``."""
    return torch.stack([embedding_bag_fwd_plain(t, ids[:, f, :],
                                                lengths[:, f], pooling)
                        for f, t in enumerate(tables)], dim=1)


def embedding_bag_grouped_coo_rows_plain(g: torch.Tensor, ids: torch.Tensor,
                                         lengths: torch.Tensor,
                                         vocabs: Sequence[int],
                                         pooling: str = "sum"
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The plain version of B6 over a group:
    :func:`embedding_bag_coo_rows_plain` per field, stacked to ``(ids (F,
    B*L), rows (F, B*L, D))``."""
    per = [embedding_bag_coo_rows_plain(g[:, f, :], ids[:, f, :],
                                        lengths[:, f], v, pooling)
           for f, v in enumerate(vocabs)]
    return (torch.stack([c for c, _ in per]),
            torch.stack([r for _, r in per]))


def embedding_bag_grouped_coo_grad(pooling: str,
                                   tables: Sequence[torch.Tensor],
                                   ids: torch.Tensor, lengths: torch.Tensor,
                                   out: torch.Tensor, g: torch.Tensor,
                                   needs: Sequence[bool]
                                   ) -> List[Optional[SparseRows]]:
    """The group's backward in COO form, one entry a field (None where
    ``needs`` is false). Sum and mean take one B6 launch over all fields on
    a CUDA ``g`` (the plain version on a CPU one); max is the plain tie
    split, field by field. ``out`` is the forward's (B, F, D) output."""
    vocabs = [t.shape[0] for t in tables]
    if pooling == "max":
        return [SparseRows(*embedding_bag_max_coo_rows_ref(
                    t, ids[:, f, :], lengths[:, f], out[:, f, :],
                    g[:, f, :]), t.shape[0]) if need else None
                for f, (t, need) in enumerate(zip(tables, needs))]
    rows_fn = (embedding_bag_grouped_coo_rows_cuda
               if g.device.type == "cuda"
               else embedding_bag_grouped_coo_rows_plain)
    cids, rows = rows_fn(g, ids, lengths, vocabs, pooling)
    return [SparseRows(cids[f], rows[f], v) if need else None
            for f, (v, need) in enumerate(zip(vocabs, needs))]


class GroupedEmbeddingBagFn(torch.autograd.Function):
    """A group of embedding bags (the F fields of one lookup) as one
    differentiable op on the card: forward one B5 launch, backward one B6
    launch (or the max rule, field by field) then each field's densify
    (``SparseRows.to_dense``, fixed order, so two backward calls give the
    same bits). A table whose gradient is not needed is not densified and
    gets None; ids and lengths get none.

    ``apply(ids (B, F, L), lengths (B, F), pooling, *tables) -> (B, F, D)``;
    tables contiguous fp32 or bf16 on one CUDA device, one D and dtype.
    """

    @staticmethod
    def forward(ctx, ids, lengths, pooling, *tables):
        out = embedding_bag_grouped_fwd_cuda(tables, ids, lengths, pooling)
        ctx.save_for_backward(ids, lengths, out, *tables)
        ctx.pooling = pooling
        return out

    @staticmethod
    def backward(ctx, grad_out):
        ids, lengths, out, *tables = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        grads = [None] * len(tables)
        if any(needs):
            coos = embedding_bag_grouped_coo_grad(
                ctx.pooling, tables, ids, lengths, out,
                grad_out.contiguous(), needs)
            grads = [None if c is None else c.to_dense() for c in coos]
        return (None, None, None, *grads)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  lengths: torch.Tensor, pooling: str = "sum",
                  backend: Optional[str] = None) -> torch.Tensor:
    """table: (V, D); ids: (B, L) int; lengths: (B,). Returns (B, D) pooled
    embeddings (sum | mean | max); empty bags give zeros. The group of one
    field of :func:`embedding_bag_grouped`, so differentiable w.r.t.
    ``table`` on every backend, and on ``cuda`` one B5 launch forward and
    one B6 launch backward."""
    ids3, len2 = _bag_views("embedding_bag", ids, lengths)
    return embedding_bag_grouped([table], ids3, len2, pooling,
                                 backend).squeeze(1)


def embedding_bag_grouped(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                          lengths: torch.Tensor, pooling: str = "sum",
                          backend: Optional[str] = None) -> torch.Tensor:
    """The bags of a group of fields: ``tables[f] (V_f, D)`` (one D and
    dtype), ``ids (B, F, L)`` int, ``lengths (B, F)``. Returns ``(B, F, D)``;
    field f is :func:`embedding_bag` of ``tables[f]`` on ``ids[:, f]``.
    Differentiable w.r.t. every table on every backend; on ``cuda`` one B5
    launch forward and one B6 launch backward. ``backend`` resolves through
    ``kernels/dispatch.py`` on the first table's device when None (``cuda``
    on a CUDA table, ``torch`` otherwise; ``REPRO_TORCH_EMB_BACKEND``
    honored)."""
    from repro_torch.kernels import dispatch
    tables = list(tables)
    if not tables:
        raise ValueError("embedding_bag_grouped needs at least one table")
    if pooling not in POOLINGS:
        raise ValueError(f"unknown pooling {pooling!r}")
    be = dispatch.resolve_emb_backend(backend, tables[0].device)
    if be == "torch":
        return embedding_bag_grouped_plain(tables, ids, lengths, pooling)
    if any(t.device.type != "cuda" for t in tables):
        raise ValueError(f"embedding-bag backend 'cuda' needs CUDA tensors, "
                         f"got {[str(t.device) for t in tables]}")
    return GroupedEmbeddingBagFn.apply(ids, lengths, pooling,
                                       *(t.contiguous() for t in tables))
