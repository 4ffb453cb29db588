"""Backend dispatch for HSTU attention, its cached-prefix variant, the
embedding bag and the DLRM dot interaction (port of
``repro/kernels/dispatch.py``).

HSTU backends:

  cuda           — the hand-written CUDA kernels; CUDA tensors only. The
                   full attention runs as hstu_attention_bwd.HSTUAttentionFn
                   (forward B1, backward B2 + B3); the cached-prefix
                   attention (kernels/hstu_attention_prefix.py) is forward
                   only and raises when autograd would differentiate it
  torch-chunked  — blockwise torch path (core.hstu): scores, bias and mask
                   are produced per q-chunk, so no (S, S) tensor exists
  torch-dense    — the (S, S)-materializing oracle (kernels/ref.py)

Resolution walks the port's own knob ladder (explicit ``backend=`` >
:func:`use_backend` scope > :func:`set_default_backend` >
``REPRO_TORCH_HSTU_BACKEND`` > auto). The env var is the port's own, so a
``REPRO_HSTU_BACKEND`` exported for the JAX package never reaches it. Auto
follows the tensor: ``cuda`` when q lives on a CUDA device, ``torch-chunked``
otherwise. On a CUDA tensor auto launches the kernel or raises; the plain
backends stay available on any device by explicit choice only. Both entry
points (:func:`hstu_attention`, :func:`hstu_attention_prefix`) use the same
ladder.

Embedding-bag backends have their own knob (``REPRO_TORCH_EMB_BACKEND``,
:func:`set_default_emb_backend`, :func:`use_emb_backend`):

  cuda   — the hand-written CUDA kernels (kernels/embedding_bag.py):
           ``GroupedEmbeddingBagFn`` for the fields of one lookup (one
           table is a group of one), forward B5, backward B6 then the
           densify, one launch each way; CUDA tensors only
  torch  — take + masked reduce oracle (kernels/ref.py)

Auto follows the table: ``cuda`` on a CUDA device, ``torch`` otherwise; on
a CUDA table auto launches the kernel or raises. ``REPRO_EMB_BACKEND``
(the reference's) never reaches the port.

The dot interaction has a third knob (``REPRO_TORCH_DOT_BACKEND``,
:func:`set_default_dot_backend`, :func:`use_dot_backend`), the port's
counterpart of the reference's ``ops.dot_interaction(use_pallas=...)``:

  cuda   — the hand-written CUDA kernel (kernels/dot_interaction.py):
           ``DotInteractionFn``, forward B7, backward plain torch; CUDA
           tensors only
  torch  — fp32 bmm + tril gather oracle (kernels/ref.py)

Auto follows the dense input: ``cuda`` on a CUDA device, ``torch``
otherwise; on a CUDA tensor auto launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.masks import MaskSpec, PrefixMaskSpec
from repro_torch.scenario.knobs import UNSET, Knob

BACKENDS = ("cuda", "torch-chunked", "torch-dense")
ENV_VAR = "REPRO_TORCH_HSTU_BACKEND"

EMB_BACKENDS = ("cuda", "torch")
EMB_ENV_VAR = "REPRO_TORCH_EMB_BACKEND"

DOT_BACKENDS = ("cuda", "torch")
DOT_ENV_VAR = "REPRO_TORCH_DOT_BACKEND"

# auto is device-dependent, so it resolves in resolve_backend /
# resolve_emb_backend / resolve_dot_backend (a None from the ladder means
# "no rung set")
ATTN_KNOB = Knob("attn_backend", ENV_VAR, choices=BACKENDS, kind="backend")
EMB_KNOB = Knob("emb_backend", EMB_ENV_VAR, choices=EMB_BACKENDS,
                kind="backend")
DOT_KNOB = Knob("dot_backend", DOT_ENV_VAR, choices=DOT_BACKENDS,
                kind="backend")


def set_default_backend(backend: Optional[str]) -> None:
    """Process-wide default; ``None`` clears it."""
    ATTN_KNOB.set_default(UNSET if backend is None else backend)


def get_default_backend() -> Optional[str]:
    return ATTN_KNOB.get_default()


def use_backend(backend: Optional[str]):
    """Scoped backend override (ContextVar); ``None`` is a no-op."""
    return ATTN_KNOB.scoped(UNSET if backend is None else backend)


def resolve_backend(backend: Optional[str] = None,
                    device: Optional[torch.device] = None) -> str:
    """The backend a call on ``device`` runs: the ladder's value, else
    ``cuda`` for a CUDA device and ``torch-chunked`` otherwise."""
    be = ATTN_KNOB.resolve(UNSET if backend is None else backend)
    if be is not None:
        return be
    is_cuda = device is not None and torch.device(device).type == "cuda"
    return "cuda" if is_cuda else "torch-chunked"


def set_default_emb_backend(backend: Optional[str]) -> None:
    """Process-wide embedding-bag default; ``None`` clears it."""
    EMB_KNOB.set_default(UNSET if backend is None else backend)


def get_default_emb_backend() -> Optional[str]:
    return EMB_KNOB.get_default()


def use_emb_backend(backend: Optional[str]):
    """Scoped embedding-bag backend override; ``None`` is a no-op."""
    return EMB_KNOB.scoped(UNSET if backend is None else backend)


def resolve_emb_backend(backend: Optional[str] = None,
                        device: Optional[torch.device] = None) -> str:
    """The embedding-bag backend a call on ``device`` runs: the ladder's
    value, else ``cuda`` for a CUDA device and ``torch`` otherwise."""
    be = EMB_KNOB.resolve(UNSET if backend is None else backend)
    if be is not None:
        return be
    is_cuda = device is not None and torch.device(device).type == "cuda"
    return "cuda" if is_cuda else "torch"


def set_default_dot_backend(backend: Optional[str]) -> None:
    """Process-wide dot-interaction default; ``None`` clears it."""
    DOT_KNOB.set_default(UNSET if backend is None else backend)


def use_dot_backend(backend: Optional[str]):
    """Scoped dot-interaction backend override; ``None`` is a no-op."""
    return DOT_KNOB.scoped(UNSET if backend is None else backend)


def resolve_dot_backend(backend: Optional[str] = None,
                        device: Optional[torch.device] = None) -> str:
    """The dot-interaction backend a call on ``device`` runs: the ladder's
    value, else ``cuda`` for a CUDA device and ``torch`` otherwise."""
    be = DOT_KNOB.resolve(UNSET if backend is None else backend)
    if be is not None:
        return be
    is_cuda = device is not None and torch.device(device).type == "cuda"
    return "cuda" if is_cuda else "torch"


def hstu_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rab: Optional[torch.Tensor], spec: MaskSpec,
                   backend: Optional[str] = None, *,
                   max_rel_pos: int = 128,
                   chunk: int = 128) -> torch.Tensor:
    """Masked HSTU pointwise attention on the selected backend.

    q, k: (B, H, S, Dqk); v: (B, H, S, Dv); rab: (H, 2*max_rel_pos+1) or
    None; ``spec`` describes the ROO mask structurally. Returns
    (B, H, S, Dv). Differentiable w.r.t. q, k, v and rab on every backend
    (on ``cuda`` through the backward kernels).
    """
    be = resolve_backend(backend, q.device)
    if be == "cuda":
        if q.device.type != "cuda":
            raise ValueError(f"attention backend 'cuda' needs CUDA tensors, "
                             f"got {q.device}")
        from repro_torch.kernels.hstu_attention import hstu_attention as fn
        return fn(q, k, v, rab, spec.n_hist, spec.hist_lengths,
                  spec.target_counts, max_rel_pos)
    if be == "torch-chunked":
        from repro_torch.core.hstu import hstu_attention_chunked
        return hstu_attention_chunked(q, k, v, rab, spec,
                                      max_rel_pos=max_rel_pos, chunk=chunk)
    from repro_torch.kernels.ref import hstu_attention_ref
    return hstu_attention_ref(q, k, v, rab, spec.n_hist, spec.hist_lengths,
                              spec.target_counts, max_rel_pos)


def hstu_attention_prefix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          rab: Optional[torch.Tensor], spec: PrefixMaskSpec,
                          backend: Optional[str] = None, *,
                          scale_len: int, max_rel_pos: int = 128,
                          chunk: int = 128) -> torch.Tensor:
    """Cached-prefix HSTU attention (incremental serving; forward only).

    Rows are [new events | targets] (q: (B, H, n_new + m, Dqk)); columns
    the full K/V buffer [history cache | targets] (k, v: (B, H, n_hist + m,
    ·)). ``spec`` carries the per-request prefix/new/target counts;
    ``scale_len`` pins the 1/n normalizer to the equivalent full-sequence
    length. Same backend ladder as :func:`hstu_attention`; with
    ``prefix_lengths == 0`` and ``n_new == n_hist`` each backend computes
    its full-recompute counterpart.
    """
    be = resolve_backend(backend, q.device)
    if be == "cuda":
        from repro_torch.kernels.hstu_attention import refuse_grad
        refuse_grad("the cached-prefix cuda backend", q, k, v, rab)
        if q.device.type != "cuda":
            raise ValueError(f"attention backend 'cuda' needs CUDA tensors, "
                             f"got {q.device}")
        from repro_torch.kernels.hstu_attention import (
            hstu_attention_prefix as fn)
        return fn(q, k, v, rab, spec.n_hist, spec.n_new, spec.prefix_lengths,
                  spec.new_counts, spec.target_counts, scale_len, max_rel_pos)
    if be == "torch-chunked":
        from repro_torch.core.hstu import hstu_attention_prefix_chunked
        return hstu_attention_prefix_chunked(q, k, v, rab, spec, scale_len,
                                             max_rel_pos=max_rel_pos,
                                             chunk=chunk)
    from repro_torch.kernels.ref import hstu_attention_prefix_ref
    return hstu_attention_prefix_ref(q, k, v, rab, spec.n_hist, spec.n_new,
                                     spec.prefix_lengths, spec.new_counts,
                                     spec.target_counts, scale_len,
                                     max_rel_pos)
