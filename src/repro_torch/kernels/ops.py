"""Public wrappers over the hand-written kernels with the plain torch
oracles beside them (torch port of ``repro/kernels/ops.py``).

``use_pallas`` keeps the reference's name and values, mapped onto the
port's dispatch (``kernels/dispatch.py``):

  "never"  — the plain torch oracle (kernels/ref.py): the dense attention,
             the take + masked reduce bag, the fp32 bmm + tril gather;
  "auto"   — the backend knob ladder (explicit scope > process default >
             ``REPRO_TORCH_*_BACKEND`` > auto: the CUDA kernel on a CUDA
             tensor, the plain torch path otherwise);
  "always" — the CUDA kernel (B1, B5, B7); on a CPU tensor dispatch's
             ``cuda`` rung raises, as it does for any call that names it.

No wrapper has a kernel of its own: each reaches its family's entry point,
so a launch counts on the kernel module's counter as any other.
"""
from __future__ import annotations

import torch

from repro_torch.core.masks import MaskSpec
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.kernels import ref as _ref

USE_PALLAS = ("never", "auto", "always")


def _check(use_pallas: str) -> None:
    if use_pallas not in USE_PALLAS:
        raise ValueError(f"use_pallas={use_pallas!r}; expected one of "
                         f"{USE_PALLAS}")


def hstu_attention(q, k, v, rab, hist_lengths, target_counts, *,
                   n_hist: int, max_rel_pos: int = 128,
                   use_pallas: str = "never") -> torch.Tensor:
    """HSTU attention under the ROO mask: q, k (B, H, S, Dqk), v (B, H, S,
    Dv), rab (H, 2 * max_rel_pos + 1) or None -> (B, H, S, Dv)."""
    _check(use_pallas)
    spec = MaskSpec(n_hist, hist_lengths, target_counts)
    backend = {"never": "torch-dense", "always": "cuda"}.get(use_pallas)
    return _dispatch.hstu_attention(q, k, v, rab, spec, backend=backend,
                                    max_rel_pos=max_rel_pos)


def embedding_bag(table, ids, lengths, *, pooling: str = "sum",
                  use_pallas: str = "never") -> torch.Tensor:
    """table (V, D), ids (B, L), lengths (B,) -> (B, D) pooled bags."""
    _check(use_pallas)
    if use_pallas == "never":
        return _ref.embedding_bag_ref(table, ids, lengths, pooling)
    from repro_torch.kernels.embedding_bag import embedding_bag as bag
    return bag(table, ids, lengths, pooling,
               backend="cuda" if use_pallas == "always" else None)


def dot_interaction(dense_out, sparse_embs, *,
                    use_pallas: str = "never") -> torch.Tensor:
    """dense_out (B, D), sparse_embs (B, F, D) -> (B, D + F(F+1)/2)."""
    _check(use_pallas)
    if use_pallas == "never":
        return _ref.dot_interaction_ref(dense_out, sparse_embs)
    from repro_torch.kernels.dot_interaction import dot_interaction as dot
    return dot(dense_out, sparse_embs,
               backend="cuda" if use_pallas == "always" else None)
