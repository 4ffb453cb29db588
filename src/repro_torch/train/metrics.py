"""Evaluation metrics: Normalized Entropy (NE), AUC and Recall@K (torch port
of ``repro/train/metrics.py``).

NE (He et al. 2014) = cross-entropy of the model / cross-entropy of the
background CTR predictor — the paper's ranking metric (lower is better;
NE < 1 beats predicting the base rate).
"""
from __future__ import annotations

from typing import Optional

import torch


def bce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE from logits in the stable form
    ``max(x, 0) - x y + log1p(exp(-|x|))``, with the reference's
    subgradients at x = 0 (where a zero-init head sits on padding rows):
    JAX's ``maximum`` splits the tie (``torch.maximum`` does too) and its
    ``abs`` takes +1 there (``torch.abs`` takes 0)."""
    zero = torch.zeros_like(logits)
    abs_x = torch.where(logits >= 0, logits, -logits)
    return torch.maximum(logits, zero) - logits * labels + \
        torch.log1p(torch.exp(-abs_x))


def bce(logits: torch.Tensor, labels: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy from logits (:func:`bce_terms`); weighted mean
    when ``weights`` is given."""
    loss = bce_terms(logits, labels)
    if weights is None:
        return torch.mean(loss)
    return torch.sum(loss * weights) / torch.clamp(torch.sum(weights),
                                                   min=1.0)


def normalized_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       plan=None) -> torch.Tensor:
    """NE = CE(model) / CE(base rate). Under an SPMD ``plan`` the inputs
    are this rank's batch block and every sum is summed over the batch
    axes (``spmd.data_sum``)."""
    from repro_torch.distributed.spmd import data_sum
    weights = (torch.ones_like(labels) if weights is None
               else weights.to(labels.dtype))
    loss = bce_terms(logits, labels)
    w_sum = torch.clamp(data_sum(torch.sum(weights), plan), min=1.0)
    ce = data_sum(torch.sum(loss * weights), plan) / w_sum
    p = data_sum(torch.sum(labels * weights), plan) / w_sum
    p = torch.clamp(p, 1e-6, 1 - 1e-6)
    ce_base = -(p * torch.log(p) + (1 - p) * torch.log(1 - p))
    return ce / ce_base


def make_ne_metrics(logits_labels_fn, plan=None):
    """Build a Trainer ``metrics_fn`` surfacing NE in the logged metrics.

    ``logits_labels_fn(params, batch) -> (logits, labels[, weights])``
    extracts the primary-task head from the model; the returned callable
    plugs into ``Trainer(metrics_fn=...)``, so every logged history row
    carries the paper's quality metric beside the loss (over the whole
    batch under an SPMD ``plan``).
    """
    def metrics_fn(params, batch, rng):
        out = logits_labels_fn(params, batch)
        logits, labels = out[0], out[1]
        weights = out[2] if len(out) > 2 else None
        return {"ne": normalized_entropy(logits, labels, weights, plan)}
    return metrics_fn


def recall_at_k(user_repr: torch.Tensor, item_repr: torch.Tensor,
                positives: torch.Tensor, k: int = 100) -> torch.Tensor:
    """user_repr: (B, d); item_repr: (N, d); positives: (B,) item indices.
    Fraction of users whose positive lands in their top-k scores."""
    scores = user_repr @ item_repr.T                    # (B, N)
    pos_score = torch.gather(scores, 1, positives.long()[:, None])[:, 0]
    rank = torch.sum(scores > pos_score[:, None], dim=1)
    return torch.mean((rank < k).to(torch.float32))


def auc(logits: torch.Tensor, labels: torch.Tensor,
        n_bins: int = 1024) -> torch.Tensor:
    """Histogram-approximated ROC-AUC (streaming-friendly)."""
    p = torch.sigmoid(logits)
    bins = torch.clamp((p * n_bins).to(torch.int32), 0, n_bins - 1).long()
    labels = labels.to(p.dtype)
    pos = torch.bincount(bins, weights=labels, minlength=n_bins)
    neg = torch.bincount(bins, weights=1 - labels, minlength=n_bins)
    cneg = torch.cumsum(neg, 0) - neg
    auc_num = torch.sum(pos * (cneg + 0.5 * neg))
    return auc_num / torch.clamp(torch.sum(pos) * torch.sum(neg), min=1.0)
