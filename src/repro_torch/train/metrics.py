"""Evaluation metrics: Normalized Entropy (NE), AUC and Recall@K (torch port
of ``repro/train/metrics.py``).

NE (He et al. 2014) = cross-entropy of the model / cross-entropy of the
background CTR predictor — the paper's ranking metric (lower is better;
NE < 1 beats predicting the base rate).
"""
from __future__ import annotations

from typing import Optional

import torch


def bce(logits: torch.Tensor, labels: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy from logits, in the stable form; weighted mean
    when ``weights`` is given."""
    loss = torch.clamp(logits, min=0) - logits * labels + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    if weights is None:
        return torch.mean(loss)
    return torch.sum(loss * weights) / torch.clamp(torch.sum(weights),
                                                   min=1.0)


def normalized_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """NE = CE(model) / CE(base rate)."""
    weights = (torch.ones_like(labels) if weights is None
               else weights.to(labels.dtype))
    ce = bce(logits, labels, weights)
    p = torch.sum(labels * weights) / torch.clamp(torch.sum(weights), min=1.0)
    p = torch.clamp(p, 1e-6, 1 - 1e-6)
    ce_base = -(p * torch.log(p) + (1 - p) * torch.log(1 - p))
    return ce / ce_base


def make_ne_metrics(logits_labels_fn):
    """Build a Trainer ``metrics_fn`` surfacing NE in the logged metrics.

    ``logits_labels_fn(params, batch) -> (logits, labels[, weights])``
    extracts the primary-task head from the model; the returned callable
    plugs into ``Trainer(metrics_fn=...)``, so every logged history row
    carries the paper's quality metric beside the loss.
    """
    def metrics_fn(params, batch, rng):
        out = logits_labels_fn(params, batch)
        logits, labels = out[0], out[1]
        weights = out[2] if len(out) > 2 else None
        return {"ne": normalized_entropy(logits, labels, weights)}
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
