"""Plain PyTorch DLRM with request-only (ROO) inputs, its loss, and the
optimizers the configuration names: the yardstick the program's dlrm is
held to. Written from the published model (Naumov et al. 2019; MLPerf
DLRM v1: sum bags, bottom MLP, dot interaction over the strict lower
triangle with the dense output first, top MLP) and from the configuration
file; it uses nothing of the program.

Parameters are a dict ``{"tables": [T_0, ...], "bot": [(w, b), ...],
"top": [(w, b), ...]}`` with ``x @ w + b`` layers and ReLU between them.
The user-side (RO) fields and the dense features are per request; each
impression reads its request's row through ``seg``.

Tables may be compact: only the rows a batch's ids name, with the ids
renumbered to them. A bag's sum, its gradient and a row-wise Adagrad step
on a row depend on that row alone, so this computes what the full table
would.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def mlp(layers, x: torch.Tensor) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def bag_sum(table: torch.Tensor, ids: torch.Tensor,
            lengths: torch.Tensor) -> torch.Tensor:
    """(B, L) ids, (B,) lengths -> (B, D): the sum of the rows of the
    first ``lengths`` slots of each bag."""
    valid = (torch.arange(ids.shape[1], device=ids.device)[None, :]
             < lengths[:, None])
    rows = table[torch.where(valid, ids.long(), 0)]
    return (rows * valid[..., None].to(rows.dtype)).sum(dim=1)


def logits(p: Dict, cfg: dict, b: Dict) -> torch.Tensor:
    n_ro = cfg["n_ro_fields"]
    n_f = len(p["tables"])
    dense = mlp(p["bot"], b["ro_dense"])
    ro = torch.stack([bag_sum(p["tables"][f], b["ro_ids"][:, f],
                              b["ro_len"][:, f]) for f in range(n_ro)], 1)
    nro = torch.stack([bag_sum(p["tables"][f], b["nro_ids"][:, f - n_ro],
                               b["nro_len"][:, f - n_ro])
                       for f in range(n_ro, n_f)], 1)
    seg = b["seg"].long()
    d = dense[seg]
    t = torch.cat([d[:, None, :], ro[seg], nro], dim=1)      # (B, F + 1, D)
    gram = torch.bmm(t, t.transpose(1, 2))
    i, j = torch.tril_indices(n_f + 1, n_f + 1, offset=-1, device=t.device)
    return mlp(p["top"], torch.cat([d, gram[:, i, j]], dim=1))[:, 0]


def bce(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits (the stable form)."""
    return torch.mean(torch.clamp(x, min=0) - x * y
                      + torch.log1p(torch.exp(-torch.abs(x))))


def leaf_names(p: Dict) -> List[str]:
    """Names of the leaves in :func:`leaves` order, as the program's
    parameter paths spell them."""
    names = [f"tables/t{f}" for f in range(len(p["tables"]))]
    for side, key in (("bot", "bot_mlp"), ("top", "top_mlp")):
        for i in range(len(p[side])):
            names += [f"{key}/layers/{i}/w", f"{key}/layers/{i}/b"]
    return names


def leaves(p: Dict) -> List[torch.Tensor]:
    out = list(p["tables"])
    for side in ("bot", "top"):
        for w, b in p[side]:
            out += [w, b]
    return out


def from_leaves(p: Dict, flat: List[torch.Tensor]) -> Dict:
    n_t = len(p["tables"])
    it = iter(flat[n_t:])
    return {"tables": flat[:n_t],
            "bot": [(next(it), next(it)) for _ in p["bot"]],
            "top": [(next(it), next(it)) for _ in p["top"]]}


def train(p0: Dict, cfg: dict, batches: List[Dict], opt: dict) -> Dict:
    """``len(batches)`` steps from ``p0``: BCE, its gradient by autograd,
    row-wise Adagrad on the tables (an accumulator a row: the mean of the
    row's squared gradient added, the row stepped by lr / (sqrt(acc) +
    eps)) and Adam on the rest (Kingma and Ba, bias-corrected, eps
    outside the root). Returns each step's loss, the first step's gradient
    norm by leaf, the parameters' change norm by leaf after the last step,
    and the final parameters."""
    n_t = len(p0["tables"])
    flat0 = [x.detach().clone() for x in leaves(p0)]
    flat = [x.clone() for x in flat0]
    acc = [torch.zeros(x.shape[0], device=x.device) for x in flat[:n_t]]
    m = [torch.zeros_like(x) for x in flat[n_t:]]
    v = [torch.zeros_like(x) for x in flat[n_t:]]
    a, b1, b2 = opt["adam"]["lr"], opt["adam"]["b1"], opt["adam"]["b2"]
    eps_a = opt["adam"]["eps"]
    lr_e, eps_e = opt["rowwise_adagrad"]["lr"], opt["rowwise_adagrad"]["eps"]
    losses, grad_norms = [], {}
    names = leaf_names(p0)
    for step, b in enumerate(batches, start=1):
        req = [x.requires_grad_(True) for x in flat]
        loss = bce(logits(from_leaves(p0, req), cfg, b), b["y"])
        grads = torch.autograd.grad(loss, req)
        losses.append(float(loss.detach()))
        if step == 1:
            grad_norms = {n: float(torch.linalg.vector_norm(g))
                          for n, g in zip(names, grads)}
        with torch.no_grad():
            new = []
            for k, (x, g) in enumerate(zip(req, grads)):
                x = x.detach()
                if k < n_t:
                    acc[k] = acc[k] + (g * g).mean(dim=1)
                    x = x - lr_e * g / (torch.sqrt(acc[k]) + eps_e)[:, None]
                else:
                    j = k - n_t
                    m[j] = b1 * m[j] + (1 - b1) * g
                    v[j] = b2 * v[j] + (1 - b2) * g * g
                    mh = m[j] / (1 - b1 ** step)
                    vh = v[j] / (1 - b2 ** step)
                    x = x - a * mh / (torch.sqrt(vh) + eps_a)
                new.append(x)
            flat = new
    change = {n: float(torch.linalg.vector_norm(x - x0))
              for n, x, x0 in zip(names, flat, flat0)}
    return {"losses": losses, "grad_norms": grad_norms, "change": change,
            "params": from_leaves(p0, flat)}
