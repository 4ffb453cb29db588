"""Plain PyTorch training of hstu-gr ranking (Zhai et al. 2024, "Actions
Speak Louder than Words", HSTU with the request-only target layout): the
yardstick the program's sparse-row training steps are held to. It uses
nothing of the program; the model is ``reference/hstu_gr.py``'s, one
request at a time on its real rows.

Loss: the masked multi-task BCE of the ranking head, task 0 on the first
label and task 1 on the second label being positive, summed over the
step's impressions and tasks and divided by their number (impressions
times tasks). Gradients by autograd; each HSTU layer is recomputed in the
backward (``torch.utils.checkpoint``), so only the layers' inputs are
held, and the attention runs in blocks of query rows, so no (S, S) tensor
is.

Optimizers as the configuration names them: row-wise Adagrad on the
embedding tables (``item_emb``, ``act_emb``: an accumulator a row, the mean
of the row's squared gradient added, the row stepped by
lr / (sqrt(acc) + eps)) and Adam on the rest (Kingma and Ba,
bias-corrected, eps outside the root).

The item table may be compact: only the rows the steps' ids name, with the
ids renumbered to them. A lookup's gradient and a row-wise Adagrad step on
a row depend on that row alone, so this computes what the full table
would.

Parameters are a flat dict by the program's path names (``item_emb``,
``act_emb``, ``hstu/in_ln_scale``, ``hstu/layers/<i>/w_uvqk``, ...,
``task_head/layers/<i>/w``). A request is a dict of ``hist``, ``acts`` and
``items`` (id tensors) and ``labels`` (``(len(items), 2)``).
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .hstu_gr import attention, ln

LAYER_KEYS = ("w_uvqk", "b_uvqk", "w_o", "ln_scale", "ln_bias", "rab")


def layer(x, pos, is_hist, cfg: dict, w_uvqk, b_uvqk, w_o, ln_scale,
          ln_bias, rab) -> torch.Tensor:
    """One HSTU layer over a request's real rows (``hstu_gr``'s
    equations)."""
    h, dqk, dv, eps = cfg["n_heads"], cfg["d_qk"], cfg["d_v"], cfg["eps"]
    n_slots = cfg["hist_len"] + cfg["m_targets"]
    uvqk = F.silu(ln(x, eps) @ w_uvqk + b_uvqk)
    u, v, q, k = torch.split(uvqk, [h * dv, h * dv, h * dqk, h * dqk],
                             dim=-1)
    av = torch.cat([attention(
        q[:, i * dqk:(i + 1) * dqk], k[:, i * dqk:(i + 1) * dqk],
        v[:, i * dv:(i + 1) * dv], rab[i], pos, is_hist, n_slots,
        cfg["max_rel_pos"]) for i in range(h)], dim=-1)
    y = ln(av, eps) * ln_scale + ln_bias
    return x + (y * u) @ w_o


def request_logits(p: Dict[str, torch.Tensor], cfg: dict,
                   req: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(t, n_tasks) logits of one request's targets."""
    hid, act, tid = req["hist"].long(), req["acts"].long(), \
        req["items"].long()
    n_h, n_t = hid.numel(), tid.numel()
    dev = hid.device
    x = torch.cat([p["item_emb"][hid] + p["act_emb"][act],
                   p["item_emb"][tid]], dim=0)
    pos = torch.cat([torch.arange(n_h, device=dev),
                     cfg["hist_len"] + torch.arange(n_t, device=dev)])
    is_hist = pos < cfg["hist_len"]
    x = ln(x, cfg["eps"]) * p["hstu/in_ln_scale"] + p["hstu/in_ln_bias"]
    for i in range(cfg["n_layers"]):
        ws = [p[f"hstu/layers/{i}/{k}"] for k in LAYER_KEYS]
        x = checkpoint(layer, x, pos, is_hist, cfg, *ws, use_reentrant=False)
    feats = x[n_h:]
    n_head = sum(1 for k in p if k.startswith("task_head/") and
                 k.endswith("/w"))
    for i in range(n_head):
        feats = feats @ p[f"task_head/layers/{i}/w"] + \
            p[f"task_head/layers/{i}/b"]
        if i < n_head - 1:
            feats = torch.relu(feats)
    return feats


def bce_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Summed binary cross-entropy from logits (the stable form)."""
    return torch.sum(torch.clamp(x, min=0) - x * y
                     + torch.log1p(torch.exp(-torch.abs(x))))


def targets(labels: torch.Tensor, n_tasks: int) -> torch.Tensor:
    """Task 0: the first label; task 1: the second label is positive."""
    return torch.stack([labels[:, 0], (labels[:, 1] > 0).to(labels.dtype)],
                       -1)[:, :n_tasks]


def step_grads(p: Dict[str, torch.Tensor], cfg: dict,
               batch: List[Dict[str, torch.Tensor]]):
    """(loss, {name: gradient}) of one step: each request's forward and
    backward in turn, its summed BCE scaled by the step's normaliser."""
    n_tasks = cfg["n_tasks"]
    norm = float(sum(r["items"].numel() for r in batch) * n_tasks)
    names = list(p)
    leaves = [p[n].detach().requires_grad_(True) for n in names]
    q = dict(zip(names, leaves))
    grads = [torch.zeros_like(x) for x in leaves]
    loss = 0.0
    for req in batch:
        part = bce_sum(request_logits(q, cfg, req),
                       targets(req["labels"], n_tasks)) / norm
        got = torch.autograd.grad(part, leaves, allow_unused=True)
        grads = [a if g is None else a + g for a, g in zip(grads, got)]
        loss += float(part.detach())
    return loss, dict(zip(names, grads))


def train(p0: Dict[str, torch.Tensor], cfg: dict,
          batches: List[List[Dict[str, torch.Tensor]]], opt: dict) -> Dict:
    """``len(batches)`` steps from ``p0``. Returns each step's loss, the
    first step's gradient norm by leaf, the parameters' change norm by leaf
    after the last step, and the final parameters."""
    p = {n: x.detach().clone() for n, x in p0.items()}
    emb = [n for n in p if "emb" in n]
    acc = {n: torch.zeros(p[n].shape[0], device=p[n].device) for n in emb}
    m = {n: torch.zeros_like(x) for n, x in p.items() if n not in acc}
    v = {n: torch.zeros_like(x) for n, x in m.items()}
    a, b1, b2 = opt["adam"]["lr"], opt["adam"]["b1"], opt["adam"]["b2"]
    eps_a = opt["adam"]["eps"]
    lr_e, eps_e = opt["rowwise_adagrad"]["lr"], opt["rowwise_adagrad"]["eps"]
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches, start=1):
        loss, grads = step_grads(p, cfg, batch)
        losses.append(loss)
        if step == 1:
            grad_norms = {n: float(torch.linalg.vector_norm(g))
                          for n, g in grads.items()}
        with torch.no_grad():
            for n, g in grads.items():
                if n in acc:
                    acc[n] = acc[n] + (g * g).mean(dim=1)
                    p[n] = p[n] - lr_e * g / (torch.sqrt(acc[n])
                                              + eps_e)[:, None]
                else:
                    m[n] = b1 * m[n] + (1 - b1) * g
                    v[n] = b2 * v[n] + (1 - b2) * g * g
                    mh = m[n] / (1 - b1 ** step)
                    vh = v[n] / (1 - b2 ** step)
                    p[n] = p[n] - a * mh / (torch.sqrt(vh) + eps_a)
    change = {n: float(torch.linalg.vector_norm(p[n] - p0[n]))
              for n in p}
    return {"losses": losses, "grad_norms": grad_norms, "change": change,
            "params": p}
