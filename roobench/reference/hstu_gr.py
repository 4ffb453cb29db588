"""Plain PyTorch hstu-gr ranking (Zhai et al. 2024, "Actions Speak Louder
than Words", HSTU with the request-only target layout): the yardstick the
program's served scores are held to. It uses nothing of the program.

One request at a time. The sequence is the request's history (its item
embedding plus its action embedding, at slots 0..L-1 of a ``hist_len``
window) followed by its targets (item embeddings at slots
``hist_len .. hist_len + t - 1``); the model is defined over
``S = hist_len + m_targets`` slots, and the empty ones change nothing but
the 1 / S scale. Each HSTU layer:

    [U, V, Q, K] = SiLU(LN(X) W + b)
    A = SiLU(Q K^T / sqrt(d_qk) + rab[clip(p_i - p_j)]) * mask / S
    X = X + ((LN(A V) * scale + bias) * U) W_o

with LN without affine (population variance, eps inside the root), after
an input LN with scale and bias. The mask: a history slot sees the
history up to itself; a target sees the whole history and itself. The
targets' outputs go through the task head (ReLU MLP).

Attention runs in blocks of query rows, so no (S, S) tensor is held.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def attention(q, k, v, rab, pos, is_hist, n_slots: int, max_rel: int,
              block: int = 1024) -> torch.Tensor:
    """q, k: (R, d_qk), v: (R, d_v) of one head over the request's real
    rows at slot positions ``pos``; rab: (2 * max_rel + 1,)."""
    out = []
    inv_d = 1.0 / math.sqrt(q.shape[-1])
    for r0 in range(0, q.shape[0], block):
        rows = slice(r0, r0 + block)
        s = (q[rows] @ k.T) * inv_d
        delta = torch.clamp(pos[rows, None] - pos[None, :], -max_rel,
                            max_rel) + max_rel
        s = s + rab[delta]
        hq, hk = is_hist[rows, None], is_hist[None, :]
        keep = ((hq & hk & (pos[None, :] <= pos[rows, None]))
                | (~hq & hk)
                | (~hq & ~hk & (pos[None, :] == pos[rows, None])))
        a = F.silu(s) / n_slots * keep.to(s.dtype)
        out.append(a @ v)
    return torch.cat(out, dim=0)


def request_logits(p: Dict, cfg: dict, hist_ids: Sequence[int],
                   hist_acts: Sequence[int],
                   item_ids: Sequence[int]) -> torch.Tensor:
    """(t, n_tasks) logits of one request's targets."""
    dev = p["item_emb"].device
    hid = torch.as_tensor(list(hist_ids), dtype=torch.long, device=dev)
    act = torch.as_tensor(list(hist_acts), dtype=torch.long, device=dev)
    tid = torch.as_tensor(list(item_ids), dtype=torch.long, device=dev)
    n_h, n_t = hid.numel(), tid.numel()
    x = torch.cat([p["item_emb"][hid] + p["act_emb"][act],
                   p["item_emb"][tid]], dim=0)
    pos = torch.cat([torch.arange(n_h, device=dev),
                     cfg["hist_len"] + torch.arange(n_t, device=dev)])
    is_hist = pos < cfg["hist_len"]
    n_slots = cfg["hist_len"] + cfg["m_targets"]
    h, dqk, dv, eps = cfg["n_heads"], cfg["d_qk"], cfg["d_v"], cfg["eps"]
    hs = p["hstu"]
    x = ln(x, eps) * hs["in_ln_scale"] + hs["in_ln_bias"]
    for lyr in hs["layers"]:
        uvqk = F.silu(ln(x, eps) @ lyr["w_uvqk"] + lyr["b_uvqk"])
        u, v, q, k = torch.split(uvqk, [h * dv, h * dv, h * dqk, h * dqk],
                                 dim=-1)
        av = torch.cat([attention(
            q[:, i * dqk:(i + 1) * dqk], k[:, i * dqk:(i + 1) * dqk],
            v[:, i * dv:(i + 1) * dv], lyr["rab"][i], pos, is_hist, n_slots,
            cfg["max_rel_pos"]) for i in range(h)], dim=-1)
        y = ln(av, eps) * lyr["ln_scale"] + lyr["ln_bias"]
        x = x + (y * u) @ lyr["w_o"]
    feats = x[n_h:]
    layers = p["task_head"]["layers"]
    for i, lyr in enumerate(layers):
        feats = feats @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            feats = torch.relu(feats)
    return feats
