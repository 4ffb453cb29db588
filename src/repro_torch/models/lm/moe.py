"""Mixture-of-Experts block (torch port of ``repro/models/lm/moe.py``).

GShard-style capacity-based routing with sort-based dispatch (argsort by
expert + scatter into capacity slots) instead of the O(T·E·C·d) one-hot
einsum, as the reference: the gathers move O(T·k·d) bytes only.

The single-device route only. The argsort is stable (``jnp.argsort``'s
default), so the tokens that overflow an expert's capacity, and are
dropped, are the reference's. Overflow entries park in one extra buffer
row that is cut off, as the reference's ``.at[slot].set`` does. The
repeated-index sums run in a fixed order so that a second run on the card
is bit for bit: each token's k copies are gathered through
``embeddings.sparse.gather_rows`` (whose backward sums duplicates in a
fixed order), and the combine adds a token's k contributions one after
another in ascending expert order, the order in which the reference's
scatter-add meets them, instead of a scatter-add with float atomics.

Under an enabled SPMD plan :func:`moe_layer` raises: the expert-parallel
``all_to_all`` route and the experts' FSDP storage are ROADMAP A9b.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.hstu import normal_init
from repro_torch.embeddings.sparse import gather_rows

PLAN_NOT_PORTED = ("the MoE's expert-parallel all_to_all route and its "
                   "FSDP expert storage are not ported yet (ROADMAP A9b)")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    pad_to: int = 16                 # pad expert count to EP-degree multiple
    router_dtype: str = "float32"

    @property
    def n_experts_padded(self) -> int:
        return math.ceil(self.n_experts / self.pad_to) * self.pad_to


def moe_init(gen: torch.Generator, cfg: MoEConfig, n_layers: int,
             d_model: int, dtype=torch.float32, device="cuda") -> Dict:
    ep, fe = cfg.n_experts_padded, cfg.d_ff_expert

    def nrm(shape, fan_in):
        return normal_init(gen, shape, fan_in ** -0.5, dtype, device)

    return {
        "router": nrm((n_layers, d_model, ep), d_model),
        "w1e": nrm((n_layers, ep, d_model, fe), d_model),
        "w3e": nrm((n_layers, ep, d_model, fe), d_model),
        "w2e": nrm((n_layers, ep, fe, d_model), fe),
    }


def _capacity(t_local: int, cfg: MoEConfig) -> int:
    return max(1, math.ceil(t_local * cfg.top_k / cfg.n_experts_padded
                            * cfg.capacity_factor))


def _route_local(xt: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """xt: (T, d). Returns (topk_idx (T, k) int32, topk_prob (T, k) f32);
    padded experts never win."""
    rl = xt.float() @ router.float()
    pad = torch.arange(cfg.n_experts_padded, device=xt.device) >= cfg.n_experts
    rl = torch.where(pad[None, :], -1e30, rl)
    probs = torch.softmax(rl, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_i.to(torch.int32), top_p


def _dispatch_slots(top_i: torch.Tensor, c: int, cfg: MoEConfig):
    """The sort-based dispatch of (T, k) expert choices into capacity
    ``c``: (order, st, in_cap, slot), each over the T·k entries in stably
    sorted expert order: the sort, each entry's token, whether it fits its
    expert's capacity, and its buffer row (E·c, the park row, if not)."""
    t, k = top_i.shape
    ep, dev = cfg.n_experts_padded, top_i.device
    flat_e = top_i.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.arange(t, device=dev).repeat_interleave(k)[order]
    # se is sorted: each expert's first entry is its exclusive count prefix
    starts = torch.searchsorted(se, torch.arange(ep, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[se]
    in_cap = pos < c
    slot = torch.where(in_cap, se * c + pos, ep * c)        # park overflow
    return order, st, in_cap, slot


def _dispatch_compute_combine(xt, router, w1, w3, w2,
                              cfg: MoEConfig) -> torch.Tensor:
    """route -> sort-dispatch -> expert SwiGLU -> combine, one device.
    xt: (T, d); w1 / w3: (E, d, fe); w2: (E, fe, d)."""
    t, d = xt.shape
    ep, k = cfg.n_experts_padded, cfg.top_k
    c = _capacity(t, cfg)
    dev = xt.device
    top_i, top_p = _route_local(xt, router, cfg)

    # ---- sort-based dispatch into the (E, C, d) capacity buffer -----------
    order, st, in_cap, slot = _dispatch_slots(top_i, c, cfg)
    sp = top_p.reshape(-1).gather(0, order)
    buf = xt.new_zeros((ep * c + 1, d)).index_put((slot,),
                                                  gather_rows(xt, st))
    buf = buf[:-1].reshape(ep, c, d)

    # ---- expert FFN ---------------------------------------------------------
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    out = torch.bmm(h, w2)                                   # (E, C, d)

    # ---- combine ------------------------------------------------------------
    gathered = gather_rows(out.reshape(ep * c, d),
                           torch.clamp(slot, max=ep * c - 1))
    gathered = torch.where(in_cap[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype, device=dev))
    contrib = (gathered * sp[:, None]).to(xt.dtype)
    # each (token, rank) entry's place in the sorted order, its k entries
    # taken in ascending expert order (the sorted order's within a token)
    where = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=dev))
    by_expert = torch.argsort(top_i, dim=1, stable=True)
    parts = gather_rows(contrib, where.reshape(t, k).gather(1, by_expert)
                        .reshape(-1)).reshape(t, k, d)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y


def moe_layer(x: torch.Tensor, lyr: Dict, cfg: MoEConfig,
              plan=None) -> torch.Tensor:
    """x: (B, S, d) residual -> (B, S, d), on one device."""
    if plan is not None and plan.enabled:
        raise NotImplementedError(f"moe_layer under a plan: "
                                  f"{PLAN_NOT_PORTED}")
    b, s, d = x.shape
    y = _dispatch_compute_combine(x.reshape(b * s, d), lyr["router"],
                                  lyr["w1e"], lyr["w3e"], lyr["w2e"], cfg)
    return y.reshape(b, s, d)
