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

Under an SPMD plan (one process a rank, ``distributed/``) the experts are
split over ``model`` (expert parallelism) and their weights' ``d`` dims
over the fsdp axes (:func:`moe_param_specs`); each rank's weights are its
blocks, gathered over the fsdp axes just in time (the gather's backward
reduce-scatters the gradient). Two routes, as the reference's:

  * training (``seq_sharded=True``): each rank routes its own tokens into
    a per-rank capacity, then one ``all_to_all`` over ``model`` sends
    expert j's buffer rows to the rank holding j, the local experts run
    on every rank's rows, and the inverse exchange brings them back;
  * decode (``seq_sharded=False``): every model rank holds the same
    tokens, computes only its local experts into a zero ``(E, C, d)``
    buffer, and the combined outputs are summed over ``model``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.hstu import normal_init
from repro_torch.distributed.sharding import ShardingPlan  # noqa: F401
from repro_torch.embeddings.sparse import gather_rows



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
             d_model: int, dtype=torch.float32, device="cuda",
             cut=None) -> Dict:
    """The stacked MoE leaves; ``cut(leaf, name)`` (the LM's blockwise
    init under a plan) is applied to each as soon as it is drawn."""
    ep, fe = cfg.n_experts_padded, cfg.d_ff_expert
    cut = cut or (lambda x, name: x)

    def nrm(name, shape, fan_in):
        return cut(normal_init(gen, shape, fan_in ** -0.5, dtype, device),
                   name)

    return {
        "router": nrm("router", (n_layers, d_model, ep), d_model),
        "w1e": nrm("w1e", (n_layers, ep, d_model, fe), d_model),
        "w3e": nrm("w3e", (n_layers, ep, d_model, fe), d_model),
        "w2e": nrm("w2e", (n_layers, ep, fe, d_model), fe),
    }


def moe_param_specs(plan) -> Dict:
    """The stacked MoE leaves' specs (reference ``moe.py:57-64``)."""
    m, fs = plan.model_axis, plan.fsdp_axis
    return {"router": (None, None, None),
            "w1e": (None, m, fs, None),
            "w3e": (None, m, fs, None),
            "w2e": (None, m, None, fs)}


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


def _dispatch_compute_combine(xt, router, w1, w3, w2, cfg: MoEConfig,
                              experts=None) -> torch.Tensor:
    """route -> sort-dispatch -> expert SwiGLU -> combine. xt: (T, d);
    w1 / w3: (E', d, fe); w2: (E', fe, d). ``experts(buf (E, C, d)) ->
    (E, C, d)`` replaces the one-device FFN of all E experts (a plan's
    routes: the exchange and the local experts)."""
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
    out = (experts or (lambda bf: _ffn(bf, w1, w3, w2)))(buf)  # (E, C, d)

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


def _ffn(buf, w1, w3, w2) -> torch.Tensor:
    """The experts' SwiGLU on their buffer rows. buf: (E', C', d)."""
    h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
    return torch.bmm(h, w2)


def _gather_fsdp(w: torch.Tensor, spec, plan) -> torch.Tensor:
    """A weight's fsdp dims gathered for use (the ``model`` dim stays this
    rank's experts); backward the reduce-scatter over the fsdp axes."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import spmd
    from repro_torch.models.lm.transformer import _note
    for dim, e in enumerate(spec):
        axes = spmd.entry_axes(e)
        if axes and plan.model_axis not in axes:
            w = _note("moe:expert_gather:fsdp", coll.all_gather_dim(
                w, spmd.plan_axes(plan, axes), dim), "all_gather")
    return w


def _layer_specs(cfg: MoEConfig, d: int, plan) -> Dict:
    """One layer's realized specs (the stacked specs less their L entry,
    fitted to the global shapes)."""
    from repro_torch.distributed import spmd
    ep, fe = cfg.n_experts_padded, cfg.d_ff_expert
    shapes = {"w1e": (ep, d, fe), "w3e": (ep, d, fe), "w2e": (ep, fe, d)}
    stacked = moe_param_specs(plan)
    return {n: spmd.fit_spec(stacked[n][1:], shp, plan)
            for n, shp in shapes.items()}


def moe_layer(x: torch.Tensor, lyr: Dict, cfg: MoEConfig, plan=None,
              seq_sharded: bool = True, batch_whole: bool = False
              ) -> torch.Tensor:
    """x: (B, S, d) residual -> (B, S, d).

    Under an enabled ``plan`` ``x`` is this rank's block and ``lyr`` holds
    its weight blocks (module note); ``seq_sharded`` picks the route:
    training keeps the residual seq-sharded over ``model``, decode
    (S == 1) holds the same tokens on every model rank. ``batch_whole``
    says ``x`` is the whole batch on every rank (a decode cache whose
    batch is not split): the reference's layer still splits it over the
    batch axes when they divide it, so the capacity is the same."""
    b, s, d = x.shape
    if plan is None or not plan.enabled:
        y = _dispatch_compute_combine(x.reshape(b * s, d), lyr["router"],
                                      lyr["w1e"], lyr["w3e"], lyr["w2e"],
                                      cfg)
        return y.reshape(b, s, d)
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import spmd
    n_batch = spmd.data_shard_count(plan)
    if batch_whole and b % n_batch == 0 and b >= n_batch and n_batch > 1:
        mine = coll.chunk_dim(x, spmd.plan_axes(plan, plan.batch_axes), 0)
        y = moe_layer(mine, lyr, cfg, plan, seq_sharded)
        return spmd.gather_batch(y, plan)
    n = spmd.model_shard_count(plan)
    ep = cfg.n_experts_padded
    if ep % n:
        raise ValueError(f"{ep} experts do not split over {n} model ranks")
    e_loc = ep // n
    group = spmd.model_group(plan)
    specs = _layer_specs(cfg, d, plan)
    w1, w3, w2 = (_gather_fsdp(lyr[k], specs[k], plan)
                  for k in ("w1e", "w3e", "w2e"))
    if spmd.entry_axes(specs["w1e"][0] if specs["w1e"] else None) != (
            plan.model_axis,):
        raise ValueError("the experts are not split over model")

    from repro_torch.models.lm.transformer import _note

    def exchanged(buf):
        # expert j's rows to the rank holding j, and back
        buf = coll.all_to_all(_note("moe:dispatch:a2a", buf, "all_to_all"),
                              group, n, 0, 1)               # (E/n, n*C, d)
        out = _note("moe:combine:a2a", _ffn(buf, w1, w3, w2), "all_to_all")
        return coll.all_to_all(out, group, n, 1, 0)

    def local_only(buf):
        k = spmd.model_index(plan)
        out = _ffn(buf[k * e_loc:(k + 1) * e_loc], w1, w3, w2)
        return torch.cat([buf.new_zeros((k * e_loc,) + buf.shape[1:]), out,
                          buf.new_zeros(((n - k - 1) * e_loc,)
                                        + buf.shape[1:])])

    y = _dispatch_compute_combine(x.reshape(b * s, d), lyr["router"],
                                  w1, w3, w2, cfg,
                                  exchanged if seq_sharded else local_only)
    if not seq_sharded:
        y = coll.all_reduce_sum(y, [group])
    return y.reshape(b, s, d)
