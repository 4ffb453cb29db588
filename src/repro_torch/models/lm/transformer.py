"""Dense / MoE GQA transformer LM (torch port of
``repro/models/lm/transformer.py``): the LM-family archs.

The reference's parameter tree, path for path: per-layer params stacked on
a leading ``L`` axis. The reference scans over that axis under
``jax.checkpoint(nothing_saveable)``; the port loops over the layers and,
when autograd records, runs each under ``torch.utils.checkpoint`` (only a
layer's input is kept; the backward recomputes the layer). That changes
memory, not numbers. RoPE (non-interleaved halves), SwiGLU / GELU (the tanh
approximation, ``jax.nn.gelu``'s default), RMSNorm, GQA attention causal by
positions, and the q-chunked branch above ``full_attn_max_seq`` (the (Sq,
Skv) scores never exist whole).

Mixed precision as the reference: params (f32 unless ``param_dtype`` says
bf16) are cast to the compute dtype once a forward; RMSNorm runs in f32
and casts back; the attention scores and the logits are products of
compute-dtype values summed and returned in f32 (the reference's
``preferred_element_type``). The port multiplies f32 copies of the two
operands, which gives the same products: a bf16 × bf16 product is exact in
f32. The token embedding is read through ``embeddings.sparse.gather_rows``,
whose backward sums repeated tokens in a fixed order on the card.

The paper's ROO dedup does not apply to LM pretraining batches: these archs
run without it.

Under an SPMD plan (one process a rank, ``distributed/``) every entry point
takes the global tokens on every rank and each rank holds its blocks of the
params by :func:`lm_param_specs` (Megatron TP over ``model``: q heads,
d_ff, vocab and experts; FSDP over the fsdp axes for the other dim of every
matrix). Both values of ``use_spmd_layer`` run the explicit Megatron-SP
schedule of the reference's ``_layer_spmd`` (GSPMD's ``_layer`` computes
the same numbers): the residual is sequence-parallel over ``model``, each
block all-gathers its normed input over the sequence, runs its local
heads (every KV head is computed, each local q head picks its own) and its
d_ff / expert slice, and reduce-scatters the partial output back. A
layer's weights are gathered over the fsdp axes inside the checkpointed
layer, so the backward regathers them instead of keeping them. Where
``n_heads`` does not divide over ``model`` the attention runs all heads on
every model rank (``wq`` / ``wo`` gathered over ``model`` too) and the
block output is cut back to the rank's sequence chunk. The token
embedding is vocab-parallel: each model rank looks up the ids in its row
range and the partials are reduce-scattered into the sequence-parallel
residual; the tied head multiplies the gathered hidden by the rank's
vocab rows (logits vocab-sharded) and :func:`lm_loss`'s log-sum-exp and
label pick are sums over ``model``. :func:`lm_grad_axes` tells the train
step the axes each leaf's use is split over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.hstu import normal_init
from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingPlan, replicated_plan)
from repro_torch.embeddings.sparse import gather_rows
from repro_torch.models.lm.moe import (MoEConfig, moe_init, moe_layer,
                                       moe_param_specs)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    activation: str = "swiglu"          # swiglu | gelu
    moe: Optional[MoEConfig] = None
    param_dtype: str = "float32"        # float32 | bfloat16
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = True
    q_chunk: int = 1024                 # q-block size for chunked attention
    full_attn_max_seq: int = 4096       # above this, use chunked attention
    use_spmd_layer: bool = False        # explicit megatron-SP layer

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def n_params(self) -> int:
        d, h, kv, dh, f, L = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.d_head, self.d_ff, self.n_layers)
        attn = d * h * dh + d * 2 * kv * dh + h * dh * d
        if self.moe:
            mlp = (d * self.moe.n_experts_padded
                   + self.moe.n_experts * 3 * d * self.moe.d_ff_expert)
        else:
            n_in = 2 if self.activation == "swiglu" else 1
            mlp = n_in * d * f + f * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return L * (attn + mlp + 2 * d) + emb + d

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        h, kv, dh = self.n_heads, self.n_kv_heads, self.d_head
        attn = d * h * dh + d * 2 * kv * dh + h * dh * d
        mlp = (d * self.moe.n_experts_padded
               + self.moe.top_k * 3 * d * self.moe.d_ff_expert)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return L * (attn + mlp + 2 * d) + emb + d


def _enabled(plan) -> bool:
    return plan is not None and plan.enabled


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def lm_init(gen: torch.Generator, cfg: LMConfig, device="cuda",
            plan=None) -> Dict:
    """The params, drawn leaf by leaf from ``gen``. Under an enabled
    ``plan`` each leaf is cut to this rank's block as soon as it is drawn
    (and the whole leaf freed), so no rank ever holds the whole tree and
    the blocks equal a cut of the one-process init."""
    dt = cfg.pdtype
    d, h, kv, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.d_head, cfg.d_ff, cfg.n_layers)
    specs = lm_block_specs(cfg, plan) if _enabled(plan) else None
    cut = _cutter(specs, plan)

    def nrm(shape, fan_in, *path):
        return cut(normal_init(gen, shape, fan_in ** -0.5, dt, device), path)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": ones(L, d),
        "wq": nrm((L, d, h * dh), d, "layers", "wq"),
        "wkv": nrm((L, d, 2 * kv * dh), d, "layers", "wkv"),
        "wo": nrm((L, h * dh, d), h * dh, "layers", "wo"),
        "mlp_norm": ones(L, d),
    }
    if cfg.moe is not None:
        layers.update(moe_init(gen, cfg.moe, L, d, dt, device,
                               cut=lambda x, name: cut(x, ("layers", name))))
    else:
        layers["w1"] = nrm((L, d, f), d, "layers", "w1")
        if cfg.activation == "swiglu":
            layers["w3"] = nrm((L, d, f), d, "layers", "w3")
        layers["w2"] = nrm((L, f, d), f, "layers", "w2")
    params = {
        "embed": cut(normal_init(gen, (cfg.vocab, d), 0.02, dt, device),
                     ("embed",)),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["head"] = cut(normal_init(gen, (cfg.vocab, d), 0.02, dt,
                                         device), ("head",))
    return params


def _cutter(specs, plan):
    """(leaf, path) -> this rank's block of the leaf by ``specs``."""
    if specs is None:
        return lambda x, path: x
    from repro_torch.distributed import spmd

    def cut(x, path):
        node = specs
        for k in path:
            node = node[k]
        return spmd.local_block(x, node, plan)
    return cut


def lm_param_specs(cfg: LMConfig, plan) -> Dict:
    """The spec tree matching :func:`lm_init`'s (reference
    ``transformer.py:124-148``)."""
    m, fs = plan.model_axis, plan.fsdp_axis
    layers = {
        "attn_norm": (None, None),
        "wq": (None, fs, m),
        "wkv": (None, fs, None),
        "wo": (None, m, fs),
        "mlp_norm": (None, None),
    }
    if cfg.moe is not None:
        layers.update(moe_param_specs(plan))
    else:
        layers["w1"] = (None, fs, m)
        if cfg.activation == "swiglu":
            layers["w3"] = (None, fs, m)
        layers["w2"] = (None, m, fs)
    specs = {"embed": (m, fs), "layers": layers, "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["head"] = (m, fs)
    return specs


def lm_shapes(cfg: LMConfig) -> Dict:
    """The global shape of every leaf of :func:`lm_init`'s tree."""
    d, h, kv, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.d_head, cfg.d_ff, cfg.n_layers)
    layers = {"attn_norm": (L, d), "wq": (L, d, h * dh),
              "wkv": (L, d, 2 * kv * dh), "wo": (L, h * dh, d),
              "mlp_norm": (L, d)}
    if cfg.moe is not None:
        ep, fe = cfg.moe.n_experts_padded, cfg.moe.d_ff_expert
        layers.update(router=(L, d, ep), w1e=(L, ep, d, fe),
                      w3e=(L, ep, d, fe), w2e=(L, ep, fe, d))
    else:
        layers["w1"] = (L, d, f)
        if cfg.activation == "swiglu":
            layers["w3"] = (L, d, f)
        layers["w2"] = (L, f, d)
    shapes = {"embed": (cfg.vocab, d), "layers": layers, "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["head"] = (cfg.vocab, d)
    return shapes


def lm_block_specs(cfg: LMConfig, plan) -> Dict:
    """:func:`lm_param_specs` fitted to the leaves' shapes on ``plan``'s
    mesh: what each rank really holds (``spmd.fit_spec``)."""
    from repro_torch.distributed import spmd
    specs = lm_param_specs(cfg, plan)
    shapes = lm_shapes(cfg)

    def fit(sp, sh):
        if isinstance(sp, dict):
            return {k: fit(sp[k], sh[k]) for k in sp}
        return spmd.fit_spec(sp, sh, plan)
    return fit(specs, shapes)


def _heads_split(cfg: LMConfig, plan) -> bool:
    from repro_torch.distributed import spmd
    return cfg.n_heads % spmd.model_shard_count(plan) == 0


def lm_grad_axes(cfg: LMConfig, plan) -> Dict:
    """The axes each leaf's use is split over (``make_train_step``'s
    ``grad_axes``): the batch axes and ``model`` (the sequence-parallel
    residual, the local heads, d_ff, vocab and experts), except the
    attention's weights where the heads do not split over ``model``:
    their use is then replicated over it."""
    ba = tuple(plan.batch_axes)
    full = ba + (plan.model_axis,)

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if (not _heads_split(cfg, plan) and path[:1] == ("layers",)
                and path[-1] in ("wq", "wkv", "wo")):
            return ba
        return full
    return walk(lm_param_specs(cfg, plan))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    n = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (n * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, d_head); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # (.., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _attention(q, k, v, q_pos, kv_pos, cfg: LMConfig, kv_valid=None):
    """GQA attention, causal by positions. q: (B, Sq, H, dh); k, v: (B, Skv,
    KV, dh) -> (B, Sq, H, dh). Above ``full_attn_max_seq`` query rows go in
    blocks of ``q_chunk``, so the (Sq, Skv) scores never exist whole."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = dh ** -0.5
    # (B, KV, G, Sq, dh): a KV head's G query heads share one product
    qg = q.reshape(b, sq, kvh, g, dh).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1).float()                      # (B, KV, dh, S)
    vt = v.permute(0, 2, 1, 3)                              # (B, KV, S, dh)

    def block(q_blk, qpos_blk):
        t = q_blk.shape[3]
        scores = torch.matmul(q_blk.reshape(b, kvh, g * t, dh).float(),
                              kt).reshape(b, kvh, g, t, -1) * scale
        mask = kv_pos[:, None, :] <= qpos_blk[:, :, None]    # (B, T, Skv)
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, :]
        scores = torch.where(mask[:, None, None], scores, -1e30)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.matmul(p.reshape(b, kvh, g * t, -1),
                            vt).reshape(b, kvh, g, t, dh)

    if sq <= cfg.full_attn_max_seq:
        out = block(qg, q_pos)
    else:
        out = torch.cat([block(qb, pb) for qb, pb in zip(
            torch.split(qg, cfg.q_chunk, dim=3),
            torch.split(q_pos, cfg.q_chunk, dim=1))], dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def _mlp(x: torch.Tensor, lyr: Dict, cfg: LMConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ lyr["w1"]) * (x @ lyr["w3"])
    else:
        h = F.gelu(x @ lyr["w1"], approximate="tanh")
    return h @ lyr["w2"]


def _qkv(xn: torch.Tensor, lyr: Dict, cfg: LMConfig, positions):
    """The roped q (B, S, H, dh), the roped k and v (B, S, KV, dh)."""
    b, s, _ = xn.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (xn @ lyr["wq"]).reshape(b, s, h, dh)
    kvp = (xn @ lyr["wkv"]).reshape(b, s, 2, kvh, dh)
    return (rope(q, positions, cfg.rope_theta),
            rope(kvp[:, :, 0], positions, cfg.rope_theta), kvp[:, :, 1])


def _ffn(x: torch.Tensor, lyr: Dict, cfg: LMConfig) -> torch.Tensor:
    """The block's second half: x + MLP or MoE of the normed residual."""
    xn = _rmsnorm(x, lyr["mlp_norm"])
    if cfg.moe is not None:
        return x + moe_layer(xn, lyr, cfg.moe)
    return x + _mlp(xn, lyr, cfg)


def _layer(x: torch.Tensor, lyr: Dict, cfg: LMConfig, positions):
    """One transformer block. x: (B, S, d)."""
    b, s, _ = x.shape
    q, k, v = _qkv(_rmsnorm(x, lyr["attn_norm"]), lyr, cfg, positions)
    attn = _attention(q, k, v, positions, positions, cfg)
    x = x + attn.reshape(b, s, -1) @ lyr["wo"]
    return _ffn(x, lyr, cfg)


def layer_params(params: Dict, cdt: torch.dtype) -> list:
    """Per-layer dicts of the stacked ``params["layers"]`` in the compute
    dtype (one cast a leaf, then views of the L axis)."""
    names = sorted(params["layers"])
    cast = [params["layers"][n].to(cdt) for n in names]
    return [dict(zip(names, vals))
            for vals in zip(*(torch.unbind(t, 0) for t in cast))]


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _body(x, lyr, cfg: LMConfig, positions, collect_kv: bool):
    ys = None
    if collect_kv:
        # K/V for the cache (prefill): recomputed, cheap beside attention
        _, k, v = _qkv(_rmsnorm(x, lyr["attn_norm"]), lyr, cfg, positions)
        ys = (k, v)
    return _layer(x, lyr, cfg, positions), ys


# ---------------------------------------------------------------------------
# the plan route (module note)
# ---------------------------------------------------------------------------

class _Route:
    """What a forward under a plan needs of it: the realized specs, the
    model axis as ``collectives.Axes``, this rank's coordinates."""

    def __init__(self, cfg: LMConfig, plan):
        from repro_torch.distributed import spmd
        self.cfg, self.plan = cfg, plan
        self.specs = lm_block_specs(cfg, plan)
        self.m_axes = spmd.plan_axes(plan, plan.model_axis)
        self.b_axes = spmd.plan_axes(plan, tuple(plan.batch_axes))
        self.n_model = spmd.model_shard_count(plan)
        self.k_model = spmd.model_index(plan)
        self.n_batch = spmd.data_shard_count(plan)
        self.tp = _heads_split(cfg, plan)
        self.h_loc = cfg.n_heads // self.n_model if self.tp else cfg.n_heads
        head = "embed" if cfg.tie_embeddings else "head"
        for name, spec in (("embed", self.specs["embed"]),
                           (head, self.specs[head])):
            if not spec or spec[0] != plan.model_axis:
                raise ValueError(f"vocab {cfg.vocab} ({name}) does not split "
                                 f"over {self.n_model} model ranks")
        if cfg.moe is None and cfg.d_ff % self.n_model:
            raise ValueError(f"d_ff {cfg.d_ff} does not split over "
                             f"{self.n_model} model ranks")

    def batch_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global batch when the batch axes divide
        it (the reference's layout), else the whole batch."""
        from repro_torch.distributed import collectives as coll
        if self.batch_split(x.shape[0]):
            return coll.chunk_dim(x, self.b_axes, 0)
        return x

    def batch_split(self, b: int) -> bool:
        return self.n_batch > 1 and b % self.n_batch == 0

    def weight(self, lyr: Dict, name: str, model_too: bool = False):
        """A layer's weight gathered for use over its fsdp dims (backward:
        the reduce-scatter), and over ``model`` too (backward: this rank's
        chunk, the use being replicated there) with ``model_too``."""
        from repro_torch.distributed import collectives as coll
        from repro_torch.distributed import spmd
        w = lyr[name]
        spec = self.specs["layers"][name][1:]
        for dim, e in enumerate(spec):
            axes = spmd.entry_axes(e)
            if not axes:
                continue
            if self.plan.model_axis in axes:
                if model_too:
                    w = _note("lm:weight_gather:model", coll.all_gather_dim(
                        w, self.m_axes, dim, "slice"), "all_gather")
                continue
            w = _note("lm:weight_gather:fsdp", coll.all_gather_dim(
                w, spmd.plan_axes(self.plan, axes), dim), "all_gather")
        return w

    def vocab_rows(self, params: Dict, name: str) -> torch.Tensor:
        """This model rank's vocab rows of ``embed`` / ``head``, their
        columns gathered over the fsdp axes."""
        from repro_torch.distributed import collectives as coll
        from repro_torch.distributed import spmd
        w = params[name]
        e = self.specs[name][1] if len(self.specs[name]) > 1 else None
        if spmd.entry_axes(e):
            w = _note("lm:vocab_gather:fsdp", coll.all_gather_dim(
                w, spmd.plan_axes(self.plan, e), 1), "all_gather")
        return w


def _note(site: str, x: torch.Tensor, collective: str) -> torch.Tensor:
    """Account one call of a dense exchange site (``comms.STATS``): the
    bytes of the whole tensor it gathers or scatters. Forward calls only
    (each backward mirrors its forward), a checkpointed layer's recompute
    included."""
    from repro_torch.distributed import comms
    comms.STATS.record_bytes(site, x.numel() * x.element_size(), collective)
    return x


def _local_ids(ids: torch.Tensor, rows: int, k: int):
    """Ids in model rank k's row range [k * rows, (k + 1) * rows), as local
    rows (clamped), and the mask of those that are."""
    local = ids.long() - k * rows
    ok = (local >= 0) & (local < rows)
    return torch.clamp(local, 0, rows - 1), ok


def _embed_plan(params: Dict, cfg: LMConfig, tokens: torch.Tensor,
                r: _Route) -> torch.Tensor:
    """The vocab-parallel lookup into the sequence-parallel residual:
    (B, S) ids -> (B, S / n_model, d)."""
    from repro_torch.distributed import collectives as coll
    emb = r.vocab_rows(params, "embed")
    local, ok = _local_ids(tokens, emb.shape[0], r.k_model)
    part = gather_rows(emb, local) * ok[..., None].to(emb.dtype)
    return coll.reduce_scatter_dim(_note("lm:embed_scatter:seq", part,
                                         "reduce_scatter"), r.m_axes, 1)


def _layer_plan(x, lyr, cfg: LMConfig, r: _Route, positions,
                collect_kv: bool):
    """One block under a plan (module note). x: (B, S / n_model, d)
    sequence-parallel; positions: (B, S)."""
    from repro_torch.distributed import collectives as coll
    b = x.shape[0]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    hl = r.h_loc
    xn = _rmsnorm(x, lyr["attn_norm"])
    xg = _note("lm:layer_gather:seq", coll.all_gather_dim(
        xn, r.m_axes, 1, "reduce_scatter" if r.tp else "slice"), "all_gather")
    s = xg.shape[1]
    wq = r.weight(lyr, "wq", model_too=not r.tp)
    wo = r.weight(lyr, "wo", model_too=not r.tp)
    q = rope((xg @ wq).reshape(b, s, hl, dh), positions, cfg.rope_theta)
    kvp = (xg @ r.weight(lyr, "wkv")).reshape(b, s, 2, kvh, dh)
    k_all = rope(kvp[:, :, 0], positions, cfg.rope_theta)
    v_all = kvp[:, :, 1]
    if r.tp:
        # each local q head's KV head (all KV heads are computed here)
        kv_idx = ((r.k_model * hl + torch.arange(hl, device=x.device))
                  // max(h // kvh, 1))
        k, v = k_all[:, :, kv_idx], v_all[:, :, kv_idx]
    else:
        k, v = k_all, v_all
    attn = _attention(q, k, v, positions, positions, cfg)
    part = attn.reshape(b, s, hl * dh) @ wo
    x = x + (coll.reduce_scatter_dim(_note(
        "lm:layer_scatter:seq", part, "reduce_scatter"), r.m_axes, 1)
        if r.tp else coll.slice_dim(part, r.m_axes, 1))

    xn = _rmsnorm(x, lyr["mlp_norm"])
    if cfg.moe is not None:
        y = moe_layer(xn, lyr, cfg.moe, r.plan, seq_sharded=True)
    else:
        xg = _note("lm:layer_gather:seq", coll.all_gather_dim(
            xn, r.m_axes, 1), "all_gather")
        w1 = r.weight(lyr, "w1")
        if cfg.activation == "swiglu":
            hh = F.silu(xg @ w1) * (xg @ r.weight(lyr, "w3"))
        else:
            hh = F.gelu(xg @ w1, approximate="tanh")
        y = coll.reduce_scatter_dim(_note(
            "lm:layer_scatter:seq", hh @ r.weight(lyr, "w2"),
            "reduce_scatter"), r.m_axes, 1)
    return x + y, ((k_all, v_all) if collect_kv else None)


def _forward_plan(params: Dict, cfg: LMConfig, tokens: torch.Tensor,
                  r: _Route, collect_kv: bool):
    tokens = r.batch_block(tokens)
    b, s = tokens.shape
    if s % r.n_model:
        raise ValueError(f"sequence {s} does not split over {r.n_model} "
                         f"model ranks")
    x = _embed_plan(params, cfg, tokens, r).to(cfg.cdtype)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    ks, vs = [], []
    for lyr in layer_params(params, cfg.cdtype):
        if torch.is_grad_enabled():
            x, ys = checkpoint(_layer_plan, x, lyr, cfg, r, positions,
                               collect_kv, use_reentrant=False)
        else:
            x, ys = _layer_plan(x, lyr, cfg, r, positions, collect_kv)
        if collect_kv:
            ks.append(ys[0])
            vs.append(ys[1])
    x = _rmsnorm(x, params["final_norm"])
    if collect_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x


def _vocab_logits(params: Dict, cfg: LMConfig, hidden: torch.Tensor,
                  r: _Route) -> torch.Tensor:
    """(B, S, d) hidden whole over ``model`` -> (B, S, V / n_model) f32
    logits of this rank's vocab rows."""
    head = r.vocab_rows(params, "embed" if cfg.tie_embeddings else "head")
    return torch.matmul(hidden.float(), head.to(hidden.dtype).float().t())


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def lm_forward(params: Dict, cfg: LMConfig, tokens: torch.Tensor,
               plan=None, collect_kv: bool = False):
    """tokens: (B, S) int -> hidden (B, S, d) in the compute dtype [+ the
    per-layer (k, v) stacks, each (L, B, S, KV, dh)].

    Under an enabled ``plan``: ``tokens`` is the global batch on every
    rank, the hidden this rank's block (B / n_batch when the batch axes
    divide B, S / n_model) and the K/V stacks its batch block, whole over
    the sequence and the KV heads."""
    if _enabled(plan):
        return _forward_plan(params, cfg, tokens, _Route(cfg, plan),
                             collect_kv)
    b, s = tokens.shape
    x = gather_rows(params["embed"], tokens).to(cfg.cdtype)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    ks, vs = [], []
    for lyr in layer_params(params, cfg.cdtype):
        if torch.is_grad_enabled():
            x, ys = checkpoint(_body, x, lyr, cfg, positions, collect_kv,
                               use_reentrant=False)
        else:
            x, ys = _body(x, lyr, cfg, positions, collect_kv)
        if collect_kv:
            ks.append(ys[0])
            vs.append(ys[1])
    x = _rmsnorm(x, params["final_norm"])
    if collect_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x


def lm_logits(params: Dict, cfg: LMConfig, hidden: torch.Tensor,
              plan=None) -> torch.Tensor:
    """(B, S, d) hidden -> (B, S, V) f32 logits: compute-dtype products
    summed in f32. Under an enabled ``plan`` the hidden is
    :func:`lm_forward`'s block and the logits are this rank's (B, S,
    V / n_model) vocab block, as the reference constrains them."""
    if _enabled(plan):
        from repro_torch.distributed import collectives as coll
        r = _Route(cfg, plan)
        return _vocab_logits(params, cfg, _note(
            "lm:head_gather:seq", coll.all_gather_dim(hidden, r.m_axes, 1),
            "all_gather"), r)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return torch.matmul(hidden.float(), head.to(hidden.dtype).float().t())


def lm_loss(params: Dict, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor, plan=None) -> torch.Tensor:
    """Cross-entropy of ``labels`` under the logits at each position (the
    caller shifts, or not: the reference's launcher passes the tokens).
    Under an enabled ``plan`` both are the global batch, every rank
    returns the global mean, and the log-sum-exp and the label's logit
    are sums over ``model`` of each rank's vocab block."""
    if not _enabled(plan):
        logits = lm_logits(params, cfg, lm_forward(params, cfg, tokens))
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.mean(lse - lab)
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import spmd
    r = _Route(cfg, plan)
    if r.n_batch > 1 and not r.batch_split(tokens.shape[0]):
        raise ValueError(f"batch {tokens.shape[0]} does not split over "
                         f"{r.n_batch} batch ranks")
    hidden = _forward_plan(params, cfg, tokens, r, False)
    logits = _vocab_logits(params, cfg, _note(
        "lm:head_gather:seq", coll.all_gather_dim(hidden, r.m_axes, 1),
        "all_gather"), r)
    groups = [spmd.model_group(plan)]
    mx = coll.all_reduce_max(logits.amax(-1), groups)
    se = coll.all_reduce_sum(torch.exp(logits - mx[..., None]).sum(-1),
                             groups)
    local, ok = _local_ids(r.batch_block(labels), logits.shape[-1],
                           r.k_model)
    pick = torch.gather(logits, -1, local[..., None])[..., 0]
    lab = coll.all_reduce_sum(torch.where(ok, pick, 0.0), groups)
    total = spmd.data_sum(torch.sum(torch.log(se) + mx - lab), plan)
    return total / labels.numel()
