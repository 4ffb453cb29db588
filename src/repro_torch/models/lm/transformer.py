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
run without it. Under an enabled SPMD plan the LM raises: its FSDP / TP
storage and the explicit Megatron-SP layer (the reference's
``_layer_spmd``) are ROADMAP A9b.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.hstu import normal_init
from repro_torch.embeddings.sparse import gather_rows
from repro_torch.models.lm.moe import MoEConfig, moe_init, moe_layer

PLAN_NOT_PORTED = ("the LM under an SPMD plan (FSDP / TP storage and the "
                   "explicit Megatron-SP layer _layer_spmd) is not ported "
                   "yet (ROADMAP A9b)")

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
    use_spmd_layer: bool = False        # explicit megatron-SP layer (A9b)

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


def refuse_plan(plan) -> None:
    if plan is not None and plan.enabled:
        raise NotImplementedError(PLAN_NOT_PORTED)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def lm_init(gen: torch.Generator, cfg: LMConfig, device="cuda") -> Dict:
    dt = cfg.pdtype
    d, h, kv, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.d_head, cfg.d_ff, cfg.n_layers)

    def nrm(shape, fan_in):
        return normal_init(gen, shape, fan_in ** -0.5, dt, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": ones(L, d),
        "wq": nrm((L, d, h * dh), d),
        "wkv": nrm((L, d, 2 * kv * dh), d),
        "wo": nrm((L, h * dh, d), h * dh),
        "mlp_norm": ones(L, d),
    }
    if cfg.moe is not None:
        layers.update(moe_init(gen, cfg.moe, L, d, dt, device))
    else:
        layers["w1"] = nrm((L, d, f), d)
        if cfg.activation == "swiglu":
            layers["w3"] = nrm((L, d, f), d)
        layers["w2"] = nrm((L, f, d), f)
    params = {
        "embed": normal_init(gen, (cfg.vocab, d), 0.02, dt, device),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal_init(gen, (cfg.vocab, d), 0.02, dt, device)
    return params


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


def lm_forward(params: Dict, cfg: LMConfig, tokens: torch.Tensor,
               plan=None, collect_kv: bool = False):
    """tokens: (B, S) int -> hidden (B, S, d) in the compute dtype [+ the
    per-layer (k, v) stacks, each (L, B, S, KV, dh)]."""
    refuse_plan(plan)
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
    summed in f32."""
    refuse_plan(plan)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return torch.matmul(hidden.float(), head.to(hidden.dtype).float().t())


def lm_loss(params: Dict, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor, plan=None) -> torch.Tensor:
    """Cross-entropy of ``labels`` under the logits at each position (the
    caller shifts, or not: the reference's launcher passes the tokens)."""
    logits = lm_logits(params, cfg, lm_forward(params, cfg, tokens, plan))
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - lab)
