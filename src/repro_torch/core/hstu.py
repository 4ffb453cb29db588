"""HSTU — Hierarchical Sequential Transduction Unit (Zhai et al. 2024), torch
port of ``repro/core/hstu.py``.

One HSTU layer (pointwise attention variant):

    [U, V, Q, K] = SiLU( X @ W_uvqk )                        (f1)
    A            = SiLU( Q K^T / sqrt(d) + rab ) * mask / n  (pointwise attn)
    Y            = ( LayerNorm( A @ V ) * U ) @ W_o          (f2)
    out          = X + Y                                     (residual)

The attention goes through ``kernels/dispatch.py`` (the CUDA kernel on the
card). Params are a nested dict/list of tensors in the reference's layout
(``x @ w + b`` with ``w`` as (in, out)). The cached-prefix variants
(``hstu_prefix_*``) serve incremental requests against a per-user K/V cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.masks import MaskSpec, PrefixMaskSpec


@dataclasses.dataclass(frozen=True)
class HSTUConfig:
    d_model: int
    n_heads: int
    d_qk: int
    d_v: int
    n_layers: int
    max_rel_pos: int = 128         # rab table covers deltas in [-max, max]
    use_rab: bool = True
    eps: float = 1e-6
    # attention backend (kernels/dispatch.py): None = auto (cuda on a CUDA
    # tensor, torch-chunked elsewhere) | "cuda" | "torch-chunked" |
    # "torch-dense"
    attn_backend: Optional[str] = None


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine: population variance, eps inside rsqrt."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def normal_init(gen: torch.Generator, shape, std: float, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """N(0, std²) values drawn from ``gen`` (on the generator's device),
    then moved to ``device`` — the port's one random initializer."""
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(
        device=device, dtype=dtype)


def hstu_layer_init(gen: torch.Generator, cfg: HSTUConfig,
                    dtype=torch.float32, device="cuda") -> Dict:
    h, dqk, dv, d = cfg.n_heads, cfg.d_qk, cfg.d_v, cfg.d_model
    width = h * (2 * dv + 2 * dqk)
    params = {
        "w_uvqk": normal_init(gen, (d, width), (2.0 / (d + width)) ** 0.5,
                              dtype, device),
        "b_uvqk": torch.zeros((width,), dtype=dtype, device=device),
        "w_o": normal_init(gen, (h * dv, d), (2.0 / (h * dv + d)) ** 0.5,
                           dtype, device),
        "ln_scale": torch.ones((h * dv,), dtype=dtype, device=device),
        "ln_bias": torch.zeros((h * dv,), dtype=dtype, device=device),
    }
    if cfg.use_rab:
        params["rab"] = normal_init(gen, (h, 2 * cfg.max_rel_pos + 1),
                                    0.02, dtype, device)
    return params


def hstu_init(gen: torch.Generator, cfg: HSTUConfig, dtype=torch.float32,
              device="cuda") -> Dict:
    return {"layers": [hstu_layer_init(gen, cfg, dtype, device)
                       for _ in range(cfg.n_layers)],
            "in_ln_scale": torch.ones((cfg.d_model,), dtype=dtype,
                                      device=device),
            "in_ln_bias": torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=device)}


def hstu_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rab: Optional[torch.Tensor], spec: MaskSpec,
                           max_rel_pos: int = 128,
                           chunk: int = 128) -> torch.Tensor:
    """Blockwise torch path: scores, rab bias and the ROO mask are produced
    one q-chunk at a time, so no (S, S) tensor exists — what
    `torch-chunked` dispatches to. Matches kernels/ref.py numerics: on
    bf16 operands the scores and probabilities are fp32 and the
    probabilities are rounded to bf16 before the product with v, as the
    reference's jnp-chunked route (the kernels keep them in fp32).

    q, k: (B, H, S, Dqk); v: (B, H, S, Dv); rab: (H, 2*max_rel_pos+1) | None.
    """
    b, h, s, dqk = q.shape
    device = q.device
    cq = max(1, min(chunk, s))
    inv_d = 1.0 / math.sqrt(dqk)
    inv_n = 1.0 / s
    n_hist = spec.n_hist
    hl, tc = spec.hist_lengths, spec.target_counts
    kf = k.float()
    cols = torch.arange(s, device=device)
    is_hk = cols < n_hist
    valid_c = torch.where(is_hk[None, :], cols[None, :] < hl[:, None],
                          (cols[None, :] - n_hist) < tc[:, None])    # (B, S)
    outs = []
    for c0 in range(0, s, cq):
        rows = torch.arange(c0, min(c0 + cq, s), device=device)
        q_c = q[:, :, c0:c0 + cq].float()
        scores = torch.einsum("bhid,bhjd->bhij", q_c, kf) * inv_d
        if rab is not None:
            delta = torch.clamp(rows[:, None] - cols[None, :],
                                -max_rel_pos, max_rel_pos) + max_rel_pos
            scores = scores + rab[:, delta][None].to(scores.dtype)
        is_hq = rows < n_hist
        struct = ((is_hq[:, None] & is_hk[None, :]
                   & (cols[None, :] <= rows[:, None]))
                  | (~is_hq[:, None] & is_hk[None, :])
                  | (~is_hq[:, None] & ~is_hk[None, :]
                     & (rows[:, None] == cols[None, :])))            # (cq, S)
        valid_r = torch.where(is_hq[None, :], rows[None, :] < hl[:, None],
                              (rows[None, :] - n_hist) < tc[:, None])  # (B, cq)
        m = struct[None] & valid_r[:, :, None] & valid_c[:, None, :]
        a = F.silu(scores) * inv_n
        a = a * m[:, None].to(a.dtype)
        outs.append(torch.einsum("bhij,bhjd->bhid", a.to(v.dtype), v))
    return torch.cat(outs, dim=2)


def hstu_attention_prefix_chunked(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  rab: Optional[torch.Tensor],
                                  spec: PrefixMaskSpec, scale_len: int,
                                  max_rel_pos: int = 128,
                                  chunk: int = 128) -> torch.Tensor:
    """Blockwise cached-prefix attention — the `torch-chunked` backend of
    ``dispatch.hstu_attention_prefix``. Rows are [new events | targets]
    (q: (B, H, R, Dqk)), columns the full K/V buffer [history cache |
    targets] (k/v: (B, H, C, ·)). Mirrors :func:`hstu_attention_chunked`
    op for op, so extend-from-empty (prefix 0, n_new == n_hist) gives
    exactly what full recompute gives.
    """
    b, h, n_rows, dqk = q.shape
    n_cols = k.shape[2]
    device = q.device
    cq = max(1, min(chunk, n_rows))
    inv_d = 1.0 / math.sqrt(dqk)
    inv_n = 1.0 / scale_len
    n_hist, n_new = spec.n_hist, spec.n_new
    pfx, nc, tc = spec.prefix_lengths, spec.new_counts, spec.target_counts
    kf = k.float()
    cols = torch.arange(n_cols, device=device)
    is_hk = cols < n_hist
    valid_c = torch.where(is_hk[None, :], cols[None, :] < (pfx + nc)[:, None],
                          (cols[None, :] - n_hist) < tc[:, None])    # (B, C)
    outs = []
    for c0 in range(0, n_rows, cq):
        rows = torch.arange(c0, min(c0 + cq, n_rows), device=device)
        q_c = q[:, :, c0:c0 + cq].float()
        is_new = rows < n_new
        row_pos = torch.where(is_new[None, :], pfx[:, None] + rows[None, :],
                              rows[None, :] + (n_hist - n_new))      # (B, cq)
        scores = torch.einsum("bhid,bhjd->bhij", q_c, kf) * inv_d
        if rab is not None:
            delta = torch.clamp(row_pos[:, :, None] - cols[None, None, :],
                                -max_rel_pos, max_rel_pos) + max_rel_pos
            bias = rab[:, delta.long()].transpose(0, 1)          # (B,H,cq,C)
            scores = scores + bias.to(scores.dtype)
        struct = ((is_new[None, :, None] & is_hk[None, None, :]
                   & (cols[None, None, :] <= row_pos[:, :, None]))
                  | ((~is_new[:, None] & is_hk[None, :])
                     | (~is_new[:, None] & ~is_hk[None, :]
                        & ((rows - n_new)[:, None]
                           == (cols - n_hist)[None, :])))[None])   # (B, cq, C)
        valid_r = torch.where(is_new[None, :], rows[None, :] < nc[:, None],
                              (rows[None, :] - n_new) < tc[:, None])  # (B, cq)
        m = struct & valid_r[:, :, None] & valid_c[:, None, :]
        a = F.silu(scores) * inv_n
        a = a * m[:, None].to(a.dtype)
        outs.append(torch.einsum("bhij,bhjd->bhid", a.to(v.dtype), v))
    return torch.cat(outs, dim=2)


def _rel_bias(rab: torch.Tensor, s: int, max_rel: int) -> torch.Tensor:
    """(H, S, S) bias from the (H, 2*max+1) delta table."""
    pos = torch.arange(s, device=rab.device)
    delta = torch.clamp(pos[:, None] - pos[None, :], -max_rel,
                        max_rel) + max_rel
    return rab[:, delta]


def hstu_layer_apply(params: Dict, cfg: HSTUConfig, x: torch.Tensor,
                     mask: Union[torch.Tensor, MaskSpec],
                     backend: Optional[str] = None) -> torch.Tensor:
    """x: (B, S, d). Returns (B, S, d).

    ``mask``: a :class:`MaskSpec` (preferred: routed through
    kernels/dispatch.py, so the mask is generated inside the selected
    backend and the CUDA kernels run on the card) or a dense (B, S, S) /
    (S, S) bool tensor (the reference's legacy path, plain torch: it
    materializes the scores and the bias, and ignores ``backend``).
    ``backend`` overrides ``cfg.attn_backend`` for this call."""
    b, s, d = x.shape
    h, dqk, dv = cfg.n_heads, cfg.d_qk, cfg.d_v
    xn = _ln(x, cfg.eps)
    uvqk = F.silu(xn @ params["w_uvqk"] + params["b_uvqk"])
    u, v, q, k = torch.split(uvqk, [h * dv, h * dv, h * dqk, h * dqk], dim=-1)
    q = q.reshape(b, s, h, dqk).transpose(1, 2)
    k = k.reshape(b, s, h, dqk).transpose(1, 2)
    v = v.reshape(b, s, h, dv).transpose(1, 2)

    if isinstance(mask, MaskSpec):
        from repro_torch.kernels import dispatch
        rab = params["rab"] if cfg.use_rab else None
        av = dispatch.hstu_attention(q, k, v, rab, mask,
                                     backend=backend or cfg.attn_backend,
                                     max_rel_pos=cfg.max_rel_pos)
    else:
        if mask.dim() == 2:
            mask = mask[None]
        scores = torch.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(dqk)
        if cfg.use_rab:
            scores = scores + _rel_bias(params["rab"], s,
                                        cfg.max_rel_pos)[None]
        a = F.silu(scores) / s
        a = a * mask[:, None].to(a.dtype)
        av = torch.einsum("bhij,bhjd->bhid", a, v)

    av = av.transpose(1, 2).reshape(b, s, h * dv)
    y = _ln(av, cfg.eps) * params["ln_scale"] + params["ln_bias"]
    y = (y * u) @ params["w_o"]
    return x + y


def hstu_apply(params: Dict, cfg: HSTUConfig, x: torch.Tensor,
               mask: Union[torch.Tensor, MaskSpec],
               backend: Optional[str] = None) -> torch.Tensor:
    x = _ln(x, cfg.eps) * params["in_ln_scale"] + params["in_ln_bias"]
    for layer in params["layers"]:
        x = hstu_layer_apply(layer, cfg, x, mask, backend=backend)
    return x


def hstu_prefix_layer_apply(params: Dict, cfg: HSTUConfig, x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            spec: PrefixMaskSpec, scale_len: int,
                            backend: Optional[str] = None):
    """One HSTU layer over [new events | targets] rows against a per-user
    K/V cache (incremental serving).

    x: (B, n_new + m, d); k_cache: (B, n_hist, H, dqk); v_cache:
    (B, n_hist, H, dv). The rows are projected exactly as in
    :func:`hstu_layer_apply`, the valid new rows' K/V are written into a
    copy of the cache at ``prefix + r``, and the rows attend against
    [cache | target K/V]. Returns ``(x_out, k_cache', v_cache')``; the
    inputs are not modified.
    """
    b, r_len, d = x.shape
    h, dqk, dv = cfg.n_heads, cfg.d_qk, cfg.d_v
    n_hist, n_new = spec.n_hist, spec.n_new
    xn = _ln(x, cfg.eps)
    uvqk = F.silu(xn @ params["w_uvqk"] + params["b_uvqk"])
    u, v, q, k = torch.split(uvqk, [h * dv, h * dv, h * dqk, h * dqk], dim=-1)
    q = q.reshape(b, r_len, h, dqk).transpose(1, 2)
    k = k.reshape(b, r_len, h, dqk)
    v = v.reshape(b, r_len, h, dv)

    # Write valid new rows into the cache; invalid rows park at the extra
    # slot n_hist, which is cropped, so garbage never lands in user state.
    # Only the parking slot takes duplicate writes.
    rr = torch.arange(n_new, device=x.device)
    pos = torch.where(rr[None, :] < spec.new_counts[:, None],
                      spec.prefix_lengths[:, None].long() + rr[None, :],
                      n_hist)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, n_new)
    kc = torch.cat([k_cache, k_cache.new_zeros((b, 1, h, dqk))], dim=1)
    kc.index_put_((bidx, pos), k[:, :n_new])
    kc = kc[:, :n_hist]
    vc = torch.cat([v_cache, v_cache.new_zeros((b, 1, h, dv))], dim=1)
    vc.index_put_((bidx, pos), v[:, :n_new])
    vc = vc[:, :n_hist]

    k_cols = torch.cat([kc, k[:, n_new:]], dim=1).transpose(1, 2)
    v_cols = torch.cat([vc, v[:, n_new:]], dim=1).transpose(1, 2)

    from repro_torch.kernels import dispatch
    rab = params["rab"] if cfg.use_rab else None
    av = dispatch.hstu_attention_prefix(
        q, k_cols, v_cols, rab, spec, backend=backend or cfg.attn_backend,
        scale_len=scale_len, max_rel_pos=cfg.max_rel_pos)

    av = av.transpose(1, 2).reshape(b, r_len, h * dv)
    y = _ln(av, cfg.eps) * params["ln_scale"] + params["ln_bias"]
    y = (y * u) @ params["w_o"]
    return x + y, kc, vc


def hstu_prefix_apply(params: Dict, cfg: HSTUConfig, x: torch.Tensor,
                      state_k: torch.Tensor, state_v: torch.Tensor,
                      spec: PrefixMaskSpec, scale_len: int,
                      backend: Optional[str] = None):
    """Incremental counterpart of :func:`hstu_apply`.

    x: (B, n_new + m, d) rows [new events | targets]; state_k:
    (B, n_layers, n_hist, H, dqk); state_v: (B, n_layers, n_hist, H, dv).
    Returns ``(x_out, state_k', state_v')`` with the per-layer caches
    extended by this request's valid new events.
    """
    x = _ln(x, cfg.eps) * params["in_ln_scale"] + params["in_ln_bias"]
    ks, vs = [], []
    for li, layer in enumerate(params["layers"]):
        x, kc, vc = hstu_prefix_layer_apply(
            layer, cfg, x, state_k[:, li], state_v[:, li], spec, scale_len,
            backend=backend)
        ks.append(kc)
        vs.append(vc)
    return x, torch.stack(ks, dim=1), torch.stack(vs, dim=1)


def hstu_flops(cfg: HSTUConfig, batch: int, seq: int) -> int:
    """Forward FLOPs (2x MACs) of the encoder, dense (unmasked) count."""
    h, dqk, dv, d = cfg.n_heads, cfg.d_qk, cfg.d_v, cfg.d_model
    per_layer = (
        2 * seq * d * h * (2 * dv + 2 * dqk)        # f1 projections
        + 2 * h * seq * seq * dqk                   # Q K^T
        + 2 * h * seq * seq * dv                    # A V
        + 2 * seq * h * dv * d                      # f2 output proj
    )
    return batch * cfg.n_layers * per_layer
