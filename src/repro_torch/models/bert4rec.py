"""BERT4Rec (Sun et al. 2019, arXiv:1904.06690), torch port of
``repro/models/bert4rec.py``.

Config: embed_dim=64, n_blocks=2, n_heads=2, seq_len=200; bidirectional
self-attention over the user's item sequence, trained with the cloze
(masked-item) objective.

ROO applicability: the encoder consumes only the user history (RO). Under
ROO it runs once per request; the m candidates are scored against the
encoded representation at the mask position. Encoder-only: no decode shapes.

No kernel of its own: the attention is plain softmax attention with a
-1e9 key mask (``scaled_dot_product_attention`` treats a fully masked row
otherwise), GELU its tanh form (``jax.nn.gelu``'s default). The cloze head
is a full softmax over ``item_emb`` and reads every table row, so BERT4Rec
trains with dense embedding gradients: it has no ``table_ids``
declaration for the sparse path. The cloze mask is drawn from the step's
generator (other draws than the reference's PRNG); ``cloze_loss`` also
takes the uniform draws or the mask itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.fanout import fanout
from repro_torch.core.hstu import normal_init
from repro_torch.core.roo_batch import ROOBatch
from repro_torch.embeddings import collection as ec
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.train.metrics import bce

MASK_TOKEN = 1   # reserved id


@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    n_items: int
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff: int = 256
    mask_prob: float = 0.2


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine: population variance, eps inside rsqrt."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def bert4rec_init(gen: torch.Generator, cfg: BERT4RecConfig,
                  dtype=torch.float32, device="cuda") -> Dict:
    """Random params in the reference's layout, drawn from ``gen``."""
    d = cfg.embed_dim
    item_emb = normal_init(gen, (cfg.n_items, d), 0.02, dtype, device)
    pos_emb = normal_init(gen, (cfg.seq_len, d), 0.02, dtype, device)
    blocks = [{
        "wqkv": normal_init(gen, (d, 3 * d), d ** -0.5, dtype, device),
        "wo": normal_init(gen, (d, d), d ** -0.5, dtype, device),
        "ff1": mlp_init(gen, (d, cfg.d_ff), dtype, device),
        "ff2": mlp_init(gen, (cfg.d_ff, d), dtype, device),
    } for _ in range(cfg.n_blocks)]
    return {"item_emb": item_emb, "pos_emb": pos_emb, "blocks": blocks,
            "out_bias": torch.zeros((cfg.n_items,), dtype=dtype,
                                    device=device)}


def encode(params: Dict, cfg: BERT4RecConfig, ids: torch.Tensor,
           lengths: torch.Tensor, plan=None) -> torch.Tensor:
    """ids: (B, S) -> (B, S, d) bidirectional encoding (valid-masked).
    Under an SPMD ``plan`` the ids are this rank's batch block and the
    item lookup goes through the plan's row-sharded route; the encoder's
    weights are whole on every rank."""
    b, s = ids.shape
    d, h = cfg.embed_dim, cfg.n_heads
    x = ec.seq_lookup(params["item_emb"], ids, vocab=cfg.n_items, plan=plan)
    x = x + params["pos_emb"][None, :s]
    valid = torch.arange(s, device=x.device)[None] < lengths[:, None]
    attn_mask = valid[:, None, None, :]                     # keys must be valid
    for blk in params["blocks"]:
        q, k, v = torch.chunk(_ln(x) @ blk["wqkv"], 3, dim=-1)
        q, k, v = (t.reshape(b, s, h, d // h).transpose(1, 2)
                   for t in (q, k, v))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(d / h)
        a = torch.softmax(torch.where(attn_mask, scores, -1e9), dim=-1)
        av = (a @ v).transpose(1, 2).reshape(b, s, d)
        x = x + av @ blk["wo"]
        x = x + mlp_apply(blk["ff2"], F.gelu(mlp_apply(blk["ff1"], _ln(x)),
                                             approximate="tanh"))
    return _ln(x) * valid[..., None]


def cloze_loss(params: Dict, cfg: BERT4RecConfig, ids: torch.Tensor,
               lengths: torch.Tensor, gen: Optional[torch.Generator] = None,
               *, uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-item prediction with a full softmax over the items. ids:
    (B, S). A valid position is masked where its uniform draw is below
    ``mask_prob``: the draws come from ``gen`` (made on the generator's
    device), or are given as ``uniform`` (B, S)."""
    b, s = ids.shape
    if uniform is None:
        dev = gen.device if gen is not None else ids.device
        uniform = torch.rand((b, s), generator=gen, device=dev)
    valid = torch.arange(s, device=ids.device)[None] < lengths[:, None]
    mask = (uniform.to(ids.device) < cfg.mask_prob) & valid
    masked_ids = torch.where(mask, MASK_TOKEN, ids)
    enc = encode(params, cfg, masked_ids, lengths)          # (B,S,d)
    logits = enc @ params["item_emb"].T + params["out_bias"]
    logp = torch.log_softmax(logits, dim=-1)
    tgt = torch.clamp(ids.long(), 0, cfg.n_items - 1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    w = mask.to(nll.dtype)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def score_candidates_roo(params: Dict, cfg: BERT4RecConfig,
                         batch: ROOBatch) -> torch.Tensor:
    """ROO scoring: encode the history once per request with a MASK
    appended; score the request's candidates against the mask position's
    output."""
    b = batch.b_ro
    s = cfg.seq_len
    lengths = torch.clamp(batch.history_lengths, max=s - 1).long()
    rows = torch.arange(b, device=lengths.device)
    # append MASK at position `lengths`
    ids_ext = F.pad(batch.history_ids[:, : s - 1], (0, 1))
    ids_ext[rows, lengths] = MASK_TOKEN
    enc = encode(params, cfg, ids_ext, lengths + 1)          # (B_RO, S, d)
    q_nro = fanout(enc[rows, lengths], batch.segment_ids)    # (B_NRO, d)
    cand = ec.row_lookup(params["item_emb"], batch.item_ids,
                         vocab=cfg.n_items)
    # the bias through the row gather: its backward sums repeated ids in a
    # fixed order (embeddings/sparse.gather_rows)
    bias = ec.row_lookup(params["out_bias"][:, None], batch.item_ids,
                         vocab=cfg.n_items)[:, 0]
    return torch.sum(q_nro * cand, dim=-1) + bias


def bert4rec_loss(params: Dict, cfg: BERT4RecConfig, batch: ROOBatch,
                  gen: Optional[torch.Generator] = None, *,
                  uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training = cloze over histories (RO-only) + the candidates' BCE
    head. The cloze mask comes from ``gen`` or ``uniform`` (``cloze_loss``)."""
    cl = cloze_loss(params, cfg, batch.history_ids[:, :cfg.seq_len],
                    torch.clamp(batch.history_lengths, max=cfg.seq_len), gen,
                    uniform=uniform)
    logits = score_candidates_roo(params, cfg, batch)
    return cl + bce(logits, batch.labels[:, 0],
                    batch.impression_mask().to(logits.dtype))
