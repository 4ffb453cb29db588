"""MACE (Batatia et al. 2022, arXiv:2206.07697) — torch port of
``repro/models/gnn/mace.py``.

Higher-order E(3)-equivariant message passing: A-features A_i^{l3} =
Σ_{j∈N(i)} R(r_ij) ⊙ CG(Y^{l1}(r̂_ij) ⊗ h_j^{l2}) with per-path radial
weights; the product basis by iterated CG contraction B¹ = A, Bᵛ =
CG(Bᵛ⁻¹ ⊗ A) up to the correlation order; a per-irrep linear update of
[B¹..Bᵛ] plus a residual; an invariant (l = 0) readout MLP, segment-summed
to a per-graph energy. The same graph layout as the reference: flattened
node / edge arrays, ``edge_index (E, 2)`` (src, dst), ``edge_mask``,
``graph_ids``; batched molecules are one block-diagonal graph.

Fixed-order sums, so a second run on the card is bit for bit: the
reference's ``segment_sum`` sites become one stable sort of the edges by
``dst`` a forward (of the nodes by graph for the energy) and
``torch.segment_reduce`` over the sorted rows, which adds each segment's
rows in order (a node's messages in edge order, as a sequential
scatter-add meets them). The gathers over edges (``h_j``, the positions)
go through ``embeddings.sparse.gather_rows``, whose backward sums repeated
nodes in a fixed order. The Clebsch–Gordan blocks are cached per (l1, l2,
l3, dtype, device): one host-to-device copy each a process, not one a
path, layer and forward.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.core.hstu import normal_init
from repro_torch.embeddings.sparse import gather_rows
from repro_torch.models.gnn.irreps import (DIMS, cg_paths, cg_real,
                                           spherical_harmonics)
from repro_torch.models.mlp import mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    n_layers: int = 2
    channels: int = 128          # d_hidden
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    n_feat_in: int = 16          # raw node feature dim (species one-hot etc.)
    readout_mlp: Tuple[int, ...] = (64,)
    n_out: int = 1               # energy (or class logits for node tasks)


def _ls(cfg) -> List[int]:
    return list(range(cfg.l_max + 1))


def mace_init(gen: torch.Generator, cfg: MACEConfig, dtype=torch.float32,
              device="cuda") -> Dict:
    c = cfg.channels

    def square(rows):
        return normal_init(gen, (rows, c), rows ** -0.5, dtype, device)

    params: Dict = {"embed": mlp_init(gen, (cfg.n_feat_in, c), dtype, device)}
    paths = cg_paths(cfg.l_max)
    for t in range(cfg.n_layers):
        lyr: Dict = {}
        # radial MLP -> per-path per-channel weights
        lyr["radial"] = mlp_init(gen, (cfg.n_rbf, 64, len(paths) * c), dtype,
                                 device)
        # per-irrep linear mixing of h before message
        for l in _ls(cfg):
            lyr[f"wh_{l}"] = square(c)
        # product-basis mixing weights per correlation order and l
        for v in range(2, cfg.correlation + 1):
            for l in _ls(cfg):
                lyr[f"wprod{v}_{l}"] = square(c)
        # update linear: concat [B1..Bv] -> h
        for l in _ls(cfg):
            lyr[f"wupd_{l}"] = square(cfg.correlation * c)
            lyr[f"wres_{l}"] = square(c)
        lyr["readout"] = mlp_init(gen, (c,) + cfg.readout_mlp + (cfg.n_out,),
                                  dtype, device)
        params[f"layer_{t}"] = lyr
    return params


def bessel_rbf(r: torch.Tensor, n: int, r_cut: float) -> torch.Tensor:
    """Bessel radial basis with smooth polynomial cutoff envelope."""
    r = torch.clamp(r, min=1e-9)
    k = torch.arange(1, n + 1, dtype=r.dtype, device=r.device)
    rb = math.sqrt(2.0 / r_cut) * torch.sin(
        k[None] * math.pi * r[:, None] / r_cut) / r[:, None]
    u = torch.clamp(r / r_cut, 0.0, 1.0)
    env = 1.0 - 10.0 * u**3 + 15.0 * u**4 - 6.0 * u**5      # p=3 envelope
    return rb * env[:, None]


@functools.lru_cache(maxsize=None)
def _cg_tensor(l1: int, l2: int, l3: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    return torch.as_tensor(cg_real(l1, l2, l3), dtype=dtype, device=device)


def segment_layout(ids: torch.Tensor, n: int):
    """(perm, lengths) for :func:`segment_sum`: the stable sort of ``ids``
    and the lengths of n + 2 segments of the sorted ids (ids < 0, then each
    of 0..n-1, then ids >= n; the outer two are dropped, as
    ``jax.ops.segment_sum`` drops out-of-range ids). No host sync."""
    ids_s, perm = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(ids_s, torch.arange(
        n + 1, dtype=ids_s.dtype, device=ids.device))
    total = torch.full((1,), ids.numel(), dtype=bounds.dtype,
                       device=ids.device)
    return perm, torch.diff(torch.cat([bounds, total]),
                            prepend=torch.zeros_like(total))


def segment_sum(rows: torch.Tensor, lengths: torch.Tensor,
                n: int) -> torch.Tensor:
    """Sum of ``rows`` (already in :func:`segment_layout`'s order) per
    segment 0..n-1, each segment's rows added in order -> (n, ...)."""
    out = torch.segment_reduce(rows.reshape(rows.shape[0], -1), "sum",
                               lengths=lengths, unsafe=True)
    return out[1:n + 1].reshape((n,) + tuple(rows.shape[1:]))


def _gather(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``t[ids]`` along dim 0 for a tensor of any rank (gather_rows on its
    rows flattened)."""
    return gather_rows(t.reshape(t.shape[0], -1), ids).reshape(
        (ids.shape[0],) + tuple(t.shape[1:]))


def mace_forward(params: Dict, cfg: MACEConfig,
                 node_feat: torch.Tensor,         # (N, F)
                 positions: torch.Tensor,         # (N, 3)
                 edge_index: torch.Tensor,        # (E, 2) int (src, dst)
                 edge_mask: torch.Tensor,         # (E,) bool
                 graph_ids: torch.Tensor,         # (N,) int
                 n_graphs: int,
                 node_mask: torch.Tensor = None,
                 hoist_gathers: bool = False,
                 msg_dtype=None) -> Dict[str, torch.Tensor]:
    """Returns {"energy": (n_graphs, n_out), "node_out": (N, n_out)}.

    ``hoist_gathers``: gather each irrep of h_j over edges ONCE per layer
    (3 gathers) instead of once per CG path (15 gathers), and sum each
    l3's paths in one segment sum: identical math. ``msg_dtype`` (a torch
    dtype) is the messages' dtype on that route.
    """
    n = node_feat.shape[0]
    c = cfg.channels
    paths = cg_paths(cfg.l_max)
    dt, dev = node_feat.dtype, node_feat.device
    if node_mask is None:
        node_mask = torch.ones((n,), dtype=torch.bool, device=dev)

    src = torch.clamp(edge_index[:, 0], 0, n - 1).long()
    dst = torch.clamp(edge_index[:, 1], 0, n - 1).long()
    # the edges in dst order, stable: each node's messages in edge order
    perm, lengths = segment_layout(dst, n)
    src, dst, edge_mask = src[perm], dst[perm], edge_mask[perm]
    rel = gather_rows(positions, dst) - gather_rows(positions, src)
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-18)
    unit = rel / dist[:, None]
    # zero-length edges (self-loops / padding) carry no geometry and their
    # l>0 SH would be equivariance-breaking constants — mask them out.
    geom_ok = dist > 1e-6
    Y = spherical_harmonics(unit)                            # {l: (E, 2l+1)}
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.r_cut)             # (E, n_rbf)
    emask = (edge_mask & geom_ok).to(dt)[:, None]
    g_perm, g_lengths = segment_layout(graph_ids, n_graphs)

    def zeros():
        return {l: torch.zeros((n, DIMS[l], c), dtype=dt, device=dev)
                for l in _ls(cfg)}

    # h: {l: (N, 2l+1, c)} — start with scalars from node features
    h = zeros()
    h[0] = mlp_apply(params["embed"], node_feat)[:, None, :]

    energy = torch.zeros((n_graphs, cfg.n_out), dtype=dt, device=dev)
    node_out = torch.zeros((n, cfg.n_out), dtype=dt, device=dev)
    for t in range(cfg.n_layers):
        lyr = params[f"layer_{t}"]
        radial = mlp_apply(lyr["radial"], rbf)               # (E, P*c)
        radial = radial.reshape(-1, len(paths), c)
        hm = {l: torch.einsum("nmc,cd->nmd", h[l], lyr[f"wh_{l}"])
              for l in _ls(cfg)}
        # ---- A-features: edge messages, CG(Y ⊗ h_j), summed into dst ----
        A = zeros()
        if hoist_gathers:
            mdt = msg_dtype or dt
            if msg_dtype is not None:
                hm = {l: hm[l].to(msg_dtype) for l in _ls(cfg)}
            hm_src = {l: _gather(hm[l], src) for l in _ls(cfg)}  # 3 gathers
            msgs = {l: [] for l in _ls(cfg)}
            for pi, (l1, l2, l3) in enumerate(paths):
                C = _cg_tensor(l1, l2, l3, mdt, dev)
                m = torch.einsum("abk,ea,ebc->ekc", C, Y[l1].to(mdt),
                                 hm_src[l2])
                msgs[l3].append(
                    m * (radial[:, pi, :] * emask)[:, None, :].to(mdt))
            for l3 in _ls(cfg):                              # 3 sums/layer
                if msgs[l3]:
                    summed = segment_sum(torch.cat(msgs[l3], dim=-1),
                                         lengths, n)
                    A[l3] = sum(p.to(dt) for p in torch.split(summed, c,
                                                              dim=-1))
        else:
            for pi, (l1, l2, l3) in enumerate(paths):
                C = _cg_tensor(l1, l2, l3, dt, dev)          # (d1,d2,d3)
                hj = _gather(hm[l2], src)                    # (E, d2, c)
                m = torch.einsum("abk,ea,ebc->ekc", C, Y[l1], hj)
                m = m * (radial[:, pi, :] * emask)[:, None, :]
                A[l3] = A[l3] + segment_sum(m, lengths, n)
        # ---- product basis: iterated CG contraction to correlation order ---
        Bs = [A]
        for v in range(2, cfg.correlation + 1):
            prev = Bs[-1]
            nxt = zeros()
            for (l1, l2, l3) in paths:
                C = _cg_tensor(l1, l2, l3, dt, dev)
                z = torch.einsum("abk,nac,nbc->nkc", C, prev[l1], A[l2])
                nxt[l3] = nxt[l3] + torch.einsum(
                    "nkc,cd->nkd", z, lyr[f"wprod{v}_{l3}"])
            Bs.append(nxt)
        # ---- update + residual ----------------------------------------------
        new_h = {}
        for l in _ls(cfg):
            cat = torch.cat([b[l] for b in Bs], dim=-1)          # (N,d,3c)
            upd = torch.einsum("nmc,cd->nmd", cat, lyr[f"wupd_{l}"])
            res = torch.einsum("nmc,cd->nmd", h[l], lyr[f"wres_{l}"])
            new_h[l] = upd + res
        h = new_h
        # ---- invariant readout ----------------------------------------------
        inv = h[0][:, 0, :]                                   # (N, c)
        e_node = mlp_apply(lyr["readout"], inv)               # (N, n_out)
        e_node = e_node * node_mask[:, None].to(dt)
        node_out = node_out + e_node
        energy = energy + segment_sum(gather_rows(e_node, g_perm), g_lengths,
                                      n_graphs)
    return {"energy": energy, "node_out": node_out}


def mace_energy_loss(params, cfg, batch, targets) -> torch.Tensor:
    out = mace_forward(params, cfg, **batch)
    return torch.mean((out["energy"] - targets) ** 2)
