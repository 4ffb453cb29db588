"""Cell builders for MACE (GNN family); torch port of
``repro/configs/mace_cells.py``.

Shapes (assigned):
  full_graph_sm   N=2 708  E=10 556   d_feat=1 433  (Cora-like node class., 7)
  minibatch_lg    sampled subgraph: 1 024 seeds, fanout 15-10 (Reddit-like,
                  d_feat=602, 41 classes) -> N≈170k, E≈169k capacities
  ogb_products    N=2 449 029 E=61 859 140 d_feat=100 (47 classes, full batch)
  molecule        128 graphs x (30 nodes, 64 edges) -> block-diagonal batch,
                  energy regression

Node/edge arrays shard over ALL mesh axes (graph work has no TP dimension;
the whole chip grid is data-parallel over edges). Counts are padded to
mesh-size multiples; padding edges are masked. Non-geometric graphs get a
synthetic 3-D position channel. The params are whole on every rank and
``mace_forward(plan=...)`` says the collectives the reference leaves to
GSPMD (its module note); the gradient is summed over every axis.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import (Cell, abstract, all_true,
                                      cell_train_step, ids_below, in_order,
                                      normal, pad_to, sds)
from repro_torch.configs.recsys_cells import batch_sum, specs_like
from repro_torch.distributed.sharding import ShardingPlan
from repro_torch.models.gnn.irreps import DIMS, cg_paths
from repro_torch.models.gnn.mace import MACEConfig, mace_forward, mace_init
from repro_torch.train.optim import adam

MACE_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          n_graphs=1, n_out=7, task="node"),
    "minibatch_lg": dict(n_nodes=170496, n_edges=169984, d_feat=602,
                         n_graphs=1, n_out=41, task="node"),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                         n_graphs=1, n_out=47, task="node"),
    "molecule": dict(n_nodes=3840, n_edges=8192, d_feat=16,
                     n_graphs=128, n_out=1, task="energy"),
}
MACE_OPT_LEVELS = ("baseline", "hoist", "hoist_bf16")


def mace_flops(cfg: MACEConfig, n_nodes: int, n_edges: int) -> float:
    """Analytic forward FLOPs: CG messages + products + linears."""
    c = cfg.channels
    paths = cg_paths(cfg.l_max)
    cg_cost = sum(DIMS[l1] * DIMS[l2] * DIMS[l3] for l1, l2, l3 in paths)
    msg = 2.0 * n_edges * cg_cost * c                      # edge CG products
    prod = 2.0 * n_nodes * cg_cost * c * (cfg.correlation - 1)
    mix = 2.0 * n_nodes * sum(DIMS[l] for l in range(cfg.l_max + 1)) * c * c \
        * (2 + cfg.correlation)
    radial = 2.0 * n_edges * (cfg.n_rbf * 64 + 64 * len(paths) * c)
    return cfg.n_layers * (msg + prod + mix + radial)


def mace_cell_forward(p, cfg: MACEConfig, inputs: Dict, plan, n_graphs: int,
                      opt_level: str = "baseline"):
    return mace_forward(
        p, cfg, inputs["node_feat"], inputs["positions"],
        inputs["edge_index"], inputs["edge_mask"], inputs["graph_ids"],
        n_graphs, node_mask=inputs["node_mask"],
        hoist_gathers=opt_level.startswith("hoist"),
        msg_dtype=torch.bfloat16 if opt_level == "hoist_bf16" else None,
        plan=plan)


def mace_cell_loss(p, cfg: MACEConfig, inputs: Dict, plan, n_graphs: int,
                   task: str, n_nodes: int, opt_level: str = "baseline"):
    """Energy MSE over the graphs, or the masked node-class NLL (its sums
    over every mesh axis: the node blocks split over all of them)."""
    out = mace_cell_forward(p, cfg, inputs, plan, n_graphs, opt_level)
    if task == "energy":
        return torch.mean((out["energy"][:, 0] - inputs["targets"]) ** 2)
    logp = torch.log_softmax(out["node_out"], dim=-1)      # (N, n_classes)
    nll = -torch.gather(logp, 1, inputs["labels"][:, None].long())[:, 0]
    w = inputs["label_mask"].to(nll.dtype)
    all_axes = _all_axes_plan(plan)
    return batch_sum(nll * w, n_nodes, all_axes) / torch.clamp(
        batch_sum(w, n_nodes, all_axes), min=1.0)


def _all_axes_plan(plan):
    """``plan`` with every mesh axis a batch axis (the node blocks')."""
    if plan is None or not plan.enabled:
        return plan
    import dataclasses
    return dataclasses.replace(
        plan, batch_axes=tuple(plan.batch_axes) + (plan.model_axis,))


def build_mace_cell(shape_name: str, plan: ShardingPlan,
                    opt_level: str = "baseline",
                    cfg: MACEConfig = None) -> Cell:
    """opt_level "hoist": per-layer (not per-CG-path) edge gathers +
    grouped segment-sums — identical math, ~5x fewer cross-shard
    gather/scatter collectives; "hoist_bf16": + bf16 messages.
    ``cfg`` replaces the shape's config (the tests' small one)."""
    if opt_level not in MACE_OPT_LEVELS:
        raise ValueError(f"mace has no opt level {opt_level!r}")
    sh = MACE_SHAPES[shape_name]
    n_dev = 1
    if plan.enabled:
        n_dev = plan.mesh.size
    axes_all = (tuple(plan.batch_axes) + (plan.model_axis,)) if plan.enabled \
        else None
    n = pad_to(sh["n_nodes"], max(n_dev, 1))
    e = pad_to(sh["n_edges"], max(n_dev, 1))
    g = sh["n_graphs"]
    cfg = cfg or MACEConfig(n_feat_in=sh["d_feat"], n_out=sh["n_out"])
    opt = adam(1e-3)

    def init_fn():
        return mace_init(torch.Generator().manual_seed(0), cfg,
                         device="meta")

    def abstract_state():
        params = abstract(init_fn)
        return {"params": params, "opt": abstract(lambda: opt.init(params)),
                "step": sds((), torch.int32)}

    def state_pspecs(plan):
        pp = specs_like(abstract(init_fn))
        return {"params": pp, "opt": {"m": pp, "v": pp, "t": ()},
                "step": ()}

    def specs_fn():
        s = {"node_feat": sds((n, sh["d_feat"])),
             "positions": sds((n, 3)),
             "edge_index": sds((e, 2), torch.int32),
             "edge_mask": sds((e,), torch.bool),
             "graph_ids": sds((n,), torch.int32),
             "node_mask": sds((n,), torch.bool)}
        if sh["task"] == "energy":
            s["targets"] = sds((g,))
        else:
            s["labels"] = sds((n,), torch.int32)
            s["label_mask"] = sds((n,), torch.bool)
        return s

    def pspecs_fn(plan):
        ax = axes_all
        s = {"node_feat": (ax, None), "positions": (ax, None),
             "edge_index": (ax, None), "edge_mask": (ax,),
             "graph_ids": (ax,), "node_mask": (ax,)}
        if sh["task"] == "energy":
            s["targets"] = (None,)
        else:
            s["labels"] = (ax,)
            s["label_mask"] = (ax,)
        return s

    def loss(p, inputs):
        return mace_cell_loss(p, cfg, inputs, plan, g, sh["task"], n,
                              opt_level)

    step = cell_train_step(loss, opt, _all_axes_plan(plan),
                           lambda: specs_like(abstract(init_fn)))
    flops = mace_flops(cfg, n, e) * 3          # fwd+bwd
    fill = {"node_feat": normal, "positions": normal,
            "edge_index": ids_below(n), "edge_mask": all_true,
            "graph_ids": in_order(g), "node_mask": all_true,
            "targets": normal, "labels": ids_below(sh["n_out"]),
            "label_mask": all_true}
    return Cell("mace", shape_name, "train", step, abstract_state,
                state_pspecs, specs_fn, pspecs_fn, flops,
                notes="synthetic 3-D positions for non-geometric graphs",
                fill=fill)
