"""Neighbor sampler for minibatch GNN training (GraphSAGE-style fanout);
pure numpy, a copy of ``repro/models/gnn/sampler.py`` (the same
``RandomState`` gives the same subgraph).

``minibatch_lg`` (232 965 nodes / 114 M edges, batch_nodes=1024,
fanout 15-10) requires a real sampler: host-side numpy over a CSR adjacency,
emitting fixed-capacity subgraph arrays (static shapes for XLA).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray      # (N+1,)
    indices: np.ndarray     # (nnz,)
    n_nodes: int

    @staticmethod
    def from_edges(edges: np.ndarray, n_nodes: int) -> "CSRGraph":
        order = np.argsort(edges[:, 0], kind="stable")
        src = edges[order, 0]
        dst = edges[order, 1]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRGraph(indptr=indptr, indices=dst.astype(np.int64),
                        n_nodes=n_nodes)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


@dataclasses.dataclass
class SampledSubgraph:
    """Fixed-capacity subgraph: local ids, padded."""
    node_ids: np.ndarray      # (max_nodes,) global ids (0-padded)
    n_nodes: int
    edge_index: np.ndarray    # (max_edges, 2) local (src, dst)
    edge_mask: np.ndarray     # (max_edges,)
    seed_mask: np.ndarray     # (max_nodes,) True for the labeled seed nodes


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanouts: List[int],
                    max_nodes: int, max_edges: int,
                    rng: np.random.RandomState) -> SampledSubgraph:
    """k-hop uniform neighbor sampling: layer l samples fanouts[l] neighbors
    of the current frontier; edges are (neighbor -> frontier node)."""
    local: Dict[int, int] = {}
    order: List[int] = []

    def lid(v: int) -> int:
        if v not in local:
            local[v] = len(order)
            order.append(v)
        return local[v]

    for s in seeds:
        lid(int(s))
    frontier = [int(s) for s in seeds]
    edges: List[Tuple[int, int]] = []
    for f in fanouts:
        nxt: List[int] = []
        for v in frontier:
            nbrs = g.neighbors(v)
            if len(nbrs) == 0:
                continue
            take = nbrs if len(nbrs) <= f else \
                nbrs[rng.choice(len(nbrs), size=f, replace=False)]
            for u in take:
                u = int(u)
                if len(order) >= max_nodes and u not in local:
                    continue
                if len(edges) >= max_edges:
                    break
                edges.append((lid(u), local[v]))
                nxt.append(u)
        frontier = nxt
    node_ids = np.zeros(max_nodes, np.int64)
    node_ids[:len(order)] = order
    ei = np.zeros((max_edges, 2), np.int32)
    if edges:
        ei[:len(edges)] = np.asarray(edges, np.int32)
    emask = np.zeros(max_edges, bool)
    emask[:len(edges)] = True
    smask = np.zeros(max_nodes, bool)
    smask[:len(seeds)] = True
    return SampledSubgraph(node_ids=node_ids, n_nodes=len(order),
                           edge_index=ei, edge_mask=emask, seed_mask=smask)


def random_graph(n_nodes: int, avg_degree: int, seed: int = 0) -> CSRGraph:
    rng = np.random.RandomState(seed)
    m = n_nodes * avg_degree
    edges = np.stack([rng.randint(0, n_nodes, m),
                      rng.randint(0, n_nodes, m)], axis=1)
    return CSRGraph.from_edges(edges, n_nodes)
