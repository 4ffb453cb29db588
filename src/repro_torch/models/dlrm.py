"""DLRM (Naumov et al. 2019), MLPerf benchmark config, ROO-capable (torch
port of ``repro/models/dlrm.py``).

Assigned config (dlrm-mlperf): 13 dense features, 26 sparse fields,
embed_dim=128, bottom MLP 13-512-256-128, top MLP 1024-1024-512-256-1,
dot interaction, Criteo-1TB-scale vocabs.

ROO applicability: the 13 dense features and the user-side subset of
sparse fields are RO; item-side fields are NRO. Under ROO the bottom MLP
and the RO lookups run at B_RO and fan out at the interaction.

On the card the bags of a side's fields run as one group through the
embedding-bag kernels (one B5 launch forward, one B6 launch backward) and
the interaction runs B7. Sparse-row training declares each batch's ids
per table with ``dlrm_table_ids`` (for
``embeddings.sparse.make_sparse_value_and_grad``): the tables of at least
64 rows are then gathered ``GatheredTable``s, which the grouped lookup
takes beside the dense tiny tables, still one group a side.

Under an SPMD ``plan`` (the reference's ``out_sharded=True`` route) each
model rank works on a D / n_model slice: the tables the plan row-shards
take the reduce-scatter bag (one collective a side for all of them), the
replicated tables (vocab < 64 or not divisible) stay one grouped B5
launch and the rank takes its D slice of their output, as of the bottom
MLP's. B7 then runs on the slices: its pairs are a partial lower triangle
of T·Tᵀ, linear in the D split, which one sum over ``model`` completes
(the dense output itself comes from the replicated bottom MLP). When the
model ranks do not divide D, sharded tables take the all-reduce bag and
everything stays at full width.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.fanout import fanout
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import spmd
from repro_torch.embeddings.collection import (EmbeddingCollection,
                                               EmbeddingCollectionConfig,
                                               FeatureSpec, TableConfig,
                                               bag_lookup_dense,  # noqa: F401
                                               bag_lookup_dense_grouped)
from repro_torch.models.interactions import dot_interaction
from repro_torch.models.mlp import mlp_apply, mlp_flops, mlp_init

# MLPerf Criteo-1TB row counts (the capped variant of the reference v1
# benchmark): 187,767,399 rows in all, 96.1 GB in fp32 at dim 128.
MLPERF_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    embed_dim: int = 128
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    vocabs: Tuple[int, ...] = MLPERF_VOCABS
    n_ro_fields: int = 13       # first k sparse fields treated as user-side
    multi_hot: int = 1          # ids per field (MLPerf v1 is one-hot)

    @property
    def n_sparse(self) -> int:
        return len(self.vocabs)

    SHARD_MIN_ROWS = 65536      # tables below this are replicated
    ROW_PAD = 512               # sharded tables pad rows to this multiple

    def padded_vocab(self, v: int) -> int:
        if v < self.SHARD_MIN_ROWS:
            return v
        return ((v + self.ROW_PAD - 1) // self.ROW_PAD) * self.ROW_PAD

    def tables(self) -> EmbeddingCollectionConfig:
        return EmbeddingCollectionConfig(tuple(
            TableConfig(name=f"t{i}", vocab=self.padded_vocab(v),
                        dim=self.embed_dim,
                        side="ro" if i < self.n_ro_fields else "nro")
            for i, v in enumerate(self.vocabs)))

    def collection(self) -> EmbeddingCollection:
        """The named embedding entry point: one multi-hot bag feature per
        sparse field, routed to its table."""
        return EmbeddingCollection(self.tables(), tuple(
            FeatureSpec(name=f"f{i}", table=f"t{i}", kind="bag",
                        pooling="sum")
            for i in range(self.n_sparse)))

    def top_in_dim(self) -> int:
        f = self.n_sparse + 1
        return self.embed_dim + f * (f - 1) // 2


def dlrm_init(gen: torch.Generator, cfg: DLRMConfig, dtype=torch.float32,
              device="cuda") -> Dict:
    """The reference's tree ``{tables: {t0..}, bot_mlp, top_mlp}``, drawn
    from ``gen`` in that order (on the generator's device, then moved to
    ``device``)."""
    top_dims = (cfg.top_in_dim(),) + cfg.top_mlp[1:]
    return {
        "tables": cfg.collection().init(gen, dtype, device=device),
        "bot_mlp": mlp_init(gen, cfg.bot_mlp, dtype, device),
        "top_mlp": mlp_init(gen, top_dims, dtype, device),
    }


def _sliced(cfg: DLRMConfig, plan) -> bool:
    """Whether the plan puts each model rank on a D / n_model slice."""
    n = spmd.model_shard_count(plan)
    return n > 1 and cfg.embed_dim % n == 0


def _field_lookup(params: Dict, ids: torch.Tensor, lengths: torch.Tensor,
                  fields, *, cfg: DLRMConfig = None,
                  plan=None) -> torch.Tensor:
    """ids: (B, n_fields, multi_hot) -> (B, n_fields, D): the fields' sum
    bags as one grouped lookup of the collection (on the card one B5 launch
    forward and one B6 launch backward for all the fields, dense tables and
    ``GatheredTable``s alike). Under a plan (module note; ``cfg`` names the
    fields' vocabs) -> (B, n_fields, D / n_model) when the plan slices D."""
    fields = list(fields)
    tables = [params["tables"][f"t{i}"] for i in fields]
    if plan is None or not plan.enabled:
        return bag_lookup_dense_grouped(tables, ids, lengths)
    from repro_torch.embeddings import sharded
    vocabs = [cfg.padded_vocab(cfg.vocabs[i]) for i in fields]
    shard_f = [j for j, v in enumerate(vocabs)
               if spmd.table_is_sharded(plan, v)]
    repl_f = [j for j in range(len(fields)) if j not in shard_f]
    sliced = _sliced(cfg, plan)
    parts = []
    if shard_f:
        sel = torch.tensor(shard_f, device=ids.device)
        clipped = torch.stack([torch.clamp(ids[:, j].long(), 0, vocabs[j] - 1)
                               for j in shard_f], dim=1)
        if sliced:
            parts.append(sharded.sharded_bags_rs(
                [tables[j] for j in shard_f], clipped, lengths[:, sel],
                plan=plan, vocabs=[vocabs[j] for j in shard_f]))
        else:
            parts.append(torch.stack([sharded.sharded_bag_lookup(
                tables[j], clipped[:, i], lengths[:, j], plan=plan,
                vocab=vocabs[j]) for i, j in enumerate(shard_f)], dim=1))
    if repl_f:
        sel = torch.tensor(repl_f, device=ids.device)
        full = bag_lookup_dense_grouped([tables[j] for j in repl_f],
                                        ids[:, sel], lengths[:, sel])
        parts.append(coll.slice_cols(full, spmd.model_group(plan),
                                     spmd.model_shard_count(plan),
                                     spmd.model_index(plan))
                     if sliced else full)
    order = torch.tensor([(shard_f + repl_f).index(j)
                          for j in range(len(fields))], device=ids.device)
    return torch.cat(parts, dim=1).index_select(1, order)


def dlrm_forward_from_embs(params: Dict, cfg: DLRMConfig,
                           ro_dense: torch.Tensor, ro_embs: torch.Tensor,
                           nro_embs: torch.Tensor,
                           segment_ids: torch.Tensor,
                           plan=None) -> torch.Tensor:
    """Interaction + MLPs given already-gathered embeddings.

    ro_embs: (B_RO, n_ro_fields, D); nro_embs: (B_NRO, n_nro_fields, D)
    (D / n_model slices under a plan that slices D). Split out so a
    sparse-update training path can differentiate w.r.t. the gathered
    rows instead of the full tables.
    """
    dense_out = mlp_apply(params["bot_mlp"], ro_dense)            # (B_RO, D)
    if not _sliced(cfg, plan):
        ro_pack = torch.cat([dense_out[:, None, :], ro_embs], dim=1)
        ro_at_nro = fanout(ro_pack, segment_ids)                  # one fanout
        sparse = torch.cat([ro_at_nro[:, 1:, :], nro_embs], dim=1)
        z = dot_interaction(ro_at_nro[:, 0, :], sparse)
        return mlp_apply(params["top_mlp"], z)[:, 0]
    n = spmd.model_shard_count(plan)
    dense_slice = coll.slice_cols(dense_out, spmd.model_group(plan), n,
                                  spmd.model_index(plan))
    ro_pack = torch.cat([dense_slice[:, None, :], ro_embs], dim=1)
    ro_at_nro = fanout(ro_pack, segment_ids)
    sparse = torch.cat([ro_at_nro[:, 1:, :], nro_embs], dim=1)
    # B7 on the D slice: its pairs are this slice's part of T·Tᵀ
    part = dot_interaction(ro_at_nro[:, 0, :], sparse)
    pairs = spmd.model_sum(part[:, cfg.embed_dim // n:], plan)
    z = torch.cat([fanout(dense_out, segment_ids), pairs], dim=1)
    return mlp_apply(params["top_mlp"], z)[:, 0]


def dlrm_forward_roo(params: Dict, cfg: DLRMConfig, ro_dense: torch.Tensor,
                     ro_ids: torch.Tensor, ro_lengths: torch.Tensor,
                     nro_ids: torch.Tensor, nro_lengths: torch.Tensor,
                     segment_ids: torch.Tensor, plan=None) -> torch.Tensor:
    """ROO path: user side at B_RO, fanned out once.

    ro_dense: (B_RO, n_dense); ro_ids: (B_RO, n_ro_fields, mh);
    nro_ids: (B_NRO, n_nro_fields, mh). Returns (B_NRO,) logits.
    """
    ro_embs = _field_lookup(params, ro_ids, ro_lengths,
                            range(cfg.n_ro_fields), cfg=cfg, plan=plan)
    nro_embs = _field_lookup(params, nro_ids, nro_lengths,
                             range(cfg.n_ro_fields, cfg.n_sparse), cfg=cfg,
                             plan=plan)
    return dlrm_forward_from_embs(params, cfg, ro_dense, ro_embs, nro_embs,
                                  segment_ids, plan)


def dlrm_forward_impression(params: Dict, cfg: DLRMConfig,
                            dense: torch.Tensor, ids: torch.Tensor,
                            lengths: torch.Tensor, plan=None) -> torch.Tensor:
    """Impression-level baseline: everything at B_NRO.

    dense: (B, n_dense); ids: (B, n_sparse, mh). Returns (B,) logits.
    Under a plan the lookups go through ``_field_lookup``'s sharded bags
    and, where the plan slices D, B7 runs on this rank's slice as in
    :func:`dlrm_forward_from_embs`.
    """
    dense_out = mlp_apply(params["bot_mlp"], dense)
    embs = _field_lookup(params, ids, lengths, range(cfg.n_sparse), cfg=cfg,
                         plan=plan)
    if not _sliced(cfg, plan):
        z = dot_interaction(dense_out, embs)
        return mlp_apply(params["top_mlp"], z)[:, 0]
    n = spmd.model_shard_count(plan)
    dense_slice = coll.slice_cols(dense_out, spmd.model_group(plan), n,
                                  spmd.model_index(plan))
    part = dot_interaction(dense_slice, embs)
    pairs = spmd.model_sum(part[:, cfg.embed_dim // n:], plan)
    z = torch.cat([dense_out, pairs], dim=1)
    return mlp_apply(params["top_mlp"], z)[:, 0]


def dlrm_table_ids(cfg: DLRMConfig, ro_ids: torch.Tensor,
                   nro_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-table flat id sets of one ROO batch (params-tree paths), for
    ``embeddings.sparse.make_sparse_value_and_grad``: folded through the
    collection's feature routing, so declaration and lookup cannot
    drift."""
    feats = {f"f{f}": ro_ids[:, j] for j, f in enumerate(
        range(cfg.n_ro_fields))}
    feats.update({f"f{f}": nro_ids[:, j] for j, f in enumerate(
        range(cfg.n_ro_fields, cfg.n_sparse))})
    return cfg.collection().request_ids(feats, prefix="tables/")


def dlrm_flops_per_example(cfg: DLRMConfig) -> int:
    """Analytic dense forward FLOPs per impression (impression-level)."""
    f = cfg.n_sparse + 1
    top_dims = (cfg.top_in_dim(),) + cfg.top_mlp[1:]
    return (mlp_flops(cfg.bot_mlp, 1) + mlp_flops(top_dims, 1)
            + 2 * f * f * cfg.embed_dim)
