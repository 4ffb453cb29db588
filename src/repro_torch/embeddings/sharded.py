"""Row-sharded embedding tables with explicit collectives (torch port of
``repro/embeddings/sharded.py``).

Table rows are split over the ``model`` axis; each rank holds its row
block. A lookup computes a local partial (ids outside the block masked to
zero: the ``_local_partial_bag`` rule) and sums it over ``model``. Ids
arrive split over the batch axes and replicated over ``model``, so the
collective moves this rank's (B_local, D) per table — the bytes ROO
shrinks from B_NRO·D to B_RO·D for user-side tables (§2.2, Fig. 3).

Each partial rides the wire compressed per the ``comms_compress`` knob
(``distributed/comms.wire_transform``, applied before the collective, as
the reference does), and each call records its exchange in
``comms.STATS`` under the reference's site names, with the exchange's
global batch (the local one times the data shards). The collectives are
``distributed/collectives.py``'s autograd ops: an all-reduce with an
identity backward, a reduce-scatter whose backward all-gathers. Plain
torch, like the reference's jnp: no kernel runs on these routes.

Every sharded function takes ``plan`` (an enabled ``ShardingPlan``) and
the table's global ``vocab``; ``table`` is this rank's (vocab / n, D)
block. ``lookup`` / ``lookup_dense`` are the replicated path (plain bags),
and ``table_partition_specs`` gives every table of a collection its row
split over ``model`` as the port's spec tuples.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.data.jagged import JaggedTensor
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import comms, spmd
from repro_torch.distributed.sharding import Spec, normalize_spec
from repro_torch.embeddings.bag import bag_lookup, bag_lookup_dense
# table configs live with the collection (the embedding entry point);
# re-exported here, as the reference does
from repro_torch.embeddings.collection import (  # noqa: F401
    EmbeddingCollectionConfig, TableConfig, init_tables)
from repro_torch.embeddings.sparse import gather_rows


def table_partition_specs(cfg: EmbeddingCollectionConfig,
                          model_axis: str = "model") -> Dict[str, Spec]:
    """Row-shard every table over the model axis."""
    return {t.name: normalize_spec((model_axis, None)) for t in cfg.tables}


# ---------------------------------------------------------------------------
# Replicated-path lookups (one device, CPU tests): plain bags.
# ---------------------------------------------------------------------------

def lookup(table: torch.Tensor, ids: JaggedTensor, pooling: str = "sum"):
    return bag_lookup(table, ids, pooling)


def lookup_dense(table: torch.Tensor, ids: torch.Tensor,
                 lengths: torch.Tensor, pooling: str = "sum"):
    return bag_lookup_dense(table, ids, lengths, pooling)


def _local_partial_bag(tbl_shard: torch.Tensor, ids: torch.Tensor,
                       lengths: torch.Tensor, vocab: int, n_shards: int,
                       shard_idx: int, pooling: str) -> torch.Tensor:
    """Partial bag over the rows this shard owns (padded-dense ids)."""
    rows = tbl_shard.shape[0]                      # vocab // n_shards
    b, l = ids.shape
    local = ids.long() - shard_idx * rows
    in_shard = (local >= 0) & (local < rows)
    valid = (torch.arange(l, device=ids.device)[None, :]
             < lengths[:, None]) & in_shard
    emb = gather_rows(tbl_shard, torch.clamp(local, 0, rows - 1).reshape(-1)
                      ).reshape(b, l, -1)
    emb = emb * valid[..., None].to(emb.dtype)
    out = torch.sum(emb, dim=1)
    if pooling == "mean":
        out = out / torch.clamp(lengths, min=1).to(out.dtype)[:, None]
    return out


def _global_b(b_local: int, plan) -> int:
    return b_local * spmd.data_shard_count(plan)


def _psum_model(part: torch.Tensor, plan) -> torch.Tensor:
    mode, block = comms.compress_mode(), comms.block_size()
    part = comms.wire_transform(part, mode, block)
    return coll.all_reduce_sum(part, [spmd.model_group(plan)])


def sharded_bag_lookup(table: torch.Tensor, ids: torch.Tensor,
                       lengths: torch.Tensor, *, plan, vocab: int,
                       pooling: str = "sum") -> torch.Tensor:
    """Row-sharded padded bag: local partial + sum over ``model``.
    ids / lengths: this rank's (B, L) / (B,); output (B, D)."""
    d = table.shape[-1]
    b = _global_b(ids.shape[0], plan)
    comms.STATS.record_exchange(
        f"lookup:bag:V{vocab}xB{b}xD{d}", (b, d),
        mode=comms.compress_mode(), block=comms.block_size())
    part = _local_partial_bag(table, ids, lengths, vocab,
                              spmd.model_shard_count(plan),
                              spmd.model_index(plan), pooling)
    return _psum_model(part, plan)


def sharded_seq_lookup(table: torch.Tensor, ids: torch.Tensor, *, plan,
                       vocab: int, stats_shape=None,
                       stats_dedup: bool = False) -> torch.Tensor:
    """Row-sharded per-position lookup: ids (any shape) -> ids.shape + (D,).
    Each rank gathers the rows it owns and zeros the rest; the sum over
    ``model`` reassembles exact ``table[clip(ids)]`` (every position
    lands in exactly one block). ``stats_shape`` is the id shape the site
    records (the dedup route passes the request's, as the reference's
    fixed-size unique keeps it)."""
    rows, d = table.shape
    shape = tuple(stats_shape if stats_shape is not None else ids.shape)
    b = _global_b(shape[0], plan)
    comms.STATS.record_exchange(
        f"lookup:seq:V{vocab}xB{b}xL{shape[1]}xD{d}", (b,) + shape[1:] + (d,),
        mode=comms.compress_mode(), block=comms.block_size(),
        dedup=stats_dedup)
    local = torch.clamp(ids.long(), 0, vocab - 1) - \
        spmd.model_index(plan) * rows
    in_shard = (local >= 0) & (local < rows)
    emb = gather_rows(table, torch.clamp(local, 0, rows - 1).reshape(-1)
                      ).reshape(tuple(ids.shape) + (d,))
    emb = emb * in_shard[..., None].to(emb.dtype)
    return _psum_model(emb, plan)


def sharded_jagged_bag_lookup(table: torch.Tensor, ids: JaggedTensor, *,
                              plan, vocab: int,
                              pooling: str = "sum") -> torch.Tensor:
    """Row-sharded bag over a jagged id-list feature.

    The jagged buffer has no per-row alignment, so it stays whole (every
    rank holds the whole batch's ids): each model rank pools the rows it
    owns for the whole batch, the (B, D) partial is summed over ``model``
    (the RO-side collective of Fig. 3), and the rank keeps its data
    block's rows. sum / mean only."""
    if pooling not in ("sum", "mean"):
        raise ValueError(f"sharded jagged bag supports sum/mean, not "
                         f"{pooling}")
    rows, d = table.shape
    b = ids.batch_size
    comms.STATS.record_exchange(
        f"lookup:jagged:V{vocab}xB{b}xD{d}", (b, d),
        mode=comms.compress_mode(), block=comms.block_size())
    vals, lens = ids.values, ids.lengths
    seg = torch.repeat_interleave(
        torch.arange(b, device=lens.device), lens.long())
    n_valid = min(seg.numel(), vals.shape[0])
    seg = torch.cat([seg[:n_valid], torch.full(
        (vals.shape[0] - n_valid,), b, dtype=seg.dtype, device=seg.device)])
    local = torch.clamp(vals.long(), 0, vocab - 1) - \
        spmd.model_index(plan) * rows
    valid = (seg < b) & (local >= 0) & (local < rows)
    emb = gather_rows(table, torch.clamp(local, 0, rows - 1))
    emb = emb * valid[:, None].to(emb.dtype)
    out = emb.new_zeros((b + 1, d)).index_add(0, seg, emb)[:b]
    out = _psum_model(out, plan)
    if pooling == "mean":
        out = out / torch.clamp(lens, min=1).to(out.dtype)[:, None]
    n, k = spmd.data_shard_count(plan), spmd.data_index(plan)
    return out[k * (b // n):(k + 1) * (b // n)]


def sharded_bag_lookup_rs(table: torch.Tensor, ids: torch.Tensor,
                          lengths: torch.Tensor, *, plan, vocab: int,
                          pooling: str = "sum") -> torch.Tensor:
    """Reduce-scatter variant: this rank keeps the D / n_model chunk of
    the bag that its model index names. Half the collective bytes of the
    all-reduce when the consumer contracts over D (DLRM's dot
    interaction). Composes with wire compression like the psum route."""
    return sharded_bags_rs([table], ids[:, None, :], lengths[:, None],
                           plan=plan, vocabs=[vocab], pooling=pooling)[:, 0]


def sharded_bags_rs(tables, ids: torch.Tensor, lengths: torch.Tensor, *,
                    plan, vocabs, pooling: str = "sum") -> torch.Tensor:
    """The reduce-scatter route for F fields at once: ids (B, F, L),
    lengths (B, F) -> (B, F, D / n_model), one collective for the group
    (each field's site recorded as the reference's per-field call)."""
    n, k = spmd.model_shard_count(plan), spmd.model_index(plan)
    b = _global_b(ids.shape[0], plan)
    mode, block = comms.compress_mode(), comms.block_size()
    parts = []
    for f, (tbl, vocab) in enumerate(zip(tables, vocabs)):
        d = tbl.shape[-1]
        comms.STATS.record_exchange(
            f"lookup:bag_rs:V{vocab}xB{b}xD{d}", (b, d), mode=mode,
            block=block, collective="psum_scatter")
        parts.append(comms.wire_transform(_local_partial_bag(
            tbl, ids[:, f], lengths[:, f], vocab, n, k, pooling),
            mode, block))
    return coll.reduce_scatter_cols(torch.stack(parts, dim=1),
                                    spmd.model_group(plan), n)
