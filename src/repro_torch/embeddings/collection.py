"""Embedding lookups — torch port of the local path of
``repro/embeddings/collection.py``.

  * ``seq_lookup``        — (B, L) ids -> (B, L, D) rows (HSTU inputs)
  * ``row_lookup``        — (B,)  ids -> (B, D) single rows (item towers)
  * ``bag_lookup``        — JaggedTensor id lists -> (B, D) pooled bags
  * ``bag_lookup_dense``  — padded (B, L) multi-hot -> (B, D) pooled bags
  * ``bag_lookup_dense_grouped`` — the F fields of one lookup, (B, F, L)
                            ids -> (B, F, D), as one group

All clip ids to ``[0, vocab)`` and may apply request-level id dedup
(``dedup_gather``: each distinct id read once, duplicates expanded from the
small gathered buffer — bit-identical to the direct gather). Policy: the
``emb_dedup`` knob (arg > process default > ``REPRO_TORCH_EMB_DEDUP`` >
auto); auto never dedups, as the reference dedups only on TPU.
``bag_lookup_dense`` and ``bag_lookup_dense_grouped`` always run the
embedding-bag entry points (kernels/embedding_bag.py, backend from
``kernels/dispatch.py``); forced dedup pools over the small table of
distinct rows by the inverse ids, field by field.

Every lookup takes a table in either form (``Table``): a dense ``(V, D)``
tensor, or the ``embeddings.sparse.GatheredTable`` proxy of sparse-row
training (``make_sparse_value_and_grad``), whose rows were gathered once
for the batch (no further dedup). The gathers translate ids with
``GatheredTable.take``. The padded bags do not fall back to a gather, as
the reference does on its proxy: they run the same embedding-bag entry
points over the gathered rows with a zero row appended (``padded``), the
ids translated to positions and a miss pointed at the zero row, so on the
card a gathered table's bag is still B5 forward and B6 backward, and a
group that mixes gathered and dense tables is still one launch each way.
The gradient the rows get is the densify of B6's COO rows into the small
``(N + 1, D)`` buffer.

The named collection (``TableConfig``, ``FeatureSpec``,
``EmbeddingCollection``) declares tables and routes features to them:
``init``, ``lookup`` (one feature in its declared mode), ``lookup_keyed``
(every jagged feature of a ``KeyedJagged``) and ``request_ids`` (per-table
id sets for ``make_sparse_value_and_grad``). DLRM's 26 fields are its
canonical user.

Under an SPMD ``plan`` (``distributed/sharding.py``) a table the plan
row-shards (``spmd.table_is_sharded`` of its global ``vocab``, which the
caller passes: the tensor is this rank's row block) routes through the
explicit collectives of ``embeddings/sharded.py``: seq / row lookups and
padded bags sum a local partial over ``model``, a jagged bag sums the
whole batch's partial and keeps this rank's rows, and a padded bag that
declares ``out_sharded=True`` takes the reduce-scatter and returns this
rank's D / n_model chunk (a replicated table's bag is sliced to the same
chunk). Ids are clipped before the shard split (the partial zeroes an
out-of-range id, the local path clips it). Dedup composes with the sum:
the distinct ids go through the sharded gather and expand locally; a
compressed wire (``comms_compress``) forces that route, so only a
request's distinct rows ride the quantized exchange. ``max`` pooling
cannot be assembled from partials and is refused on a sharded table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.hstu import normal_init
from repro_torch.data.jagged import JaggedTensor, KeyedJagged
from repro_torch.embeddings.bag import bag_pool, bag_pool_dense  # noqa: F401
from repro_torch.embeddings.sparse import GatheredTable, gather_rows
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                              embedding_bag_grouped)
from repro_torch.scenario.knobs import UNSET, Knob

DEDUP_KNOB = Knob("emb_dedup", "REPRO_TORCH_EMB_DEDUP",
                  choices=("always", "never", "auto"), kind="policy",
                  auto=lambda: "auto")


Table = Union[torch.Tensor, GatheredTable]


def set_dedup_policy(policy: Optional[str]) -> None:
    """Process-wide dedup policy: "always" | "never" | "auto" | None."""
    DEDUP_KNOB.set_default(UNSET if policy is None else policy)


def _want_dedup(dedup: Optional[bool]) -> bool:
    if dedup is not None:
        return dedup
    return DEDUP_KNOB.resolve() == "always"


def _unique_inverse(flat: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.unique(flat, return_inverse=True)``. On meta tensors (the dry
    run: ``torch.unique`` has no meta kernel) the reference's static-size
    contract, ``jnp.unique(flat, size=flat.size, fill_value=0,
    return_inverse=True)``: ``flat.numel()`` distinct ids and as many
    inverse ids, so a count sees the gather of n rows and the expansion of
    n ids that the reference's compiled step runs."""
    if flat.device.type == "meta":
        return (torch.empty_like(flat),
                torch.empty(flat.shape, dtype=torch.long, device="meta"))
    return torch.unique(flat, return_inverse=True)


def dedup_gather(table: torch.Tensor, ids: torch.Tensor,
                 row_gather=None) -> torch.Tensor:
    """``table[ids]`` with each distinct id read once; ids pre-clipped.
    ``row_gather(uids) -> (n_ids, D)`` overrides how the distinct rows are
    fetched (a sharded gather, say)."""
    uids, inv = _unique_inverse(ids.reshape(-1))
    rows = (gather_rows(table, uids) if row_gather is None
            else row_gather(uids))
    return gather_rows(rows, inv).reshape(tuple(ids.shape)
                                          + tuple(rows.shape[1:]))


def _gather(table: Table, ids: torch.Tensor, vocab: int,
            dedup: Optional[bool]) -> torch.Tensor:
    """Row gather with dedup and the proxy; ids of any shape, unclipped."""
    ids = torch.clamp(ids.long(), 0, vocab - 1)
    if isinstance(table, GatheredTable):
        return table.take(ids)          # deduplicated for the whole batch
    if _want_dedup(dedup):
        return dedup_gather(table, ids)
    return gather_rows(table, ids)


def _vocab_of(table: Table, vocab: Optional[int], plan) -> int:
    if vocab is not None:
        return int(vocab)
    if plan is not None and plan.enabled:
        raise ValueError("a lookup under an SPMD plan needs the table's "
                         "global vocab (the tensor may be a row block)")
    return int(table.shape[0])


def _plan_shards(table: Table, vocab: int, plan) -> bool:
    if plan is None or isinstance(table, GatheredTable):
        return False
    from repro_torch.distributed.spmd import table_is_sharded
    return table_is_sharded(plan, vocab)


def _compress_active() -> bool:
    from repro_torch.distributed import comms
    return comms.compress_mode() != "none"


def _data_block(out: torch.Tensor, plan) -> torch.Tensor:
    """This rank's rows of a whole-batch output (a jagged bag's)."""
    from repro_torch.distributed import spmd
    n = spmd.data_shard_count(plan)
    if n == 1:
        return out
    m = out.shape[0] // n
    k = spmd.data_index(plan)
    return out[k * m:(k + 1) * m]


def seq_lookup(table: Table, ids: torch.Tensor, *,
               vocab: Optional[int] = None, plan=None,
               dedup: Optional[bool] = None) -> torch.Tensor:
    """(B, L) ids -> (B, L, D); exact ``table[clip(ids)]`` semantics."""
    v = _vocab_of(table, vocab, plan)
    if _plan_shards(table, v, plan):
        from repro_torch.embeddings.sharded import sharded_seq_lookup
        clipped = torch.clamp(ids.long(), 0, v - 1)
        if _want_dedup(dedup) or _compress_active():
            uids, inv = _unique_inverse(clipped.reshape(-1))
            rows = sharded_seq_lookup(table, uids, plan=plan, vocab=v,
                                      stats_shape=tuple(clipped.shape),
                                      stats_dedup=True)
            return gather_rows(rows, inv).reshape(
                tuple(ids.shape) + tuple(rows.shape[1:]))
        return sharded_seq_lookup(table, clipped, plan=plan, vocab=v)
    return _gather(table, ids, v, dedup)


def row_lookup(table: Table, ids: torch.Tensor, *,
               vocab: Optional[int] = None, plan=None,
               dedup: Optional[bool] = None) -> torch.Tensor:
    """(B,) ids -> (B, D) single-row gather."""
    return seq_lookup(table, ids[:, None], vocab=vocab, plan=plan,
                      dedup=dedup)[:, 0, :]


def bag_lookup(table: Table, ids: JaggedTensor, pooling: str = "sum",
               *, vocab: Optional[int] = None, plan=None,
               dedup: Optional[bool] = None) -> torch.Tensor:
    """Jagged id-list bag -> (B, D): (dedup-)gather, then pool. Under a
    plan the ids are the whole batch's and the output this rank's rows."""
    v = _vocab_of(table, vocab, plan)
    if pooling in ("sum", "mean") and _plan_shards(table, v, plan):
        from repro_torch.embeddings.sharded import sharded_jagged_bag_lookup
        return sharded_jagged_bag_lookup(table, ids, plan=plan, vocab=v,
                                         pooling=pooling)
    emb = _gather(table, ids.values, v, dedup)
    out = bag_pool(emb, ids, pooling)
    return _data_block(out, plan) if plan is not None else out


def bag_lookup_dense(table: Table, ids: torch.Tensor,
                     lengths: torch.Tensor, pooling: str = "sum", *,
                     vocab: Optional[int] = None, plan=None,
                     dedup: Optional[bool] = None,
                     backend: Optional[str] = None,
                     out_sharded: Optional[bool] = None) -> torch.Tensor:
    """Padded-layout bag: (B, L) ids + (B,) lengths -> (B, D).

    Runs ``kernels/embedding_bag.embedding_bag`` (forward B5, backward B6
    on a CUDA table; the plain path on a CPU one). A ``GatheredTable``
    runs it over its rows and a zero row by the ids' positions
    (``GatheredTable.padded``). Forced dedup (arg or the "always" policy)
    gathers each distinct clipped id's row of a dense table once and pools
    that small table by the inverse ids, so it runs the same kernels.
    Under a plan a sharded table takes ``embeddings/sharded.py``'s bag
    (module note); ``out_sharded=True`` returns this rank's D / n_model
    chunk when the model ranks divide D.
    """
    v = _vocab_of(table, vocab, plan)
    chunked = bool(out_sharded) and _chunks_d(table, plan)
    if _plan_shards(table, v, plan):
        from repro_torch.embeddings import sharded
        if pooling not in ("sum", "mean"):
            raise ValueError(f"{pooling} pooling cannot be assembled from "
                             f"a row-sharded table's partial bags")
        clipped = torch.clamp(ids.long(), 0, v - 1)
        if chunked:
            return sharded.sharded_bag_lookup_rs(
                table, clipped, lengths, plan=plan, vocab=v, pooling=pooling)
        return sharded.sharded_bag_lookup(table, clipped, lengths, plan=plan,
                                          vocab=v, pooling=pooling)
    table, ids = _bag_operands(table, ids, v, dedup)
    out = embedding_bag(table, ids, lengths, pooling, backend=backend)
    return _model_chunk(out, plan) if chunked else out


def _chunks_d(table: Table, plan) -> bool:
    """Whether an ``out_sharded`` lookup returns D / n_model chunks."""
    from repro_torch.distributed import spmd
    n = spmd.model_shard_count(plan)
    return n > 1 and int(table.shape[-1]) % n == 0


def _model_chunk(out: torch.Tensor, plan) -> torch.Tensor:
    """This rank's D chunk of a replicated output (backward: gather)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import spmd
    return coll.slice_cols(out, spmd.model_group(plan),
                           spmd.model_shard_count(plan),
                           spmd.model_index(plan))


def _distinct_rows(table: torch.Tensor, ids: torch.Tensor,
                   vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of the distinct clipped ids, and the ids into them."""
    uids, inv = _unique_inverse(torch.clamp(ids.long(), 0, vocab - 1)
                               .reshape(-1))
    return gather_rows(table, uids), inv.reshape(ids.shape)


def _bag_operands(table: Table, ids: torch.Tensor, vocab: int,
                  dedup: Optional[bool]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table and ids one field's bag hands the embedding-bag entry
    points: a gathered table's rows + zero row and positions, a dense
    table's distinct rows and inverse ids under forced dedup, else the
    table and ids as given."""
    if isinstance(table, GatheredTable):
        return table.padded(ids)
    if _want_dedup(dedup):
        return _distinct_rows(table, ids, vocab)
    return table, ids


def bag_lookup_dense_grouped(tables: Sequence[Table],
                             ids: torch.Tensor, lengths: torch.Tensor,
                             pooling: str = "sum", *,
                             dedup: Optional[bool] = None) -> torch.Tensor:
    """The padded bags of the F fields of one lookup: ``tables[f]`` (one D
    and dtype), ids (B, F, L) + lengths (B, F) -> (B, F, D); field f is
    ``bag_lookup_dense(tables[f], ids[:, f], lengths[:, f])``.

    Runs ``kernels/embedding_bag.embedding_bag_grouped`` (on CUDA tables one
    B5 launch forward and one B6 launch backward for all fields; the plain
    path on CPU ones). A ``GatheredTable`` field takes its rows and a zero
    row, its ids their positions (``GatheredTable.padded``), in the same
    group as the dense fields. Forced dedup gathers each dense field's
    distinct rows into a small table of its own and pools those by the
    inverse ids, still as one group.
    """
    tables = list(tables)
    if _want_dedup(dedup) or any(isinstance(t, GatheredTable)
                                 for t in tables):
        fields = [_bag_operands(t, ids[:, f, :], int(t.shape[0]), dedup)
                  for f, t in enumerate(tables)]
        tables = [t for t, _ in fields]
        ids = torch.stack([i.to(ids.dtype) for _, i in fields], dim=1)
    return embedding_bag_grouped(tables, ids, lengths, pooling)


# ---------------------------------------------------------------------------
# Table configs and the named collection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TableConfig:
    name: str
    vocab: int
    dim: int
    pooling: str = "sum"
    side: str = "nro"          # "ro" (user/request) or "nro" (item): which
                               # batch size the lookup runs at under ROO


@dataclasses.dataclass(frozen=True)
class EmbeddingCollectionConfig:
    tables: Tuple[TableConfig, ...]

    def table(self, name: str) -> TableConfig:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(name)


def init_tables(gen: torch.Generator, cfg: EmbeddingCollectionConfig,
                dtype=torch.float32, scale: float = 0.01,
                device="cuda") -> Dict[str, torch.Tensor]:
    """One (vocab, dim) table per config entry, N(0, scale²), drawn from
    ``gen`` in declaration order."""
    return {t.name: normal_init(gen, (t.vocab, t.dim), scale, dtype, device)
            for t in cfg.tables}


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Feature -> table routing entry: which table a named feature reads,
    in which lookup mode, with which pooling."""
    name: str
    table: str
    kind: str = "bag"          # "jagged" | "bag" | "seq" | "row"
    pooling: str = "sum"


class EmbeddingCollection:
    """Named tables + feature -> table routing (DLRM's 26 fields are the
    canonical user)."""

    def __init__(self, cfg: EmbeddingCollectionConfig,
                 features: Tuple[FeatureSpec, ...]):
        self.cfg = cfg
        self.features = {f.name: f for f in features}
        for f in features:
            cfg.table(f.table)      # raises on a dangling route

    def init(self, gen: torch.Generator, dtype=torch.float32,
             scale: float = 0.01, device="cuda") -> Dict[str, torch.Tensor]:
        return init_tables(gen, self.cfg, dtype, scale, device)

    def lookup(self, tables: Dict[str, Table], feature: str, ids,
               lengths: Optional[torch.Tensor] = None, *, plan=None,
               dedup: Optional[bool] = None) -> torch.Tensor:
        """One feature's lookup in its declared mode. ``ids`` is a
        JaggedTensor for "jagged", (B, L) [+ lengths] for "bag" / "seq",
        (B,) for "row"."""
        f = self.features[feature]
        t = self.cfg.table(f.table)
        tbl = tables[f.table]
        if f.kind == "jagged":
            return bag_lookup(tbl, ids, f.pooling, vocab=t.vocab, plan=plan,
                              dedup=dedup)
        if f.kind == "bag":
            if lengths is None:
                lengths = torch.full((ids.shape[0],), ids.shape[1],
                                     dtype=torch.int32, device=ids.device)
            return bag_lookup_dense(tbl, ids, lengths, f.pooling,
                                    vocab=t.vocab, plan=plan, dedup=dedup)
        if f.kind == "seq":
            return seq_lookup(tbl, ids, vocab=t.vocab, plan=plan,
                              dedup=dedup)
        if f.kind == "row":
            return row_lookup(tbl, ids, vocab=t.vocab, plan=plan,
                              dedup=dedup)
        raise ValueError(f"unknown lookup kind {f.kind!r}")

    def lookup_keyed(self, tables: Dict[str, Table], kj: KeyedJagged, *,
                     plan=None, dedup: Optional[bool] = None
                     ) -> Dict[str, torch.Tensor]:
        """Pooled bags for every jagged feature of a KeyedJagged bundle
        that the collection routes."""
        return {name: self.lookup(tables, name, kj[name], plan=plan,
                                  dedup=dedup)
                for name in kj.features if name in self.features}

    def request_ids(self, feature_ids: Dict[str, object],
                    prefix: str = "") -> Dict[str, torch.Tensor]:
        """Per-feature ids (tensors or JaggedTensors) folded into one flat
        id tensor per table, the ``table_ids_fn`` payload of
        ``make_sparse_value_and_grad``. ``prefix`` locates the tables dict
        inside the params tree (e.g. "tables/")."""
        by_table: Dict[str, list] = {}
        for name, ids in feature_ids.items():
            flat = (ids.values if isinstance(ids, JaggedTensor)
                    else ids).reshape(-1)
            by_table.setdefault(self.features[name].table, []).append(flat)
        return {f"{prefix}{t}": torch.cat(parts)
                for t, parts in by_table.items()}
