"""Cell builders for the recsys architectures (ROO is native here); torch
port of ``repro/configs/recsys_cells.py``.

Shapes (assigned):
  train_batch     batch=65 536   -> ROO train step (B_NRO=65 536, B_RO=16 384)
  serve_p99       batch=512      -> online inference (B_RO=128)
  serve_bulk      batch=262 144  -> offline scoring (B_RO=65 536)
  retrieval_cand  batch=1, n_candidates=10⁶ -> one user vs 1 000 448 items
                  (padded to a 512-multiple), batched dot — never a loop.

``batch`` counts impressions (B_NRO); B_RO = batch/4 reflects the paper's
4–7 impressions-per-request regime (Fig. 2). Embedding tables are
row-sharded over `model`; batch tensors shard over the (pod,)data axes.

The reference gives these cells only their input shardings and lets GSPMD
place the collectives. The port runs one program a rank, so every cell
function here takes ``plan`` and says its collectives: the item lookups
go through the row-sharded route of ``embeddings/sharded.py`` (a local
partial summed over ``model``), and a loss's sums over the batch are
summed over the batch axes (``spmd.data_sum``, identity backward), so
every rank returns the global loss and its gradient is its own block's
part, which the step sums over the batch axes (``spmd.reduce_grads``).
Inputs are this rank's blocks; ``segment_ids`` arrive global, as the
reference's are, and a cell rebases them to the block
(:func:`local_segments`: every impression lies in its request's block, as
the batcher lays them out). The losses are module-level functions of
``(params, cfg, inputs, plan)``, so the tests run them at small configs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import (Cell, abstract, cell_train_step, coin,
                                      ids_below, in_order, lengths_upto,
                                      normal, sds, whole_batch)
from repro_torch.core.fanout import fanout
from repro_torch.core.roo_batch import ROOBatch
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import ShardingPlan
from repro_torch.embeddings import collection as ec
from repro_torch.embeddings.sparse import gather_rows
from repro_torch.models.bert4rec import (BERT4RecConfig, bert4rec_init,
                                         encode as b4r_encode)
from repro_torch.models.din_dien import DIENConfig, dien_init, dien_logits_roo
from repro_torch.models.dlrm import (DLRMConfig, _field_lookup,
                                     dlrm_flops_per_example,
                                     dlrm_forward_from_embs, dlrm_forward_roo,
                                     dlrm_init)
from repro_torch.models.mind import MINDConfig, interest_capsules, mind_init
from repro_torch.train.metrics import bce, bce_terms  # noqa: F401
from repro_torch.train.optim import (adam, default_is_embedding, make_mixed,
                                     rowwise_adagrad)
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", b_nro=65536, b_ro=16384),
    "serve_p99": dict(kind="serve", b_nro=512, b_ro=128),
    "serve_bulk": dict(kind="serve", b_nro=262144, b_ro=65536),
    "retrieval_cand": dict(kind="serve", b_nro=1000448, b_ro=32),
}

N_ITEMS = 8388608          # 2^23-row item catalog (production-scale table)
DLRM_OPT_LEVELS = ("baseline", "impression", "opt", "opt2")


# ---------------------------------------------------------------------------
# batch helpers
# ---------------------------------------------------------------------------

def _on(plan) -> bool:
    return plan is not None and plan.enabled


def batch_sum(x: torch.Tensor, b_global: int, plan) -> torch.Tensor:
    """The sum of ``x`` over the whole batch: this block's sum summed over
    the batch axes when ``x`` is a block of a ``b_global`` batch."""
    s = torch.sum(x)
    return spmd.data_sum(s, plan) if x.shape[0] < b_global else s


def weighted_mean(x: torch.Tensor, w: torch.Tensor, b_global: int,
                  plan) -> torch.Tensor:
    return batch_sum(x * w, b_global, plan) / torch.clamp(
        batch_sum(w, b_global, plan), min=1.0)


def local_segments(seg: torch.Tensor, b_ro_local: int,
                   plan) -> torch.Tensor:
    """Global segment ids (padding >= B_RO) -> this block's: ``seg - k *
    B_RO / n``, padding -> ``B_RO / n`` (``spmd.place_batch``'s rule)."""
    n = spmd.data_shard_count(plan)
    if n == 1 or seg.numel() == 0:
        return seg
    k = spmd.data_index(plan)
    return torch.where(seg >= b_ro_local * n,
                       torch.full_like(seg, b_ro_local),
                       seg - k * b_ro_local)


def _mk_batch(history_ids, history_lengths, item_ids, segment_ids, labels,
              ro_dense=None):
    """Assemble a ROOBatch from plain tensors (unused fields zeroed)."""
    b_ro = history_ids.shape[0]
    b_nro = item_ids.shape[0]
    dev = history_ids.device
    nl = labels if labels is not None else torch.zeros(
        (b_nro, 2), dtype=torch.float32, device=dev)
    return ROOBatch(
        ro_dense=(ro_dense if ro_dense is not None
                  else torch.zeros((b_ro, 1), dtype=torch.float32,
                                   device=dev)),
        ro_sparse=None,
        history_ids=history_ids,
        history_actions=torch.zeros_like(history_ids),
        history_lengths=history_lengths,
        nro_dense=torch.zeros((b_nro, 1), dtype=torch.float32, device=dev),
        nro_sparse=None,
        item_ids=item_ids,
        labels=nl,
        num_impressions=torch.full((b_ro,), b_nro // max(b_ro, 1),
                                   dtype=torch.int32, device=dev),
        segment_ids=segment_ids)


# ---------------------------------------------------------------------------
# generic train / serve cells
# ---------------------------------------------------------------------------

def _mixed_opt():
    return make_mixed(adam(1e-3), rowwise_adagrad(0.05), default_is_embedding)


def specs_like(tree, spec=()):
    """A spec tree shaped like ``tree``, every leaf ``spec``."""
    return tree_map(lambda _: spec, tree)


def fitted(specs, params, plan):
    """``specs`` fitted to the global ``params``' shapes (what each rank
    holds: ``spmd.fit_spec``)."""
    return unflatten(params, [
        spmd.fit_spec(s, tuple(p.shape), plan)
        for s, p in zip(leaves(specs, is_leaf=spmd.is_spec),
                        leaves(params))])


def _train_cell(arch, shape_name, plan, init_fn, cell_loss, specs_fn,
                pspecs_fn, param_pspecs, flops, fill) -> Cell:
    """Generic recsys train cell: cell_loss(params, inputs) + mixed opt."""
    opt = _mixed_opt()

    def abstract_params():
        return abstract(init_fn)

    def abstract_state():
        params = abstract_params()
        return {"params": params, "opt": abstract(lambda: opt.init(params)),
                "step": sds((), torch.int32)}

    def state_pspecs(plan):
        params = abstract_params()
        pp = param_pspecs(params)
        emb_mask = [default_is_embedding(path)
                    for path, _ in flatten_with_path(params)]
        pp_leaves = leaves(pp, is_leaf=spmd.is_spec)
        emb_specs = [s for s, m in zip(pp_leaves, emb_mask) if m]
        dense_specs = [s for s, m in zip(pp_leaves, emb_mask) if not m]
        # row-wise adagrad state: (rows,) per table -> first axis of the spec
        emb_acc = [tuple(s[:1]) for s in emb_specs]
        return {"params": pp,
                "opt": {"emb": {"acc": emb_acc},
                        "dense": {"m": dense_specs, "v": dense_specs,
                                  "t": ()}},
                "step": ()}

    def realized():
        params = abstract_params()
        return fitted(param_pspecs(params), params, plan)

    step = cell_train_step(cell_loss, opt, plan, realized)
    return Cell(arch, shape_name, "train", step, abstract_state, state_pspecs,
                specs_fn, pspecs_fn, flops, fill=fill)


def _serve_cell(arch, shape_name, init_fn, fwd_fn, specs_fn, pspecs_fn,
                param_pspecs, flops, fill) -> Cell:
    def abstract_state():
        return {"params": abstract(init_fn)}

    def state_pspecs(plan):
        return {"params": param_pspecs(abstract(init_fn))}

    def step(state, inputs):
        with torch.no_grad():
            return fwd_fn(state["params"], inputs)

    return Cell(arch, shape_name, "serve", step, abstract_state, state_pspecs,
                specs_fn, pspecs_fn, flops, fill=fill)


def _gen():
    return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# dlrm-mlperf
# ---------------------------------------------------------------------------

def field_ids(vocabs):
    """Filler of (B, n_fields, ids a field) ids: field j's drawn
    uniformly below ``vocabs[j]``."""
    def draw(spec, gen, device):
        hi = torch.tensor(vocabs, dtype=torch.float64, device=device)
        u = torch.rand(tuple(spec.shape), generator=gen, device=device,
                       dtype=torch.float64)
        return (u * hi[None, :, None]).to(spec.dtype)
    return draw


def _ones(b, f, ref):
    return torch.ones((b, f), dtype=torch.int32, device=ref.device)


def dlrm_cell_logits(p, cfg: DLRMConfig, inputs: Dict, plan, b_ro: int):
    """The ROO forward of the dlrm cells (``b_ro``: the global B_RO)."""
    ro_ids, nro_ids = inputs["ro_ids"], inputs["nro_ids"]
    seg = local_segments(inputs["segment_ids"], ro_ids.shape[0], plan)
    return dlrm_forward_roo(
        p, cfg, inputs["ro_dense"], ro_ids,
        _ones(ro_ids.shape[0], cfg.n_ro_fields, ro_ids), nro_ids,
        _ones(nro_ids.shape[0], cfg.n_sparse - cfg.n_ro_fields, nro_ids),
        seg, plan)


def dlrm_cell_loss(p, cfg: DLRMConfig, inputs: Dict, plan, b_ro: int,
                   b_nro: int):
    logits = dlrm_cell_logits(p, cfg, inputs, plan, b_ro)
    return batch_sum(bce_terms(logits, inputs["labels"]), b_nro,
                     plan) / b_nro


def dlrm_impression_loss(p, cfg: DLRMConfig, inputs: Dict, plan,
                         b_nro: int):
    """Pre-ROO ablation: user-side lookups run at B_NRO (duplicated)."""
    ro_ids, nro_ids = inputs["ro_ids"], inputs["nro_ids"]
    n = nro_ids.shape[0]
    seg = local_segments(inputs["segment_ids"], ro_ids.shape[0], plan)
    # expand RO ids/dense to impression level FIRST (the waste ROO removes)
    ro_ids_nro = fanout(ro_ids, seg)
    ro_dense_nro = fanout(inputs["ro_dense"], seg)
    kw = dict(cfg=cfg, plan=plan)
    ro_embs = _field_lookup(p, ro_ids_nro, _ones(n, cfg.n_ro_fields, ro_ids),
                            range(cfg.n_ro_fields), **kw)
    nro_embs = _field_lookup(
        p, nro_ids, _ones(n, cfg.n_sparse - cfg.n_ro_fields, nro_ids),
        range(cfg.n_ro_fields, cfg.n_sparse), **kw)
    logits = dlrm_forward_from_embs(
        p, cfg, ro_dense_nro, ro_embs, nro_embs,
        torch.arange(n, dtype=torch.int32, device=nro_ids.device), plan)
    return batch_sum(bce_terms(logits, inputs["labels"]), b_nro,
                     plan) / b_nro


def _row_part(table, ids, vocab: int, cfg: DLRMConfig, plan):
    """The bf16 rows of ``ids`` before their exchange (the opt levels'
    bf16 collectives): a sharded table's local partial (rows this rank
    does not own zeroed), a replicated table's rows."""
    if spmd.table_is_sharded(plan, vocab):
        rows = table.shape[0]
        local = ids - spmd.model_index(plan) * rows
        ok = (local >= 0) & (local < rows)
        part = gather_rows(table, torch.clamp(local, 0, rows - 1))
        return (part * ok[:, None].to(part.dtype)).to(torch.bfloat16)
    return gather_rows(table, ids).to(torch.bfloat16)


def _row_exchange(part, vocab: int, cfg: DLRMConfig, plan):
    """:func:`_row_part`'s rows as the forward uses them: a partial summed
    over ``model`` (reduce-scattered to this rank's D slice where the plan
    slices D); replicated rows sliced there. Each backward hands the part
    the whole row's gradient."""
    if not _on(plan):
        return part
    n = spmd.model_shard_count(plan)
    sliced = n > 1 and cfg.embed_dim % n == 0
    group = spmd.model_group(plan)
    if spmd.table_is_sharded(plan, vocab):
        if sliced:
            return coll.reduce_scatter_cols(part, group, n)
        return coll.all_reduce_sum(part, [group])
    if sliced:
        return coll.slice_cols(part, group, n, spmd.model_index(plan))
    return part


def sparse_row_update(table, acc, ids, g, *, plan, sharded: bool,
                      exchange: bool, lr: float, eps: float):
    """Row-wise Adagrad on touched rows ONLY (the reference's
    ``_sparse_row_update`` and its GSPMD counterpart).

    table: this rank's (V / n_model, D) block if ``sharded`` else whole;
    acc its (rows,); ids (B,) global (clipped) and g (B, D) f32 this
    rank's batch block. ``exchange``: every rank all-gathers every (id,
    grad) pair over the batch axes (O(touched rows)) and applies the
    masked update to its rows; otherwise each rank scatters its block's
    pairs into table-block-sized deltas that are summed over the batch
    axes (the dense exchange GSPMD emits for the scatter)."""
    rows = table.shape[0]
    if not _on(plan):
        acc2 = acc.index_add(0, ids, torch.mean(g * g, dim=-1))
        scale = lr * torch.rsqrt(acc2[ids] + eps)
        return table.index_add(0, ids, -(scale[:, None] * g).to(
            table.dtype)), acc2
    b_axes = spmd.plan_axes(plan, tuple(plan.batch_axes))
    if exchange:
        ids = coll.gather_dim(ids, b_axes, 0)
        g = coll.gather_dim(g, b_axes, 0).float()
    local = ids - spmd.model_index(plan) * rows if sharded else ids
    ok = ((local >= 0) & (local < rows)).to(torch.float32)
    li = torch.clamp(local, 0, rows - 1)
    groups = [grp for grp, _, _ in b_axes]
    d_acc = torch.zeros_like(acc).index_add(0, li,
                                            torch.mean(g * g, dim=-1) * ok)
    if not exchange:
        d_acc = coll.all_reduce_sum(d_acc, groups)
    acc2 = acc + d_acc
    scale = lr * torch.rsqrt(acc2[li] + eps) * ok
    d_tbl = torch.zeros(table.shape, dtype=torch.float32,
                        device=table.device).index_add(
        0, li, -(scale[:, None] * g))
    if not exchange:
        d_tbl = coll.all_reduce_sum(d_tbl, groups)
    return (table.float() + d_tbl).to(table.dtype), acc2


def _dlrm_opt_step(cfg: DLRMConfig, plan, b_ro: int, b_nro: int,
                   sparse_exchange: bool):
    """Beyond-paper: bf16 embedding collectives + sparse row updates."""
    adam_opt = adam(1e-3)
    lr_emb, eps = 0.05, 1e-8
    vocabs = {f"t{i}": cfg.padded_vocab(v) for i, v in enumerate(cfg.vocabs)}

    def step(state, inputs):
        params = state["params"]
        tables = params["tables"]
        dense_params = {"bot_mlp": params["bot_mlp"],
                        "top_mlp": params["top_mlp"]}
        names = sorted(tables.keys(), key=lambda k: int(k[1:]))
        ro_names = names[:cfg.n_ro_fields]
        nro_names = names[cfg.n_ro_fields:]
        ids = {n: inputs["ro_ids"][:, j, 0] for j, n in enumerate(ro_names)}
        ids.update({n: inputs["nro_ids"][:, j, 0]
                    for j, n in enumerate(nro_names)})
        seg = local_segments(inputs["segment_ids"], inputs["ro_ids"].shape[0],
                             plan)
        ids = {n: torch.clamp(ids[n].long(), 0, vocabs[n] - 1)
               for n in names}
        # differentiate wrt the GATHERED rows, not the (V, D) tables
        dense_l = [x.detach().requires_grad_(True)
                   for x in leaves(dense_params)]
        with torch.no_grad():
            row_l = [_row_part(tables[n], ids[n], vocabs[n], cfg, plan)
                     for n in names]
        row_l = [r.requires_grad_(True) for r in row_l]
        embs = [_row_exchange(r, vocabs[n], cfg, plan).float()
                for r, n in zip(row_l, names)]
        dp = unflatten(dense_params, dense_l)
        ro_embs = torch.stack(embs[:cfg.n_ro_fields], 1)
        nro_embs = torch.stack(embs[cfg.n_ro_fields:], 1)
        logits = dlrm_forward_from_embs({**dp, "tables": tables}, cfg,
                                        inputs["ro_dense"], ro_embs,
                                        nro_embs, seg, plan)
        loss = batch_sum(bce_terms(logits, inputs["labels"]), b_nro,
                         plan) / b_nro
        grads = torch.autograd.grad(loss, dense_l + row_l)
        g_dense = unflatten(dense_params, list(grads[:len(dense_l)]))
        if _on(plan):
            g_dense = spmd.reduce_grads(g_dense, specs_like(dense_params),
                                        plan)
        new_leaves, new_adam = adam_opt.update(
            leaves(g_dense), state["opt"]["dense"], leaves(dense_params))
        new_dense = unflatten(dense_params, new_leaves)
        # tables: SPARSE row-wise adagrad — touch only looked-up rows
        acc_order = sorted(names)
        acc_by_name = dict(zip(acc_order, state["opt"]["emb"]["acc"]))
        new_tables = dict(tables)
        # a part's gradient is its whole row's: the exchange's backward
        # (all-gather, identity) hands it over
        with torch.no_grad():
            for j, n in enumerate(names):
                g = grads[len(dense_l) + j].float()
                new_tables[n], acc_by_name[n] = sparse_row_update(
                    tables[n], acc_by_name[n], ids[n], g,
                    plan=plan, sharded=spmd.table_is_sharded(plan, vocabs[n]),
                    exchange=sparse_exchange, lr=lr_emb, eps=eps)
        new_params = {"tables": new_tables, "bot_mlp": new_dense["bot_mlp"],
                      "top_mlp": new_dense["top_mlp"]}
        new_opt = {"emb": {"acc": [acc_by_name[n] for n in acc_order]},
                   "dense": new_adam}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, loss.detach()
    return step


def build_dlrm_cell(shape_name: str, plan: ShardingPlan,
                    opt_level: str = "baseline",
                    cfg: DLRMConfig = None) -> Cell:
    """opt_level:
      impression — pre-ROO baseline: RO features looked up at B_NRO
                   (user-side lookups duplicated per impression);
      baseline   — paper-faithful ROO (RO side at B_RO, one fanout);
      opt        — beyond-paper: bf16 embedding collectives + SPARSE
                   row-wise-Adagrad updates (no dense (V,D) gradient /
                   optimizer sweep; only touched rows move);
      opt2       — opt with the (id, grad) pairs all-gathered over the
                   batch axes instead of table-sized deltas summed.
    ``cfg`` replaces the MLPerf config (the tests' small one).
    """
    if opt_level not in DLRM_OPT_LEVELS:
        raise ValueError(f"dlrm-mlperf has no opt level {opt_level!r}")
    sh = RECSYS_SHAPES[shape_name]
    b_ro, b_nro = sh["b_ro"], sh["b_nro"]
    cfg = cfg or DLRMConfig()
    # the tables under SHARD_MIN_ROWS stay replicated, as the reference's
    # cells place them
    plan = dataclasses.replace(plan, table_min_rows=cfg.SHARD_MIN_ROWS)
    m = plan.model_axis
    train = sh["kind"] == "train"

    def init_fn():
        return dlrm_init(_gen(), cfg, device="meta")

    def param_pspecs(params):
        # big tables row-sharded over `model`; tiny ones replicated
        return {
            "tables": {k: ((m, None)
                           if params["tables"][k].shape[0]
                           >= plan.table_min_rows else (None, None))
                       for k in params["tables"]},
            "bot_mlp": specs_like(params["bot_mlp"]),
            "top_mlp": specs_like(params["top_mlp"]),
        }

    def specs_fn():
        s = {"ro_dense": sds((b_ro, 13)),
             "ro_ids": sds((b_ro, cfg.n_ro_fields, 1), torch.int32),
             "nro_ids": sds((b_nro, cfg.n_sparse - cfg.n_ro_fields, 1),
                            torch.int32),
             "segment_ids": sds((b_nro,), torch.int32)}
        if train:
            s["labels"] = sds((b_nro,))
        return s

    def pspecs_fn(plan):
        ba = plan.batch_axes
        s = {"ro_dense": (ba, None), "ro_ids": (ba, None, None),
             "nro_ids": (ba, None, None), "segment_ids": (ba,)}
        if train:
            s["labels"] = (ba,)
        return s

    k = cfg.n_ro_fields
    fill = {"ro_dense": normal, "ro_ids": field_ids(cfg.vocabs[:k]),
            "nro_ids": field_ids(cfg.vocabs[k:]),
            "segment_ids": in_order(b_ro), "labels": coin}
    flops = dlrm_flops_per_example(cfg) * b_nro * (3 if train else 1)
    if not train:
        return _serve_cell(
            "dlrm-mlperf", shape_name, init_fn,
            lambda p, i: dlrm_cell_logits(p, cfg, i, plan, b_ro), specs_fn,
            pspecs_fn, param_pspecs, flops, fill)
    if opt_level == "impression":
        loss = (lambda p, i: dlrm_impression_loss(p, cfg, i, plan, b_nro))
        notes = "impression-level ablation (pre-ROO)"
    else:
        loss = (lambda p, i: dlrm_cell_loss(p, cfg, i, plan, b_ro, b_nro))
        notes = ("bf16 collectives + sparse row-wise adagrad"
                 if opt_level in ("opt", "opt2") else "")
    cell = _train_cell("dlrm-mlperf", shape_name, plan, init_fn, loss,
                       specs_fn, pspecs_fn, param_pspecs, flops, fill)
    if opt_level in ("opt", "opt2"):
        cell.step = _dlrm_opt_step(cfg, plan, b_ro, b_nro,
                                   sparse_exchange=opt_level == "opt2")
    cell.notes = notes
    return cell


# ---------------------------------------------------------------------------
# mind
# ---------------------------------------------------------------------------

MIND_NEG = 8192


def mind_cell_loss(p, cfg: MINDConfig, inputs: Dict, plan, b_nro: int):
    """Sampled-softmax over shared negatives, positives = clicks."""
    hist = inputs["history_ids"]
    caps = interest_capsules(p, cfg, hist, inputs["history_lengths"],
                             plan)                            # (B_RO,K,d)
    seg = local_segments(inputs["segment_ids"], hist.shape[0], plan)
    caps_nro = fanout(caps, seg)
    tgt = ec.row_lookup(p["item_emb"], inputs["item_ids"], vocab=cfg.n_items,
                        plan=plan)
    att = torch.softmax(cfg.pow_p * torch.einsum("bkd,bd->bk", caps_nro, tgt),
                        dim=-1)
    u = torch.einsum("bk,bkd->bd", att, caps_nro)
    pos = torch.sum(u * tgt, -1) / 0.1                        # (B_NRO,)
    neg_emb = ec.row_lookup(p["item_emb"], inputs["neg_ids"],
                            vocab=cfg.n_items, plan=plan)     # (n_neg, d)
    neg = (u @ neg_emb.T) / 0.1                               # (B_NRO, n_neg)
    lse = torch.logaddexp(torch.logsumexp(neg, -1), pos)
    return weighted_mean(lse - pos, inputs["labels"], b_nro, plan)


def mind_cell_serve(p, cfg: MINDConfig, inputs: Dict, plan, b_ro: int,
                    retrieval: bool):
    """Serving scores. ``retrieval``: the whole batch's users (gathered
    over the batch axes) against this rank's block of the candidates ->
    (B_RO, C / n_batch): the candidates stay split as they arrive."""
    hist = inputs["history_ids"]
    caps = interest_capsules(p, cfg, hist, inputs["history_lengths"],
                             plan)                            # (B_RO,K,d)
    cand = ec.row_lookup(p["item_emb"], inputs["item_ids"],
                         vocab=cfg.n_items, plan=plan)
    if retrieval:
        caps = whole_batch(caps, b_ro, plan)
        scores = torch.einsum("bkd,cd->bkc", caps, cand)      # (B_RO,K,C)
        return torch.amax(scores, dim=1)                      # (B_RO, C)
    seg = local_segments(inputs["segment_ids"], hist.shape[0], plan)
    caps_nro = fanout(caps, seg)
    return torch.amax(torch.einsum("bkd,bd->bk", caps_nro, cand), -1)


def build_mind_cell(shape_name: str, plan: ShardingPlan,
                    cfg: MINDConfig = None) -> Cell:
    sh = RECSYS_SHAPES[shape_name]
    b_ro, b_nro = sh["b_ro"], sh["b_nro"]
    cfg = cfg or MINDConfig(n_items=N_ITEMS, hist_len=64)
    m = plan.model_axis
    n_neg = MIND_NEG
    retrieval = shape_name == "retrieval_cand"

    def init_fn():
        return mind_init(_gen(), cfg, device="meta")

    def param_pspecs(params):
        return {"item_emb": (m, None), "S": ()}

    def specs_fn():
        s = {"history_ids": sds((b_ro, cfg.hist_len), torch.int32),
             "history_lengths": sds((b_ro,), torch.int32),
             "item_ids": sds((b_nro,), torch.int32)}
        if not retrieval:
            s["segment_ids"] = sds((b_nro,), torch.int32)
        if sh["kind"] == "train":
            s["labels"] = sds((b_nro,))
            s["neg_ids"] = sds((n_neg,), torch.int32)
        return s

    def pspecs_fn(plan):
        ba = plan.batch_axes
        s = {"history_ids": (ba, None), "history_lengths": (ba,),
             "item_ids": (ba,)}
        if not retrieval:
            s["segment_ids"] = (ba,)
        if sh["kind"] == "train":
            s["labels"] = (ba,)
            s["neg_ids"] = (None,)
        return s

    d, kk = cfg.embed_dim, cfg.n_interests
    flops = (b_ro * cfg.capsule_iters * 2 * cfg.hist_len * kk * d   # routing
             + b_ro * 2 * cfg.hist_len * d * d                      # S map
             + b_nro * 2 * kk * d
             + (b_nro * 2 * n_neg * d if sh["kind"] == "train" else 0))
    flops *= 3 if sh["kind"] == "train" else 1
    items = ids_below(cfg.n_items)
    fill = {"history_ids": items, "history_lengths": lengths_upto(
        cfg.hist_len), "item_ids": items, "segment_ids": in_order(b_ro),
        "labels": coin, "neg_ids": items}
    if sh["kind"] == "train":
        return _train_cell(
            "mind", shape_name, plan, init_fn,
            lambda p, i: mind_cell_loss(p, cfg, i, plan, b_nro), specs_fn,
            pspecs_fn, param_pspecs, flops, fill)
    return _serve_cell(
        "mind", shape_name, init_fn,
        lambda p, i: mind_cell_serve(p, cfg, i, plan, b_ro, retrieval),
        specs_fn, pspecs_fn, param_pspecs, flops, fill)


# ---------------------------------------------------------------------------
# bert4rec
# ---------------------------------------------------------------------------

B4R_NEG, B4R_MASK = 8192, 16


def bert4rec_cell_loss(p, cfg: BERT4RecConfig, inputs: Dict, plan,
                       b_ro: int, n_mask: int = B4R_MASK):
    """Sampled cloze: mask the last n_mask valid positions, score vs
    positives + shared negatives."""
    ids = inputs["history_ids"]
    lens = inputs["history_lengths"]
    # mask the trailing n_mask valid positions per row
    pos_idx = torch.clamp(lens[:, None].long() - 1 - torch.arange(
        n_mask, device=ids.device)[None], min=0)
    tgt = torch.gather(ids, 1, pos_idx)                       # (B, n_mask)
    masked = ids.scatter(1, pos_idx, 1)                       # MASK token
    enc = b4r_encode(p, cfg, masked, lens, plan)              # (B,S,d)
    q = torch.gather(enc, 1, pos_idx[..., None].expand(
        -1, -1, enc.shape[-1]))                               # (B,n_mask,d)
    tgt_e = ec.seq_lookup(p["item_emb"], tgt, vocab=cfg.n_items, plan=plan)
    pos_s = torch.sum(q * tgt_e, -1)                          # (B, n_mask)
    neg_e = ec.row_lookup(p["item_emb"], inputs["neg_ids"],
                          vocab=cfg.n_items, plan=plan)
    neg_s = torch.einsum("bmd,nd->bmn", q, neg_e)
    lse = torch.logaddexp(torch.logsumexp(neg_s, -1), pos_s)
    w = (pos_idx > 0).to(lse.dtype)
    return weighted_mean(lse - pos_s, w, b_ro, plan)


def bert4rec_cell_serve(p, cfg: BERT4RecConfig, inputs: Dict, plan,
                        b_ro: int, retrieval: bool):
    """Serving scores (``retrieval``: as :func:`mind_cell_serve`)."""
    ids = inputs["history_ids"]
    lens = torch.clamp(inputs["history_lengths"].long(), max=cfg.seq_len - 1)
    b = ids.shape[0]
    ids_ext = ids.scatter(1, lens[:, None], 1)
    enc = b4r_encode(p, cfg, ids_ext, lens + 1, plan)
    q = enc[torch.arange(b, device=ids.device), lens]         # (B_RO, d)
    cand = ec.row_lookup(p["item_emb"], inputs["item_ids"],
                         vocab=cfg.n_items, plan=plan)
    if retrieval:
        return whole_batch(q, b_ro, plan) @ cand.T           # (B_RO, C)
    seg = local_segments(inputs["segment_ids"], b, plan)
    return torch.sum(fanout(q, seg) * cand, -1)


def build_bert4rec_cell(shape_name: str, plan: ShardingPlan,
                        cfg: BERT4RecConfig = None) -> Cell:
    sh = RECSYS_SHAPES[shape_name]
    b_ro, b_nro = sh["b_ro"], sh["b_nro"]
    cfg = cfg or BERT4RecConfig(n_items=N_ITEMS, seq_len=200)
    m = plan.model_axis
    n_neg, n_mask = B4R_NEG, B4R_MASK
    retrieval = shape_name == "retrieval_cand"

    def init_fn():
        return bert4rec_init(_gen(), cfg, device="meta")

    def param_pspecs(params):
        return {"item_emb": (m, None), "pos_emb": (),
                "blocks": specs_like(params["blocks"]),
                "out_bias": (m,)}

    def specs_fn():
        s = {"history_ids": sds((b_ro, cfg.seq_len), torch.int32),
             "history_lengths": sds((b_ro,), torch.int32)}
        if sh["kind"] == "train":
            s["neg_ids"] = sds((n_neg,), torch.int32)
            s["labels"] = sds((b_nro,))
        else:
            s["item_ids"] = sds((b_nro,), torch.int32)
            if not retrieval:
                s["segment_ids"] = sds((b_nro,), torch.int32)
        return s

    def pspecs_fn(plan):
        ba = plan.batch_axes
        s = {"history_ids": (ba, None), "history_lengths": (ba,)}
        if sh["kind"] == "train":
            s["neg_ids"] = (None,)
            s["labels"] = (ba,)
        else:
            s["item_ids"] = (ba,)
            if not retrieval:
                s["segment_ids"] = (ba,)
        return s

    d, sl = cfg.embed_dim, cfg.seq_len
    enc_flops = b_ro * cfg.n_blocks * (8 * sl * d * d + 4 * sl * sl * d
                                       + 4 * sl * d * cfg.d_ff)
    flops = enc_flops + (b_ro * n_mask * n_neg * 2 * d
                         if sh["kind"] == "train" else b_nro * 2 * d)
    flops *= 3 if sh["kind"] == "train" else 1
    items = ids_below(cfg.n_items)
    fill = {"history_ids": items, "history_lengths": lengths_upto(
        cfg.seq_len), "neg_ids": items, "labels": coin, "item_ids": items,
        "segment_ids": in_order(b_ro)}
    if sh["kind"] == "train":
        return _train_cell(
            "bert4rec", shape_name, plan, init_fn,
            lambda p, i: bert4rec_cell_loss(p, cfg, i, plan, b_ro, n_mask),
            specs_fn, pspecs_fn, param_pspecs, flops, fill)
    return _serve_cell(
        "bert4rec", shape_name, init_fn,
        lambda p, i: bert4rec_cell_serve(p, cfg, i, plan, b_ro, retrieval),
        specs_fn, pspecs_fn, param_pspecs, flops, fill)


# ---------------------------------------------------------------------------
# dien
# ---------------------------------------------------------------------------

def dien_cell_logits(p, cfg: DIENConfig, inputs: Dict, plan):
    hist = inputs["history_ids"]
    batch = _mk_batch(hist, inputs["history_lengths"], inputs["item_ids"],
                      local_segments(inputs["segment_ids"], hist.shape[0],
                                     plan),
                      inputs.get("labels_2d"), ro_dense=inputs["ro_dense"])
    return dien_logits_roo(p, cfg, batch, plan)


def dien_cell_loss(p, cfg: DIENConfig, inputs: Dict, plan, b_nro: int):
    logits = dien_cell_logits(p, cfg, inputs, plan)
    return batch_sum(bce_terms(logits, inputs["labels"]), b_nro,
                     plan) / b_nro


def build_dien_cell(shape_name: str, plan: ShardingPlan,
                    cfg: DIENConfig = None) -> Cell:
    sh = RECSYS_SHAPES[shape_name]
    b_ro, b_nro = sh["b_ro"], sh["b_nro"]
    cfg = cfg or DIENConfig(n_items=N_ITEMS, seq_len=100, n_ro_dense=16)
    m = plan.model_axis

    def init_fn():
        return dien_init(_gen(), cfg, device="meta")

    def param_pspecs(params):
        pp = specs_like(params)
        pp["item_emb"] = (m, None)
        return pp

    def specs_fn():
        s = {"history_ids": sds((b_ro, cfg.seq_len), torch.int32),
             "history_lengths": sds((b_ro,), torch.int32),
             "ro_dense": sds((b_ro, cfg.n_ro_dense)),
             "item_ids": sds((b_nro,), torch.int32),
             "segment_ids": sds((b_nro,), torch.int32)}
        if sh["kind"] == "train":
            s["labels"] = sds((b_nro,))
        return s

    def pspecs_fn(plan):
        ba = plan.batch_axes
        s = {"history_ids": (ba, None), "history_lengths": (ba,),
             "ro_dense": (ba, None), "item_ids": (ba,),
             "segment_ids": (ba,)}
        if sh["kind"] == "train":
            s["labels"] = (ba,)
        return s

    d, h, t = cfg.embed_dim, cfg.gru_dim, cfg.seq_len
    gru = 6 * (d * h + h * h)
    flops = (b_ro * t * gru                       # extraction GRU (RO!)
             + b_nro * t * (6 * (h * h + h * h))  # AUGRU at B_NRO
             + b_nro * t * 2 * (2 * h + d) * 64   # attention MLP
             + b_nro * 2 * (h + d + 16) * 200)
    flops *= 3 if sh["kind"] == "train" else 1
    items = ids_below(cfg.n_items)
    fill = {"history_ids": items, "history_lengths": lengths_upto(
        cfg.seq_len), "ro_dense": normal, "item_ids": items,
        "segment_ids": in_order(b_ro), "labels": coin}
    if sh["kind"] == "train":
        return _train_cell(
            "dien", shape_name, plan, init_fn,
            lambda p, i: dien_cell_loss(p, cfg, i, plan, b_nro), specs_fn,
            pspecs_fn, param_pspecs, flops, fill)
    return _serve_cell("dien", shape_name, init_fn,
                       lambda p, i: dien_cell_logits(p, cfg, i, plan),
                       specs_fn, pspecs_fn, param_pspecs, flops, fill)
