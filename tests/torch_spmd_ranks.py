"""What each spawned rank of the port's multi-rank tests runs.

The test modules (``test_torch_sharded_lookups.py``,
``test_torch_distributed_train.py``) spawn one gloo world per module
(``repro_torch.launch.hostdevices.spawn``) and hand it one of the
functions below; the ranks import the port only (no JAX), write what the
tests compare as ``.npz`` / ``.json`` files into the module's results
directory (rank 0 writes the whole-batch, whole-table results, gathered
over the mesh), and the test process holds them against the port's
single-process run and the reference.

Sizes are the reference's ``tests/test_distributed_train.py``'s
(``_lsr_cfg``, ``_gr_cfg``, 60 requests over 512 items, batches of 8 / 32).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.hstu import HSTUConfig
from repro_torch.core.joiner import RequestLevelJoiner
from repro_torch.data.batcher import BatcherConfig, ROOBatcher
from repro_torch.data.events import EventSimulator, EventStreamConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import comms, spmd
from repro_torch.distributed.sharding import plan_for_mesh
from repro_torch.interop import params_off_plan, params_onto_plan
from repro_torch.launch.mesh import in_mesh, make_test_mesh
from repro_torch.models.gr import GRConfig, gr_init, gr_ranking_loss
from repro_torch.models.lsr import LSRConfig, lsr_init, lsr_loss
from repro_torch.scenario.build import train_from_scenario
from repro_torch.scenario.knobs import UNSET
from repro_torch.train.loop import Trainer, TrainLoopConfig, value_and_grad
from repro_torch.train.optim import (adam, default_is_embedding, make_mixed,
                                     rowwise_adagrad)
from repro_torch.tree import flatten_with_path, tree_map

N_STEPS = 20


def lsr_cfg() -> LSRConfig:
    # vocabs divide model = 2 and clear SHARD_MIN_ROWS, so item_emb and
    # user_cat_emb row-shard while act_emb stays whole
    return LSRConfig(n_items=512, n_user_cats=64, n_item_cats=64,
                     embed_dim=32, n_ro_dense=16, n_item_dense=8, hist_len=16,
                     mode="userarch_hstu", lce_n_out=4, lce_d_out=32,
                     n_cross_layers=2, top_mlp=(64,),
                     hstu=HSTUConfig(d_model=32, n_heads=2, d_qk=16, d_v=16,
                                     n_layers=1, max_rel_pos=16))


def gr_cfg() -> GRConfig:
    return GRConfig(n_items=512, hist_len=16, m_targets=8,
                    hstu=HSTUConfig(d_model=32, n_heads=2, d_qk=16, d_v=16,
                                    n_layers=1, max_rel_pos=24))


def samples():
    stream = EventStreamConfig(n_requests=60, n_items=512, hist_init_max=12,
                               seed=0)
    return RequestLevelJoiner().join(list(EventSimulator(stream).stream()))


def batches(n_shards: int = 2):
    """Global batches packed for ``n_shards`` data shards, on the CPU."""
    cfg = BatcherConfig(b_ro=8, b_nro=32, hist_len=16, n_shards=n_shards,
                        ro_idlist_capacity=256, item_idlist_capacity=512)
    return list(ROOBatcher(cfg, device="cpu").batches(samples()))


def model(arch: str):
    """(init params, loss(params, batch, plan)) of a test model."""
    if arch == "lsr":
        cfg = lsr_cfg()
        return (lsr_init(torch.Generator().manual_seed(0), cfg,
                         device="cpu"),
                lambda p, b, plan: lsr_loss(p, cfg, b, plan=plan))
    cfg = gr_cfg()
    return (gr_init(torch.Generator().manual_seed(1), cfg, device="cpu"),
            lambda p, b, plan: gr_ranking_loss(p, cfg, b, plan=plan))


def optimizer(lr_emb: float = 0.05):
    return make_mixed(adam(1e-3), rowwise_adagrad(lr_emb),
                      default_is_embedding)


def cycling(blist, place):
    def it(start):
        i = start
        while True:
            yield place(blist[i % len(blist)])
            i += 1
    return it


def train(arch: str, plan, n_steps: int = N_STEPS, *, microbatches: int = 1,
          ckpt_dir=None, ckpt_every: int = 1000, lr_emb: float = 0.05,
          n_shards: int = 2):
    """A Trainer run of ``n_steps`` at log_every 1: (losses, trainer,
    state). Under a plan each step's batch is this rank's block."""
    params, loss = model(arch)
    blist = batches(n_shards)
    if microbatches > 1:
        blist = [tree_map(lambda a, b: torch.stack([a, b]), blist[2 * i],
                          blist[2 * i + 1]) for i in range(len(blist) // 2)]
    trainer = Trainer(lambda p, b, g: loss(p, b, plan), optimizer(lr_emb),
                      TrainLoopConfig(total_steps=n_steps, log_every=1,
                                      ckpt_dir=ckpt_dir,
                                      ckpt_every=ckpt_every,
                                      microbatches=microbatches),
                      lambda: params, device="cpu", plan=plan)
    place = spmd.make_batch_placer(plan, 1 if microbatches > 1 else 0)
    state = trainer.run(cycling(blist, place), seed=7)
    return [r["loss"] for r in trainer.history], trainer, state


def _np_tree(tree) -> dict:
    """path ("params/item_emb") -> numpy leaf (of tensor or numpy leaves)."""
    return {"/".join(p.strip("[]'") for p in path):
            leaf.detach().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf)
            for path, leaf in flatten_with_path(tree)}


def save_npz(path, **arrays) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def _with_comms(compress: str, overlap: str):
    comms.COMPRESS_KNOB.set_default(compress)
    comms.OVERLAP_KNOB.set_default(overlap)


def _reset_comms():
    comms.COMPRESS_KNOB.set_default(UNSET)
    comms.OVERLAP_KNOB.set_default(UNSET)


# ---------------------------------------------------------------------------
# test_torch_distributed_train.py
# ---------------------------------------------------------------------------

def train_rank(rank: int, out: str) -> None:
    """Everything the distributed-train tests read, in one 4-rank world."""
    plan = plan_for_mesh(make_test_mesh(2, 2))

    # 20-step parity runs and the table blocks
    for arch in ("lsr", "gr"):
        losses, trainer, state = train(arch, plan)
        full = trainer.gather_state(state)
        if rank == 0:
            save_npz(os.path.join(out, f"{arch}_2x2.npz"),
                     losses=np.asarray(losses),
                     **{f"p/{k}": v for k, v in _np_tree(
                         full["params"]).items()})
            blocks = {k: list(v.shape) for k, v in _np_tree(
                state["params"]).items()}
            with open(os.path.join(out, f"{arch}_blocks.json"), "w") as f:
                json.dump(blocks, f)

    # step 0: loss and the whole gradient tree
    for arch in ("lsr", "gr"):
        params, loss = model(arch)
        local, specs = params_onto_plan(params, plan, "cpu")
        batch = spmd.place_batch(batches()[0], plan)
        value, grads = value_and_grad(lambda p, b, g: loss(
            spmd.gather_dense(p, specs, plan), b, plan))(local, batch, None)
        grads = params_off_plan(spmd.reduce_grads(grads, specs, plan),
                                specs, plan)
        if rank == 0:
            save_npz(os.path.join(out, f"{arch}_step0.npz"), loss=value,
                     **{f"g/{k}": v for k, v in _np_tree(grads).items()})

    # int8 + error feedback and overlap, at the reference's settings
    # (microbatches 2, lr_emb 0.01)
    runs = {}
    for compress, overlap in (("none", "off"), ("none", "on"),
                              ("int8", "on")):
        _with_comms(compress, overlap)
        comms.STATS.reset()
        try:
            losses, trainer, state = train("lsr", plan, microbatches=2,
                                           lr_emb=0.01)
        finally:
            _reset_comms()
        runs[f"{compress}_{overlap}"] = losses
        if compress == "int8":
            ef = state["comms_ef"]["item_emb"]
            snap = comms.STATS.snapshot()
            runs["int8_ef_rows"] = [int(ef.shape[0])]
            runs["int8_ef_absmax"] = [float(ef.abs().max())]
            runs["int8_ratio"] = [snap["compression_ratio"]]
            runs["int8_occupancy"] = [snap["overlap"]["occupancy"]]
            runs["int8_grad_sites"] = [sum(
                s["kind"] == "grad" for s in snap["sites"].values())]
            runs["int8_dedup"] = [snap["dedup_exchanges"]]
    if rank == 0:
        save_npz(os.path.join(out, "comms.npz"), **runs)

    # a sharded checkpoint on 2 x 2 at step 8 (read by the reference)
    ck = os.path.join(out, "ck_2x2")
    losses, trainer, state = train("lsr", plan, 8, ckpt_dir=ck, ckpt_every=8)
    full = trainer.gather_state(state)
    if rank == 0:
        save_npz(os.path.join(out, "ck_2x2_live.npz"),
                 **{f"s/{k}": v for k, v in _np_tree(
                     {k: full[k] for k in ("params", "opt", "step")}).items()})

    # 1 x 2 on ranks 0 and 1: resume the 2 x 2 checkpoint and continue to
    # 16; an unbroken 16-step run with a checkpoint at 8, and its resume
    sub = plan_for_mesh(make_test_mesh(1, 2))
    if in_mesh(sub.mesh):
        from repro_torch.train.checkpoint import CheckpointManager
        cut = CheckpointManager(ck).restore_sharded(sub, 8)
        rows = full["params"]["item_emb"].shape[0] // 2
        k = spmd.model_index(sub)
        save_npz(os.path.join(out, f"restore_sharded_r{rank}.npz"),
                 item_emb=cut["params"]["item_emb"].numpy(),
                 want=full["params"]["item_emb"][k * rows:(k + 1) * rows]
                 .numpy(), act_emb=cut["params"]["act_emb"].numpy())
        if rank == 0:
            shutil.copytree(ck, os.path.join(out, "resume_2x2"))
        dist.barrier(group=spmd.model_group(sub))
        r_losses, _, _ = train("lsr", sub, 16,
                               ckpt_dir=os.path.join(out, "resume_2x2"))
        u_dir = os.path.join(out, "ck_1x2")
        u_losses, trainer, u_state = train("lsr", sub, 16, ckpt_dir=u_dir,
                                           ckpt_every=8)
        u_full = trainer.gather_state(u_state)
        if rank == 0:
            shutil.copytree(os.path.join(u_dir, "step_000000000008"),
                            os.path.join(out, "ck_1x2_at8",
                                         "step_000000000008"))
        dist.barrier(group=spmd.model_group(sub))
        b_losses, trainer, b_state = train(
            "lsr", sub, 16, ckpt_dir=os.path.join(out, "ck_1x2_at8"))
        b_full = trainer.gather_state(b_state)
        if rank == 0:
            save_npz(os.path.join(out, "resume.npz"),
                     resumed_2x2=np.asarray(r_losses),
                     unbroken=np.asarray(u_losses),
                     resumed_1x2=np.asarray(b_losses),
                     **{f"u/{k}": v for k, v in _np_tree(
                         u_full["params"]).items()},
                     **{f"b/{k}": v for k, v in _np_tree(
                         b_full["params"]).items()})
    dist.barrier()

    # the scenario entry point under train.mesh, memory and disk sources
    scen = {}
    for key, arch, mesh, extra in SCENARIO_RUNS:
        spec = scenario_spec(arch, mesh, extra)
        trainer, state = train_from_scenario(
            spec, prints=False, device="cpu",
            shard_dir=os.path.join(out, "shards"))
        scen[key] = {"losses": [r["loss"] for r in trainer.history],
                     "ne": [r["ne"] for r in trainer.history],
                     "step": int(state["step"]),
                     "item_rows": int(state["params"]["item_emb"].shape[0])}
    if rank == 0:
        with open(os.path.join(out, "scenarios.json"), "w") as f:
            json.dump(scen, f)
    dist.barrier()


SCENARIO_SMALL = {"model.n_items": 2000, "data.n_requests": 40,
                  "train.steps": 3, "train.log_every": 1}
SCENARIO_RUNS = (
    ("gr_memory", "hstu-gr", "2x2", {}),
    ("lsr_memory", "roo-lsr", "2x2", {}),
    ("gr_1x4", "hstu-gr", "1x4", {}),
    ("gr_disk", "hstu-gr", "2x2", {"data.source": "disk",
                                   "data.requests_per_shard": 20}))


def scenario_spec(arch: str, mesh: str, extra: dict):
    from repro_torch.configs.registry import scenario
    return scenario(arch, dict(SCENARIO_SMALL, **extra,
                               **({"train.mesh": mesh} if mesh else {})))


# ---------------------------------------------------------------------------
# test_torch_sharded_lookups.py
# ---------------------------------------------------------------------------

VOCAB, DIM, B, L = 512, 32, 8, 16


def lookup_inputs():
    """The whole table, ids, lengths, jagged ids and cotangents (numpy,
    seeded): what every rank and the test process start from."""
    r = np.random.RandomState(0)
    jag_lens = r.randint(0, 6, (B,)).astype(np.int32)
    return {
        "table": r.normal(size=(VOCAB, DIM)).astype(np.float32),
        "ids": r.randint(-5, VOCAB + 5, (B, L)).astype(np.int64),
        "dup_ids": r.randint(0, 40, (B, L)).astype(np.int64),
        "lengths": r.randint(0, L + 1, (B,)).astype(np.int32),
        "jag_values": r.randint(0, VOCAB, (48,)).astype(np.int64),
        "jag_lens": jag_lens,
        "cot_seq": r.normal(size=(B, L, DIM)).astype(np.float32),
        "cot_bag": r.normal(size=(B, DIM)).astype(np.float32),
    }


def dlrm_inputs():
    """The reference's ``TestDLRMShardedLookups`` config and batch."""
    from repro_torch.models.dlrm import DLRMConfig
    cfg = DLRMConfig(n_dense=4, embed_dim=32, bot_mlp=(4, 32, 32),
                     top_mlp=(64, 32, 1), vocabs=(256, 128, 64, 8),
                     n_ro_fields=2, multi_hot=2)
    r = np.random.RandomState(0)
    b_ro, b_nro = 8, 32
    args = (r.normal(size=(b_ro, 4)).astype(np.float32),
            r.randint(0, 64, (b_ro, 2, 2)).astype(np.int32),
            np.full((b_ro, 2), 2, np.int32),
            r.randint(0, 8, (b_nro, 2, 2)).astype(np.int32),
            np.full((b_nro, 2), 2, np.int32),
            np.repeat(np.arange(b_ro, dtype=np.int32), b_nro // b_ro))
    return cfg, args


def dlrm_impression_inputs():
    """An impression-level batch of ``dlrm_inputs``' config: (dense (32,
    4), ids (32, 4, 2), lengths (32, 4))."""
    r = np.random.RandomState(1)
    return (r.normal(size=(32, 4)).astype(np.float32),
            r.randint(0, 8, (32, 4, 2)).astype(np.int32),
            r.randint(0, 3, (32, 4)).astype(np.int32))


def _gather_cols(x: torch.Tensor, plan) -> torch.Tensor:
    """Every model rank's last-dim chunk, side by side."""
    n, c = spmd.model_shard_count(plan), x.shape[-1]
    rows = coll.gather_rows_front(x.reshape(-1, c), spmd.model_group(plan), n)
    return rows.reshape((n,) + tuple(x.shape)).movedim(0, -2).reshape(
        tuple(x.shape[:-1]) + (n * c,))


def lookups_rank(rank: int, out: str) -> None:
    from repro_torch.data.jagged import JaggedTensor
    from repro_torch.embeddings import collection as ec
    from repro_torch.models.dlrm import (dlrm_forward_impression,
                                         dlrm_forward_roo, dlrm_init)
    plan = plan_for_mesh(make_test_mesh(2, 2))
    d, n_data = spmd.data_index(plan), spmd.data_shard_count(plan)
    m, n_model = spmd.model_index(plan), spmd.model_shard_count(plan)
    x = {k: torch.from_numpy(v) for k, v in lookup_inputs().items()}
    rows = VOCAB // n_model
    block = x["table"][m * rows:(m + 1) * rows].clone().requires_grad_(True)
    b = B // n_data
    mine = slice(d * b, (d + 1) * b)
    jag = JaggedTensor(x["jag_values"], x["jag_lens"])
    c = DIM // n_model
    cases = {
        "seq": lambda: ec.seq_lookup(block, x["ids"][mine], vocab=VOCAB,
                                     plan=plan),
        "seq_dedup": lambda: ec.seq_lookup(block, x["dup_ids"][mine],
                                           vocab=VOCAB, plan=plan,
                                           dedup=True),
        "row": lambda: ec.row_lookup(block, x["ids"][mine, 0], vocab=VOCAB,
                                     plan=plan),
        "bag_sum": lambda: ec.bag_lookup_dense(
            block, x["ids"][mine], x["lengths"][mine], "sum", vocab=VOCAB,
            plan=plan),
        "bag_mean": lambda: ec.bag_lookup_dense(
            block, x["ids"][mine], x["lengths"][mine], "mean", vocab=VOCAB,
            plan=plan),
        "bag_rs": lambda: ec.bag_lookup_dense(
            block, x["ids"][mine], x["lengths"][mine], "sum", vocab=VOCAB,
            plan=plan, out_sharded=True),
        "jagged_sum": lambda: ec.bag_lookup(block, jag, "sum", vocab=VOCAB,
                                            plan=plan),
        "jagged_mean": lambda: ec.bag_lookup(block, jag, "mean",
                                             vocab=VOCAB, plan=plan),
    }
    res = {}
    comms.STATS.reset()
    for name, fn in cases.items():
        block.grad = None
        y = fn()
        if name.startswith("seq"):
            cot = x["cot_seq"][mine]
        elif name == "row":
            cot = x["cot_seq"][mine, 0]
        elif name == "bag_rs":
            cot = x["cot_bag"][mine, m * c:(m + 1) * c]
        else:
            cot = x["cot_bag"][mine]
        torch.sum(y * cot).backward()
        g = coll.all_reduce_flat([block.grad], spmd.batch_groups(plan))[0]
        res[f"{name}/grad"] = coll.gather_rows_front(
            g, spmd.model_group(plan), n_model)
        if name == "bag_rs":
            y = _gather_cols(y, plan)
        res[f"{name}/out"] = spmd.gather_batch(y.detach(), plan)
    sites = sorted(comms.STATS.snapshot()["sites"])
    # compressed bags: forward only
    with torch.no_grad():
        for mode in ("bf16", "int8"):
            comms.COMPRESS_KNOB.set_default(mode)
            try:
                for pooling in ("sum", "mean"):
                    y = ec.bag_lookup_dense(block, x["ids"][mine],
                                            x["lengths"][mine], pooling,
                                            vocab=VOCAB, plan=plan)
                    res[f"{mode}_{pooling}/out"] = spmd.gather_batch(y, plan)
            finally:
                comms.COMPRESS_KNOB.set_default(UNSET)
    # the dlrm forward under the plan: RS bags + B7 on the D slices
    cfg, args = dlrm_inputs()
    params = dlrm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    local, specs = params_onto_plan(params, plan, "cpu")
    local = spmd.gather_dense(local, specs, plan)
    targs = [torch.from_numpy(a) for a in args]
    b_ro = targs[0].shape[0] // n_data
    placed = [spmd.place_batch(a, plan) for a in targs]
    placed[5] = placed[5] - d * b_ro          # the block's segment ids
    with torch.no_grad():
        logits = dlrm_forward_roo(local, cfg, *placed, plan=plan)
        imp = [spmd.place_batch(torch.from_numpy(a), plan)
               for a in dlrm_impression_inputs()]
        res["dlrm_impression/out"] = spmd.gather_batch(
            dlrm_forward_impression(local, cfg, *imp, plan=plan), plan)
    res["dlrm/out"] = spmd.gather_batch(logits, plan)
    # the lsr loss with dedup forced, through the sums
    ec.set_dedup_policy("always")
    try:
        params, loss = model("lsr")
        with torch.no_grad():
            local, specs = params_onto_plan(params, plan, "cpu")
            res["lsr_dedup/loss"] = loss(spmd.gather_dense(local, specs,
                                                           plan),
                                         spmd.place_batch(batches()[0], plan),
                                         plan)
    finally:
        ec.set_dedup_policy(None)
    if rank == 0:
        save_npz(os.path.join(out, "lookups.npz"),
                 **{k: v.detach().numpy() for k, v in res.items()})
        with open(os.path.join(out, "sites.json"), "w") as f:
            json.dump(sites, f)
    dist.barrier()


# ---------------------------------------------------------------------------
# test_torch_lm_spmd.py
# ---------------------------------------------------------------------------

LM_ARCHS = ("phi3-medium-14b", "granite-moe-3b-a800m")
LM_BATCH, LM_SEQ, PROMPT, S_MAX, STEPS = 4, 16, 8, 16, 4


def lm_config(arch: str):
    """The smoke config at f32 compute; the MoE at ``capacity_factor``
    0.5, so tokens drop (``torch_ref_spmd.lm_config``)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    return cfg


def odd_heads_config():
    """phi3's smoke config with 5 heads (5 KV heads): the model axis of 2
    splits ``wq``'s 40 columns but not its heads."""
    import dataclasses
    return dataclasses.replace(lm_config("phi3-medium-14b"), n_heads=5,
                               n_kv_heads=5)


def nested(flat: dict) -> dict:
    """"a/b"-keyed leaves -> the nested dict tree."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def lm_rank(rank: int, out: str, params_npz: str) -> None:
    """The LM under a 2 x 2 plan on the reference's params: the hidden,
    the loss and the gathered gradients on both layer routes, and
    ``prefill`` + ``STEPS`` ``serve_step``s under both ``lm_cells`` cache
    layouts (rank 0 writes ``lm.npz``); each rank's block shapes
    (``lm_blocks_r{rank}.json``)."""
    import dataclasses
    from repro_torch.models.lm import decode
    from repro_torch.models.lm.transformer import (lm_forward, lm_grad_axes,
                                                   lm_init, lm_loss,
                                                   lm_param_specs)
    plan = plan_for_mesh(make_test_mesh(2, 2))
    m_axes = spmd.plan_axes(plan, "model")
    b_axes = spmd.plan_axes(plan, ("data",))
    data = np.load(params_npz)
    res, shapes = {}, {}
    for arch in LM_ARCHS:
        cfg = lm_config(arch)
        prefix = f"{arch}/p/"
        params = nested({k[len(prefix):]: data[k] for k in data.files
                         if k.startswith(prefix)})
        local, specs = params_onto_plan(params, plan, "cpu",
                                        param_specs=lm_param_specs(cfg, plan))
        shapes[arch] = {k: list(v.shape) for k, v in _np_tree(local).items()}
        toks = torch.from_numpy(np.random.RandomState(7).randint(
            0, cfg.vocab, (LM_BATCH, LM_SEQ)).astype(np.int64))
        for spmd_layer in (False, True):
            c = dataclasses.replace(cfg, use_spmd_layer=spmd_layer)
            tag = f"{arch}/{int(spmd_layer)}"
            with torch.no_grad():
                h = lm_forward(local, c, toks, plan)
            res[f"{tag}/hidden"] = coll.gather_dim(
                coll.gather_dim(h, m_axes, 1), b_axes, 0)
            loss, grads = value_and_grad(
                lambda p, b, g: lm_loss(p, c, toks, toks, plan))(
                    local, None, None)
            grads = spmd.reduce_grads(grads, specs, plan,
                                      lm_grad_axes(c, plan))
            res[f"{tag}/loss"] = loss
            res.update({f"{tag}/g/{k}": torch.from_numpy(v) for k, v in
                        _np_tree(spmd.gather_state(grads, specs,
                                                   plan)).items()})
        with torch.no_grad():
            for name, cs in (
                    ("seq", decode.CacheSpec(("data",), "model")),
                    ("long", decode.CacheSpec(None, ("data", "model")))):
                logits, cache = decode.prefill(local, cfg, toks[:, :PROMPT],
                                               plan=plan, s_max=S_MAX, cs=cs)
                res[f"{arch}/{name}/0"] = logits
                shapes[f"{arch}/{name}/cache"] = list(cache["k"].shape)
                for i in range(STEPS):
                    logits, cache = decode.serve_step(
                        local, cfg, cache,
                        toks[:, PROMPT + i:PROMPT + i + 1], plan=plan, cs=cs)
                    res[f"{arch}/{name}/{i + 1}"] = logits
    # heads the model axis does not divide: every head on every model rank
    cfg = odd_heads_config()
    params = lm_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    local, specs = params_onto_plan(params, plan, "cpu",
                                    param_specs=lm_param_specs(cfg, plan))
    shapes["odd_heads/wq"] = list(local["layers"]["wq"].shape)
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab, (LM_BATCH, LM_SEQ)).astype(np.int64))
    loss, grads = value_and_grad(
        lambda p, b, g: lm_loss(p, cfg, toks, toks, plan))(local, None, None)
    grads = spmd.gather_state(spmd.reduce_grads(
        grads, specs, plan, lm_grad_axes(cfg, plan)), specs, plan)
    res["odd_heads/loss"] = loss
    res.update({f"odd_heads/g/{k}": torch.from_numpy(v)
                for k, v in _np_tree(grads).items()})
    with open(os.path.join(out, f"lm_blocks_r{rank}.json"), "w") as f:
        json.dump(shapes, f)
    if rank == 0:
        save_npz(os.path.join(out, "lm.npz"),
                 **{k: v.detach().numpy() for k, v in res.items()})
    dist.barrier()


# ---------------------------------------------------------------------------
# test_torch_fsdp.py
# ---------------------------------------------------------------------------

def fsdp_rank(rank: int, out: str) -> None:
    """FSDP / TP storage of the recsys archs on 2 x 2: each rank's blocks
    (``fsdp_blocks_r{rank}.npz``, with its mesh coordinate), step 0's
    loss and gathered gradients, 20 Trainer steps, a checkpoint of 2-D
    blocks at step 8 and its resume on 1 x 2 (rank 0 writes
    ``fsdp.npz``)."""
    plan = plan_for_mesh(make_test_mesh(2, 2))
    res, blocks = {}, {"coord": np.asarray([spmd.data_index(plan),
                                            spmd.model_index(plan)])}
    for arch in ("lsr", "gr"):
        params, loss = model(arch)
        local, specs = params_onto_plan(params, plan, "cpu")
        blocks.update({f"{arch}/{k}": v for k, v in _np_tree(local).items()})
        batch = spmd.place_batch(batches()[0], plan)
        value, grads = value_and_grad(lambda p, b, g: loss(
            spmd.gather_dense(p, specs, plan), b, plan))(local, batch, None)
        grads = params_off_plan(spmd.reduce_grads(grads, specs, plan),
                                specs, plan)
        res[f"{arch}/loss"] = np.asarray(value)
        res.update({f"{arch}/g/{k}": v for k, v in _np_tree(grads).items()})
        losses, trainer, state = train(arch, plan)
        res[f"{arch}/losses"] = np.asarray(losses)
        res.update({f"{arch}/p/{k}": v for k, v in _np_tree(
            trainer.gather_state(state)["params"]).items()})
    save_npz(os.path.join(out, f"fsdp_blocks_r{rank}.npz"), **blocks)
    ck = os.path.join(out, "ck_2x2")
    _, trainer, state = train("lsr", plan, 8, ckpt_dir=ck, ckpt_every=8)
    full = trainer.gather_state(state)
    res.update({f"s/{k}": v for k, v in _np_tree(
        {k: full[k] for k in ("params", "opt", "step")}).items()})
    sub = plan_for_mesh(make_test_mesh(1, 2))
    if in_mesh(sub.mesh):
        if rank == 0:
            shutil.copytree(ck, os.path.join(out, "resume_2x2"))
        dist.barrier(group=spmd.model_group(sub))
        losses, _, _ = train("lsr", sub, 16,
                             ckpt_dir=os.path.join(out, "resume_2x2"))
        res["resumed"] = np.asarray(losses)
    if rank == 0:
        save_npz(os.path.join(out, "fsdp.npz"), **res)
    dist.barrier()
