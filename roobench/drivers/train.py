"""Driver ``train``: sparse-row dlrm training through the program's
``Trainer``, as its scenario builds it with ``train.sparse_emb`` on (the
sparse ``value_and_grad``, row-wise Adagrad on the touched rows, Adam on
the MLPs, ``dlrm_forward_roo`` and its BCE).

One ``Trainer.run`` drives every step: the first ``check_steps`` from the
seed (the correctness comparison reads them), then the rest of the pool
once (every batch shape warmed), then the measured window, which the feed
closes after ``--seconds`` by ending. A pool batch is copied to the card
each step, as the batcher does.

Correctness: thin recorders around the program's ``value_and_grad`` and
optimizer keep the first steps' losses, the first step's gradient norms
as the optimizer state holds them (row-wise Adagrad's accumulator: D times
its sum is the squared norm; Adam's first moment: (1 - b1) g) and the
parameters' change after the last checked step. After the window the
plain reference (``reference/dlrm.py``) takes the same initial weights and
batches through the same steps.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from roobench import compare, harness, inputs, programs, weights
from roobench.harness import Check, Outcome, window_spans
from roobench.reference import dlrm as ref
from roobench.trace import Window


class _Recorder:
    """Passes every call through; keeps readings of the first steps."""

    def __init__(self, vag, opt, n_check: int, b1: float, rows, init_rows,
                 init_dense, device):
        self._vag, self._opt = vag, opt
        self.n_check, self.b1 = n_check, b1
        self.rows, self.init_rows, self.init_dense = rows, init_rows, init_dense
        self.device = device
        self.losses, self.grad_norms, self.change = [], {}, {}
        self.n_vag = self.n_upd = 0
        self.seconds = 0.0

    def vag(self, params, batch, gen):
        loss, grads = self._vag(params, batch, gen)
        self.n_vag += 1
        if self.n_vag <= self.n_check:
            self.losses.append(loss)
        return loss, grads

    def update(self, grads, state, params, **kw):
        new_p, new_s = self._opt.update(grads, state, params, **kw)
        self.n_upd += 1
        if self.n_upd == 1 or self.n_upd == self.n_check:
            t0 = time.perf_counter()
            self._read(params, new_p, new_s)
            self.seconds += time.perf_counter() - t0
        return new_p, new_s

    def _read(self, params, new_p, new_s):
        from repro_torch.train.optim import default_is_embedding
        from repro_torch.tree import flatten_with_path, leaves
        flat = flatten_with_path(params)
        # the program spells a path's keys as "['bot_mlp']", "[0]"
        paths = ["/".join(str(k).strip("[]'\"") for k in p) for p, _ in flat]
        emb = [default_is_embedding(p) for p, _ in flat]
        new_flat = leaves(new_p)
        with torch.no_grad():
            if self.n_upd == 1:
                acc, mom = iter(new_s["emb"]["acc"]), iter(new_s["dense"]["m"])
                for path, is_e, p in zip(paths, emb, new_flat):
                    if is_e:
                        sq = p.shape[1] * torch.sum(next(acc).double())
                        self.grad_norms[path] = float(torch.sqrt(sq))
                    else:
                        self.grad_norms[path] = float(torch.linalg.vector_norm(
                            next(mom).double())) / (1 - self.b1)
            if self.n_upd == self.n_check:
                for path, is_e, p in zip(paths, emb, new_flat):
                    if is_e:
                        d = p[self.rows[path]] - self.init_rows[path]
                    else:
                        d = p - self.init_dense[path]
                    self.change[path] = float(torch.linalg.vector_norm(
                        d.double()))
                self.init_rows = self.init_dense = None
        if self.device == "cuda":
            torch.cuda.synchronize()


def run(ctx):
    from repro_torch.embeddings.sparse import make_sparse_value_and_grad
    from repro_torch.models.dlrm import dlrm_table_ids
    from repro_torch.train.loop import Trainer, TrainLoopConfig
    from repro_torch.train.metrics import bce
    from repro_torch.train.optim import (Optimizer, adam,
                                         default_is_embedding, make_mixed,
                                         rowwise_adagrad)
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n_check = int(tr["check_steps"])
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pool = inputs.dlrm_pool(ctx.seed, cfg, tr)
    host = programs.host_batches(pool, dev)
    ctx.phase("inputs")
    w = weights.dlrm(ctx.seed, cfg, dev)
    dcfg = programs.dlrm_config(cfg)
    ctx.phase("weights")

    # the reference's copy of what the checked steps read: each table's
    # rows their ids name, and the MLPs
    t0 = time.perf_counter()
    n_f = len(cfg["vocabs"])
    rows, init_rows, ref_tables = {}, {}, []
    for f in range(n_f):
        ids = np.unique(np.concatenate([inputs.field_ids(pool[j], cfg, f)
                                        for j in range(n_check)]))
        idx = torch.from_numpy(ids.astype(np.int64)).to(dev)
        rows[f"tables/t{f}"] = idx
        init_rows[f"tables/t{f}"] = w["tables"][f"t{f}"][idx]
        ref_tables.append((ids, init_rows[f"tables/t{f}"].cpu()))
    init_dense = {}
    for key in ("bot_mlp", "top_mlp"):
        for i, lyr in enumerate(w[key]["layers"]):
            for n in ("w", "b"):
                init_dense[f"{key}/layers/{i}/{n}"] = lyr[n].clone()
    ref_dense = {k: v.cpu() for k, v in init_dense.items()}
    check_s = time.perf_counter() - t0

    def loss(p, b, g):
        return bce(programs.dlrm_forward(dcfg, p, b), b["y"])

    o = cfg["optimizer"]
    opt = make_mixed(adam(o["adam"]["lr"], o["adam"]["b1"], o["adam"]["b2"],
                          o["adam"]["eps"]),
                     rowwise_adagrad(o["rowwise_adagrad"]["lr"],
                                     o["rowwise_adagrad"]["eps"]),
                     default_is_embedding)
    vag = make_sparse_value_and_grad(
        loss, lambda b: dlrm_table_ids(dcfg, b["ro_ids"], b["nro_ids"]))
    rec = _Recorder(vag, opt, n_check, o["adam"]["b1"], rows, init_rows,
                    init_dense, dev)
    held = [w]
    del w
    trainer = Trainer(loss, Optimizer(opt.init, rec.update),
                      TrainLoopConfig(total_steps=1 << 62,
                                      log_every=cfg["trainer"]["log_every"]),
                      lambda: held.pop(), value_and_grad_fn=rec.vag,
                      device=dev)

    n_setup = len(host)
    win = Window(dev, ctx.traced)
    infos = []                     # the pool batches the window trained on

    def feed(start):
        for k in range(start, 1 << 62):
            if k == n_setup:
                ctx.phase("warm steps")
                win.open()
            elif k > n_setup and time.perf_counter() - win.t0 >= ctx.seconds:
                win.close()
                return
            j = k % len(host)
            if k >= n_setup:
                infos.append(pool[j]["_info"])
            yield programs.to_device(host[j], dev)

    try:
        trainer.run(feed, seed=ctx.seed)
    except StopIteration:
        pass
    del trainer
    setup_s = win.t0 - ctx.t_start - check_s - rec.seconds
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    steps = len(infos)
    spans = window_spans(win.t0, win.t1) if ctx.traced else []

    # the reference, once the window has closed and the program is gone
    if dev == "cuda":
        torch.cuda.empty_cache()
    p0 = {"tables": [t.to(dev) for _, t in ref_tables],
          "bot": [(ref_dense[f"bot_mlp/layers/{i}/w"].to(dev),
                   ref_dense[f"bot_mlp/layers/{i}/b"].to(dev))
                  for i in range(len(cfg["bot_mlp"]) - 1)],
          "top": [(ref_dense[f"top_mlp/layers/{i}/w"].to(dev),
                   ref_dense[f"top_mlp/layers/{i}/b"].to(dev))
                  for i in range(len(cfg["top_mlp"]))]}
    batches = [compact_batch(pool[j], cfg, [ids for ids, _ in ref_tables],
                             dev) for j in range(n_check)]
    r = ref.train(p0, cfg, batches, o)
    lim = cfg["limits"]["train"]
    prog = {"losses": [float(x) for x in rec.losses],
            "grad_norms": rec.grad_norms, "change": rec.change}
    checks = [Check(k, v, lim[k]) for k, v in gaps(prog, r, lim).items()]

    def variants(name):
        """The check's numbers with the reference put in the program's
        place: ``tf32`` (computed in TF32), ``half_batch`` (each step's
        loss the mean over the first half of its impressions) or
        ``stale_state`` (a step that returns its state unchanged)."""
        bs, oo = batches, o
        if name == "half_batch":
            bs = [{k: (v[:len(v) // 2] if k in HALVED else v)
                   for k, v in b.items()} for b in batches]
        if name == "stale_state":
            oo = {k: {**v, "lr": 0.0} for k, v in o.items()}
        with harness.tf32(name == "tf32"):
            got = ref.train(p0, cfg, bs, oo)
        if name == "stale_state":
            # nothing moves and the optimizer state stays at its start
            got["grad_norms"] = {k: 0.0 for k in got["grad_norms"]}
            got["change"] = {k: 0.0 for k in got["change"]}
        return gaps(got, r, lim)

    imps = sum(i["b_nro"] for i in infos)
    counts = {"steps": steps,
              "train_flops": sum(i["train_flops"] for i in infos),
              "bag_bytes": sum(i["b5_bytes"] + i["b6_bytes"]
                               for i in infos)}
    ctx.log(f"window {win.seconds:.3f} s, {steps} steps, {imps} impressions")
    return Outcome(e2e={"train_imps_per_s": imps / win.seconds},
                   setup_s=setup_s, attempted=steps, failed=0, checks=checks,
                   counts=counts, memory_peak_bytes=peak, trace=win.trace,
                   spans=spans, batches=infos, variants=variants)


# the impression-side inputs a half batch cuts
HALVED = ("nro_ids", "nro_len", "seg", "y")


def gaps(prog: dict, r: dict, lim: dict) -> dict:
    """The three numbers compared: each step's loss, the first step's
    gradient norm by leaf, the change norm by leaf after the checked steps
    (leaves whose reference gradient is under ``leaf_floor`` of the median
    leaf's move by round-off alone and are left out)."""
    moving = compare.moving_leaves(r["grad_norms"], lim["leaf_floor"])
    return {"loss_gap": compare.loss_gap(prog["losses"], r["losses"]),
            "grad_gap": compare.leaf_gap(prog["grad_norms"], r["grad_norms"]),
            "change_gap": compare.leaf_gap(prog["change"], r["change"],
                                           moving)}


def compact_batch(b, cfg, kept_ids, dev):
    """A pool batch on ``dev`` with each field's ids renumbered to the rows
    the compact tables keep (``kept_ids[f]``, sorted)."""
    n_ro = cfg["n_ro_fields"]
    ro = np.stack([np.searchsorted(kept_ids[f], b["ro_ids"][:, f])
                   for f in range(n_ro)], axis=1)
    nro = np.stack([np.searchsorted(kept_ids[n_ro + f], b["nro_ids"][:, f])
                    for f in range(len(kept_ids) - n_ro)], axis=1)
    t = {"ro_dense": b["ro_dense"], "ro_ids": ro, "ro_len": b["ro_len"],
         "nro_ids": nro, "nro_len": b["nro_len"], "seg": b["seg"],
         "y": b["y"]}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in t.items()}
