"""Driver ``gr_train``: sparse-row hstu-gr ranking training through the
program's normal path. The scenario (``configs.registry.scenario`` with
the configuration's widths, sizes and rates) builds the model with
``train.sparse_emb`` on (``scenario.build.build_model``:
``gr_ranking_loss``, ``gr_table_ids`` and the sparse ``value_and_grad``),
the program's ``ROOBatcher`` packs each step's requests from
``ROOSample``s (a new user each), and its ``Trainer`` runs row-wise
Adagrad on the item and action tables and Adam on the rest, at the
configuration's rates.

A step is ``requests_per_step`` requests whose histories, impressions,
item ids, actions and labels the traffic file's laws draw from ``--seed``;
the pool's ``pool_batches`` host batches are copied to the card each step.
Every batch has the one padded shape, so one ``Trainer.run`` drives the
``check_steps`` checked steps and one more (every kernel built), then the
window, which the feed closes by ending at the first whole pool after
``--seconds``: a step of two long histories costs about four times one of
two short ones, and a window of whole pools trains on the pool's mean
work whatever order the seed gives its requests.

Correctness: ``drivers/train.py``'s recorders and its three numbers (each
checked step's loss, the first step's gradient norm by leaf as the
optimizer state holds it, the change by leaf after the checked steps),
each under the configuration's limit, against the plain reference
(``reference/hstu_gr_train.py``), which takes
the same initial weights (the item rows the checked steps touch) and the
same requests on their real rows, once the window has closed and the
program's memory is freed.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from roobench import harness, traffic as T, weights
from roobench import yardstick_gr_train as YT
from roobench.drivers.train import _Recorder, gaps
from roobench.harness import Outcome, window_spans
from roobench.reference import hstu_gr_train as ref
from roobench.trace import Window

# the program's batch label columns (``BatcherConfig.label_keys``), one law
# each in the traffic file's ``labels``
LABEL_KEYS = ("click", "view_sec")
# the numbers ``drivers.train.gaps`` compares, each limited by the
# configuration
NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def spec(cfg: dict, tr: dict):
    """The hstu-gr scenario at the configuration's widths, sizes and rates,
    one step's requests a batch."""
    from repro_torch.configs.registry import scenario
    n = int(tr["requests_per_step"])
    o = cfg["optimizer"]
    over = {f"model.{k}": cfg[k] for k in (
        "n_items", "hist_len", "m_targets", "d_model", "n_heads", "d_qk",
        "d_v", "n_layers", "max_rel_pos")}
    over.update({"batcher.b_ro": n, "batcher.b_nro": n * cfg["m_targets"],
                 "batcher.hist_len": cfg["hist_len"],
                 "train.sparse_emb": True,
                 "train.log_every": cfg["trainer"]["log_every"],
                 "train.lr_dense": o["adam"]["lr"],
                 "train.lr_emb": o["rowwise_adagrad"]["lr"]})
    return scenario("hstu-gr", over)


def requests(seed: int, cfg: dict, tr: dict) -> List[Dict]:
    """The pool's requests, in step order: history ids and actions (a
    ``history_len`` draw, capped at the window), impression item ids and
    labels (an ``impressions_per_request`` draw, capped at the target
    slots). Item ids follow ``item_ids`` over the rows held here,
    scattered by one seeded permutation for the run."""
    n = int(tr["requests_per_step"])
    n_req = int(tr["pool_batches"]) * n
    n_items = cfg["n_items"]
    g = T.rng(seed, 31)
    hists = np.minimum(T.draw(tr["history_len"], g, n_req),
                       cfg["hist_len"])
    imps = np.minimum(T.draw(tr["impressions_per_request"], g, n_req),
                      cfg["m_targets"])
    perm = T.affine_permutation(g, n_items)
    out = []
    for i in range(n_req):
        gi = T.rng(seed, 32, i)
        out.append({
            "hist": T.zipf_ids(tr["item_ids"], gi, int(hists[i]), n_items,
                               perm),
            "acts": T.draw(tr["actions"], gi, int(hists[i])),
            "items": T.zipf_ids(tr["item_ids"], gi, int(imps[i]), n_items,
                                perm),
            "labels": np.stack([T.draw(law, gi, int(imps[i]))
                                for law in tr["labels"]], axis=1)})
    return out


def sample(req: Dict, request_id: int):
    """A request as the program's ``ROOSample`` (a new user)."""
    from repro_torch.core.joiner import ROOSample
    zero = np.zeros((1,), np.float32)
    n = len(req["items"])
    return ROOSample(
        request_id=request_id, user_id=request_id, ro_dense=zero,
        ro_idlist=[], history_ids=req["hist"].tolist(),
        history_actions=req["acts"].tolist(),
        item_ids=req["items"].tolist(), item_dense=[zero] * n,
        item_idlist=[[]] * n,
        labels=[dict(zip(LABEL_KEYS, map(float, row)))
                for row in req["labels"]])


def pool(seed: int, cfg: dict, tr: dict, scenario_spec):
    """(host batches, the requests of each, each batch's ``_info``): the
    program's ``ROOBatcher`` packs the requests, ``requests_per_step`` a
    batch, in order, on the host."""
    from repro_torch.data.batcher import ROOBatcher
    from repro_torch.scenario.build import build_batcher_cfg
    reqs = requests(seed, cfg, tr)
    n = int(tr["requests_per_step"])
    batches = list(ROOBatcher(build_batcher_cfg(scenario_spec),
                              device="cpu").batches(
        [sample(r, i) for i, r in enumerate(reqs)]))
    groups = [reqs[j * n:(j + 1) * n] for j in range(len(batches))]
    infos = []
    for b, grp in zip(batches, groups):
        if int(b.request_mask().sum()) != len(grp):
            raise RuntimeError("the batcher packed a step's requests into "
                               "more than one batch")
        hists = [len(r["hist"]) for r in grp]
        tgts = [len(r["items"]) for r in grp]
        infos.append({
            "hists": hists, "targets": tgts, "impressions": sum(tgts),
            "train_flops": sum(YT.gr_train_flops(cfg, h, t)
                               for h, t in zip(hists, tgts)),
            **YT.attention_step(cfg, hists, tgts)})
    return batches, groups, infos


def param_paths(params) -> List[str]:
    """The program's parameter paths, ``/``-joined, in flatten order."""
    from repro_torch.tree import flatten_with_path
    return ["/".join(str(k).strip("[]'\"") for k in p)
            for p, _ in flatten_with_path(params)]


def run(ctx):
    from repro_torch.scenario.build import build_model
    from repro_torch.train.loop import Trainer, TrainLoopConfig
    from repro_torch.train.optim import (Optimizer, adam,
                                         default_is_embedding, make_mixed,
                                         rowwise_adagrad)
    from repro_torch.tree import flatten_with_path, tree_map
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    scenario_spec = spec(cfg, tr)          # refuses a program without it
    lim = cfg["limits"]["train"]
    unlimited = set(NUMBERS) - set(lim)
    if unlimited:
        raise ValueError(f"the configuration gives no limit for "
                         f"{sorted(unlimited)}")
    n_check = int(tr["check_steps"])
    cuda = dev == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    batches, groups, pool_info = pool(ctx.seed, cfg, tr, scenario_spec)
    host = [tree_map(lambda t: t.pin_memory(), b) if cuda else b
            for b in batches]
    ctx.phase("inputs")
    w = weights.gr(ctx.seed, cfg, dev)
    bundle = build_model(scenario_spec, torch.Generator(), sparse=True,
                         device=dev, params=w)
    ctx.phase("weights")

    # the reference's copy of what the checked steps read: the item rows
    # their real ids name, the action table, every other leaf
    t0 = time.perf_counter()
    kept_ids = np.unique(np.concatenate(
        [np.concatenate([r["hist"], r["items"]])
         for grp in groups[:n_check] for r in grp]))
    idx = torch.from_numpy(kept_ids.astype(np.int64)).to(dev)
    rows = {"item_emb": idx,
            "act_emb": torch.arange(cfg["n_actions"], device=dev)}
    init_rows = {k: w[k][i] for k, i in rows.items()}
    init_dense = {p: x.clone() for p, (path, x) in zip(
        param_paths(w), flatten_with_path(w))
        if not default_is_embedding(path)}
    ref_p0 = {**{k: v.cpu() for k, v in init_rows.items()},
              **{k: v.cpu() for k, v in init_dense.items()}}
    check_s = time.perf_counter() - t0

    o = cfg["optimizer"]
    opt = make_mixed(adam(o["adam"]["lr"], o["adam"]["b1"], o["adam"]["b2"],
                          o["adam"]["eps"]),
                     rowwise_adagrad(o["rowwise_adagrad"]["lr"],
                                     o["rowwise_adagrad"]["eps"]),
                     default_is_embedding)
    rec = _Recorder(bundle.vag_fn, opt, n_check, o["adam"]["b1"], rows,
                    init_rows, init_dense, dev)
    held = [bundle.params]
    loss_fn = bundle.loss_fn
    del w, bundle
    trainer = Trainer(loss_fn, Optimizer(opt.init, rec.update),
                      TrainLoopConfig(total_steps=1 << 62,
                                      log_every=cfg["trainer"]["log_every"]),
                      lambda: held.pop(), value_and_grad_fn=rec.vag,
                      device=dev)

    n_setup = n_check + 1
    win = Window(dev, ctx.traced)
    infos = []                     # the pool batches the window trained on

    def feed(start):
        for k in range(start, 1 << 62):
            if k == n_setup:
                ctx.phase("warm steps")
                win.open()
            elif (k > n_setup and (k - n_setup) % len(host) == 0
                  and time.perf_counter() - win.t0 >= ctx.seconds):
                win.close()
                return
            j = k % len(host)
            if k >= n_setup:
                infos.append(pool_info[j])
            yield tree_map(lambda t: t.to(dev, non_blocking=True), host[j])

    try:
        trainer.run(feed, seed=ctx.seed)
    except StopIteration:
        pass
    del trainer
    setup_s = win.t0 - ctx.t_start - check_s - rec.seconds
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    steps = len(infos)
    spans = window_spans(win.t0, win.t1) if ctx.traced else []

    # the reference, once the window has closed and the program is gone
    rec.rows = None
    if cuda:
        torch.cuda.empty_cache()
    p0 = {k: v.to(dev) for k, v in ref_p0.items()}
    checked = [ref_batch(grp, kept_ids, dev) for grp in groups[:n_check]]
    r = ref.train(p0, cfg, checked, o)
    prog = {"losses": [float(x) for x in rec.losses],
            "grad_norms": rec.grad_norms, "change": rec.change}
    checks = [harness.Check(k, v, lim[k])
              for k, v in gaps(prog, r, lim).items()]

    def variants(name):
        """The check's numbers with the reference put in the program's
        place: ``tf32`` (computed in TF32), ``half_batch`` (each step's
        loss the mean over the first half of its impressions, in slot
        order) or ``stale_state`` (a step that returns its state
        unchanged)."""
        bs, oo = checked, o
        if name == "half_batch":
            bs = [half(b) for b in checked]
        if name == "stale_state":
            oo = {k: {**v, "lr": 0.0} for k, v in o.items()}
        with harness.tf32(name == "tf32"):
            got = ref.train(p0, cfg, bs, oo)
        if name == "stale_state":
            # nothing moves and the optimizer state stays at its start
            got["grad_norms"] = {k: 0.0 for k in got["grad_norms"]}
            got["change"] = {k: 0.0 for k in got["change"]}
        return gaps(got, r, lim)

    imps = sum(i["impressions"] for i in infos)
    counts = {"steps": steps,
              **{k: sum(i[k] for i in infos) for k in (
                  "train_flops", "b1_flops", "b1_bytes", "bwd_flops",
                  "bwd_bytes")}}
    ctx.log(f"window {win.seconds:.3f} s, {steps} steps, {imps} impressions,"
            f" {sum(sum(i['hists']) for i in infos)} history events")
    return Outcome(e2e={"train_imps_per_s": imps / win.seconds},
                   setup_s=setup_s, attempted=steps, failed=0, checks=checks,
                   counts=counts, memory_peak_bytes=peak, trace=win.trace,
                   spans=spans, batches=infos, variants=variants)


def ref_batch(grp: List[Dict], kept_ids: np.ndarray, dev) -> List[Dict]:
    """A step's requests for the reference, on ``dev``, with item ids
    renumbered to the compact table's rows (``kept_ids``, sorted)."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
    return [{"hist": t(np.searchsorted(kept_ids, r["hist"]), torch.long),
             "acts": t(r["acts"], torch.long),
             "items": t(np.searchsorted(kept_ids, r["items"]), torch.long),
             "labels": t(r["labels"], torch.float32)} for r in grp]


def half(batch: List[Dict]) -> List[Dict]:
    """The step with only the first half of its impressions, in slot
    order (a request left with none drops out: its targets are its only
    loss terms)."""
    left = sum(r["items"].numel() for r in batch) // 2
    out = []
    for r in batch:
        k = min(left, r["items"].numel())
        left -= k
        if k:
            out.append({**r, "items": r["items"][:k],
                        "labels": r["labels"][:k]})
    return out
