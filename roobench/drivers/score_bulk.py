"""Driver ``score_bulk``: closed-loop bulk scoring through the program's
``dlrm_forward_roo`` in inference mode, dispatched one batch ahead: the
next batch's copy to the card and its forward are issued before the
previous batch's scores are read back, and every batch's scores come back
to the host.

Correctness: the scores of ``check_batches`` pool batches, drawn from the
seed, as the window last returned them, against the plain reference
(``reference/dlrm.py``) on the same weights and inputs.
"""
from __future__ import annotations

import time

import torch

from roobench import compare, harness, inputs, programs, traffic, weights
from roobench.harness import Check, Outcome
from roobench.reference import dlrm as ref
from roobench.trace import Window


def run(ctx):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pool = inputs.dlrm_pool(ctx.seed, cfg, tr)
    host = programs.host_batches(pool, dev)
    ctx.phase("inputs")
    w = weights.dlrm(ctx.seed, cfg, dev)
    ctx.phase("weights")
    dcfg = programs.dlrm_config(cfg)
    n = len(host)
    sampled = set(traffic.rng(ctx.seed, 31).choice(
        n, size=min(n, int(tr["check_batches"])), replace=False).tolist())
    b_nro = int(tr["impressions_per_step"])
    ring = [torch.empty(b_nro, pin_memory=cuda) for _ in range(3)]
    kept = {}

    def issue(k):
        j = k % n
        logits = programs.dlrm_forward(dcfg, w, programs.to_device(
            host[j], dev))
        out = ring[k % len(ring)]
        out.copy_(logits, non_blocking=True)
        ev = torch.cuda.Event() if cuda else None
        if cuda:
            ev.record()
        return (k, j, out, ev)

    def take(pending):
        k, j, out, ev = pending
        if ev is not None:
            ev.synchronize()
        if j in sampled:
            kept[j] = out.numpy().copy()

    win = Window(dev, ctx.traced)
    done = 0
    with torch.inference_mode():
        prev = None
        for k in range(n):                       # every shape, once
            cur = issue(k)
            if prev is not None:
                take(prev)
            prev = cur
        take(prev)
        ctx.phase("warm batches")
        kept.clear()
        win.open()
        k, prev = n, None
        # at least one pass over the pool, so every sampled batch is due
        while time.perf_counter() - win.t0 < ctx.seconds or k < 2 * n:
            cur = issue(k)
            if prev is not None:
                take(prev)
                done += 1
            prev, k = cur, k + 1
        if prev is not None:
            take(prev)
            done += 1
        win.close()
    setup_s = win.t0 - ctx.t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the reference, after the window, on the benchmark's own weights
    p = {"tables": [w["tables"][f"t{f}"] for f in range(len(cfg["vocabs"]))],
         "bot": [(x["w"], x["b"]) for x in w["bot_mlp"]["layers"]],
         "top": [(x["w"], x["b"]) for x in w["top_mlp"]["layers"]]}
    missing = len(sampled - set(kept))
    inputs_of = {j: {k: v.to(dev) for k, v in host[j].items()}
                 for j in sorted(kept)}

    def ref_scores(on_tf32: bool):
        with torch.no_grad(), harness.tf32(on_tf32):
            return {j: ref.logits(p, cfg, b).cpu().numpy()
                    for j, b in inputs_of.items()}
    want = ref_scores(False)
    gap = max((compare.score_gap(kept[j], want[j]) for j in kept),
              default=float("inf"))
    lim = cfg["limits"]["score"]
    checks = [Check("score_gap", gap, lim["score_gap"]),
              Check("unanswered", missing, 0)]

    def variants(name):
        """``tf32``: the reference in TF32 put in the program's place."""
        if name != "tf32":
            raise KeyError(name)
        low = ref_scores(True)
        return {"score_gap": max(compare.score_gap(low[j], want[j])
                                 for j in low)}

    imps = done * b_nro
    ctx.log(f"window {win.seconds:.3f} s, {done} batches, {imps} impressions")
    infos = [pool[j % n]["_info"] for j in range(n, n + done)]
    counts = {"batches": done,
              "fwd_flops": sum(i["fwd_flops"] for i in infos),
              "b5_bytes": sum(i["b5_bytes"] for i in infos)}
    return Outcome(e2e={"score_imps_per_s": imps / win.seconds},
                   setup_s=setup_s, attempted=done, failed=0, checks=checks,
                   counts=counts, memory_peak_bytes=peak, trace=win.trace,
                   batches=infos, variants=variants)
