"""Driver ``serve_open``: open-loop online scoring through the program's
``ScoringEngine`` (built by ``ScoringEngine.from_scenario``) and its
online front end (``submit`` / ``poll`` / ``take``).

Requests fall due on a Poisson schedule at the traffic file's fixed rate.
One host thread submits every request that is due, polls the engine and
takes what it scored. A request's latency runs from when it fell due to
when its scores are in hand, so a stall delays every request behind it.
After the window no request is added; the ones already due are waited
for, a minute at most, and one never scored counts as slower than every
scored one.

Correctness: a sample of the requests the window scored, drawn from the
seed and holding the longest histories, against the plain reference
(``reference/hstu_gr.py``) on the same weights and requests.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from roobench import compare, harness, inputs, programs, traffic, weights
from roobench import yardstick as Y
from roobench.harness import Check, Outcome, window_spans
from roobench.reference import hstu_gr as ref
from roobench.trace import Window

WARM_GROUPS = (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def build(ctx, rate: float):
    """(engine, params, requests) of a run at ``rate`` requests/s."""
    from repro_torch.serve.engine import ScoringEngine
    cfg = ctx.config
    n_req = int(rate * ctx.seconds * 1.25) + sum(WARM_GROUPS) + 64
    reqs = inputs.GRTraffic(ctx.seed, cfg, ctx.traffic, n_req, rate)
    ctx.phase("inputs")
    w = weights.gr(ctx.seed, cfg, ctx.device)
    ctx.phase("weights")
    engine = ScoringEngine.from_scenario(programs.gr_spec(cfg), params=w,
                                         device=ctx.device)
    ctx.phase("engine")
    return engine, w, reqs


def warm(engine, reqs) -> None:
    """Every rung of the engine's ladder, through its scoring core."""
    k = 0
    for n in WARM_GROUPS:
        engine.score_requests([reqs.sample(i, -1 - i)
                               for i in range(k, k + n)])
        k += n


def open_loop(engine, reqs, seconds: float, win: Window, first: int = 0):
    """Serve requests ``first..`` as they fall due over ``seconds``; returns
    (latencies of the requests due in the window, in order; their scores
    or None; submit lateness; engine stats before and after)."""
    from repro_torch.serve.engine import ScoreError
    due = reqs.due[first:] - reqs.due[first]
    n_win = int(np.searchsorted(due, seconds, side="left"))
    ids = list(range(first, first + n_win))
    samples = [reqs.sample(i, i) for i in ids]
    stats0 = engine.stats.snapshot()
    done = np.full(n_win, np.inf)
    late = np.zeros(n_win)
    scores = [None] * n_win
    open_t, nxt = {}, 0
    # the whole window's requests are built ahead, hundreds of thousands
    # of long-lived containers a deployment never holds; keep them out of
    # the collector's full passes, which would stall the window for them
    gc.collect()
    gc.freeze()
    t0 = win.open()
    t_end = t0 + seconds

    def collect():
        t = time.perf_counter()
        for tk in list(open_t):
            r = engine.take(tk)
            if r is not None:
                j = open_t.pop(tk)
                if not isinstance(r, ScoreError):
                    done[j], scores[j] = t, r

    while True:
        now = time.perf_counter()
        while nxt < n_win and t0 + due[nxt] <= now:
            open_t[engine.submit(samples[nxt])] = nxt
            late[nxt] = now - t0 - due[nxt]
            nxt += 1
        if now >= t_end and nxt >= n_win:
            break
        if engine.poll():
            collect()
    stop = time.perf_counter() + 60.0
    while open_t and time.perf_counter() < stop:
        if engine.poll():
            collect()
    win.close()
    gc.unfreeze()
    lat = (done - (t0 + due[:n_win])) * 1e3
    return lat, scores, late, stats0, engine.stats.snapshot()


def p95(lat: np.ndarray) -> float:
    """Nearest-rank 95th percentile (a never-scored request is +inf)."""
    s = np.sort(lat)
    return float(s[max(0, math.ceil(0.95 * len(s)) - 1)])


def run(ctx):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    engine, w, reqs = build(ctx, float(tr["arrivals"]["rate_per_s"]))
    warm(engine, reqs)
    ctx.phase("warm flushes")
    first = sum(WARM_GROUPS)
    win = Window(dev, ctx.traced)
    lat, scores, late, s0, s1 = open_loop(engine, reqs, ctx.seconds, win,
                                          first)
    setup_s = win.t0 - ctx.t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans = window_spans(win.t0, win.t1) if ctx.traced else []
    n_win = len(lat)
    scored = [j for j in range(n_win) if scores[j] is not None]
    ctx.log(f"{n_win} requests due in {ctx.seconds} s, {len(scored)} scored;"
            f" generator late p95 {np.percentile(late, 95) * 1e3:.3f} ms, "
            f"max {late.max() * 1e3:.3f} ms")
    del engine
    if cuda:
        torch.cuda.empty_cache()

    # the reference on a sample of what the window scored
    g = traffic.rng(ctx.seed, 41)
    by_len = sorted(scored, key=lambda j: -reqs.hist_len(first + j))
    longest = by_len[:int(tr["check_longest"])]
    rest = sorted(set(scored) - set(longest))
    pick = g.choice(len(rest), size=min(len(rest), int(tr["check_sample"])),
                    replace=False) if rest else []
    sample = longest + [rest[i] for i in pick]
    prog = [scores[j] for j in sample]

    def ref_scores(on_tf32: bool):
        out = []
        with torch.no_grad(), harness.tf32(on_tf32):
            for j in sample:
                i = first + j
                p = reqs.pool_of[i]
                out.append(ref.request_logits(
                    w, cfg, reqs.hist_ids[p], reqs.hist_acts[p],
                    reqs.item_ids[i]).cpu().numpy())
        return np.concatenate(out) if out else None
    want = ref_scores(False)
    gap = (compare.score_gap(np.concatenate(prog), want) if sample
           else float("inf"))
    lim = cfg["limits"]["serve"]
    never = n_win - len(scored)
    checks = [Check("score_gap", gap, lim["score_gap"]),
              Check("unanswered", never, 0)]

    def variants(name):
        """``tf32``: the reference in TF32 put in the program's place."""
        if name != "tf32":
            raise KeyError(name)
        return {"score_gap": compare.score_gap(ref_scores(True), want)}

    hl = [min(reqs.hist_len(first + j), cfg["hist_len"]) for j in scored]
    tg = [int(reqs.n_imps[first + j]) for j in scored]
    n_batches = s1["n_batches"] - s0["n_batches"]
    counts = {
        "requests": len(scored), "batches": n_batches,
        "fill_requests": s1["n_requests"] - s0["n_requests"],
        "max_requests": cfg["engine"]["max_requests"],
        "fwd_flops": sum(Y.gr_fwd_flops(cfg, h, t) for h, t in zip(hl, tg)),
        "b1_flops": cfg["n_layers"] * sum(
            Y.hstu_attn_flops(cfg, h, t) for h, t in zip(hl, tg)),
        "b1_bytes": cfg["n_layers"] * (
            sum(Y.hstu_attn_bytes(cfg, h, t) for h, t in zip(hl, tg))
            + n_batches * Y.hstu_rab_bytes(cfg))}
    return Outcome(e2e={"serve_p95_ms": p95(lat)}, setup_s=setup_s,
                   attempted=n_win, failed=never, checks=checks,
                   counts=counts, memory_peak_bytes=peak, trace=win.trace,
                   spans=spans, variants=variants)
