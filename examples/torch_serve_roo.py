"""ROO inference (paper §2.2) on PyTorch: the request-centric serving
engine. The port of ``examples/serve_roo.py``, step for step.

Demonstrates the full serving path, driven by the declarative scenario
surface (docs/CONFIG.md) — the engine, model halves, and request stream
all come from one ``ScenarioSpec``:
  * request-aligned scoring — one score array per request, exactly aligned
    with ``request.item_ids`` (zero-impression and oversize requests
    included);
  * the online micro-batcher (submit / poll / take with a size-or-deadline
    admission policy) and shape-bucketed batching;
  * the user-tower cache deduping the RO side across repeat requests;
  * 1-vs-1M retrieval scoring.

On the card roo-lsr's and roo-retrieval's HSTU user towers run the
hand-written attention kernel (B1).

Run:  PYTHONPATH=src python examples/torch_serve_roo.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import scenario
from repro_torch.data.batcher import ROOBatcher
from repro_torch.scenario.build import (build_batcher_cfg, build_model,
                                        build_samples)
from repro_torch.serve.engine import ScoringEngine
from repro_torch.serve.serving import retrieval_scoring

LSR_OVERRIDES = {"serve.max_requests": 32, "serve.max_impressions": 192,
                 "serve.cache_user_tower": True, "data.n_requests": 64,
                 "data.hist_init_max": 40, "data.seed": 7}
N_ONLINE = 5
N_CANDIDATES = 1_000_000
TOP_K = 10
SEED = 0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # --- late-stage ranking serving: batched ROO requests --------------------
    # one declarative spec drives the model halves, the admission policy,
    # the bucket ladder, AND the request stream below
    spec = scenario("roo-lsr", LSR_OVERRIDES)
    print(f"scenario {spec.name} ({spec.content_hash()})")
    engine = ScoringEngine.from_scenario(spec, rng_seed=SEED, device=device)

    # incoming requests = ROO samples without labels (same schema!)
    requests = build_samples(spec)
    t0 = time.perf_counter()
    scores = engine.score_requests(requests)
    dt = (time.perf_counter() - t0) * 1e3
    assert len(scores) == len(requests)
    assert all(s.shape[0] == r.num_impressions
               for r, s in zip(requests, scores))
    n_cand = sum(len(s) for s in scores)
    print(f"scored {len(scores)} requests / {n_cand} candidates in "
          f"{dt:.1f} ms (aligned 1:1 with item_ids; user side computed ONCE "
          f"per request)")
    print(f"request 0, task 0: {np.round(scores[0][:, 0], 3)}")
    buckets = sorted(engine.stats.buckets.counts,
                     key=lambda s: (s.b_ro, s.b_nro))
    print(f"bucket shapes used: {buckets}")
    first_batches = engine.stats.n_batches

    # repeat traffic: the RO side is served from the user-tower cache
    t0 = time.perf_counter()
    scores2 = engine.score_requests(requests)
    dt2 = (time.perf_counter() - t0) * 1e3
    np.testing.assert_allclose(scores2[0], scores[0], rtol=1e-5, atol=1e-5)
    print(f"repeat pass: {dt2:.1f} ms — cache hit rate "
          f"{engine.cache.stats.hit_rate:.0%}, "
          f"{engine.stats.n_full_cache_batches} batch(es) skipped the user "
          f"tower")

    # --- online micro-batching: submit / poll / take --------------------------
    tickets = [engine.submit(r) for r in requests[:N_ONLINE]]
    engine.poll()                # under size + deadline: nothing scored yet
    engine.flush()               # e.g. shutdown / test hook forces the flush
    online = [engine.take(t) for t in tickets]
    print(f"online path: {len(online)} requests scored in one micro-batch "
          f"({sum(len(s) for s in online)} candidates)")
    stats = engine.stats.snapshot()

    # --- retrieval serving: 1 user vs 1M candidates --------------------------
    ret = scenario("roo-retrieval")
    bundle = build_model(ret, torch.Generator().manual_seed(SEED),
                         device=device)
    batch = next(ROOBatcher(build_batcher_cfg(spec), device=device).batches(
        requests))
    with torch.no_grad():
        u = bundle.serve.user_fn(bundle.params, batch)[0]          # (d,)
    gen = torch.Generator(device=device).manual_seed(SEED)
    cand = torch.randn((N_CANDIDATES, u.shape[-1]), generator=gen,
                       device=device) * 0.1
    sync(device)
    t0 = time.perf_counter()
    top_scores, top_idx = retrieval_scoring(u, cand, k=TOP_K)
    sync(device)
    dt3 = (time.perf_counter() - t0) * 1e3
    print(f"1-vs-1M retrieval in {dt3:.1f} ms; "
          f"top-3 items {top_idx[:3].cpu().numpy()} "
          f"scores {np.round(top_scores[:3].cpu().numpy(), 3)}")
    return {"spec_hash": spec.content_hash(),
            "n_requests": len(requests), "n_candidates": n_cand,
            "scores": scores, "repeat_scores": scores2, "online": online,
            "first_pass_ms": dt, "repeat_pass_ms": dt2,
            "requests_per_s": len(requests) / (dt * 1e-3),
            "repeat_requests_per_s": len(requests) / (dt2 * 1e-3),
            "first_pass_batches": first_batches,
            "buckets": [(s.b_ro, s.b_nro) for s in buckets],
            "cache_hit_rate": engine.cache.stats.hit_rate, "stats": stats,
            "lsr_layers": len(engine.params["hstu"]["layers"]),
            "retrieval_layers": len(bundle.params["hstu"]["layers"]),
            "retrieval_ms": dt3, "user_repr": u.cpu(),
            "top_scores": top_scores.cpu(), "top_idx": top_idx.cpu()}


if __name__ == "__main__":
    main()
