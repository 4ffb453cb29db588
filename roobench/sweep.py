"""Find the highest arrival rate the serving engine sustains: one open-loop
window a rate, in one process, on the card.

    python3 -m roobench.sweep --workload <serving cell> \
        --rates 600,800,1000 --seconds 8 --seed 1

for a cell of ``BENCHMARK.json`` whose traffic names the ``serve_open``
driver.

For each rate it prints the latency percentiles of the requests due in
the window, those of its first and second half (a backlog that grows
through the window shows as a second half far slower than the first),
and how late the generator ran. The cell's traffic file then takes 0.8x
the highest rate sustained, as a number.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    from roobench import harness
    harness.prepare_env()
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from roobench.drivers import serve_open as so
    from roobench.trace import Window
    bench = harness.load_bench()
    _, cfg, tr = harness.resolve(bench, args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    top = max(rates)
    ctx = harness.Ctx(args.workload, cfg, tr, args.seed, args.seconds, False,
                      "cuda", T_START)
    engine, _, reqs = so.build(ctx, top)
    so.warm(engine, reqs)
    first = sum(so.WARM_GROUPS)
    base = reqs.due.copy()
    for rate in rates:
        reqs.due = base * (top / rate)
        lat, _, late, s0, s1 = so.open_loop(engine, reqs, args.seconds,
                                            Window("cuda", False), first)
        half = len(lat) // 2
        nb = s1["n_batches"] - s0["n_batches"]
        row = {"rate": rate, "requests": len(lat),
               "p50_ms": float(np.median(lat)), "p95_ms": so.p95(lat),
               "p99_ms": float(np.sort(lat)[int(0.99 * (len(lat) - 1))]),
               "p95_first_half_ms": so.p95(lat[:half]),
               "p95_second_half_ms": so.p95(lat[half:]),
               "late_p95_ms": float(np.percentile(late, 95) * 1e3),
               "late_max_ms": float(late.max() * 1e3),
               "batches": nb,
               "requests_per_batch": (s1["n_requests"] - s0["n_requests"])
               / max(nb, 1)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
