"""Readings that set a cell's correctness limits, on the card, in one
process: for each seed, the program's numbers (a short run of the cell)
and each variant's, the reference put in the program's place computed in
a lower precision (``tf32``) or with a planted fault (``half_batch``).

    python3 -m roobench.control --workload <cell> --seeds 1,2,3 \
        --seconds 2 --variants tf32[,half_batch] [--out readings.jsonl]

One JSON line a seed. The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--variants", default="tf32")
    p.add_argument("--out")
    args = p.parse_args(argv)
    from roobench import harness
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        _, _, out = harness.execute(args.workload, seed, args.seconds, False,
                                    device="cuda", t_start=t0)
        row = {"workload": args.workload, "seed": seed,
               "program": {c.name: c.value for c in out.checks},
               "e2e": out.e2e, "setup_s": out.setup_s}
        for v in filter(None, args.variants.split(",")):
            row[v] = out.variants(v)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
