"""Run one cell of the benchmark once and print its result line.

    python3 -m roobench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It measures on the machine it starts on and
refuses to run without the CUDA cards the cell asks for.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a non-negative whole number")

    from roobench import harness
    bench = harness.load_bench()
    cell, _, _ = harness.resolve(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark measures the "
              f"port alone", file=sys.stderr)
        return 4
    harness.print_checks(line)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
