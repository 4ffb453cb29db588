#!/usr/bin/env python3
"""Where a dense dlrm-mlperf training step's time goes, fp32 against bf16
tables, by a ``torch.profiler`` trace of the card.

Run from the repo root on a machine with one NVIDIA H100:

    python3 scripts/dlrm_dtype_profile.py [--steps 5]

For each dtype: ``chip_smoke.py``'s dense dlrm training setup (published
widths, tables capped at ``chip_smoke.DLRM_CAP`` rows, 2,048 requests /
8,192 impressions a step, the scenario's mixed optimizer), one Trainer run
of 3 steps to warm up, then ``--steps`` steps under a trace of the card
and the host. Prints, per dtype and per step: the wall time, the device
time of the trace's kernels and copies summed, the kernel launches the
host issued, and the ten device activities with the most time, each with
its calls. The card's name and power limit head the output. Needs the
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profile_run(setup, device, steps: int) -> dict:
    """The trace of ``steps`` Trainer steps of ``setup`` (after a warm-up
    run): wall seconds, device seconds, launches and the device activities
    by name (seconds, calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    cs.run_trainer(setup, device, 3, halt_after_skips=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.run_trainer(setup, device, steps, halt_after_skips=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + 1e-6 * e.time_range.elapsed_us(), n + 1)
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += 1
    return dict(wall=wall, device=sum(t for t, _ in by_name.values()),
                launches=launches,
                top=sorted(by_name.items(), key=lambda kv: -kv[1][0]))


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dlrm_dtype_profile: no card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(cs.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.kernels import dot_interaction as dmod
    from repro_torch.kernels import embedding_bag as emod
    from repro_torch.kernels import hstu_attention as kmod
    from repro_torch.kernels import hstu_attention_bwd as bmod
    from repro_torch.kernels import hstu_attention_prefix as pmod
    cs.phase_build([kmod, pmod, bmod, emod, dmod])     # and its gates
    device = torch.device("cuda", 0)
    print(cs.card_line())
    cfg = cs.dlrm_config(cs.DLRM_CAP)
    print(cs.dlrm_describe(cfg))
    for dtype in (torch.float32, torch.bfloat16):
        setup = cs.dlrm_setup(cfg, 2048, 8192, device, device, dtype=dtype)
        r = profile_run(setup, device, args.steps)
        n = args.steps
        print(f"[{dtype}] {n} steps: wall {1e3 * r['wall'] / n:.3f} ms a "
              f"step, device {1e3 * r['device'] / n:.3f} ms a step (traced), "
              f"{r['launches'] / n:.1f} kernel launches a step")
        for name, (t, calls) in r["top"][:10]:
            print(f"[{dtype}]   {1e3 * t / n:8.3f} ms a step, {calls / n:6.1f} "
                  f"calls: {name[:110]}")
        del setup
        torch.cuda.empty_cache()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
