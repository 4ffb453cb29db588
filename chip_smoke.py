#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repo root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. device   — the card's name and power limit; no CUDA, no run
  2. build    — nvcc builds every kernel of the path from the sources in
                this checkout (registers / shared memory from -Xptxas -v)
  3. kernels  — each kernel against its plain torch version on the card, at
                the serving shape and at a ragged S > 128 shape, rab on/off
  4. serve    — ROOServer with random hstu-gr params (seeded
                torch.Generator) scores a few hundred simulated requests on
                the card through the kernel; launch counts, failed batches
                and scores are checked against the torch-dense server and a
                CPU server
  5. times    — kernel vs plain version (CUDA events; device time with the
                host run ahead, and host-issued call time) beside the bound,
                and the server's requests/s

Numerics: the reference is fp32 end to end, so TF32 is switched off for
matmuls and cuDNN; kernel and plain versions then differ only in summation
order (atol = rtol = 1e-5 on attention outputs, 1e-4 on logits).

The second-to-last lines are the kernels' JSON record and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.
It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ATOL = RTOL = 1e-5            # attention outputs, kernel vs plain
LOGIT_TOL = 1e-4              # logits / scores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean time per call of ``fn`` issued back to back by the host (CUDA
    events): what a caller pays, host launch overhead included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time per call of ``fn``: a sleep kernel holds the card
    while the host enqueues every call, so the CUDA events between them
    time the device alone. Fails if the host did not get ahead."""
    import torch
    host_s = call_ms(fn, iters) * 1e-3 * iters        # also the warm-up
    for cycles in (4e9 * host_s + 1e7, 40e9 * host_s + 1e8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cycles))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()   # the card had not reached the calls yet
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
    raise SystemExit("device_ms: the host never got ahead of the card")


def attention_inputs(shape, seed, device):
    """Random q/k/v/rab and ragged lengths (incl. zeros) from numpy."""
    import numpy as np
    import torch
    b, h, s, dqk, dv, n_hist, max_rel = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, dqk)).astype(np.float32)
    k = rng.normal(size=(b, h, s, dqk)).astype(np.float32)
    v = rng.normal(size=(b, h, s, dv)).astype(np.float32)
    rab = (0.5 * rng.normal(size=(h, 2 * max_rel + 1))).astype(np.float32)
    hl = rng.integers(0, n_hist + 1, size=b).astype(np.int32)
    tc = rng.integers(0, s - n_hist + 1, size=b).astype(np.int32)
    hl[0], tc[0] = 0, s - n_hist          # no history, every target
    if b > 1:
        hl[1], tc[1] = n_hist, 0          # full history, no target
    t = lambda a: torch.from_numpy(a).to(device)
    return dict(q=t(q), k=t(k), v=t(v), rab=t(rab), hl=t(hl), tc=t(tc),
                n_hist=n_hist, max_rel=max_rel)


def bound(x) -> tuple:
    """Least time (ms) the card needs for one call on these inputs: bytes
    over HBM rate vs FLOPs over the fp32 rate, both counted on what the ROO
    mask keeps. Bytes: the q, k and v rows the output depends on (history
    rows < hist_lengths, target rows < target_counts) read once, the whole
    output written once, rab and the lengths. FLOPs: 2 (Dqk + Dv) per cell
    the mask keeps."""
    from repro_torch.core.masks import roo_spec
    b, h, s, dqk = x["q"].shape
    dv = x["v"].shape[-1]
    valid_rows = int((x["hl"] + x["tc"]).sum()) * h
    n_bytes = 4 * (valid_rows * (2 * dqk + dv) + b * h * s * dv
                   + x["rab"].numel() + 2 * b)
    cells = int(roo_spec(x["hl"], x["tc"], x["n_hist"]).dense(s).sum()) * h
    ops = 2 * cells * (dqk + dv)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes, ops)


def phase_build(kmod) -> None:
    t0 = time.perf_counter()
    path, log = kmod.build()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def phase_kernels(kmod, device) -> float:
    """Kernel vs plain version (and the chunked path) on the card, the
    kernel reached through the dispatch entry the model calls (auto
    backend); returns the largest |kernel - plain|."""
    import torch
    from repro_torch.core.hstu import hstu_attention_chunked
    from repro_torch.core.masks import roo_spec
    from repro_torch.kernels import dispatch
    shapes = {
        "serve B64 S80": (64, 2, 80, 32, 32, 64, 64),
        "ragged S203": (5, 3, 203, 48, 40, 150, 100),
        "wide D128 S160": (3, 2, 160, 128, 128, 140, 128),  # > 48 KB smem
        "causal S96": (4, 2, 96, 32, 32, 96, 64),
    }
    worst = 0.0
    for i, (name, shape) in enumerate(shapes.items()):
        x = attention_inputs(shape, seed=i, device=device)
        if name.startswith("causal"):
            x["tc"].zero_()
        for use_rab in (True, False):
            rab = x["rab"] if use_rab else None
            spec = roo_spec(x["hl"], x["tc"], x["n_hist"])
            before = kmod.launch_count
            got = dispatch.hstu_attention(x["q"], x["k"], x["v"], rab, spec,
                                          max_rel_pos=x["max_rel"])
            if kmod.launch_count != before + 1:
                raise SystemExit("dispatch auto did not launch the kernel "
                                 "on a CUDA tensor")
            plain = kmod.hstu_attention_plain(
                x["q"], x["k"], x["v"], rab, x["n_hist"], x["hl"], x["tc"],
                x["max_rel"])
            chunked = hstu_attention_chunked(
                x["q"], x["k"], x["v"], rab, spec,
                max_rel_pos=x["max_rel"], chunk=32)
            torch.cuda.synchronize()
            err = (got - plain).abs()
            worst = max(worst, float(err.max()))
            ok = bool(torch.all(err <= ATOL + RTOL * plain.abs()))
            ok_chunk = torch.allclose(got, chunked, atol=ATOL, rtol=RTOL)
            s = x["q"].shape[2]
            dead = ~spec.dense(s).any(-1)                     # (B, S)
            zero = bool(torch.all(got.transpose(1, 2)[dead] == 0))
            finite = bool(torch.isfinite(got).all())
            print(f"[kernels] {name} rab={use_rab}: max|kernel-plain| = "
                  f"{float(err.max()):.3e} ok={ok} chunked_ok={ok_chunk} "
                  f"masked_rows_zero={zero} finite={finite}")
            if not (ok and ok_chunk and zero and finite):
                raise SystemExit(f"kernel disagrees with its plain version "
                                 f"at {name} rab={use_rab}")
    return worst


def make_requests(cfg, n_requests):
    from repro_torch.core.joiner import RequestLevelJoiner
    from repro_torch.data.events import EventSimulator, EventStreamConfig
    evs = EventSimulator(EventStreamConfig(
        n_requests=n_requests, n_items=cfg.n_items,
        hist_init_max=cfg.hist_len, seed=0)).stream()
    return RequestLevelJoiner().join(evs)


def phase_serve(kmod, device) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs.roo_models import gr_config
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.models.gr import gr_init, gr_ranking_logits
    from repro_torch.serve.engine import ScoreError
    from repro_torch.serve.serving import ROOServer, ServeConfig

    cfg = gr_config()
    params = gr_init(torch.Generator().manual_seed(0), cfg, device=device)
    score = lambda p, b: gr_ranking_logits(p, cfg, b)
    requests = make_requests(cfg, 1000)
    print(f"[serve] hstu-gr d_model={cfg.hstu.d_model} heads="
          f"{cfg.hstu.n_heads} layers={cfg.hstu.n_layers} hist="
          f"{cfg.hist_len} m={cfg.m_targets} items={cfg.n_items}; "
          f"{len(requests)} requests, "
          f"{sum(r.num_impressions for r in requests)} impressions")

    serve_cfg = ServeConfig(b_ro=64, b_nro=512, hist_len=cfg.hist_len)
    ROOServer(params, score, serve_cfg, device=device).score_requests(
        requests[:80])                                  # warm-up
    torch.cuda.synchronize()

    server = ROOServer(params, score, serve_cfg, device=device)
    kmod.reset_launch_count()
    t0 = time.perf_counter()
    scores = server.score_requests(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kmod.launch_count
    st = server.stats
    print(f"[serve] {len(requests)} requests in {wall * 1e3:.1f} ms "
          f"({len(requests) / wall:.1f} requests/s), {st.n_batches} batches "
          f"{st.buckets.snapshot()['counts']}, kernel launches {launches}")

    errors = [s for s in scores if isinstance(s, ScoreError)]
    if errors or st.n_failed_batches:
        raise SystemExit(f"{len(errors)} ScoreError(s), "
                         f"{st.n_failed_batches} failed batch(es): "
                         f"{errors[:1]}")
    if len(scores) != len(requests) or any(
            s.shape != (r.num_impressions, cfg.n_tasks)
            or not np.isfinite(s).all() for r, s in zip(requests, scores)):
        raise SystemExit("scores misaligned with requests or not finite")
    if launches != cfg.hstu.n_layers * st.n_batches or launches == 0:
        raise SystemExit(f"kernel launches {launches} != n_layers x "
                         f"n_batches = {cfg.hstu.n_layers * st.n_batches}")

    # where the serving time goes: host packing + copy vs the forward,
    # measured twice, before the CPU comparison below can load the host
    from repro_torch.data.batcher import BatcherConfig, ROOBatcher
    packer = ROOBatcher(BatcherConfig(b_ro=64, b_nro=512,
                                      hist_len=cfg.hist_len), device=device)
    for _ in range(2):
        t0 = time.perf_counter()
        batches = list(packer.batches(requests))
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.inference_mode():
            for b in batches:
                score(params, b).to("cpu")
        fwd_s = time.perf_counter() - t0
        print(f"[serve] breakdown over {len(batches)} top-rung batches: "
              f"pack + copy to card {pack_s * 1e3:.1f} ms, forward + copy "
              f"back {fwd_s * 1e3:.1f} ms; engine total {wall * 1e3:.1f} ms")

    before = kmod.launch_count
    dense = ROOServer(params, score, ServeConfig(
        b_ro=64, b_nro=512, hist_len=cfg.hist_len,
        attn_backend="torch-dense"), device=device).score_requests(requests)
    if kmod.launch_count != before:
        raise SystemExit("the torch-dense server launched the kernel")
    diff = max(float(np.abs(a - b).max(initial=0.0))
               for a, b in zip(scores, dense))
    ok = all(np.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)
             for a, b in zip(scores, dense))
    print(f"[serve] max|cuda - torch-dense| over scores = {diff:.3e} "
          f"ok={ok}")
    if not ok:
        raise SystemExit("served scores disagree with the torch-dense run")

    cpu_params = params_from_numpy(params_to_numpy(params), "cpu")
    cpu = ROOServer(cpu_params, score, serve_cfg,
                    device="cpu").score_requests(requests[:48])
    diff_cpu = max(float(np.abs(a - b).max(initial=0.0))
                   for a, b in zip(scores[:48], cpu))
    ok_cpu = all(np.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)
                 for a, b in zip(scores[:48], cpu))
    print(f"[serve] max|card - CPU torch-chunked| over 48 requests = "
          f"{diff_cpu:.3e} ok={ok_cpu}")
    if not ok_cpu:
        raise SystemExit("served scores disagree with the CPU server")

    return dict(launches=launches, requests_per_s=len(requests) / wall,
                n_batches=st.n_batches)


def phase_times(kmod, device, card: str) -> dict:
    x = attention_inputs((64, 2, 80, 32, 32, 64, 64), seed=0, device=device)
    args = (x["q"], x["k"], x["v"], x["rab"], x["n_hist"], x["hl"], x["tc"],
            x["max_rel"])
    kernel = lambda: kmod.hstu_attention_cuda(*args)
    plain = lambda: kmod.hstu_attention_plain(*args)
    # plain, kernel, kernel, plain: turns within one call on one card
    plain_ms = device_ms(plain, iters=20)
    ms = device_ms(kernel, iters=200)
    ms_again = device_ms(kernel, iters=200)
    plain_again = device_ms(plain, iters=20)
    kernel_call, plain_call = call_ms(kernel, 200), call_ms(plain, 50)
    bound_ms, bound_by, n_bytes, ops = bound(x)
    print(f"[times] {card}: hstu_attention_fwd B64 H2 S80 D32 rab, device "
          f"time per call: kernel {ms:.5f} ms (again {ms_again:.5f}), plain "
          f"torch {plain_ms:.5f} ms (again {plain_again:.5f}); bound "
          f"{bound_ms:.5f} ms ({bound_by}: {n_bytes} B, {ops} FLOP at "
          f"3.35 TB/s / 67 TFLOP/s); library: none")
    print(f"[times] {card}: host-issued back-to-back calls: kernel "
          f"{kernel_call:.5f} ms, plain torch {plain_call:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs the card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no {SRC / 'repro_torch'}; run from the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    print(f"[device] {card} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    from repro_torch.kernels import hstu_attention as kmod
    phase_build(kmod)
    worst = phase_kernels(kmod, device)
    serve = phase_serve(kmod, device)
    times = phase_times(kmod, device, card)
    print(f"[serve] {card}: {serve['requests_per_s']:.1f} requests/s")

    print(json.dumps({"kernels": [{
        "name": "hstu_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hstu_attention_fwd.cu",
        "replaces": "src/repro/kernels/hstu_attention.py:80",
        "launches": serve["launches"], "max_abs_err": worst,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": None}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
