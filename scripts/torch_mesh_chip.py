"""The port's SPMD path at world 4: FSDP / TP storage and the LM under a
2 x 2 (data x model) plan, NCCL one rank a card.

Run on four cards of one host:

    torchrun --standalone --nproc-per-node 4 scripts/torch_mesh_chip.py

(``--smoke`` runs the same phases on the CPU over gloo at the smoke
configs' widths: ``torchrun --standalone --nproc-per-node 4
scripts/torch_mesh_chip.py --smoke``.) Rank 0 prints, with the card's name
and power limit:

  * **the gate, f32 compute**: phi3-medium-14b at 2 layers and
    granite-moe-3b-a800m at 4 layers (``capacity_factor`` E / k: nothing
    drops, so the per-rank capacity routes as one process does), full
    width, on the 2 x 2 plan against rank 0's no-plan run of the same
    global batch and init (run first, its losses and gradients kept on the
    host and the model freed before the plan run): step 0's loss within
    rtol 1e-5 on both layer routes, step 0's gathered gradients within
    1e-4 x the leaf's max |g|, 3 steps' losses within rtol 1e-4;
  * **training at bf16 compute**: granite at its full 32 layers and phi3 at
    8 of its 40 layers (the one cut), 2 x 4,096 tokens, 5 steps of adam,
    each rank's params drawn leaf by leaf and cut to its block
    (``lm_init(plan=)``): steps/s, tokens/s, the model-FLOP share of four
    cards' dense bf16 peak, each rank's peak memory and each dense
    exchange site's bytes a step (``comms.STATS``); granite twice from one
    init, bit for bit (losses and every block);
  * **decode** on both: a 4 x 1,024 prompt into ``s_max`` 1,152, 64 steps,
    the cache's batch over ``data`` and its sequence over ``model``:
    tokens/s and each rank's cache bytes;
  * **hstu-gr through the launcher** (``repro_torch.launch.train --mesh
    2x2 --steps 20`` in this world) against ``--mesh 1x1`` (a subprocess on
    rank 0's card): steps/s after the first step (which builds the
    kernels), and each rank's dense bytes equal to its FSDP / TP share.

The last line is ``{"ok": true, ...}``; any gate that fails exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

GATE_RUNS = (("phi3-medium-14b", 2), ("granite-moe-3b-a800m", 4))
GATE_TOKENS = (2, 1024)            # global batch x sequence, f32 compute
GATE_STEPS = 3
TRAIN_RUNS = (("granite-moe-3b-a800m", 32), ("phi3-medium-14b", 8))
TRAIN_TOKENS = (2, 4096)
TRAIN_STEPS = 5
DECODE = (4, 1024, 1152, 64)       # batch, prompt, s_max, steps
LOSS_RTOL, STEPS_RTOL, GRAD_TOL = 1e-5, 1e-4, 1e-4
LR = 3e-4
COLLECTIVE_TIMEOUT_S = 420       # rank 0's lone runs take well under this


def say(*args) -> None:
    import torch.distributed as dist
    if dist.get_rank() == 0:
        print(*args, flush=True)


def fail(msg: str) -> None:
    print(f"rank {_rank()}: {msg}", flush=True)
    sys.exit(1)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def sync(device) -> None:
    import torch
    import torch.distributed as dist
    if device.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def configs(arch: str, layers: int, smoke: bool, **changes):
    from repro_torch.configs.registry import get_arch
    mod = get_arch(arch)
    base = mod.smoke_config() if smoke else mod.CONFIG
    return dataclasses.replace(base, n_layers=layers, **changes)


def no_drop(cfg):
    """The MoE at ``capacity_factor`` E / k: no token is ever dropped."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts_padded / cfg.moe.top_k))


def tokens(cfg, shape, seed: int, device):
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, shape, generator=gen, device=device)


def state_specs(cfg, plan, opt):
    """The train state's specs from the global shapes (meta tensors)."""
    import torch
    from repro_torch.distributed import spmd
    from repro_torch.models.lm.transformer import lm_param_specs, lm_shapes

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        return torch.empty(node, device="meta")
    params = meta(lm_shapes(cfg))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), device="meta"),
             "rng": torch.zeros((), device="meta")}
    return spmd.state_shardings(state, plan,
                                param_specs=lm_param_specs(cfg, plan))


def new_state(params, opt, device):
    import torch
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "rng": torch.tensor(0, dtype=torch.int64)}


def run_steps(step_fn, state, batches, device):
    """The steps over ``batches``: (losses, state, seconds, synchronized
    at both ends)."""
    losses = []
    sync(device)
    t0 = time.perf_counter()
    for i, toks in enumerate(batches):
        state, metrics = step_fn(state, toks, 0, i)
        losses.append(metrics["loss"])
    sync(device)
    secs = time.perf_counter() - t0
    return [float(x) for x in losses], state, secs


def gate(arch, layers, plan, device, smoke) -> dict:
    """Phase 1 for one model (module note)."""
    import torch
    from repro_torch.distributed import spmd
    from repro_torch.models.lm.transformer import (lm_grad_axes, lm_init,
                                                   lm_loss)
    from repro_torch.train.loop import make_train_step, value_and_grad
    from repro_torch.train.optim import adam
    from repro_torch.tree import leaves
    cfg = no_drop(configs(arch, layers, smoke, compute_dtype="float32"))
    batches = [tokens(cfg, GATE_TOKENS, 10 + i, device)
               for i in range(GATE_STEPS)]

    def loss_of(c, p):
        return lambda params, toks, g: lm_loss(params, c, toks, toks, p)
    want = None
    if _rank() == 0:
        params = lm_init(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
        loss0, grads = value_and_grad(loss_of(cfg, None))(params, batches[0],
                                                          None)
        want = dict(loss0=float(loss0),
                    grads=[g.float().cpu() for g in leaves(grads)])
        del grads
        opt = adam(LR)
        step = make_train_step(loss_of(cfg, None), opt)
        state = new_state(params, opt, device)
        want["losses"] = []
        for i, toks in enumerate(batches):       # rank 0 alone: no barrier
            state, metrics = step(state, toks, 0, i)
            want["losses"].append(float(metrics["loss"]))
        del params, state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    sync(device)
    opt = adam(LR)
    specs = state_specs(cfg, plan, opt)
    res = {}
    for spmd_layer in (False, True):
        c = dataclasses.replace(cfg, use_spmd_layer=spmd_layer)
        blocks = lm_init(torch.Generator(device=device).manual_seed(0), c,
                         device=device, plan=plan)
        loss0, grads = value_and_grad(loss_of(c, plan))(blocks, batches[0],
                                                        None)
        grads = spmd.reduce_grads(grads, specs["params"], plan,
                                  lm_grad_axes(c, plan))
        whole = leaves(spmd.gather_state(grads, specs["params"], plan))
        del grads
        if _rank() == 0:
            rel = abs(float(loss0) - want["loss0"]) / abs(want["loss0"])
            gerr = max(float((g.float().cpu() - w).abs().max()
                             / w.abs().max().clamp(min=1e-30))
                       for g, w in zip(whole, want["grads"]))
            res[spmd_layer] = dict(loss0=float(loss0), rel=rel, grad=gerr)
        del whole
        if not spmd_layer:
            step = make_train_step(
                loss_of(c, plan), opt, plan=plan, state_shardings=specs,
                grad_axes=lm_grad_axes(c, plan), gathers_own=True)
            losses, state, _ = run_steps(step, new_state(blocks, opt, device),
                                         batches, device)
            del state
            if _rank() == 0:
                res["losses"] = losses
                res["steps_rel"] = max(abs(a - b) / abs(b) for a, b in
                                       zip(losses, want["losses"]))
        del blocks
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if _rank() == 0:
        ok = (all(res[k]["rel"] <= LOSS_RTOL and res[k]["grad"] <= GRAD_TOL
                  for k in (False, True))
              and res["steps_rel"] <= STEPS_RTOL)
        say(f"[mesh gate] {arch} at {layers} layers, full width, f32 "
            f"compute, 2x2 plan vs rank 0's no-plan run, {GATE_TOKENS} "
            f"tokens: step-0 loss {want['loss0']:.6f}; GSPMD route rel "
            f"{res[False]['rel']:.3e}, max grad diff / max |g| "
            f"{res[False]['grad']:.3e}; explicit route rel "
            f"{res[True]['rel']:.3e}, grads {res[True]['grad']:.3e} (bounds "
            f"{LOSS_RTOL}, {GRAD_TOL}); {GATE_STEPS} steps' losses "
            f"{res['losses']} vs {want['losses']}: rel {res['steps_rel']:.3e}"
            f" (bound {STEPS_RTOL}) ok={ok}")
        if not ok:
            fail(f"{arch}: the 2x2 plan is off the no-plan run")
    sync(device)
    return res


def train(arch, layers, plan, device, smoke, card, repeat=False) -> dict:
    """Phase 2 for one model: TRAIN_STEPS at bf16 compute (module note)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import comms
    from repro_torch.models.lm.transformer import lm_grad_axes, lm_init, lm_loss
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adam
    from repro_torch.tree import leaves
    sys.path[:0] = [str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs.registry import get_arch
    cfg = configs(arch, layers, smoke)
    full = get_arch(arch).CONFIG.n_layers
    opt = adam(LR)
    specs = state_specs(cfg, plan, opt)
    batches = [tokens(cfg, TRAIN_TOKENS, 20 + i, device)
               for i in range(TRAIN_STEPS)]
    step = make_train_step(
        lambda p, toks, g: lm_loss(p, cfg, toks, toks, plan), opt, plan=plan,
        state_shardings=specs, grad_axes=lm_grad_axes(cfg, plan),
        gathers_own=True)
    runs = []
    for _ in range(2 if repeat else 1):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        blocks = lm_init(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device, plan=plan)
        state = new_state(blocks, opt, device)
        del blocks
        block_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(state["params"]))
        # one step's exchanges, then the timed steps
        comms.STATS.reset()
        state, _ = step(state, batches[0], 0, 0)
        sites = comms.STATS.snapshot().get("dense_sites", {})
        losses, state, secs = run_steps(step, state, batches[1:], device)
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else 0)
        # the blocks wait on the host for the second run's
        host = [t.cpu() for t in leaves(state["params"])] if repeat else []
        runs.append(dict(losses=losses, secs=secs, peak=peak, host=host,
                         block_bytes=block_bytes))
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    r = runs[-1]
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, (r["peak"], r["block_bytes"]))
    bitwise = None
    if repeat:
        same = torch.tensor(int(
            runs[0]["losses"] == runs[1]["losses"] and all(
                torch.equal(a, b) for a, b in zip(runs[0]["host"],
                                                  runs[1]["host"]))),
            device=device)
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
        bitwise = bool(same)
    n = TRAIN_STEPS - 1
    b, s = TRAIN_TOKENS
    steps_per_s = n / r["secs"]
    flops = cs.lm_flops(cfg, b, s)
    share = flops * steps_per_s / (dist.get_world_size()
                                   * cs.BF16_FLOP_PER_S)
    step_bytes = sum(v["bytes"] for v in sites.values())
    say(f"[mesh train] {arch} {card} x{dist.get_world_size()}: {layers} of "
        f"{full} layers, full width, bf16 compute, {b} x {s} tokens, 2x2 "
        f"plan; {cfg.n_params():,} params ({cfg.n_active_params():,} "
        f"active a token); losses {r['losses']} (step 1 untimed: its "
        f"exchanges recorded); {steps_per_s:.3f} steps/s over {n} steps "
        f"({r['secs']:.3f} s), {steps_per_s * b * s:.1f} tokens/s; model "
        f"FLOPs {flops:.4e} a step: {flops * steps_per_s / 1e12:.2f} "
        f"TFLOP/s, {100 * share:.2f} % of {dist.get_world_size()} cards' "
        f"dense bf16 peak; per rank (peak memory, param block bytes) "
        f"{[(cs.gib(p), cs.gib(q)) for p, q in peaks]}"
        + ("" if bitwise is None else
           f"; a second run from one init bit for bit (losses and every "
           f"block) {bitwise}"))
    say(f"[mesh train] {arch}: dense exchange sites, rank 0's bytes in one "
        f"step (forward calls, the checkpointed layers' recompute included; "
        f"each backward moves as many): total {step_bytes:,} B; "
        + json.dumps(sites, sort_keys=True))
    if repeat and not bitwise:
        fail(f"{arch}: a second run is not bit for bit")
    if not all(map(lambda x: x == x and abs(x) < 1e4, r["losses"])):
        fail(f"{arch}: losses {r['losses']}")
    return dict(steps_per_s=steps_per_s, tokens_per_s=steps_per_s * b * s,
                mfu=share, peaks=peaks, sites=sites, bitwise=bitwise,
                step_bytes=step_bytes)


def decode_run(arch, layers, plan, device, smoke, card) -> dict:
    """Phase 3 for one model (module note)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.lm import decode
    from repro_torch.models.lm.transformer import lm_init
    cfg = configs(arch, layers, smoke)
    b, prompt, s_max, steps = DECODE
    params = lm_init(torch.Generator(device=device).manual_seed(0), cfg,
                     device=device, plan=plan)
    toks = tokens(cfg, (b, prompt + steps), 30, device)
    cs = decode.CacheSpec(("data",), "model")
    with torch.no_grad():
        sync(device)
        t0 = time.perf_counter()
        logits, cache = decode.prefill(params, cfg, toks[:, :prompt],
                                       plan=plan, s_max=s_max, cs=cs)
        sync(device)
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = decode.serve_step(
                params, cfg, cache, toks[:, prompt + i:prompt + i + 1],
                plan=plan, cs=cs)
        sync(device)
        t_dec = time.perf_counter() - t0
    cache_bytes = sum(cache[n].numel() * cache[n].element_size()
                      for n in ("k", "v"))
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, cache_bytes)
    ok = int(cache["pos"]) == prompt + steps and bool(
        torch.isfinite(logits).all()) and tuple(logits.shape) == (
            b, cfg.vocab)
    say(f"[mesh decode] {arch} {card}: {layers} layers, bf16 compute, "
        f"prefill {b} x {prompt} into s_max {s_max} {t_pre * 1e3:.1f} ms, "
        f"{steps} serve_steps {t_dec * 1e3:.1f} ms: "
        f"{b * steps / t_dec:.1f} decode tokens/s; {cs}: each rank's bf16 "
        f"cache {per_rank} B; logits {tuple(logits.shape)} finite {ok}")
    if not ok:
        fail(f"{arch} decode: pos {int(cache['pos'])} or logits")
    del params, cache
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(tokens_per_s=b * steps / t_dec, cache_bytes=per_rank)


def after_first(history) -> float:
    """Steps/s over a run's steps after its first, from a history logged
    every step (each row's ``steps_per_s`` counts from the run's start):
    the first step builds the kernels and warms the allocator."""
    n, first = history[-1]["step"], history[0]["step"]
    t_n = n / history[-1]["steps_per_s"]
    t_1 = first / history[0]["steps_per_s"]
    return (n - first) / (t_n - t_1)


def launcher_runs(device, smoke, card) -> dict:
    """Phase 4: hstu-gr through the launcher, 2x2 in this world against
    1x1 in a subprocess on rank 0's card (module note)."""
    import torch.distributed as dist
    from repro_torch.distributed import spmd
    from repro_torch.launch.train import main
    from repro_torch.tree import leaves
    extra = ["--set", "train.log_every=1"]
    if smoke:
        extra += ["--device", "cpu", "--set", "model.n_items=2000", "--set",
                  "data.n_requests=40"]
    argv = ["--arch", "hstu-gr", "--steps", "20"] + extra
    trainer, state = main(argv + ["--mesh", "2x2"])
    rate = after_first(trainer.history)
    specs = trainer._specs["params"]
    whole = trainer.gather_state(state)["params"]
    got = want = 0
    for x, full, sp in zip(leaves(state["params"]), leaves(whole),
                           leaves(specs, is_leaf=spmd.is_spec)):
        if not spmd.rows_sharded(sp, trainer.plan):
            n = 1
            for a in spmd.split_axes(sp):
                n *= trainer.plan.mesh.shape[a]
            got += x.numel() * x.element_size()
            want += full.numel() * full.element_size() // n
    shares = [None] * dist.get_world_size()
    dist.all_gather_object(shares, (got, want))
    one = None
    if dist.get_rank() == 0 and smoke:
        # the CPU launcher spawns its own ranks for a mesh: time no mesh
        t, _ = main(argv)
        one = after_first(t.history)
    elif dist.get_rank() == 0:
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                            "MASTER_PORT", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                            "ROLE_RANK", "ROLE_WORLD_SIZE",
                            "TORCHELASTIC_RUN_ID")}
        env["PYTHONPATH"] = str(ROOT / "src")
        code = (f"import sys; sys.path.insert(0, {str(ROOT / 'scripts')!r}); "
                "from torch_mesh_chip import after_first; "
                "from repro_torch.launch.train import main; "
                "t, s = main(sys.argv[1:]); "
                "print('RATE', after_first(t.history))")
        proc = subprocess.run([sys.executable, "-c", code] + argv
                              + ["--mesh", "1x1"], env=env,
                              capture_output=True, text=True, timeout=900)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("RATE")]
        if proc.returncode or not lines:
            fail("--mesh 1x1: " + proc.stderr[-3000:])
        one = float(lines[-1].split()[1])
    dist.barrier()
    ok = all(g == w for g, w in shares)
    if dist.get_rank() == 0:
        say(f"[mesh launcher] hstu-gr {card}: steps/s after the first "
            f"step (its kernel builds): --mesh 2x2 (4 ranks) {rate:.2f} vs "
            + ("no mesh" if smoke else "--mesh 1x1")
            + f" {one:.2f} (alone on rank 0's device); each rank's "
            f"dense bytes (held, its FSDP / TP share) {shares} ok={ok}")
    if not ok:
        fail("hstu-gr: a rank's dense bytes are not its FSDP / TP share")
    return dict(rate_2x2=rate, rate_1x1=one, shares=shares)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the CPU over gloo at the smoke configs' widths")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from repro_torch.distributed.sharding import plan_for_mesh
    from repro_torch.launch.mesh import make_mesh_from_spec
    if args.smoke:
        global GATE_TOKENS, TRAIN_TOKENS, DECODE, TRAIN_RUNS
        GATE_TOKENS, TRAIN_TOKENS = (2, 16), (2, 32)
        DECODE = (4, 8, 16, 4)
        TRAIN_RUNS = (("granite-moe-3b-a800m", 2), ("phi3-medium-14b", 2))
        device = torch.device("cpu")
        card = "CPU (gloo)"
        torch.set_num_threads(1)
    else:
        if not torch.cuda.is_available():
            print("no CUDA device", flush=True)
            return 1
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda")
        import chip_smoke as cs
        card = cs.card_line()
    # torchrun's world, with a collective timeout well inside the run's
    # limit: a rank that stops answering fails the run instead of hanging it
    import datetime
    torch.distributed.init_process_group(
        "gloo" if args.smoke else "nccl",
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    plan = plan_for_mesh(make_mesh_from_spec("2x2"))
    say(card)
    say(f"[mesh] torch {torch.__version__}, world "
        f"{torch.distributed.get_world_size()}, backend "
        f"{torch.distributed.get_backend()}, mesh {plan.mesh.shape}")
    t0 = time.perf_counter()
    out = {"gate": {}, "train": {}, "decode": {}}
    for arch, layers in GATE_RUNS:
        out["gate"][arch] = gate(arch, layers, plan, device, args.smoke)
    for arch, layers in TRAIN_RUNS:
        out["train"][arch] = train(arch, layers, plan, device, args.smoke,
                                   card, repeat=arch.startswith("granite"))
        out["decode"][arch] = decode_run(arch, layers, plan, device,
                                         args.smoke, card)
    out["launcher"] = launcher_runs(device, args.smoke, card)
    say(f"[mesh] done in {time.perf_counter() - t0:.1f} s")
    kind = card.split(",")[0]
    say(json.dumps({"ok": True, "device": {
        "platform": "cpu" if args.smoke else "gpu", "kind": kind,
        "count": torch.distributed.get_world_size()}}))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
