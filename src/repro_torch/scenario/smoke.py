"""Scenario smoke runner (torch port of ``repro/scenario/smoke.py``).

For every registered recsys scenario (or one, with ``--arch``):

  1. validate + JSON round-trip: ``to_json -> from_json`` must reproduce
     the spec bit-identically (same object, same content hash);
  2. a short training run through the same ``train_from_scenario`` path
     the launcher uses, with checkpoints in a temp dir;
  3. checkpoint provenance: the committed meta.json must carry the spec's
     name + content hash;
  4. a tiny serve pass through ``ScoringEngine.from_scenario`` for every
     ROO-servable arch.

Run on the card (``--device cpu`` for the CPU):

    PYTHONPATH=src python -m repro_torch.scenario.smoke [--steps 2]
        [--arch X] [--trace OUT.json] [--device cuda|cpu]

``--trace`` forces obs.mode=trace and saves the accumulated span trace as
Chrome trace-event JSON (open in Perfetto).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def smoke_one(spec, steps: int, trace: bool = False,
              device="cuda") -> dict:
    """Round-trip + short train + provenance + serve for one scenario."""
    from repro_torch.scenario.build import build_samples, train_from_scenario
    from repro_torch.scenario.spec import ScenarioSpec
    from repro_torch.serve.engine import ScoringEngine

    # 1. serialization is the identity (and so is the hash)
    wire = spec.to_json_str()
    back = ScenarioSpec.from_json(json.loads(wire))
    if back != spec or back.content_hash() != spec.content_hash():
        raise AssertionError(f"{spec.name}: JSON round-trip changed the spec")

    # 2+3. train through the shared construction path; checkpoint meta
    # must carry the provenance hash
    overrides = {"train.steps": steps,
                 "train.ckpt_every": steps,
                 "train.log_every": steps}
    if trace:
        overrides["obs.mode"] = "trace"
    run = spec.with_overrides(overrides)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        trainer, state = train_from_scenario(run, ckpt_dir=ckpt_dir,
                                             prints=False, device=device)
        step_dir = os.path.join(ckpt_dir, f"step_{steps:012d}")
        with open(os.path.join(step_dir, "meta.json")) as f:
            meta = json.load(f)
        if int(state["step"]) != steps \
                or meta.get("scenario") != run.name \
                or meta.get("scenario_hash") != run.content_hash():
            raise AssertionError(f"{spec.name}: wrong step count or "
                                 f"checkpoint provenance {meta}")
        loss = trainer.history[-1]["loss"] if trainer.history else None

    # 4. serve the trained params through the same spec
    served = 0
    if spec.model.arch != "dlrm-mlperf":
        engine = ScoringEngine.from_scenario(run, params=state["params"],
                                             device=device)
        requests = build_samples(run.with_overrides(
            {"data.n_requests": 40}))[:8]
        scores = engine.score_requests(requests)
        if len(scores) != len(requests) or any(
                s.shape[0] != r.num_impressions
                for r, s in zip(requests, scores)):
            raise AssertionError(f"{spec.name}: served scores misaligned")
        served = sum(len(s) for s in scores)
    return {"scenario": spec.name, "hash": spec.content_hash(),
            "steps": steps, "loss": loss, "served_impressions": served}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.scenario.smoke")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--arch", default=None,
                    help="run a single scenario instead of all")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="run the scenarios under obs.mode=trace and save "
                         "the span trace as Chrome trace-event JSON")
    ap.add_argument("--device", default="cuda",
                    help="device to train and serve on (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import SCENARIO_ARCHS, scenario
    from repro_torch.obs.log import get_logger
    log = get_logger("scenario-smoke")
    archs = (args.arch,) if args.arch else SCENARIO_ARCHS
    for arch in archs:
        t0 = time.time()
        row = smoke_one(scenario(arch), args.steps,
                        trace=args.trace is not None, device=args.device)
        log.info("smoke", arch=arch, hash=row["hash"], steps=row["steps"],
                 loss=("-" if row["loss"] is None
                       else round(row["loss"], 4)),
                 served=row["served_impressions"],
                 seconds=round(time.time() - t0, 1))
    if args.trace:
        from repro_torch.obs import trace as obs_trace
        n = obs_trace.get_tracer().save(args.trace)
        log.info("trace-saved", path=args.trace, events=n)
    log.info("ok", scenarios=len(archs))


if __name__ == "__main__":
    main()
