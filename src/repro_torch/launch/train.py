"""Training launcher: ``--arch <id>`` selects a registered recsys
architecture (torch port of the recsys part of ``repro/launch/train.py``).

The recsys archs (roo-lsr / roo-esr / roo-retrieval / hstu-gr / dien /
mind / bert4rec / dlrm-mlperf) are **scenario-driven**: the registry's
ScenarioSpec factory (configs/registry.py) supplies the declarative
config, ``--config spec.json`` replaces it with a serialized spec,
``--set section.field=value`` applies dotted overrides, and the legacy
flags (--steps, --b-ro, --data, ...) are translated into the same
overrides. Construction happens in ``repro_torch.scenario.build``, the
same code path the tests and the smoke runner use, which is what makes a
spec-driven run bit-identical to its flag-driven equivalent.

Runs on the card unless ``--device cpu`` is passed. ``--data disk`` trains
from on-disk ROO shards in ``--shard-dir`` (built from the spec's event
stream on the first run, reused after), through the prefetching loader,
resuming from the cursor saved beside each checkpoint. Not ported yet, and
refused with a message naming the slice: the LM and MACE archs (ROADMAP
A10), ``--mesh`` and the ``--comms-*`` flags (A9).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch roo-lsr --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --arch roo-lsr \\
      --config myrun.json --set train.steps=500 --set knobs.emb_dedup=always
  PYTHONPATH=src python -m repro_torch.launch.train --arch roo-lsr \\
      --steps 200 --data disk --shard-dir shards --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch dien --steps 20 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import time

from repro_torch.obs.log import get_logger

LM_ARCHS = ("starcoder2-15b", "deepseek-coder-33b", "phi3-medium-14b",
            "qwen3-moe-235b-a22b", "granite-moe-3b-a800m")

log = get_logger("launch")


def _parser() -> argparse.ArgumentParser:
    from repro_torch.kernels.dispatch import BACKENDS, EMB_BACKENDS
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default=None,
                    help="registered arch id; optional when --config "
                         "supplies the scenario")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda; cpu for the "
                         "CPU)")
    # scenario surface
    ap.add_argument("--config", default=None, metavar="SPEC.json",
                    help="load a serialized ScenarioSpec instead of the "
                         "registry factory for --arch")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    dest="sets",
                    help="dotted spec override, e.g. train.steps=500 or "
                         "knobs.attn_backend=torch-chunked (repeatable)")
    ap.add_argument("--dump-config", default=None, metavar="OUT.json",
                    help="write the resolved spec as JSON and exit "
                         "(the artifact --config replays)")
    # legacy flags — kept working as spec overrides (None = not passed)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--b-ro", type=int, default=None)
    ap.add_argument("--b-nro", type=int, default=None)
    ap.add_argument("--attn-backend", default=None, choices=BACKENDS,
                    help="HSTU attention backend (default: auto — the CUDA "
                         "kernel on the card, torch-chunked on the CPU)")
    ap.add_argument("--emb-backend", default=None, choices=EMB_BACKENDS,
                    help="embedding-bag backend (default: auto — the CUDA "
                         "kernel on a CUDA table, torch elsewhere)")
    ap.add_argument("--sparse-emb", action="store_true",
                    help="train embedding tables with COO row gradients + "
                         "touched-rows-only row-wise Adagrad (recsys archs "
                         "with a table_ids declaration)")
    ap.add_argument("--emb-dedup", default=None,
                    choices=("auto", "always", "never"),
                    help="request-level id dedup before embedding lookups")
    ap.add_argument("--comms-compress", default=None,
                    choices=("none", "bf16", "int8"),
                    help="sharded-embedding wire compression (not ported "
                         "yet: ROADMAP A9)")
    ap.add_argument("--comms-overlap", default=None, choices=("on", "off"),
                    help="lookup/compute overlap (not ported yet: A9)")
    ap.add_argument("--comms-block", type=int, default=None,
                    help="int8 scale-block width (not ported yet: A9)")
    ap.add_argument("--data", default=None, choices=("memory", "disk"),
                    help="recsys data path: in-memory batches (default) or "
                         "the disk-backed shard pipeline with prefetch + "
                         "cursor resume")
    ap.add_argument("--shard-dir", default=None,
                    help="shard directory for --data disk (required "
                         "there; reused if its manifest was built from the "
                         "same data settings, refused if not)")
    ap.add_argument("--requests-per-shard", type=int, default=None)
    ap.add_argument("--strict-shards", action="store_true",
                    help="raise on corrupt shards instead of quarantining "
                         "them (data-validation runs)")
    ap.add_argument("--halt-after-skips", type=int, default=None,
                    help="halt after N consecutive non-finite training "
                         "steps (0 = keep skipping silently)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the background prefetch thread "
                         "(synchronous shard reads; benchmarking aid)")
    ap.add_argument("--label-wait", type=float, default=None,
                    help="online-join label wait window (seconds)")
    ap.add_argument("--late-fraction", type=float, default=None,
                    help="fraction of conversions given a heavy-tail delay")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="SPMD over a device mesh (not ported yet: A9)")
    # observability
    ap.add_argument("--obs", default=None,
                    choices=("off", "metrics", "trace"),
                    help="observability mode (spec obs.mode / env "
                         "REPRO_TORCH_OBS): metrics = registry counters/"
                         "histograms, trace = metrics + span tracing")
    ap.add_argument("--obs-export", default=None, metavar="OUT.jsonl",
                    help="append periodic metrics snapshots to this JSONL "
                         "file (cadence obs.export_every_s; read with "
                         "python -m repro_torch.obs.report)")
    ap.add_argument("--trace-out", default=None, metavar="OUT.json",
                    help="save the run's span trace as Chrome trace-event "
                         "JSON (open in Perfetto; implies --obs trace)")
    return ap


def _flag_overrides(args) -> dict:
    """Legacy flags -> dotted spec overrides (only flags actually passed)."""
    mapping = {
        "train.steps": args.steps,
        "batcher.b_ro": args.b_ro,
        "batcher.b_nro": args.b_nro,
        "knobs.attn_backend": args.attn_backend,
        "knobs.emb_backend": args.emb_backend,
        "knobs.emb_dedup": args.emb_dedup,
        "knobs.comms_compress": args.comms_compress,
        "knobs.comms_overlap": args.comms_overlap,
        "knobs.comms_block": args.comms_block,
        "data.source": args.data,
        "data.requests_per_shard": args.requests_per_shard,
        "data.label_wait_s": args.label_wait,
        "data.late_fraction": args.late_fraction,
        "train.halt_after_skips": args.halt_after_skips,
        "train.mesh": args.mesh,
        "obs.mode": (args.obs if args.obs is not None
                     else "trace" if args.trace_out else None),
    }
    out = {k: v for k, v in mapping.items() if v is not None}
    if args.obs_export:
        out["obs.export"] = True
    if args.sparse_emb:
        out["train.sparse_emb"] = True
    if args.strict_shards:
        out["data.strict_shards"] = True
    if args.no_prefetch:
        out["data.prefetch"] = False
    return out


def resolve_spec(args):
    """--config / registry factory + --set + legacy flags -> ScenarioSpec."""
    from repro_torch.configs.registry import scenario
    from repro_torch.scenario.spec import ScenarioSpec, parse_set_args
    if args.config:
        spec = ScenarioSpec.load(args.config)
        if args.arch and args.arch != spec.model.arch:
            raise SystemExit(f"--arch {args.arch} contradicts --config "
                             f"(model.arch={spec.model.arch}); drop one")
    else:
        spec = scenario(args.arch)
    overrides = _flag_overrides(args)
    overrides.update(parse_set_args(args.sets))   # --set beats legacy flags
    return spec.with_overrides(overrides) if overrides else spec


def main(argv=None):
    args = _parser().parse_args(argv)
    if not args.arch and not args.config:
        raise SystemExit("pass --arch <id> or --config spec.json")
    if args.arch in LM_ARCHS or args.arch == "mace":
        raise SystemExit(f"--arch {args.arch}: the LM and MACE archs are not "
                         f"ported yet (ROADMAP A10)")

    from repro_torch.scenario.build import train_from_scenario
    from repro_torch.scenario.spec import ScenarioValidationError
    try:
        spec = resolve_spec(args)
        if args.dump_config:
            spec.save(args.dump_config)
            log.info("config-dumped", scenario=spec.name,
                     hash=spec.content_hash(), path=args.dump_config)
            return None
        t0 = time.time()
        trainer, state = train_from_scenario(
            spec, ckpt_dir=args.ckpt_dir, shard_dir=args.shard_dir,
            telemetry_path=args.obs_export, device=args.device)
    except ScenarioValidationError as e:
        raise SystemExit(str(e))
    dt = time.time() - t0
    # history only fills every log_every steps; a short run may log none
    last = trainer.history[-1] if trainer.history else {}
    kv = {k: round(last[k], 4) for k in ("loss", "ne") if k in last}
    if not kv:
        kv = {"logged": "none"}
    log.info("train-done", arch=spec.model.arch, steps=int(state["step"]),
             seconds=round(dt, 1), scenario=spec.name,
             hash=spec.content_hash(), device=args.device, **kv)
    if args.trace_out:
        from repro_torch.obs import trace as obs_trace
        n = obs_trace.get_tracer().save(args.trace_out)
        log.info("trace-saved", path=args.trace_out, events=n)
    return trainer, state


if __name__ == "__main__":
    main()
