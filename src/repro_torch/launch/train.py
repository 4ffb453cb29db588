"""Training launcher: ``--arch <id>`` selects a registered architecture
(torch port of ``repro/launch/train.py``).

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
resuming from the cursor saved beside each checkpoint.

``--mesh DATAxMODEL`` (or ``PODxDATAxMODEL``) trains hstu-gr / roo-lsr
SPMD, one process per rank (``repro_torch.distributed``), with
``--comms-compress`` / ``--comms-overlap`` / ``--comms-block`` for the
exchange. On the CPU the launcher spawns the mesh's gloo ranks itself; on
the card run one rank a card (``torchrun --nproc-per-node N``, NCCL), or
``--mesh 1x1`` in this process: a mesh larger than the visible cards is
refused. Each rank holds its FSDP / TP block of every dense leaf and its
row block of every sharded table, and logs their bytes (``rank-bytes``).
The LM archs take no ``--mesh`` (the reference's launcher has none): the
LM under a plan is reached through the library (``lm_loss(..., plan)``).

The LM archs and ``mace`` keep the reference's direct construction (they
are not recsys scenarios): the arch's ``smoke_config()`` (MACE: channels
32, 8 input features) trained by the port's ``Trainer`` and ``adam`` on
seeded random batches (LM: 4 x 64 tokens a step, the labels the tokens, as
the reference's; MACE: one fixed 64-node, 256-edge, 8-graph batch), with
``--steps`` (default 100), ``--ckpt-dir`` and ``--device``; they end with
an ``lm-smoke-done`` / ``mace-smoke-done`` line.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch roo-lsr --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --arch roo-lsr \\
      --config myrun.json --set train.steps=500 --set knobs.emb_dedup=always
  PYTHONPATH=src python -m repro_torch.launch.train --arch roo-lsr \\
      --steps 200 --data disk --shard-dir shards --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch dien --steps 20 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch hstu-gr \\
      --steps 20 --mesh 2x2 --device cpu --comms-compress int8
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
      --steps 10 --device cpu
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Optional

import torch

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
                    help="wire compression for the sharded-embedding "
                         "exchange (int8 = per-block scales + an error-"
                         "feedback residual)")
    ap.add_argument("--comms-overlap", default=None, choices=("on", "off"),
                    help="overlap the gradient reductions of grad-accum "
                         "microbatches with the next one's compute")
    ap.add_argument("--comms-block", type=int, default=None,
                    help="int8 scale-block width for --comms-compress "
                         "(default 128)")
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
                    help="train SPMD over a mesh, e.g. 2x2 (or PODxDATAx"
                         "MODEL): hstu-gr / roo-lsr. On the CPU the "
                         "launcher spawns the gloo ranks; on the card one "
                         "rank a card (torchrun), NCCL")
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


def _last_loss(trainer, digits: int) -> dict:
    """The done line's loss: the last logged row's (a run shorter than
    ``log_every`` logs none)."""
    if not trainer.history:
        return {"logged": "none"}
    return {"loss": round(trainer.history[-1]["loss"], digits)}


def lm_smoke(arch: str, device) -> dict:
    """The launcher's LM run, built: the arch's smoke config (``cfg``), its
    params from seed 0 on ``device``, the loss (the labels are the tokens,
    as the reference's launcher has them), ``batches(start)``, each step's
    4 x 64 tokens from that step on, and Adam's ``lr``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.lm.transformer import lm_init, lm_loss
    from repro_torch.train.loop import step_generator
    cfg = get_arch(arch).smoke_config()

    def batches(start):
        i = start
        while True:
            toks = torch.randint(0, cfg.vocab, (4, 64),
                                 generator=step_generator(0, i))
            yield {"tokens": toks.to(device)}
            i += 1

    return dict(cfg=cfg, batches=batches, lr=3e-4,
                params=lm_init(torch.Generator().manual_seed(0), cfg,
                               device=device),
                loss=lambda p, b, g: lm_loss(p, cfg, b["tokens"],
                                             b["tokens"]))


def mace_smoke(device) -> dict:
    """The launcher's MACE run, built as :func:`lm_smoke`'s: channels 32,
    8 input features, and one fixed 64-node, 256-edge, 8-graph batch with
    its energy targets (the reference's draws from ``RandomState(0)``)."""
    import numpy as np
    from repro_torch.models.gnn.mace import (MACEConfig, mace_forward,
                                             mace_init)
    cfg = MACEConfig(channels=32, n_feat_in=8)
    r = np.random.RandomState(0)
    n, e, g = 64, 256, 8

    def put(a):
        return torch.from_numpy(a).to(device)
    batch = dict(
        node_feat=put(r.normal(size=(n, 8)).astype(np.float32)),
        positions=put(r.normal(size=(n, 3)).astype(np.float32)),
        edge_index=put(r.randint(0, n, (e, 2)).astype(np.int32)),
        edge_mask=torch.ones((e,), dtype=torch.bool, device=device),
        graph_ids=put(np.sort(r.randint(0, g, n)).astype(np.int32)),
        targets=put(r.normal(size=(g,)).astype(np.float32)))

    def loss(p, b, _):
        b = dict(b)
        targets = b.pop("targets")
        out = mace_forward(p, cfg, **b, n_graphs=g)
        return torch.mean((out["energy"][:, 0] - targets) ** 2)

    return dict(cfg=cfg, batches=lambda start: iter(lambda: batch, None),
                lr=1e-3, loss=loss,
                params=mace_init(torch.Generator().manual_seed(0), cfg,
                                 device=device))


def _train_smoke(run: dict, steps: int, ckpt_dir: Optional[str], device):
    from repro_torch.train.loop import Trainer, TrainLoopConfig
    from repro_torch.train.optim import adam
    trainer = Trainer(run["loss"], adam(run["lr"]),
                      TrainLoopConfig(total_steps=steps, log_every=10,
                                      ckpt_dir=ckpt_dir, ckpt_every=50),
                      lambda: run["params"], device=device)
    return trainer, trainer.run(run["batches"], 0)


def _train_lm(arch: str, steps: int, ckpt_dir: Optional[str], device):
    trainer, state = _train_smoke(lm_smoke(arch, device), steps, ckpt_dir,
                                  device)
    log.info("lm-smoke-done", arch=arch, step=int(state["step"]),
             device=device, **_last_loss(trainer, 4))
    return trainer, state


def _train_mace(steps: int, ckpt_dir: Optional[str], device):
    trainer, state = _train_smoke(mace_smoke(device), steps, ckpt_dir,
                                  device)
    log.info("mace-smoke-done", step=int(state["step"]), device=device,
             **_last_loss(trainer, 5))
    return trainer, state


def main(argv=None):
    args = _parser().parse_args(argv)
    if not args.arch and not args.config:
        raise SystemExit("pass --arch <id> or --config spec.json")
    # LM/GNN smoke paths predate the scenario surface and keep their
    # direct construction (they are not recsys scenarios)
    if args.arch in LM_ARCHS:
        return _train_lm(args.arch, args.steps or 100, args.ckpt_dir,
                         args.device)
    if args.arch == "mace":
        return _train_mace(args.steps or 100, args.ckpt_dir, args.device)

    from repro_torch.scenario.build import check_mesh, train_from_scenario
    from repro_torch.scenario.spec import ScenarioValidationError
    try:
        spec = resolve_spec(args)
        if args.dump_config:
            spec.save(args.dump_config)
            log.info("config-dumped", scenario=spec.name,
                     hash=spec.content_hash(), path=args.dump_config)
            return None
        if spec.train.mesh:
            check_mesh(spec)
            if _spawns_ranks(spec.train.mesh, args.device):
                from repro_torch.launch.hostdevices import spawn
                from repro_torch.launch.mesh import parse_mesh_spec
                dims, _ = parse_mesh_spec(spec.train.mesh)
                spawn(_rank_main, math.prod(dims), backend="gloo",
                      args=(list(argv) if argv is not None
                            else sys.argv[1:],))
                return None
        t0 = time.time()
        trainer, state = train_from_scenario(
            spec, ckpt_dir=args.ckpt_dir, shard_dir=args.shard_dir,
            telemetry_path=args.obs_export, device=args.device)
    except ScenarioValidationError as e:
        raise SystemExit(str(e))
    dt = time.time() - t0
    import torch.distributed as dist
    if spec.train.mesh:
        _log_rank_bytes(state)
    if dist.is_initialized() and dist.get_rank() != 0:
        return trainer, state          # rank 0 reports the run
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


def _log_rank_bytes(state) -> None:
    """Every rank's params bytes, its tables' and its dense leaves' (the
    FSDP / TP blocks), as a ``rank-bytes`` line."""
    import torch.distributed as dist

    from repro_torch.train.optim import default_is_embedding
    from repro_torch.tree import flatten_with_path
    tables = dense = 0
    for path, x in flatten_with_path(state["params"]):
        n = x.numel() * x.element_size()
        if default_is_embedding(path):
            tables += n
        else:
            dense += n
    log.info("rank-bytes", rank=dist.get_rank(), dense=dense, tables=tables)


def _spawns_ranks(mesh: str, device) -> bool:
    """Whether this process spawns the mesh's gloo ranks itself: on the
    CPU, when it is not a rank of a world already (torchrun's, or one it
    spawned)."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.hostdevices import TORCHRUN_VARS
    return (torch.device(device).type == "cpu" and not dist.is_initialized()
            and not all(v in os.environ for v in TORCHRUN_VARS))


def _rank_main(rank: int, argv) -> None:
    """One spawned rank: the same command, inside the world."""
    main(argv)


if __name__ == "__main__":
    main()
