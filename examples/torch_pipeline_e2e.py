"""End-to-end request-log pipeline on PyTorch: events -> watermark online
join -> on-disk ROO shards -> async prefetching loader -> Trainer, then a
simulated kill-and-restart proving the (shard, offset) cursor resumes
bit-identically. The port of ``examples/pipeline_e2e.py``, step for step.

Every fixture (stream, batcher, model, provenance hash) derives from ONE
declarative ScenarioSpec (docs/CONFIG.md) — the same factory the launcher
uses — so the shards this demo writes carry the spec's data hash and the
resume cursor is keyed by it. The loader packs batches on the host and
copies them to ``--device`` on its own stream; on the card roo-lsr's HSTU
attention runs the hand-written kernels (forward B1, backward B2 + B3).

Run:  PYTHONPATH=src python examples/torch_pipeline_e2e.py [--steps 60]
          [--late-fraction 0.15] [--device cpu]
"""
import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs.registry import scenario
from repro_torch.data.events import EventSimulator
from repro_torch.pipeline import (CursorStore, OnlineJoinConfig,
                                  PipelineDataSource, PrefetchLoader,
                                  ShardDataset, WatermarkJoiner,
                                  write_samples)
from repro_torch.scenario.build import (build_batcher_cfg, build_model,
                                        build_stream_cfg, cursor_fingerprint,
                                        shard_provenance)
from repro_torch.train.loop import Trainer, TrainLoopConfig
from repro_torch.train.optim import adam
from repro_torch.tree import leaves

N_REQUESTS = 600
REQUESTS_PER_SHARD = 128
SEED = 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--late-fraction", type=float, default=0.15)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    root = tempfile.mkdtemp(prefix="roo_pipeline_demo_")
    shard_dir = os.path.join(root, "shards")
    sources = []
    # on the CPU the loader's producer thread runs torch ops while a step
    # runs, and a parallel region entered from two threads at once may
    # split its sums otherwise than on the run it is compared with: one
    # intra-op thread keeps the CPU runs bit for bit
    threads = torch.get_num_threads()
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        return _run(args, device, root, shard_dir, sources)
    finally:
        torch.set_num_threads(threads)
        for src in sources:
            src.close()
        shutil.rmtree(root, ignore_errors=True)


def _run(args, device, root, shard_dir, sources) -> dict:
    # 0) one spec drives the whole demo: stream, join window, shard size,
    #    batcher shapes, model, and the provenance/cursor hashes
    spec = scenario("roo-lsr", {"data.source": "disk",
                                "data.n_requests": N_REQUESTS,
                                "data.late_fraction": args.late_fraction,
                                "data.requests_per_shard":
                                    REQUESTS_PER_SHARD})
    print(f"scenario {spec.name} ({spec.content_hash()}, "
          f"data hash {spec.data_hash()})")

    # 1) ingest: simulate a request log with a late-conversion tail and
    #    join it online under a bounded label wait
    events = EventSimulator(build_stream_cfg(spec)).stream()
    joiner = WatermarkJoiner(OnlineJoinConfig(
        label_wait_s=spec.data.label_wait_s))
    samples = joiner.join(events)
    st = joiner.stats
    print(f"join: {st.requests_emitted} requests, "
          f"{st.impressions_emitted} impressions, "
          f"label completeness {st.label_completeness:.3f} "
          f"({st.conversions_late} late conversions), "
          f"mean close lag {st.mean_close_lag_s:.0f}s")

    # 2) store: real columnar shard files with RO-payload dedup, stamped
    #    with the spec's provenance (scenario + data hash)
    manifest = write_samples(
        shard_dir, samples,
        requests_per_shard=spec.data.requests_per_shard,
        provenance=shard_provenance(spec))
    saved = sum(s.ro_dedup_saved for s in manifest.shards)
    print(f"store: {len(manifest.shards)} shard(s), "
          f"{manifest.n_bytes / 1e6:.2f} MB, "
          f"{saved} RO payload rows deduplicated")

    # 3) train from disk through the prefetching loader, checkpointing the
    #    cursor with the model state
    bundle = build_model(spec, torch.Generator().manual_seed(SEED),
                         device=device)
    bcfg = build_batcher_cfg(spec)
    every = max(args.steps // 3, 1)

    def make_trainer(ckpt_dir):
        return Trainer(bundle.loss_fn, adam(spec.train.lr_dense),
                       TrainLoopConfig(total_steps=args.steps,
                                       ckpt_every=every, log_every=every,
                                       ckpt_dir=ckpt_dir),
                       lambda: bundle.params, device=device)

    def make_source(cursor_dir, prefetch=True):
        src = PipelineDataSource(
            PrefetchLoader(ShardDataset(shard_dir, bcfg), prefetch=prefetch,
                           device=device),
            CursorStore(cursor_dir),
            fingerprint=cursor_fingerprint(spec, manifest))
        sources.append(src)
        return src

    src = make_source(os.path.join(root, "cur_full"))
    trainer = make_trainer(os.path.join(root, "ckpt_full"))
    full = trainer.run(src.batch_iter_fn, SEED,
                       on_checkpoint=src.on_checkpoint)
    print(f"train: uninterrupted run reached step {int(full['step'])}")

    # 4) kill-and-restart: stop mid-run, resume from the cursor
    kill_at = 2 * (args.steps // 3)
    src_a = make_source(os.path.join(root, "cur_pre"))
    make_trainer(os.path.join(root, "ckpt_pre")).run(
        src_a.batch_iter_fn, SEED, stop_after=kill_at,
        on_checkpoint=src_a.on_checkpoint)
    src_a.close()
    cursor_steps = CursorStore(os.path.join(root, "cur_pre")).steps()
    print(f"kill:  stopped after {kill_at} steps "
          f"(cursor store: steps {cursor_steps})")
    src_b = make_source(os.path.join(root, "cur_pre"))
    resumed = make_trainer(os.path.join(root, "ckpt_pre")).run(
        src_b.batch_iter_fn, SEED, on_checkpoint=src_b.on_checkpoint)

    same = all(torch.equal(a, b) for a, b in zip(leaves(full["params"]),
                                                 leaves(resumed["params"])))
    print(f"resume: reached step {int(resumed['step'])}; params "
          f"{'BIT-IDENTICAL to uninterrupted run' if same else 'DIVERGED'}")
    if not same:
        raise SystemExit(1)
    return {"spec_hash": spec.content_hash(), "data_hash": spec.data_hash(),
            "n_samples": len(samples), "join": {
                "requests_emitted": st.requests_emitted,
                "impressions_emitted": st.impressions_emitted,
                "label_completeness": st.label_completeness,
                "conversions_late": st.conversions_late},
            "n_shards": len(manifest.shards), "shard_bytes": manifest.n_bytes,
            "ro_dedup_saved": saved, "steps": args.steps, "kill_at": kill_at,
            "resumed_steps": int(resumed["step"]) - kill_at,
            "cursor_steps": cursor_steps, "same": same,
            "n_layers": len(bundle.params["hstu"]["layers"]),
            "losses": [h["loss"] for h in trainer.history],
            "history": list(trainer.history)}


if __name__ == "__main__":
    main()
