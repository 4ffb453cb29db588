"""End-to-end training on PyTorch: train a ~100M-parameter ROO LSR model for
a few hundred steps with checkpointing, preemption-safe resume, and NE
tracking. The port of ``examples/train_lsr_e2e.py``.

Run:  PYTHONPATH=src python examples/torch_train_lsr_e2e.py [--steps 300]
          [--ckpt-dir DIR] [--device cpu]

The model is embedding-dominated like production DLRMs: a 1.5M-row item
table + 64-dim embeddings + UserArch/HSTU -> ~100M params. Training uses
the mixed optimizer (row-wise Adagrad for tables, Adam for dense) and the
fault-tolerant Trainer (atomic async checkpoints; rerun the script after
killing it and it resumes from the last commit). On the card the HSTU
attention runs the hand-written kernels through ``HSTUAttentionFn``
(forward B1, backward B2 + B3).
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.core.hstu import HSTUConfig
from repro_torch.core.joiner import RequestLevelJoiner
from repro_torch.data.batcher import BatcherConfig, ROOBatcher
from repro_torch.data.events import EventSimulator, EventStreamConfig
from repro_torch.models.lsr import (LSRConfig, lsr_init, lsr_logits_roo,
                                    lsr_loss)
from repro_torch.train.loop import Trainer, TrainLoopConfig
from repro_torch.train.metrics import normalized_entropy
from repro_torch.train.optim import (adam, default_is_embedding, make_mixed,
                                     rowwise_adagrad)
from repro_torch.tree import leaves

N_ITEMS = 1_500_000
N_REQUESTS = 2500
N_USERS = 500
HIST_INIT_MAX = 48
ITEM_ZIPF = 0.85
B_RO, B_NRO, HIST_LEN = 32, 192, 64
CKPT_EVERY, LOG_EVERY = 100, 25
SEED = 0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "roo_lsr_torch_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = LSRConfig(n_items=N_ITEMS, mode="userarch_hstu",
                    hstu=HSTUConfig(d_model=64, n_heads=2, d_qk=32, d_v=32,
                                    n_layers=2, max_rel_pos=64))
    n_params = []

    def init_params():
        p = lsr_init(torch.Generator().manual_seed(SEED), cfg, device=device)
        n_params.append(sum(x.numel() for x in leaves(p)))
        print(f"params: {n_params[-1] / 1e6:.1f}M")
        return p

    # data: synthetic stream -> request-level join -> ROO batches
    # (Zipfian item popularity, as in production catalogs — the 1.5M-row
    # table stays mostly cold, exactly like real DLRM tables)
    events = list(EventSimulator(EventStreamConfig(
        n_requests=N_REQUESTS, n_items=N_ITEMS, n_users=N_USERS,
        hist_init_max=HIST_INIT_MAX, item_zipf=ITEM_ZIPF,
        seed=SEED)).stream())
    samples = RequestLevelJoiner().join(events)
    batcher = ROOBatcher(BatcherConfig(b_ro=B_RO, b_nro=B_NRO,
                                       hist_len=HIST_LEN), device=device)
    batches = list(batcher.batches(samples))
    train_b, test_b = batches[:-2], batches[-2:]
    print(f"{len(samples)} requests -> {len(batches)} batches")

    def batch_iter(start_step):
        def gen():
            i = start_step
            while True:
                yield train_b[i % len(train_b)]
                i += 1
        return gen()

    opt = make_mixed(adam(1e-3), rowwise_adagrad(0.05), default_is_embedding)
    trainer = Trainer(
        lambda p, b, g: lsr_loss(p, cfg, b), opt,
        TrainLoopConfig(total_steps=args.steps, ckpt_every=CKPT_EVERY,
                        log_every=LOG_EVERY, ckpt_dir=args.ckpt_dir),
        init_params, device=device)
    start = trainer.ckpt.latest_step() or 0

    sync(device)
    t0 = time.perf_counter()
    state = trainer.run(batch_iter, seed=SEED)
    sync(device)
    dt = time.perf_counter() - t0
    for h in trainer.history:
        print(f"  step {h['step']:4d}  loss={h['loss']:.4f}  "
              f"{h['steps_per_s']:.1f} steps/s")
    print(f"trained to step {int(state['step'])} in {dt:.1f}s")

    # NE on held-out batches
    nes = []
    with torch.no_grad():
        for b in test_b:
            logits = lsr_logits_roo(state["params"], cfg, b)[:, 0]
            w = b.impression_mask().to(torch.float32)
            nes.append(float(normalized_entropy(logits, b.labels[:, 0], w)))
    ne = sum(nes) / len(nes)
    print(f"held-out NE: {ne:.4f}")
    ran = int(state["step"]) - start
    return {"n_params": n_params[0] if n_params else None,
            "n_events": len(events), "n_samples": len(samples),
            "n_batches": len(batches), "n_test_batches": len(test_b),
            "batch_impressions": [int(b.num_valid_impressions())
                                  for b in batches],
            "n_layers": cfg.hstu.n_layers, "start_step": start,
            "steps": ran, "final_step": int(state["step"]),
            "train_s": dt, "steps_per_s": ran / dt if ran else 0.0,
            "history": list(trainer.history), "ne": ne,
            "losses": [h["loss"] for h in trainer.history]}


if __name__ == "__main__":
    main()
