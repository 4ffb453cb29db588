"""Quickstart on PyTorch: the whole ROO pipeline in one minute.

Events -> request-level join (Algorithm 1) -> ROO batches -> train the LSR
model (UserArch + HSTU) -> evaluate NE -> serve one request. The port of
``examples/quickstart.py``, step for step; on the card the HSTU attention
runs the hand-written kernels (forward B1, backward B2 + B3).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import roo_models as rm
from repro_torch.core.joiner import RequestLevelJoiner
from repro_torch.data.batcher import BatcherConfig, ROOBatcher
from repro_torch.data.events import EventSimulator, EventStreamConfig
from repro_torch.models.lsr import lsr_init, lsr_logits_roo, lsr_loss
from repro_torch.train.loop import value_and_grad
from repro_torch.train.metrics import normalized_entropy
from repro_torch.train.optim import adam

N_REQUESTS = 400
HIST_INIT_MAX = 40
B_RO, B_NRO, HIST_LEN = 32, 192, 64
EPOCHS = 3
SEED = 0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # 1. simulate the impression/feedback event stream (Fig. 1a)
    events = list(EventSimulator(EventStreamConfig(
        n_requests=N_REQUESTS, hist_init_max=HIST_INIT_MAX,
        seed=SEED)).stream())
    print(f"simulated {len(events)} events")

    # 2. request-level join (Algorithm 1): one sample per request
    samples = RequestLevelJoiner().join(events)
    n_imp = sum(s.num_impressions for s in samples)
    print(f"joined {len(samples)} ROO samples covering {n_imp} impressions "
          f"({n_imp / len(samples):.1f} impressions/request)")

    # 3. pack ROO mini-batches (B_RO=32 requests, B_NRO=192 impression slots)
    batcher = ROOBatcher(BatcherConfig(b_ro=B_RO, b_nro=B_NRO,
                                       hist_len=HIST_LEN), device=device)
    batches = list(batcher.batches(samples))
    print(f"packed {len(batches)} ROO batches")

    # 4. train the paper's LSR architecture (UserArch + HSTU) for a few steps
    cfg = rm.lsr_config("userarch_hstu")
    params = lsr_init(torch.Generator().manual_seed(SEED), cfg,
                      device=device)
    opt = adam(1e-3)
    opt_state = opt.init(params)
    vag = value_and_grad(lambda p, b, g: lsr_loss(p, cfg, b))

    def step(params, opt_state, batch):
        loss, grads = vag(params, batch, None)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    losses = []
    sync(device)
    t0 = time.perf_counter()
    for epoch in range(EPOCHS):
        for batch in batches[:-1]:
            params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        print(f"epoch {epoch}: loss={losses[-1]:.4f}")
    sync(device)
    train_s = time.perf_counter() - t0
    n_steps = EPOCHS * (len(batches) - 1)

    with torch.no_grad():
        # 5. evaluate NE on the held-out batch
        test = batches[-1]
        logits = lsr_logits_roo(params, cfg, test)[:, 0]
        w = test.impression_mask().to(torch.float32)
        ne = float(normalized_entropy(logits, test.labels[:, 0], w))
        print(f"held-out NE = {ne:.4f}  (<1.0 beats base-rate predictor)")

        # 6. serve: score one request's candidates with the SAME forward
        one = batches[0]
        scores = lsr_logits_roo(params, cfg, one)[:, 0]
        first = scores[one.segment_ids == 0].cpu()
    print(f"request 0 candidate scores: "
          f"{[round(float(s), 3) for s in first]}")
    return {"n_events": len(events), "n_samples": len(samples),
            "n_impressions": n_imp, "n_batches": len(batches),
            "batch_impressions": [int(b.num_valid_impressions())
                                  for b in batches],
            "n_layers": len(params["hstu"]["layers"]), "steps": n_steps,
            "epoch_losses": losses, "train_s": train_s,
            "steps_per_s": n_steps / train_s, "ne": ne,
            "request0_scores": first.tolist()}


if __name__ == "__main__":
    main()
