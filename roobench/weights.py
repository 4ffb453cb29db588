"""The benchmark's own weights, made on the device from ``--seed``, in the
parameter layout the program takes. Both sides get these same tensors.

Tables come from one draw into one buffer, each table a row slice of it.
Every bias and normalisation parameter is drawn too (not zeros and ones),
so the comparison sees a program that drops one.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def seed_of(seed: int, *keys: int) -> int:
    """A 63-bit generator seed for (seed, *keys)."""
    return int(np.random.SeedSequence([int(seed), *keys]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, key: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, key))


def _normal(g, shape, std, device, mean=0.0):
    t = torch.empty(shape, device=device)
    return t.normal_(mean, std, generator=g)


def mlp(g, dims: Sequence[int], device, bias_std: float) -> Dict:
    """Glorot-normal weights ``(in, out)`` and N(0, bias_std^2) biases."""
    return {"layers": [
        {"w": _normal(g, (a, b), (2.0 / (a + b)) ** 0.5, device),
         "b": _normal(g, (b,), bias_std, device)}
        for a, b in zip(dims[:-1], dims[1:])]}


def dlrm(seed: int, cfg: dict, device) -> Dict:
    """``{tables: {t0..}, bot_mlp, top_mlp}``: tables N(0, 0.01^2)."""
    from roobench import yardstick
    g = generator(seed, 1, device)
    rows = cfg["vocabs"]
    buf = _normal(g, (sum(rows), cfg["embed_dim"]), cfg["table_std"], device)
    tables, at = {}, 0
    for i, r in enumerate(rows):
        tables[f"t{i}"] = buf[at:at + r]
        at += r
    return {"tables": tables,
            "bot_mlp": mlp(g, cfg["bot_mlp"], device, 0.01),
            "top_mlp": mlp(g, yardstick.dlrm_top_dims(cfg), device, 0.01)}


def gr(seed: int, cfg: dict, device) -> Dict:
    """hstu-gr ranking: item and action embeddings N(0, 0.02^2), the HSTU
    layers, the task head."""
    g = generator(seed, 2, device)
    d, h, dqk, dv = cfg["d_model"], cfg["n_heads"], cfg["d_qk"], cfg["d_v"]
    width = h * (2 * dv + 2 * dqk)
    layers = []
    for _ in range(cfg["n_layers"]):
        layers.append({
            "w_uvqk": _normal(g, (d, width), (2.0 / (d + width)) ** 0.5,
                              device),
            "b_uvqk": _normal(g, (width,), 0.02, device),
            "w_o": _normal(g, (h * dv, d), (2.0 / (h * dv + d)) ** 0.5,
                           device),
            "ln_scale": _normal(g, (h * dv,), 0.02, device, mean=1.0),
            "ln_bias": _normal(g, (h * dv,), 0.02, device),
            "rab": _normal(g, (h, 2 * cfg["max_rel_pos"] + 1), 0.02,
                           device)})
    return {
        "item_emb": _normal(g, (cfg["n_items"], d), 0.02, device),
        "act_emb": _normal(g, (cfg["n_actions"], d), 0.02, device),
        "hstu": {"layers": layers,
                 "in_ln_scale": _normal(g, (d,), 0.02, device, mean=1.0),
                 "in_ln_bias": _normal(g, (d,), 0.02, device)},
        "task_head": mlp(g, (d, 2 * d, cfg["n_tasks"]), device, 0.02)}
