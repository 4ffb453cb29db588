"""The program under test, built from a configuration file through its
public entry points, and the inputs handed to it."""
from __future__ import annotations

from typing import Dict, List

import torch


def dlrm_config(cfg: dict):
    """The program's ``DLRMConfig``. Its ``top_mlp`` starts with the
    input's width (the program takes the interaction's width there), so it
    gets the yardstick's widths: the interaction's, then every published
    layer."""
    from repro_torch.models.dlrm import DLRMConfig
    from roobench import yardstick
    return DLRMConfig(n_dense=cfg["n_dense"], embed_dim=cfg["embed_dim"],
                      bot_mlp=tuple(cfg["bot_mlp"]),
                      top_mlp=tuple(yardstick.dlrm_top_dims(cfg)),
                      vocabs=tuple(cfg["vocabs"]),
                      n_ro_fields=cfg["n_ro_fields"],
                      multi_hot=cfg["multi_hot"])


def host_batches(pool: List[Dict], device) -> List[Dict[str, torch.Tensor]]:
    """The pool's arrays as host tensors, pinned when they go to a card."""
    pin = torch.device(device).type == "cuda"
    out = []
    for b in pool:
        t = {k: torch.from_numpy(v) for k, v in b.items() if k != "_info"}
        out.append({k: v.pin_memory() if pin else v for k, v in t.items()})
    return out


def to_device(batch: Dict[str, torch.Tensor], device) -> Dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def dlrm_forward(cfg, params, b):
    from repro_torch.models.dlrm import dlrm_forward_roo
    return dlrm_forward_roo(params, cfg, b["ro_dense"], b["ro_ids"],
                            b["ro_len"], b["nro_ids"], b["nro_len"], b["seg"])


def gr_spec(cfg: dict):
    """The hstu-gr scenario at the configuration's sizes and engine
    policy."""
    from repro_torch.configs.registry import scenario
    pol = cfg["engine"]
    return scenario("hstu-gr", {
        "model.n_items": cfg["n_items"], "model.hist_len": cfg["hist_len"],
        "model.m_targets": cfg["m_targets"],
        "batcher.hist_len": cfg["hist_len"],
        "serve.max_requests": pol["max_requests"],
        "serve.max_impressions": pol["max_impressions"],
        "serve.max_delay_ms": pol["max_delay_ms"],
        "serve.cache_user_tower": False, "serve.incremental": False})
