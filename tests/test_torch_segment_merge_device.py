"""The segmented merge on a CUDA card, at the shapes of the dlrm training
cell's sparse-row merges, with Zipf 1.05 ids: the impression side's 65,536
ids into a 108-row table (+ the sentinel) and into the gathered rows of a
108-row and a 10 M-row table, the request side's 16,384 ids, and bf16 rows
2,048 wide. Three calls give the same bits, equal the plain version's bit
for bit and lie within 1e-5 of the float64 scatter. A sparse-row dlrm step
takes the kernel for every merge past 3,072 ids and ``index_put_`` for
none.

Every test here is marked ``chip`` and skips without a card. The file
imports no JAX, so it runs on the card as

    PYTHONPATH=src python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_segment_merge_device.py -m chip
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.embeddings.sparse import SparseRows, gather_table
from repro_torch.kernels import segment_merge as sm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_state import port_state  # noqa: E402,F401

TOL = 1e-5            # of the largest |sum|, against the float64 scatter


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def zipf_ids(n, vocab, seed, s=1.05):
    """n ids of a bounded Zipf law over 0..vocab-1 (the benchmark's
    inverse, with plain uniform draws), ranks scattered affinely."""
    u = np.random.default_rng(seed).random(n)
    h = ((vocab + 1.0) ** (1.0 - s) - 1.0) / (1.0 - s)
    x = (1.0 + (1.0 - s) * u * h) ** (1.0 / (1.0 - s))
    ranks = np.clip(np.floor(x).astype(np.int64) - 1, 0, vocab - 1)
    return torch.from_numpy((7919 * ranks + 13) % vocab)


def cases(device):
    """(label, ids, rows, vocab): the merges of the cell's step."""
    gen = torch.Generator(device=device).manual_seed(35)
    out = []
    for label, n, vocab, w, dtype in (
            ("impression side, a 108-row table's gathered rows", 65_536,
             108, 128, torch.float32),
            ("impression side, a 10 M-row table's gathered rows", 65_536,
             9_995_264, 128, torch.float32),
            ("request side, a 10 M-row table's gathered rows", 16_384,
             9_971_200, 128, torch.float32),
            ("bf16 rows 2,048 wide, a 32,000-row table's gathered rows",
             16_384, 32_000, 2048, torch.bfloat16)):
        ids = zipf_ids(n, vocab, n + vocab).to(device)
        pos, _ = gather_table(torch.zeros((vocab, 1), device=device),
                              ids).positions(ids)
        rows = torch.randn((n, w), generator=gen, device=device).to(dtype)
        out.append((label, pos, rows, n + 1))
    ids = zipf_ids(65_536, 109, 108).to(device)        # 108: the sentinel
    rows = torch.randn((65_536, 128), generator=gen, device=device)
    out.append(("impression side, 108 rows + the sentinel",
                ids.to(torch.int32), rows, 108))
    return out


@pytest.mark.chip
def test_merge_is_bitwise_and_near_float64(cuda_card):
    for label, ids, rows, vocab in cases(cuda_card):
        sm.reset_launch_count()
        got = [SparseRows(ids, rows, vocab).to_dense() for _ in range(3)]
        assert sm.launch_count == 3, label
        assert all(torch.equal(got[0], g) for g in got[1:]), label
        plain = sm.segment_merge_plain(ids, rows, vocab)
        assert torch.equal(got[0], plain), label
        keep = ids.long() < vocab
        want = torch.zeros((vocab, rows.shape[1]), dtype=torch.float64,
                           device=cuda_card).index_add_(
            0, ids.long()[keep], rows[keep].double())
        err = float((got[0].double() - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        # bf16 rows: the fp32 sum is rounded once to bf16
        rounding = 2.0 ** -8 if rows.dtype == torch.bfloat16 else 0.0
        runs = torch.bincount(ids.long()[keep])
        print(f"{label}: n {ids.numel()}, longest run "
              f"{int(runs.max())}, max|diff| from float64 {err:.3e} "
              f"(scale {scale:.1f})")
        assert err <= (TOL + rounding) * scale, label


@pytest.mark.chip
def test_sparse_dlrm_step_takes_the_kernel(cuda_card):
    """A sparse-row dlrm step (8,192 impressions: the NRO side's gathered
    merges take 8,192 ids) launches the kernel, its spans past 3,072 ids
    say ``segment``, and none says ``index_put``."""
    from repro_torch.configs.registry import scenario
    from repro_torch.embeddings.sparse import (FIXED_ORDER_MAX_IDS,
                                               make_sparse_value_and_grad)
    from repro_torch.models import dlrm
    from repro_torch.scenario.build import synthetic_dlrm_batches
    from repro_torch.train import metrics

    cfg = dlrm.DLRMConfig(n_dense=13, embed_dim=64, bot_mlp=(13, 128, 64),
                          top_mlp=(256, 128, 1),
                          vocabs=(4096, 100_000, 50, 100_000),
                          n_ro_fields=2, multi_hot=1)
    spec = scenario("dlrm-mlperf", {"data.seed": 0, "batcher.b_ro": 1024,
                                    "batcher.b_nro": 8192})
    (batch,) = synthetic_dlrm_batches(spec, cfg, 1, "cuda")
    params = dlrm.dlrm_init(torch.Generator("cuda").manual_seed(0), cfg,
                            device="cuda")

    def loss(p, b, g):
        return metrics.bce(dlrm.dlrm_forward_roo(
            p, cfg, b["ro_dense"], b["ro_ids"], b["ro_len"], b["nro_ids"],
            b["nro_len"], b["seg"]), b["y"])
    vag = make_sparse_value_and_grad(
        loss, lambda b: dlrm.dlrm_table_ids(cfg, b["ro_ids"], b["nro_ids"]))
    obs_metrics.OBS_KNOB.set_default("trace")
    sm.reset_launch_count()
    vag(params, batch, None)
    torch.cuda.synchronize()
    spans = [e for e in obs_trace.get_tracer().events()
             if e["name"] == "sparse.to_dense"]
    routes = sorted({(s["args"]["route"],
                      s["args"]["n_ids"] > FIXED_ORDER_MAX_IDS)
                     for s in spans})
    print(f"to_dense routes (route, past 3,072 ids): {routes}; kernel "
          f"calls {sm.launch_count}")
    big = [s["args"]["route"] for s in spans
           if s["args"]["n_ids"] > FIXED_ORDER_MAX_IDS]
    assert sm.launch_count > 0 and big and set(big) <= {"segment",
                                                        "one_hot"}
    assert "segment" in big
    assert all(s["args"]["route"] != "index_put" for s in spans)
