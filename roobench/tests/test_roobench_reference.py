"""The plain references against hand counts at tiny sizes, and against the
program run on the CPU on the same weights (the program is imported here,
in the test, never by the reference)."""
import math

import numpy as np
import pytest
import roobench_tiny as tiny
import torch

from roobench import inputs, weights
from roobench.reference import dlrm as rd
from roobench.reference import hstu_gr as rg

D64 = torch.float64


def small_dlrm():
    g = torch.Generator().manual_seed(0)
    tabs = [torch.randn(5, 2, generator=g, dtype=D64) for _ in range(3)]
    bot = [(torch.randn(2, 2, generator=g, dtype=D64),
            torch.randn(2, generator=g, dtype=D64))]
    top = [(torch.randn(8, 1, generator=g, dtype=D64),
            torch.randn(1, generator=g, dtype=D64))]
    return {"tables": tabs, "bot": bot, "top": top}


def test_dlrm_logits_by_hand():
    p = small_dlrm()
    cfg = {"n_ro_fields": 1}
    b = {"ro_dense": torch.tensor([[1.0, -2.0], [0.5, 0.25]], dtype=D64),
         "ro_ids": torch.tensor([[[1, 3]], [[4, 0]]]),
         "ro_len": torch.tensor([[2], [1]]),
         "nro_ids": torch.tensor([[[0], [2]], [[1], [1]], [[4], [3]]]),
         "nro_len": torch.tensor([[1, 1], [1, 0], [1, 1]]),
         "seg": torch.tensor([0, 1, 1])}
    got = rd.logits(p, cfg, b)
    t = [x.numpy() for x in p["tables"]]
    w0, b0 = (x.numpy() for x in p["bot"][0])
    w1, b1 = (x.numpy() for x in p["top"][0])
    for i, r in enumerate((0, 1, 1)):
        dense = b["ro_dense"][r].numpy() @ w0 + b0       # one layer: no ReLU
        ro = sum(t[0][b["ro_ids"][r, 0, k]] for k in range(
            int(b["ro_len"][r, 0])))
        nro = [sum((t[1 + f][b["nro_ids"][i, f, 0]]
                    for _ in range(int(b["nro_len"][i, f]))),
                   np.zeros(2)) for f in range(2)]
        rows = [dense, ro] + nro
        pairs = [rows[a] @ rows[c] for a in range(4) for c in range(a)]
        z = np.concatenate([dense, pairs])
        assert got[i].item() == pytest.approx(float(z @ w1[:, 0] + b1[0]),
                                              rel=1e-12)


def test_bce_by_hand():
    x = torch.tensor([-3.0, 0.0, 2.5], dtype=D64)
    y = torch.tensor([1.0, 0.0, 0.0], dtype=D64)
    want = np.mean([math.log1p(math.exp(3.0)), math.log(2.0),
                    math.log1p(math.exp(2.5))])
    assert rd.bce(x, y).item() == pytest.approx(want, rel=1e-12)


def test_one_step_of_each_optimizer_by_hand():
    p = small_dlrm()
    cfg = {"n_ro_fields": 1}
    b = {"ro_dense": torch.ones(1, 2, dtype=D64),
         "ro_ids": torch.tensor([[[2]]]), "ro_len": torch.tensor([[1]]),
         "nro_ids": torch.tensor([[[1], [4]]]),
         "nro_len": torch.tensor([[1, 1]]), "seg": torch.tensor([0]),
         "y": torch.tensor([1.0], dtype=D64)}
    opt = {"adam": {"lr": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8},
           "rowwise_adagrad": {"lr": 0.05, "eps": 1e-8}}
    r = rd.train(p, cfg, [b], opt)
    # Adam's first step moves each element by lr * |g| / (|g| + eps)
    w = p["bot"][0][0]
    assert r["change"]["bot_mlp/layers/0/w"] == pytest.approx(
        1e-3 * math.sqrt(w.numel()), rel=1e-4)
    # row-wise Adagrad's first step moves a touched row by
    # lr * g / sqrt(mean(g^2)): a norm of lr * sqrt(D), one row here
    assert r["change"]["tables/t1"] == pytest.approx(0.05 * math.sqrt(2),
                                                     rel=1e-6)
    assert r["grad_norms"]["tables/t1"] > 0
    assert len(r["losses"]) == 1


def test_hstu_attention_by_hand():
    """Two history events, one target, one head of width 1."""
    q = torch.tensor([[1.0], [2.0], [0.5]], dtype=D64)
    k = torch.tensor([[0.5], [-1.0], [1.0]], dtype=D64)
    v = torch.tensor([[1.0], [10.0], [100.0]], dtype=D64)
    rab = torch.tensor([0.1, 0.2, 0.3, 0.4, 0.5], dtype=D64)   # max_rel 2
    pos = torch.tensor([0, 1, 4])          # hist_len 4: the target at slot 4
    is_hist = pos < 4
    got = rg.attention(q, k, v, rab, pos, is_hist, n_slots=5, max_rel=2)
    silu = lambda x: x / (1 + math.exp(-x))      # noqa: E731

    def a(i, j):
        d = max(-2, min(2, int(pos[i] - pos[j]))) + 2
        return silu(q[i, 0].item() * k[j, 0].item() + rab[d].item()) / 5
    want = [a(0, 0) * 1.0,                            # sees itself
            a(1, 0) * 1.0 + a(1, 1) * 10.0,           # causal history
            a(2, 0) * 1.0 + a(2, 1) * 10.0 + a(2, 2) * 100.0]  # all + self
    assert got[:, 0].tolist() == pytest.approx(want, rel=1e-12)


def test_gr_reference_matches_the_program_on_cpu():
    from repro_torch.serve.engine import ScoringEngine
    from roobench import programs
    cfg = tiny.gr()
    w = weights.gr(5, cfg, "cpu")
    reqs = inputs.GRTraffic(5, cfg, tiny.serve_traffic(), 12,
                            100.0)
    engine = ScoringEngine.from_scenario(programs.gr_spec(cfg), params=w,
                                         device="cpu")
    got = engine.score_requests([reqs.sample(i, i) for i in range(12)])
    for i in range(12):
        p = reqs.pool_of[i]
        want = rg.request_logits(w, cfg, reqs.hist_ids[p],
                                 reqs.hist_acts[p], reqs.item_ids[i])
        assert np.allclose(got[i], want.numpy(), rtol=1e-4, atol=1e-5)


def test_dlrm_reference_matches_the_program_on_cpu():
    from roobench import programs
    cfg = tiny.dlrm()
    w = weights.dlrm(5, cfg, "cpu")
    b = inputs.dlrm_pool(5, cfg, tiny.traffic("dlrm-score-bulk"))[0]
    t = {k: torch.from_numpy(v) for k, v in b.items() if k != "_info"}
    got = programs.dlrm_forward(programs.dlrm_config(cfg), w, t)
    p = {"tables": [w["tables"][f"t{f}"] for f in range(len(cfg["vocabs"]))],
         "bot": [(x["w"], x["b"]) for x in w["bot_mlp"]["layers"]],
         "top": [(x["w"], x["b"]) for x in w["top_mlp"]["layers"]]}
    want = rd.logits(p, cfg, t)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
