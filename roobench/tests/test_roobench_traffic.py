"""The traffic generator is deterministic in the seed and follows the laws
its files name."""
import math

import numpy as np
import pytest
import roobench_tiny as tiny

from roobench import inputs
from roobench import traffic as T

SEED = 2 ** 31 + 12345          # above 32 signed bits, as the driver's are


def test_same_seed_same_draws_other_seed_other_order():
    law, n = {"law": "zipf", "s": 1.05}, 10 ** 6

    def ids(seed):
        g = T.rng(seed, 1)
        return T.zipf_ids(law, g, 5000, n, T.affine_permutation(g, n))
    a, b, c = ids(SEED), ids(SEED), ids(SEED + 1)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < n


def test_uniform_int_stratified():
    law = {"law": "uniform_int", "lo": 1, "hi": 7}
    x = T.draw(law, T.rng(SEED), 7000)
    assert x.min() == 1 and x.max() == 7
    # stratified: each value exactly n / 7 times, whatever the seed
    assert np.array_equal(np.bincount(x)[1:], np.full(7, 1000))
    y = T.draw(law, T.rng(SEED + 9), 7000)
    assert np.array_equal(np.sort(x), np.sort(y))


def test_log_uniform_quantiles():
    law = {"law": "log_uniform_int", "lo": 256, "hi": 16384}
    x = T.draw(law, T.rng(SEED), 30000)
    assert x.min() >= 256 and x.max() <= 16384
    # a third of the mass lies above 4,096 (log 16 / log 64 = 2/3 below)
    assert abs(np.mean(x >= 4096) - 1 / 3) < 0.01
    assert abs(np.median(x) - 2048) / 2048 < 0.02


def test_zipf_rank_frequencies():
    n, s = 1000, 1.05
    ranks = T.zipf_ranks(T.stratified_uniform(T.rng(SEED), 200000), n, s)
    assert ranks.min() >= 0 and ranks.max() < n
    # the continuous law's mass of rank r is H(r + 2) - H(r + 1)
    h = lambda x: (x ** (1 - s) - 1) / (1 - s)      # noqa: E731
    want = [(h(r + 2) - h(r + 1)) / h(n + 1) for r in (0, 1, 9)]
    got = [np.mean(ranks == r) for r in (0, 1, 9)]
    for w, g in zip(want, got):
        assert abs(g - w) < 0.01 * w + 1e-3
    # power law: rank 0 about 10^s times as frequent as rank 9 (bin width)
    assert 5 < got[0] / got[2] < 15


def test_affine_permutation_is_a_bijection():
    a, b = T.affine_permutation(T.rng(SEED), 1000)
    assert math.gcd(a, 1000) == 1
    assert len(set(((a * np.arange(1000) + b) % 1000).tolist())) == 1000


def test_poisson_rate():
    due = T.draw({"law": "poisson", "rate_per_s": 500.0}, T.rng(SEED), 5000)
    assert np.all(np.diff(due) >= 0)
    assert abs(due[-1] - 10.0) < 0.1


@pytest.mark.parametrize("slots", [256, 65536])
def test_request_sizes_fill_the_slots(slots):
    law = {"law": "uniform_int", "lo": 1, "hi": 7}
    sizes = T.request_sizes(law, T.rng(SEED), slots)
    assert sizes.sum() == slots and sizes.min() >= 1 and sizes.max() <= 7
    other = T.request_sizes(law, T.rng(SEED + 1), slots)
    assert abs(len(sizes) - len(other)) <= 2


def test_dlrm_pool_deterministic_and_in_range():
    cfg, tr = tiny.dlrm(), tiny.traffic("dlrm-train-zipf")
    a = inputs.dlrm_pool(SEED, cfg, tr)
    b = inputs.dlrm_pool(SEED, cfg, tr)
    assert len(a) == tr["pool_batches"]
    for x, y in zip(a, b):
        for k in ("ro_ids", "nro_ids", "seg", "y", "ro_dense"):
            assert np.array_equal(x[k], y[k])
        assert x["nro_ids"].shape[0] == tr["impressions_per_step"]
        assert x["seg"].max() == x["ro_ids"].shape[0] - 1
        n_ro = cfg["n_ro_fields"]
        for f, v in enumerate(cfg["vocabs"]):
            ids = inputs.field_ids(x, cfg, f)
            assert ids.min() >= 0 and ids.max() < v, f
    assert not np.array_equal(a[0]["nro_ids"],
                              inputs.dlrm_pool(SEED + 1, cfg, tr)[0]["nro_ids"])
    assert n_ro == 13


def test_gr_traffic_deterministic_and_windowed():
    cfg, tr = tiny.gr(), tiny.serve_traffic()
    a = inputs.GRTraffic(SEED, cfg, tr, 200, 100.0)
    b = inputs.GRTraffic(SEED, cfg, tr, 200, 100.0)
    assert a.hist_ids == b.hist_ids and a.item_ids == b.item_ids
    assert np.array_equal(a.due, b.due)
    assert max(len(h) for h in a.hist_ids) <= cfg["hist_len"]
    assert all(1 <= len(t) <= 16 for t in a.item_ids)
    assert all(0 <= x < cfg["n_items"] for t in a.item_ids for x in t)
    s = a.sample(3, 77)
    assert s.user_id == 77 and s.num_impressions == len(a.item_ids[3])
