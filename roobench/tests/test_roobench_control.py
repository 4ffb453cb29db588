"""On the card: each cell's control, the plain reference computed in TF32 in
the program's place, fails the cell's limits, while the program passes
them; and the training cell's planted half-batch fault fails too. At cut
sizes a test run holds (tables capped, fewer impressions, a shorter
window); ``roobench.control`` reads the same numbers at the cells' own
sizes, which set the limits."""
import time

import pytest

from roobench import harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


BENCH = harness.load_bench()


def cut(cell):
    _, cfg, tr = harness.resolve(BENCH, cell)
    cfg["vocabs"] = [min(v, 1 << 18) for v in cfg["vocabs"]]
    tr.update(impressions_per_step=8192, pool_batches=4)
    return cfg, tr


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_where_the_program_passes(chip, cell, seed):
    cfg, tr = cut(cell)
    _, _, out = harness.execute(cell, seed, 1.0, False, device="cuda",
                                t_start=time.perf_counter(), config=cfg,
                                traffic=tr)
    assert all(c.ok for c in out.checks), out.checks
    limits = {c.name: c.limit for c in out.checks}
    low = out.variants("tf32")
    assert any(v > limits[k] for k, v in low.items()), low
    if cell == "dlrm-train-zipf":
        half = out.variants("half_batch")
        assert any(v > limits[k] for k, v in half.items()), half
