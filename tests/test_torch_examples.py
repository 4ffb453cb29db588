"""The port's examples (``examples/torch_*.py``) on the CPU, at small sizes.

Each example's ``main(argv)`` runs with ``--device cpu`` (and ``--steps``
2-4 where it takes one), its module-level sizes shrunk with
``monkeypatch``. What it returns is held against the reference's own data
path on the same sizes, computed here (the reference's examples train, so
they are not run):

  * quickstart: events, samples, impressions and every batch's impression
    count equal; finite epoch losses; a finite NE;
  * train_lsr_e2e: the same counts, the parameter count of the reference's
    ``lsr_init`` at the same config, finite losses and NE; a second run on
    the same checkpoint directory resumes at the last commit;
  * serve_roo: the spec's content hash, the requests and their candidate
    counts equal; scores aligned 1:1, finite, equal on the cache pass; the
    online path's five requests; the 1-vs-N top-k;
  * pipeline_e2e: the spec's hashes, the join's counts, the shards' count
    and bytes and the RO
    payload rows deduplicated equal; the resumed run bit for bit;
  * storage_analysis: its stdout equals the reference example's, line for
    line (that example imports no JAX model).
"""
import importlib.util
import io
import math
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_state import port_state  # noqa: E402,F401

from repro.configs.registry import scenario as ref_scenario  # noqa: E402
from repro.core.joiner import RequestLevelJoiner  # noqa: E402
from repro.data.batcher import BatcherConfig, ROOBatcher  # noqa: E402
from repro.data.events import EventSimulator, EventStreamConfig  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name: str):
    """A fresh module object of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_batches(stream_cfg, b_ro, b_nro, hist_len):
    events = list(EventSimulator(stream_cfg).stream())
    samples = RequestLevelJoiner().join(events)
    batches = list(ROOBatcher(BatcherConfig(
        b_ro=b_ro, b_nro=b_nro, hist_len=hist_len)).batches(samples))
    return events, samples, batches


def finite(xs) -> bool:
    return all(math.isfinite(x) for x in xs)


def test_quickstart(monkeypatch):
    ex = load("torch_quickstart")
    monkeypatch.setattr(ex, "N_REQUESTS", 90)
    monkeypatch.setattr(ex, "EPOCHS", 2)
    out = ex.main(["--device", "cpu"])
    events, samples, batches = ref_batches(EventStreamConfig(
        n_requests=90, hist_init_max=ex.HIST_INIT_MAX, seed=ex.SEED),
        ex.B_RO, ex.B_NRO, ex.HIST_LEN)
    assert out["n_events"] == len(events)
    assert out["n_samples"] == len(samples)
    assert out["n_impressions"] == sum(s.num_impressions for s in samples)
    assert out["batch_impressions"] == [int(b.num_valid_impressions())
                                        for b in batches]
    assert out["steps"] == 2 * (len(batches) - 1)
    assert len(out["epoch_losses"]) == 2 and finite(out["epoch_losses"])
    assert math.isfinite(out["ne"]) and finite(out["request0_scores"])
    assert len(out["request0_scores"]) == samples[0].num_impressions


def test_train_lsr_e2e_and_resume(monkeypatch, tmp_path):
    from repro.core.hstu import HSTUConfig
    from repro.models.lsr import LSRConfig, lsr_init
    ex = load("torch_train_lsr_e2e")
    for name, value in (("N_ITEMS", 3000), ("N_REQUESTS", 150),
                        ("CKPT_EVERY", 2), ("LOG_EVERY", 1)):
        monkeypatch.setattr(ex, name, value)
    ckpt = str(tmp_path / "ckpt")
    out = ex.main(["--steps", "3", "--ckpt-dir", ckpt, "--device", "cpu"])
    events, samples, batches = ref_batches(EventStreamConfig(
        n_requests=150, n_items=3000, n_users=ex.N_USERS,
        hist_init_max=ex.HIST_INIT_MAX, item_zipf=ex.ITEM_ZIPF,
        seed=ex.SEED), ex.B_RO, ex.B_NRO, ex.HIST_LEN)
    assert out["n_events"] == len(events)
    assert out["n_samples"] == len(samples)
    assert out["batch_impressions"] == [int(b.num_valid_impressions())
                                        for b in batches]
    cfg = LSRConfig(n_items=3000, mode="userarch_hstu",
                    hstu=HSTUConfig(d_model=64, n_heads=2, d_qk=32, d_v=32,
                                    n_layers=2, max_rel_pos=64))
    shapes = jax.eval_shape(lambda: lsr_init(jax.random.PRNGKey(0), cfg))
    assert out["n_params"] == sum(int(np.prod(x.shape))
                                  for x in jax.tree.leaves(shapes))
    assert (out["start_step"], out["steps"], out["final_step"]) == (0, 3, 3)
    assert len(out["losses"]) == 3 and finite(out["losses"])
    assert math.isfinite(out["ne"])
    # a second run on the same directory resumes at the last commit (2)
    again = ex.main(["--steps", "4", "--ckpt-dir", ckpt, "--device", "cpu"])
    assert (again["start_step"], again["steps"], again["final_step"]) == (
        2, 2, 4)
    assert again["n_params"] is None       # restored, not initialized
    assert finite(again["losses"]) and math.isfinite(again["ne"])


def test_serve_roo(monkeypatch):
    from repro.scenario.build import build_samples
    ex = load("torch_serve_roo")
    monkeypatch.setattr(ex, "N_CANDIDATES", 20_000)
    out = ex.main(["--device", "cpu"])
    spec = ref_scenario("roo-lsr", ex.LSR_OVERRIDES)
    requests = build_samples(spec)
    assert out["spec_hash"] == spec.content_hash()
    assert out["n_requests"] == len(requests)
    assert out["n_candidates"] == sum(r.num_impressions for r in requests)
    for r, s, s2 in zip(requests, out["scores"], out["repeat_scores"]):
        assert s.shape[0] == r.num_impressions and np.isfinite(s).all()
        np.testing.assert_allclose(s2, s, rtol=1e-5, atol=1e-5)
    for r, s, want in zip(requests, out["online"], out["scores"]):
        np.testing.assert_allclose(s, want, rtol=1e-5, atol=1e-5)
    assert len(out["online"]) == ex.N_ONLINE
    stats = out["stats"]
    assert stats["n_full_cache_batches"] >= out["first_pass_batches"]
    assert out["cache_hit_rate"] > 0
    top = out["top_scores"].numpy()
    assert top.shape == (ex.TOP_K,) and np.all(np.diff(top) <= 0)
    assert out["top_idx"].max() < 20_000


def test_pipeline_e2e_resumes_bit_for_bit(monkeypatch, tmp_path):
    from repro.data.events import EventSimulator as RefSim
    from repro.pipeline import OnlineJoinConfig, WatermarkJoiner, \
        write_samples
    from repro.scenario.build import build_stream_cfg, shard_provenance
    ex = load("torch_pipeline_e2e")
    monkeypatch.setattr(ex, "N_REQUESTS", 300)
    monkeypatch.setattr(ex, "REQUESTS_PER_SHARD", 64)
    out = ex.main(["--steps", "3", "--late-fraction", "0.2",
                   "--device", "cpu"])
    spec = ref_scenario("roo-lsr", {"data.source": "disk",
                                    "data.n_requests": 300,
                                    "data.late_fraction": 0.2,
                                    "data.requests_per_shard": 64})
    joiner = WatermarkJoiner(OnlineJoinConfig(
        label_wait_s=spec.data.label_wait_s))
    samples = joiner.join(RefSim(build_stream_cfg(spec)).stream())
    st = joiner.stats
    assert (out["spec_hash"], out["data_hash"]) == (spec.content_hash(),
                                                    spec.data_hash())
    assert out["n_samples"] == len(samples)
    assert out["join"] == {
        "requests_emitted": st.requests_emitted,
        "impressions_emitted": st.impressions_emitted,
        "label_completeness": st.label_completeness,
        "conversions_late": st.conversions_late}
    manifest = write_samples(str(tmp_path / "ref"), samples,
                             requests_per_shard=64,
                             provenance=shard_provenance(spec))
    assert out["n_shards"] == len(manifest.shards)
    assert out["shard_bytes"] == manifest.n_bytes
    assert out["ro_dedup_saved"] == sum(s.ro_dedup_saved
                                        for s in manifest.shards)
    assert out["same"] and out["kill_at"] == 2 and out["resumed_steps"] == 1
    assert out["cursor_steps"] == [1, 2]
    assert finite(out["losses"])


def test_storage_analysis_prints_the_reference_table():
    ref, port = load("storage_analysis"), load("torch_storage_analysis")
    want, got = io.StringIO(), io.StringIO()
    with redirect_stdout(want):
        ref.main()
    with redirect_stdout(got):
        out = port.main(["--device", "cpu"])
    assert got.getvalue().splitlines() == want.getvalue().splitlines()
    assert len(want.getvalue().splitlines()) == 12
    assert out["columns"]["total"][0] > out["columns"]["total"][1]


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_roo",
                                  "torch_train_lsr_e2e",
                                  "torch_pipeline_e2e",
                                  "torch_storage_analysis"])
def test_flags_are_the_references(name):
    """``--device`` (default cuda) and the reference's own flags only."""
    import argparse
    ex = load(name)
    seen = {}

    class Stop(Exception):
        pass

    def fake_parse(self, argv=None, namespace=None):
        seen.update({a.dest: a.default for a in self._actions
                     if a.dest != "help"})
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", fake_parse)
        with pytest.raises(Stop):
            ex.main([])
    ref_flags = {"torch_train_lsr_e2e": {"steps", "ckpt_dir"},
                 "torch_pipeline_e2e": {"steps", "late_fraction"}}
    assert set(seen) == {"device"} | ref_flags.get(name, set())
    assert seen["device"] == "cuda"
    if "steps" in seen:
        assert seen["steps"] == {"torch_train_lsr_e2e": 300,
                                 "torch_pipeline_e2e": 60}[name]
