"""The port's scenario layer held against the reference's
(``repro/scenario``, ``repro/configs/registry.py``):

  * every registered scenario's JSON bytes, ``content_hash`` and
    ``data_hash`` equal across packages, and a spec written by either
    package loads in the other;
  * the reference's strict validation cases (``tests/test_scenario.py``)
    on the port's spec, plus the port's own knob choices (a spec pinning
    the reference-only ``pallas`` is rejected, naming the port's);
  * ``with_overrides`` / ``parse_set_args`` coercion, equal to the
    reference's under the same overrides;
  * ``build_samples`` and the provenance dicts equal to the reference's;
  * for each of the eight archs, ``build_model`` with the reference's
    params carried across (``interop``): the loss on the same batch, three
    ``train_from_scenario`` steps (through ``_train_from_scenario``'s
    ``bundle`` seam) and, for the seven servable archs,
    ``engine_from_scenario`` scores on the same requests;
  * the flag-driven and the ``--config`` launcher runs bit for bit inside
    the port;
  * what the port cannot run yet (mesh, comms, the LM / MACE / cell
    archs) raises, naming its slice; the disk source runs (and without a
    ``shard_dir`` is refused).

The reference runs on its CPU auto backends (``jnp-chunked`` attention,
``jnp`` bags); the port on its (``torch-chunked``, ``torch``). Sizes are
small: 2,000 items, a 40-request stream.
"""
import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.scenario import build as jax_build
from repro.scenario import spec as jax_spec
from repro_torch.configs.registry import (SCENARIO_ARCHS, all_cells,
                                          all_scenarios, get_arch, scenario)
from repro_torch.data.batcher import ROOBatcher
from repro_torch.distributed import comms
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.scenario import build
from repro_torch.scenario.spec import (ScenarioSpec, ScenarioValidationError,
                                       parse_set_args)
from repro_torch.tree import leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_state import one_thread, port_state  # noqa: E402,F401

SMALL = {"model.n_items": 2000, "data.n_requests": 40}
LOSS_TOL = dict(atol=1e-6, rtol=1e-5)     # the A7 tests' loss tolerance
SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
ULP_TOL = dict(atol=4e-8, rtol=1e-6)     # test_torch_sparse_train.ULP_TOL
SERVABLE = [a for a in SCENARIO_ARCHS if a != "dlrm-mlperf"]


def small(arch, extra=None):
    """The registered scenario at the tests' size (dlrm-mlperf is its own
    reduced config already)."""
    over = {} if arch == "dlrm-mlperf" else dict(SMALL)
    over.update(extra or {})
    return scenario(arch, over), jax_registry.scenario(arch, over)


# ---------------------------------------------------------------------------
# the wire format: bytes and hashes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SCENARIO_ARCHS)
def test_registered_scenario_bytes_and_hashes_match(arch):
    ours, theirs = scenario(arch), jax_registry.scenario(arch)
    assert ours.to_json_str() == theirs.to_json_str()
    assert ours.to_json() == theirs.to_json()
    assert ours.content_hash() == theirs.content_hash()
    assert ours.data_hash() == theirs.data_hash()
    # written by one package, loaded by the other, and back
    assert ScenarioSpec.from_json(theirs.to_json_str()) == ours
    assert jax_spec.ScenarioSpec.from_json(ours.to_json_str()) == theirs
    back = ScenarioSpec.from_json(json.loads(ours.to_json_str()))
    assert back == ours and back.content_hash() == ours.content_hash()


def test_save_load_across_packages(tmp_path):
    ours = scenario("roo-lsr", {"train.steps": 7, "obs.mode": "metrics",
                                "knobs.emb_dedup": "always"})
    ours.save(str(tmp_path / "a.json"))
    theirs = jax_spec.ScenarioSpec.load(str(tmp_path / "a.json"))
    theirs.save(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert ScenarioSpec.load(str(tmp_path / "b.json")) == ours
    assert all_scenarios() == [scenario(a) for a in SCENARIO_ARCHS]


# ---------------------------------------------------------------------------
# strict validation — the reference's cases on the port's spec
# ---------------------------------------------------------------------------

def _wire(**edits):
    wire = scenario("roo-lsr").to_json()
    wire.update(edits)
    return wire


def _with_field(section, field, value):
    wire = _wire()
    wire[section] = dict(wire[section], **{field: value})
    return wire


INVALID = {
    "unknown section": lambda: ScenarioSpec.from_json(_wire(extra={})),
    "unknown field": lambda: ScenarioSpec.from_json(
        _with_field("train", "warmup", 5)),
    "mistyped int": lambda: ScenarioSpec.from_json(
        _with_field("train", "steps", "50")),
    "bool is not int": lambda: ScenarioSpec.from_json(
        _with_field("data", "prefetch", 1)),
    "future schema": lambda: ScenarioSpec.from_json(_wire(schema_version=99)),
    "missing arch": lambda: scenario("roo-lsr", {"model.arch": ""}),
    "bad source": lambda: scenario("roo-lsr", {"data.source": "s3"}),
    "bad knob value": lambda: scenario("roo-lsr",
                                       {"knobs.attn_backend": "bogus"}),
    "bad override field": lambda: scenario("roo-lsr", {"train.nope": 1}),
    "bad override section": lambda: scenario("roo-lsr",
                                             {"notasection.x": 1}),
    "bad mesh": lambda: scenario("roo-lsr", {"train.mesh": "abc"}),
    "bad comms_compress": lambda: scenario(
        "roo-lsr", {"knobs.comms_compress": "fp4"}),
    "bad comms_block": lambda: scenario("roo-lsr", {"knobs.comms_block": 0}),
    "bad fault plan": lambda: scenario("roo-lsr",
                                       {"knobs.faults": "engine.score"}),
    "bad obs mode": lambda: scenario("roo-lsr", {"obs.mode": "loud"}),
    "incremental + cache": lambda: scenario(
        "hstu-gr", {"serve.incremental": True,
                    "serve.cache_user_tower": True}),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_specs_rejected(case):
    with pytest.raises(ScenarioValidationError):
        INVALID[case]()


@pytest.mark.parametrize("field,value,choices", [
    ("attn_backend", "pallas", dispatch.BACKENDS),
    ("attn_backend", "jnp-chunked", dispatch.BACKENDS),
    ("emb_backend", "pallas-interpret", dispatch.EMB_BACKENDS),
    ("emb_backend", "jnp", dispatch.EMB_BACKENDS)])
def test_reference_only_backend_rejected_with_the_ports_choices(
        field, value, choices):
    """A spec the reference accepts, pinning one of its own backends,
    fails the port's validation, and the message lists the port's
    choices."""
    theirs = jax_registry.scenario("roo-lsr", {f"knobs.{field}": value})
    with pytest.raises(ScenarioValidationError) as e:
        ScenarioSpec.from_json(theirs.to_json_str())
    assert value in str(e.value) and str(choices) in str(e.value)


# ---------------------------------------------------------------------------
# overrides, coercion, the knob ladder
# ---------------------------------------------------------------------------

def test_set_args_coerce_types():
    overrides = parse_set_args(["train.steps=50", "data.prefetch=false",
                                "knobs.attn_backend=none",
                                "train.lr_dense=0.01",
                                "obs.verbosity=2", "serve.bucketed=off"])
    spec = scenario("roo-lsr", overrides)
    assert spec.train.steps == 50
    assert spec.data.prefetch is False
    assert spec.knobs.attn_backend is None
    assert spec.train.lr_dense == 0.01
    assert spec.obs.verbosity == 2 and spec.serve.bucketed is False
    assert spec.to_json() == jax_registry.scenario("roo-lsr",
                                                   overrides).to_json()
    with pytest.raises(ScenarioValidationError):
        parse_set_args(["train.steps"])
    with pytest.raises(ScenarioValidationError):
        scenario("roo-lsr", {"data.prefetch": "maybe"})


@pytest.mark.parametrize("seed", range(6))
def test_overrides_roundtrip_and_match_the_reference(seed):
    """Random typed overrides (float bounds chosen here, not the
    reference's property test's): a JSON round trip is the identity, the
    ``--set`` string form coerces to the same spec, and the reference
    builds the same bytes from the same overrides."""
    r = np.random.RandomState(seed)
    arch = SCENARIO_ARCHS[seed % len(SCENARIO_ARCHS)]
    typed = {"train.steps": int(r.randint(1, 100_000)),
             "batcher.b_ro": int(r.randint(1, 257)),
             "data.seed": int(r.randint(0, 2 ** 31 - 1)),
             "data.late_fraction": float(r.uniform(0.0, 1.0)),
             "train.lr_dense": float(10 ** r.uniform(-6, 0)),
             "data.prefetch": bool(r.randint(2))}
    spec = scenario(arch, typed)
    back = ScenarioSpec.from_json(json.loads(spec.to_json_str()))
    assert back == spec and back.content_hash() == spec.content_hash()
    as_text = {k: (repr(v) if isinstance(v, float) else str(v))
               for k, v in typed.items()}
    assert scenario(arch, as_text) == spec
    theirs = jax_registry.scenario(arch, typed)
    assert spec.to_json_str() == theirs.to_json_str()
    assert spec.data_hash() == theirs.data_hash()


def test_spec_apply_installs_the_ports_defaults():
    from repro_torch.embeddings.collection import DEDUP_KNOB
    from repro_torch.obs import log as obs_log
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.reliability import faults
    spec = scenario("roo-lsr", {"knobs.attn_backend": "torch-dense",
                                "knobs.emb_backend": "torch",
                                "knobs.emb_dedup": "always",
                                "knobs.faults": "seed=4;train.batch:nan@0.5",
                                "obs.mode": "trace", "obs.verbosity": 0})
    spec.apply()
    assert dispatch.resolve_backend() == "torch-dense"
    assert dispatch.resolve_emb_backend() == "torch"
    assert DEDUP_KNOB.resolve() == "always"
    assert faults.active_plan().to_env() == "seed=4;train.batch:nan@0.5"
    assert obs_metrics.mode() == "trace"
    assert obs_log.verbosity() == 0
    with dispatch.use_backend("torch-chunked"):     # scope beats the spec
        assert dispatch.resolve_backend() == "torch-chunked"


# ---------------------------------------------------------------------------
# provenance and the event stream
# ---------------------------------------------------------------------------

def test_hashes_cover_what_they_should():
    base = scenario("roo-lsr")
    assert base.content_hash() != \
        scenario("roo-lsr", {"train.steps": 7}).content_hash()
    assert base.data_hash() == \
        scenario("roo-lsr", {"train.steps": 9999}).data_hash()
    assert base.data_hash() == \
        scenario("roo-lsr", {"data.prefetch": False}).data_hash()
    assert base.data_hash() != scenario("roo-lsr",
                                        {"data.seed": 1}).data_hash()
    a = scenario("roo-lsr", {"model.n_items": 4096})
    b = scenario("roo-lsr", {"model.n_items": 4096, "data.n_items": 4096})
    assert a.data_hash() == b.data_hash()


def test_provenance_matches_the_reference():
    ours, theirs = small("roo-lsr", {"data.seed": 5})
    assert build.shard_provenance(ours) == \
        jax_build.shard_provenance(theirs)
    assert build.ckpt_meta(ours) == {"scenario": "roo-lsr",
                                     "scenario_hash": theirs.content_hash()}
    assert build.provenance_matches(build.shard_provenance(ours), ours)
    assert not build.provenance_matches(
        build.shard_provenance(ours.with_overrides({"data.seed": 6})), ours)
    legacy = {k: build.shard_provenance(ours)[k]
              for k in ("stream", "label_wait_s", "requests_per_shard")}
    assert build.provenance_matches(legacy, ours)


def test_build_samples_match_the_reference():
    ours, theirs = small("hstu-gr", {"data.late_fraction": 0.2})
    ps, js = build.build_samples(ours), jax_build.build_samples(theirs)
    assert len(ps) == len(js) > 0
    for p, j in zip(ps, js):
        for f in dataclasses.fields(j):
            a, b = getattr(p, f.name), getattr(j, f.name)
            if f.name in ("ro_dense",):
                np.testing.assert_array_equal(a, b)
            elif f.name == "item_dense":
                np.testing.assert_array_equal(np.stack(a), np.stack(b))
            else:
                assert a == b, f.name


# ---------------------------------------------------------------------------
# the eight archs on carried parameters
# ---------------------------------------------------------------------------

def _port_batches(spec, bundle):
    if spec.model.arch == "dlrm-mlperf":
        return build.synthetic_dlrm_batches(spec, bundle.cfg, device="cpu")
    return list(ROOBatcher(build.build_batcher_cfg(spec), device="cpu")
                .batches(build.build_samples(spec)))


def _cloze_draws(key, batch, cfg):
    """The reference's cloze draws for ``key``
    (``jax.random.uniform(key, (b, s))``), as a tensor."""
    s = min(batch.history_ids.shape[1], cfg.seq_len)
    return torch.from_numpy(np.array(
        jax.random.uniform(key, (batch.b_ro, s))))


@pytest.fixture(scope="module", params=SCENARIO_ARCHS)
def carried(request):
    """Per arch: both specs (3 steps, logged each step), the reference's
    bundle and its own ``train_from_scenario`` run from that bundle's
    params, the port's bundle with those params carried across, and the
    port's batches. The reference logs each step's loss on the params
    before the step, so its first row is the loss of ``build_model``'s
    params on the first batch."""
    arch = request.param
    spec, jspec = small(arch, {"train.log_every": 1, "train.steps": 3})
    jbundle = jax_build.build_model(jspec, jax.random.PRNGKey(0))
    jtrainer, _ = jax_build.train_from_scenario(jspec, prints=False)
    bundle = build.build_model(spec, torch.Generator().manual_seed(0),
                               device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jbundle.params),
                               "cpu")
    assert [tuple(p.shape) for p in leaves(bundle.params)] == \
        [tuple(np.shape(p)) for p in jax.tree.leaves(jbundle.params)]
    bundle = bundle._replace(params=params)
    return dict(arch=arch, spec=spec, jspec=jspec, bundle=bundle,
                jbundle=jbundle, jhistory=jtrainer.history,
                pb=_port_batches(spec, bundle))


def test_build_model_loss_matches_the_reference(carried):
    c = carried
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    if c["arch"] == "bert4rec":       # the port's seam for the cloze draws
        from repro_torch.models.bert4rec import bert4rec_loss
        got = bert4rec_loss(c["bundle"].params, c["bundle"].cfg, c["pb"][0],
                            uniform=_cloze_draws(key, c["pb"][0],
                                                 c["bundle"].cfg))
    else:
        got = c["bundle"].loss_fn(c["bundle"].params, c["pb"][0], None)
    np.testing.assert_allclose(float(got), c["jhistory"][0]["loss"],
                               **LOSS_TOL)
    assert c["bundle"].vag_fn is None and c["jbundle"].vag_fn is None
    assert (c["bundle"].serve is None) == (c["jbundle"].serve is None)
    assert (c["bundle"].metrics_fn is None) == \
        (c["jbundle"].metrics_fn is None)


def test_three_train_steps_match_the_reference(carried):
    """Three ``train_from_scenario`` steps at log_every 1: the port from
    the reference's init params (handed in through the ``bundle`` seam)
    against the reference's own run, loss (and NE) per step."""
    c = carried
    bundle = c["bundle"]
    if c["arch"] == "bert4rec":
        from repro_torch.models.bert4rec import bert4rec_loss
        base = jax.random.PRNGKey(0)
        draws = iter([_cloze_draws(jax.random.fold_in(base, i),
                                   c["pb"][i % len(c["pb"])], bundle.cfg)
                      for i in range(3)])
        bundle = bundle._replace(loss_fn=lambda p, b, g: bert4rec_loss(
            p, bundle.cfg, b, uniform=next(draws)))
    spec = c["spec"].validate().apply()
    trainer, state = build._train_from_scenario(
        spec, ckpt_dir=None, rng_seed=0, prints=False, device="cpu",
        bundle=bundle)
    assert int(state["step"]) == 3 and len(trainer.history) == 3
    for row, jrow in zip(trainer.history, c["jhistory"]):
        assert row["step"] == jrow["step"]
        for key in ("loss", "ne"):
            assert (key in row) == (key in jrow)
            if key in row:
                np.testing.assert_allclose(row[key], jrow[key], **ULP_TOL)


def _requests(spec):
    return build.build_samples(spec.with_overrides(
        {"data.n_requests": 24}))[:10]


def test_engine_scores_match_the_reference(carried):
    c = carried
    if c["arch"] == "dlrm-mlperf":
        with pytest.raises(ScenarioValidationError, match="not servable"):
            build.engine_from_scenario(c["spec"], device="cpu")
        return
    spec = c["spec"].with_overrides({"serve.max_requests": 8,
                                     "serve.max_impressions": 64})
    jspec = c["jspec"].with_overrides({"serve.max_requests": 8,
                                       "serve.max_impressions": 64})
    engine = build.engine_from_scenario(spec, params=c["bundle"].params,
                                        device="cpu")
    jengine = jax_build.engine_from_scenario(jspec,
                                             params=c["jbundle"].params)
    reqs = _requests(spec)
    got = engine.score_requests(reqs)
    want = jengine.score_requests(jax_build.build_samples(
        jspec.with_overrides({"data.n_requests": 24}))[:10])
    assert len(got) == len(want) == len(reqs)
    for g, w, r in zip(got, want, reqs):
        assert g.shape[0] == r.num_impressions
        np.testing.assert_allclose(g, np.asarray(w), **SCORE_TOL)
    assert engine.stats.n_failed_batches == 0


@pytest.mark.parametrize("arch,mode", [("roo-esr", "cache_user_tower"),
                                       ("hstu-gr", "incremental"),
                                       ("roo-lsr", "bucketed")])
def test_engine_modes_score_as_stateless(arch, mode):
    """The spec's serving modes against the stateless engine on the same
    params: the user-tower cache (a second pass all hits), incremental
    state (repeat users), the fixed single-shape ladder."""
    spec, _ = small(arch)
    value = mode != "bucketed"
    stateless = build.engine_from_scenario(spec, device="cpu")
    other = build.engine_from_scenario(
        spec.with_overrides({f"serve.{mode}": value}),
        params=stateless.params, device="cpu")
    reqs = _requests(spec)
    want = stateless.score_requests(reqs)
    for _ in range(2):
        for g, w in zip(other.score_requests(reqs), want):
            np.testing.assert_allclose(g, w, **SCORE_TOL)
    if mode == "cache_user_tower":
        assert other.cache.stats.hits > 0
    elif mode == "incremental":
        assert other.state_store.stats.hits > 0
    else:
        assert len(other.ladder.rungs) == 1
        assert other.stats.buckets.distinct_shapes == 1


def test_engine_mode_conflicts_raise():
    with pytest.raises(ScenarioValidationError, match="fused forward"):
        build.engine_from_scenario(small("mind", {
            "serve.cache_user_tower": True})[0], device="cpu")
    with pytest.raises(ScenarioValidationError, match="stateful"):
        build.engine_from_scenario(small("roo-esr", {
            "serve.incremental": True})[0], device="cpu")
    with pytest.raises(ScenarioValidationError, match="state window"):
        build.engine_from_scenario(small("hstu-gr", {
            "serve.incremental": True, "batcher.hist_len": 32})[0],
            device="cpu")
    with pytest.raises(ScenarioValidationError, match="dense by"):
        build.build_model(scenario("bert4rec"), torch.Generator(),
                          sparse=True, device="cpu")


def test_sparse_emb_trains_on_sparse_rows(one_thread):
    """``train.sparse_emb`` routes through ``make_sparse_value_and_grad``:
    the first step's loss is the dense run's on the same params."""
    spec, _ = small("roo-lsr", {"train.steps": 2, "train.log_every": 1,
                                "model.variant": "userarch"})
    dense, _ = build.train_from_scenario(spec, prints=False, device="cpu")
    sparse, _ = build.train_from_scenario(
        spec.with_overrides({"train.sparse_emb": True}), prints=False,
        device="cpu")
    assert sparse.history[0]["loss"] == dense.history[0]["loss"]
    assert sparse.step_fn is not dense.step_fn


def test_checkpoint_meta_carries_the_scenario(tmp_path):
    spec, _ = small("mind", {"train.steps": 2, "train.ckpt_every": 2,
                             "train.log_every": 1})
    trainer, state = build.train_from_scenario(
        spec, ckpt_dir=str(tmp_path), prints=False, device="cpu")
    with open(tmp_path / "step_000000000002" / "meta.json") as f:
        meta = json.load(f)
    assert meta["scenario"] == "mind"
    assert meta["scenario_hash"] == spec.content_hash()
    assert int(state["step"]) == 2 and len(trainer.history) == 2


# ---------------------------------------------------------------------------
# flags and specs are the same run (the reference's TestFlagSpecParity)
# ---------------------------------------------------------------------------

def _npz_payload(path):
    with np.load(path) as data:
        return {k: (data[k].dtype.str, data[k].shape, data[k].tobytes())
                for k in data.files}


@pytest.mark.parametrize("arch", ["roo-lsr", "hstu-gr"])
def test_flag_vs_config_bit_identical(arch, tmp_path, one_thread):
    from repro_torch.launch.train import main
    steps = 6
    sets = ["train.ckpt_every=%d" % steps, "train.log_every=2",
            "data.n_requests=40", "model.n_items=2000"]
    ckpt_a = str(tmp_path / "flag_ckpt")
    argv = ["--arch", arch, "--steps", str(steps), "--ckpt-dir", ckpt_a,
            "--device", "cpu"]
    for s in sets:
        argv += ["--set", s]
    tr_a, st_a = main(argv)
    spec = scenario(arch, dict(parse_set_args(sets), **{
        "train.steps": steps}))
    cfg_path = str(tmp_path / "spec.json")
    spec.save(cfg_path)
    ckpt_b = str(tmp_path / "spec_ckpt")
    tr_b, st_b = main(["--config", cfg_path, "--ckpt-dir", ckpt_b,
                       "--device", "cpu"])

    assert int(st_a["step"]) == int(st_b["step"]) == steps
    losses_a = [h["loss"] for h in tr_a.history]
    assert losses_a == [h["loss"] for h in tr_b.history] and losses_a
    step_dir = "step_%012d" % steps
    for name in ("structure.json",):
        with open(os.path.join(ckpt_a, step_dir, name), "rb") as f:
            a = f.read()
        with open(os.path.join(ckpt_b, step_dir, name), "rb") as f:
            assert f.read() == a
    assert _npz_payload(os.path.join(ckpt_a, step_dir, "arrays.npz")) == \
        _npz_payload(os.path.join(ckpt_b, step_dir, "arrays.npz"))
    metas = []
    for d in (ckpt_a, ckpt_b):
        with open(os.path.join(d, step_dir, "meta.json")) as f:
            metas.append(json.load(f))
    assert all(m["scenario_hash"] == spec.content_hash() for m in metas)
    assert metas[0]["digests"] == metas[1]["digests"]


# ---------------------------------------------------------------------------
# what the port cannot run yet names its slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides,slice_", [
    ({"data.source": "disk"}, "needs a shard_dir"),
    ({"train.mesh": "2x4"}, "needs 8 ranks but the world has 1"),
    ({"knobs.comms_compress": "int8", "train.mesh": "2x2",
      "train.sparse_emb": True}, "mutually exclusive"),
    ({"knobs.comms_overlap": "on", "train.mesh": "3x1"},
     "divisible by the mesh's 3 data shard"),
    ({"knobs.comms_block": 64, "train.mesh": "2x2",
      "model.arch": "dien"}, "train.mesh supports roo-lsr, hstu-gr"),
    ({"train.microbatches": 2}, "microbatch axis")])
def test_unported_specs_raise_naming_the_slice(overrides, slice_):
    spec = scenario("roo-lsr", overrides)
    with pytest.raises(ScenarioValidationError, match=slice_):
        build.train_from_scenario(spec, prints=False, device="cpu")


def test_disk_source_runs(tmp_path, one_thread):
    """``data.source="disk"`` (ported with the shard pipeline) trains:
    shards built in ``shard_dir``, the cursor saved beside the checkpoint,
    the losses those of the memory source's stream joined online."""
    spec = scenario("roo-lsr", dict(SMALL, **{
        "data.source": "disk", "train.steps": 2, "train.log_every": 1,
        "train.ckpt_every": 2, "model.variant": "userarch"}))
    trainer, state = build.train_from_scenario(
        spec, shard_dir=str(tmp_path / "shards"),
        ckpt_dir=str(tmp_path / "ckpt"), prints=False, device="cpu")
    assert int(state["step"]) == 2 and len(trainer.history) == 2
    assert os.listdir(tmp_path / "ckpt" / "cursors") == [
        "cursor_000000000002.json"]
    assert "manifest.json" in os.listdir(tmp_path / "shards")
    assert all(np.isfinite(row["loss"]) for row in trainer.history)


def test_unported_engine_knobs_and_archs_raise():
    # the comms knobs (ported) reach their ladder; serving takes no plan
    engine = build.engine_from_scenario(
        scenario("roo-esr", {"knobs.comms_compress": "bf16"}), device="cpu")
    assert engine is not None and comms.compress_mode() == "bf16"
    # the LM and MACE config modules are ported (A10a); the recsys cell
    # wrappers and the dry-run cells are not (A10b)
    for arch in ("dien", "dlrm-mlperf", "mind", "bert4rec"):
        with pytest.raises(NotImplementedError, match="A10b"):
            get_arch(arch)
    with pytest.raises(NotImplementedError, match="A10b"):
        all_cells()
    assert get_arch("hstu-gr").gr_config
    assert get_arch("starcoder2-15b").FAMILY == "lm"
    assert get_arch("mace").FAMILY == "gnn"
    for arch in ("mace", "starcoder2-15b"):
        lm = scenario("roo-lsr", {"model.arch": arch})
        with pytest.raises(ScenarioValidationError,
                           match="is not a recsys scenario arch"):
            build.train_from_scenario(lm, prints=False, device="cpu")
