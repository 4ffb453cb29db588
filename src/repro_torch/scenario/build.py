"""ScenarioSpec -> running objects: the one construction path (torch port
of ``repro/scenario/build.py``).

Every consumer — ``launch/train.py``, ``ScoringEngine.from_scenario``,
``scenario/smoke.py`` — builds stream, batcher, model, Trainer and engine
through THESE functions, so a spec-driven run and a flag-driven run are
bit-identical by construction (the flags merely edit the spec).

Entry points run on ``device`` (``"cuda"`` unless the caller asks for the
CPU). Parameters are drawn from a CPU ``torch.Generator`` seeded with
``rng_seed`` and then moved, so the card and the CPU start from the same
values; the Trainer's base seed is ``rng_seed`` too.

Three data sources: ``memory`` (the event stream joined and packed in
memory), ``synthetic`` (dlrm-mlperf's field batches) and ``disk``: the
stream joined online (``WatermarkJoiner``), written as CRC-checked ROO
shards into ``shard_dir`` (or reused from there when its manifest's
provenance matches the spec), and streamed into the Trainer by the
prefetching loader, which places batches on ``device`` and resumes from a
cursor under ``<ckpt_dir or shard_dir>/cursors``.

``train.mesh`` trains ``PLAN_ARCHS`` (hstu-gr, roo-lsr: the losses that
route lookups through a sharding plan) SPMD, one process per rank
(``distributed/``, ``launch/mesh.py``): the mesh comes from the world the
process is in (the launcher spawns gloo ranks on the CPU; on the card
NCCL, a rank a card, or a world of one), each rank trains on its data
block of every batch (packed shard by shard, ``batcher.n_shards``) with
its row blocks of the tables, and only rank 0 logs. Other archs, sparse
rows under a mesh and batches the data shards do not divide are refused
with the reference's reasons. ``train.microbatches > 1`` is refused: no
scenario data source feeds it (the reference's would hand the
accumulation unstacked batches).

Also home of the provenance plumbing the spec hash rides:
:func:`shard_provenance` / :func:`provenance_matches` (what a shard
writer stamps into its manifest and what reuse is gated on),
:func:`cursor_fingerprint` (what resume cursors are keyed on) and
:func:`ckpt_meta` (``scenario`` / ``scenario_hash`` in every checkpoint's
``meta.json``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.registry import SCENARIO_ARCHS
from repro_torch.scenario.spec import ScenarioSpec, ScenarioValidationError
from repro_torch.serve.adapter import ServeAdapter

# archs the recsys scenario surface covers (dry-run-only archs excluded)
RECSYS_ARCHS = SCENARIO_ARCHS

# archs whose losses route embedding lookups through a sharding plan —
# the only ones that may train under --mesh / train.mesh
PLAN_ARCHS = ("roo-lsr", "hstu-gr")


class ModelBundle(NamedTuple):
    """Everything a trainer/server needs for one arch, built from a spec."""
    arch: str
    cfg: Any
    params: Any
    loss_fn: Callable                        # (params, batch, gen) -> loss
    vag_fn: Optional[Callable]               # sparse value_and_grad (or None)
    metrics_fn: Optional[Callable]
    serve: Optional[ServeAdapter]            # None: arch is not ROO-servable


# ---------------------------------------------------------------------------
# What the port cannot run yet
# ---------------------------------------------------------------------------

def refuse_unported(spec: ScenarioSpec, training: bool) -> None:
    """Raise for a spec the port cannot run: ``train.microbatches > 1``
    (no scenario data source stacks microbatches, in the reference
    either)."""
    if training and spec.train.microbatches > 1:
        raise ScenarioValidationError(
            f"scenario {spec.name!r}: train.microbatches="
            f"{spec.train.microbatches}: accumulation needs batches with a "
            f"leading microbatch axis, and the memory and synthetic sources "
            f"yield one batch a step")


# ---------------------------------------------------------------------------
# Data + batcher sections
# ---------------------------------------------------------------------------

def build_stream_cfg(spec: ScenarioSpec):
    from repro_torch.data.events import EventStreamConfig
    d = spec.data
    return EventStreamConfig(
        n_users=d.n_users, n_items=spec.stream_n_items(),
        n_requests=d.n_requests, product=d.product,
        hist_init_max=d.hist_init_max, seed=d.seed,
        late_fraction=d.late_fraction)


def build_batcher_cfg(spec: ScenarioSpec, n_shards: int = 1):
    from repro_torch.data.batcher import BatcherConfig
    return BatcherConfig(b_ro=spec.batcher.b_ro, b_nro=spec.batcher.b_nro,
                         hist_len=spec.batcher.hist_len, n_shards=n_shards)


def build_samples(spec: ScenarioSpec) -> List:
    """Deterministic in-memory ROO samples for the spec's event stream."""
    from repro_torch.core.joiner import RequestLevelJoiner
    from repro_torch.data.events import EventSimulator
    return RequestLevelJoiner().join(
        list(EventSimulator(build_stream_cfg(spec)).stream()))


# ---------------------------------------------------------------------------
# Provenance
# ---------------------------------------------------------------------------

def shard_provenance(spec: ScenarioSpec) -> dict:
    """Manifest provenance for shards built from ``spec``. ``data_hash``
    is the reuse gate; the rest is for humans debugging a directory."""
    return {"scenario": spec.name,
            "scenario_hash": spec.content_hash(),
            "data_hash": spec.data_hash(),
            "stream": dataclasses.asdict(build_stream_cfg(spec)),
            "label_wait_s": spec.data.label_wait_s,
            "requests_per_shard": spec.data.requests_per_shard}


def provenance_matches(stored: dict, spec: ScenarioSpec) -> bool:
    """Whether an existing shard directory holds this spec's data. New
    manifests compare by ``data_hash``; pre-scenario manifests (no hash)
    compare the legacy provenance fields."""
    if "data_hash" in stored:
        return stored["data_hash"] == spec.data_hash()
    want = shard_provenance(spec)
    legacy = {k: want[k] for k in ("stream", "label_wait_s",
                                   "requests_per_shard")}
    return stored == legacy


def cursor_fingerprint(spec: ScenarioSpec, manifest) -> str:
    """What a resume cursor is valid against: the spec's data/batcher
    sections plus the manifest's shard index. Train-section edits (more
    steps, different ckpt cadence) keep the fingerprint stable."""
    shards = [[s.filename, s.n_bytes, s.n_requests, s.n_impressions]
              for s in manifest.shards]
    blob = json.dumps([spec.data_hash(), shards], sort_keys=True)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]


def ckpt_meta(spec: ScenarioSpec) -> dict:
    return {"scenario": spec.name, "scenario_hash": spec.content_hash()}


# ---------------------------------------------------------------------------
# Models (params + loss + sparse vag + metrics + serving halves)
# ---------------------------------------------------------------------------

def _ne_metrics(logits_fn, plan=None):
    from repro_torch.train.metrics import make_ne_metrics
    return make_ne_metrics(logits_fn, plan)


def build_model(spec: ScenarioSpec, gen: torch.Generator,
                sparse: bool = False, device="cuda",
                plan=None) -> ModelBundle:
    """Params (drawn from ``gen``, placed on ``device``), loss and serving
    halves for ``spec.model``. ``loss_fn(params, batch, gen)`` takes the
    step's generator (only BERT4Rec's cloze mask draws from it). Under an
    SPMD ``plan`` (``PLAN_ARCHS`` only) the loss and the NE metric route
    through it; the params stay global (the Trainer places them)."""
    from repro_torch.configs import roo_models as rm
    from repro_torch.embeddings.sparse import make_sparse_value_and_grad

    arch, m = spec.model.arch, spec.model
    if arch not in SCENARIO_ARCHS:
        raise ScenarioValidationError(
            f"scenario {spec.name!r}: model.arch {arch!r} is not a recsys "
            f"scenario arch; expected one of {SCENARIO_ARCHS}")

    def sparse_vag(loss, table_ids_fn):
        return (make_sparse_value_and_grad(loss, table_ids_fn)
                if sparse else None)

    if arch == "roo-lsr":
        from repro_torch.models.lsr import (lsr_init, lsr_logits_from_user,
                                            lsr_logits_roo, lsr_loss,
                                            lsr_table_ids, lsr_user_repr)
        cfg = dataclasses.replace(rm.lsr_config(m.variant or "userarch_hstu"),
                                  n_items=m.n_items)
        loss = lambda p, b, g: lsr_loss(p, cfg, b, plan=plan)
        return ModelBundle(
            arch, cfg, lsr_init(gen, cfg, device=device), loss,
            sparse_vag(loss, lambda b: lsr_table_ids(cfg, b)),
            _ne_metrics(lambda p, b: (
                lsr_logits_roo(p, cfg, b, plan=plan)[:, 0], b.labels[:, 0],
                b.impression_mask()), plan),
            ServeAdapter(
                score=lambda p, b: lsr_logits_roo(p, cfg, b),
                user_repr=lambda p, b: lsr_user_repr(p, cfg, b),
                score_from_user=lambda p, b, u: lsr_logits_from_user(
                    p, cfg, b, u)))
    if arch in ("roo-esr", "roo-retrieval"):
        from repro_torch.models import two_tower as tt
        esr = arch == "roo-esr"
        cfg = dataclasses.replace(
            rm.esr_config() if esr else rm.retrieval_config(),
            n_items=m.n_items)
        if esr:
            loss = lambda p, b, g: tt.esr_loss_roo(p, cfg, b)
            metrics = _ne_metrics(lambda p, b: (
                tt.esr_logits_roo(p, cfg, b), b.labels[:, 0],
                b.impression_mask()))
            from_user = lambda p, b, u: tt.esr_logits_from_user(p, cfg, b, u)
        else:
            loss = lambda p, b, g: tt.retrieval_loss_roo(p, cfg, b)
            metrics = None
            # the reference scenario's ``_fanout_scores``
            from_user = lambda p, b, u: tt.retrieval_scores_from_user(
                p, cfg, b, u)
        return ModelBundle(
            arch, cfg, tt.two_tower_init(gen, cfg, device=device), loss,
            sparse_vag(loss, lambda b: tt.two_tower_table_ids(cfg, b)),
            metrics,
            ServeAdapter(
                score=lambda p, b: from_user(p, b, tt.user_tower(p, cfg, b)),
                user_repr=lambda p, b: tt.user_tower(p, cfg, b),
                score_from_user=from_user))
    if arch == "hstu-gr":
        from repro_torch.models import gr
        cfg = dataclasses.replace(
            rm.gr_config(hist_len=m.hist_len, m_targets=m.m_targets),
            n_items=m.n_items)
        loss = lambda p, b, g: gr.gr_ranking_loss(p, cfg, b, plan=plan)
        return ModelBundle(
            arch, cfg, gr.gr_init(gen, cfg, device=device), loss,
            sparse_vag(loss, lambda b: gr.gr_table_ids(cfg, b)),
            _ne_metrics(lambda p, b: (
                gr.gr_ranking_logits(p, cfg, b, plan=plan)[:, 0],
                b.labels[:, 0], b.impression_mask()), plan),
            ServeAdapter(
                score=lambda p, b: gr.gr_ranking_logits(p, cfg, b),
                user_repr=lambda p, b: gr.gr_history_repr(p, cfg, b),
                score_from_user=lambda p, b, h:
                    gr.gr_ranking_logits_from_history(p, cfg, b, h),
                init_user_state=lambda: gr.gr_state_init(cfg, device=device),
                extend_user_state=lambda p, b, s, *, n_new:
                    gr.gr_extend_user_state(p, cfg, b, s, n_new=n_new),
                score_from_state=lambda p, b, s, *, n_new:
                    gr.gr_score_from_state(p, cfg, b, s, n_new=n_new),
                state_hist_len=cfg.hist_len))
    if arch == "mind":
        from repro_torch.models import mind
        cfg = mind.MINDConfig(n_items=m.n_items)
        loss = lambda p, b, g: mind.mind_loss(p, cfg, b)
        return ModelBundle(
            arch, cfg, mind.mind_init(gen, cfg, device=device), loss,
            sparse_vag(loss, lambda b: mind.mind_table_ids(cfg, b)), None,
            ServeAdapter(score=lambda p, b: mind.score_candidates_roo(
                p, cfg, b)))
    if arch == "bert4rec":
        from repro_torch.models import bert4rec
        if sparse:
            raise ScenarioValidationError(
                "bert4rec's cloze head is a full softmax over item_emb — "
                "dense by construction; drop train.sparse_emb")
        cfg = bert4rec.BERT4RecConfig(n_items=m.n_items,
                                      seq_len=m.seq_len or 65)
        return ModelBundle(
            arch, cfg, bert4rec.bert4rec_init(gen, cfg, device=device),
            lambda p, b, g: bert4rec.bert4rec_loss(p, cfg, b, g), None, None,
            ServeAdapter(score=lambda p, b: bert4rec.score_candidates_roo(
                p, cfg, b)))
    if arch == "dien":
        from repro_torch.models import din_dien
        cfg = din_dien.DIENConfig(n_items=m.n_items, seq_len=m.seq_len or 64)
        loss = lambda p, b, g: din_dien.dien_loss(p, cfg, b)
        return ModelBundle(
            arch, cfg, din_dien.dien_init(gen, cfg, device=device), loss,
            sparse_vag(loss, lambda b: din_dien.dien_table_ids(cfg, b)),
            _ne_metrics(lambda p, b: (din_dien.dien_logits_roo(p, cfg, b),
                                      b.labels[:, 0], b.impression_mask())),
            ServeAdapter(score=lambda p, b: din_dien.dien_logits_roo(
                p, cfg, b)))
    # dlrm-mlperf: MLPerf-shaped at the reference scenario's reduced scale
    # (four tables of at most 512 rows). Field-dict batches, not ROOBatch,
    # so it is synthetic-data-only and not servable through the ROO engine.
    from repro_torch.models.dlrm import (DLRMConfig, dlrm_forward_roo,
                                         dlrm_init, dlrm_table_ids)
    from repro_torch.train.metrics import bce
    ed = m.embed_dim or 16
    cfg = DLRMConfig(n_dense=4, embed_dim=ed, bot_mlp=(4, 32, ed),
                     top_mlp=(64, 32, 1), vocabs=(512, 256, 64, 32),
                     n_ro_fields=2, multi_hot=2)

    def loss(p, b, g):
        logits = dlrm_forward_roo(p, cfg, b["ro_dense"], b["ro_ids"],
                                  b["ro_len"], b["nro_ids"], b["nro_len"],
                                  b["seg"])
        return bce(logits, b["y"])

    return ModelBundle(
        arch, cfg, dlrm_init(gen, cfg, device=device), loss,
        sparse_vag(loss, lambda b: dlrm_table_ids(cfg, b["ro_ids"],
                                                  b["nro_ids"])),
        None, None)


def synthetic_dlrm_batches(spec: ScenarioSpec, cfg, n_batches: int = 4,
                           device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Deterministic field-dict batches for dlrm-mlperf (its MLPerf input
    format predates the ROO schema; the stream simulator doesn't emit it).

    The same ``np.random.RandomState(spec.data.seed)`` draws in the same
    order as the reference's, at ``spec.batcher.b_ro / b_nro``, so both
    give the same bytes. Each batch: ``ro_dense (B_RO, n_dense)`` fp32,
    ``ro_ids (B_RO, n_ro, mh)`` and ``nro_ids (B_NRO, n_nro, mh)`` int32
    below each field's (unpadded) vocab, full lengths, ``seg`` (B_NRO,)
    giving each request B_NRO / B_RO impressions, labels ``y`` (B_NRO,)
    with a 0.3 positive rate; all on ``device``.
    """
    r = np.random.RandomState(spec.data.seed)
    b_ro, b_nro = spec.batcher.b_ro, spec.batcher.b_nro
    if b_nro % b_ro:
        raise ScenarioValidationError(
            f"scenario {spec.name!r}: dlrm synthetic batches need "
            f"batcher.b_nro divisible by batcher.b_ro")
    mh, n_ro = cfg.multi_hot, cfg.n_ro_fields
    n_nro = cfg.n_sparse - n_ro
    out = []
    for _ in range(n_batches):
        ro_dense = r.normal(size=(b_ro, cfg.n_dense)).astype(np.float32)
        ro_ids = np.stack([r.randint(0, cfg.vocabs[f], (b_ro, mh))
                           for f in range(n_ro)], axis=1).astype(np.int32)
        nro_ids = np.stack([r.randint(0, cfg.vocabs[n_ro + f], (b_nro, mh))
                            for f in range(n_nro)], axis=1).astype(np.int32)
        y = (r.uniform(size=(b_nro,)) < 0.3).astype(np.float32)
        batch = {
            "ro_dense": ro_dense, "ro_ids": ro_ids,
            "ro_len": np.full((b_ro, n_ro), mh, np.int32),
            "nro_ids": nro_ids,
            "nro_len": np.full((b_nro, n_nro), mh, np.int32),
            "seg": np.repeat(np.arange(b_ro, dtype=np.int32), b_nro // b_ro),
            "y": y}
        out.append({k: torch.from_numpy(v).to(device)
                    for k, v in batch.items()})
    return out


# ---------------------------------------------------------------------------
# Training: the whole recsys path, spec in -> (trainer, final state) out
# ---------------------------------------------------------------------------

def train_from_scenario(spec: ScenarioSpec, *, ckpt_dir: Optional[str] = None,
                        shard_dir: Optional[str] = None, rng_seed: int = 0,
                        prints: bool = True,
                        telemetry_path: Optional[str] = None,
                        device="cuda"):
    """Run the spec's training end to end; returns ``(trainer, state)``.

    ``ckpt_dir`` / ``shard_dir`` / ``telemetry_path`` are runtime
    locations, deliberately NOT part of the spec (a spec hash must be
    machine-portable); ``shard_dir`` is required by ``data.source="disk"``.
    ``telemetry_path`` (or ``obs.export`` in the spec, which defaults the
    file to ``<ckpt_dir>/telemetry.jsonl``) installs a JSONL telemetry
    emitter for the duration of the run. Raises
    :class:`ScenarioValidationError` on config conflicts and on what the
    port cannot run yet (the CLI turns those into exit messages).
    """
    spec.validate()
    refuse_unported(spec, training=True)
    spec.apply()
    emitter = _install_emitter(spec, telemetry_path, ckpt_dir)
    try:
        return _train_from_scenario(spec, ckpt_dir=ckpt_dir,
                                    shard_dir=shard_dir, rng_seed=rng_seed,
                                    prints=prints, device=device)
    finally:
        if emitter is not None:
            from repro_torch.obs import export as obs_export
            obs_export.install(None)
            emitter.close(final_source="train.final")


def _install_emitter(spec: ScenarioSpec, telemetry_path: Optional[str],
                     ckpt_dir: Optional[str]):
    if not (spec.obs.export or telemetry_path):
        return None
    from repro_torch.obs import export as obs_export
    if telemetry_path is None:
        if not ckpt_dir:
            raise ScenarioValidationError(
                "obs.export needs somewhere to write: pass --obs-export "
                "PATH or a --ckpt-dir (defaults to "
                "<ckpt_dir>/telemetry.jsonl)")
        os.makedirs(ckpt_dir, exist_ok=True)
        telemetry_path = os.path.join(ckpt_dir, "telemetry.jsonl")
    emitter = obs_export.TelemetryEmitter(
        telemetry_path, every_s=spec.obs.export_every_s,
        scenario_hash=spec.content_hash())
    obs_export.install(emitter)
    return emitter


def _train_from_scenario(spec: ScenarioSpec, *, ckpt_dir, rng_seed, prints,
                         device, shard_dir: Optional[str] = None,
                         bundle: Optional[ModelBundle] = None):
    """The run itself, on a spec already validated and applied. ``bundle``
    replaces ``build_model``'s (a seam for tests that carry another
    package's parameters in)."""
    from repro_torch.obs.log import get_logger
    from repro_torch.reliability import faults as _faults
    arch, tr = spec.model.arch, spec.train
    plan = _plan_from_spec(spec, device) if tr.mesh else None
    if plan is not None:
        import torch.distributed as dist
        prints = prints and dist.get_rank() == 0   # one rank logs
    log = get_logger("scenario", enabled=prints)
    if plan is not None:
        log.info("mesh", axes=plan.mesh.shape, devices=plan.mesh.size)
    _fplan = _faults.active_plan()
    if _fplan is not None:
        # fault injection is never silent: a chaos run announces itself
        log.info("fault-injection-active", plan=_fplan.to_env())

    if spec.data.source == "disk" and not shard_dir:
        raise ScenarioValidationError(
            "data.source='disk' needs a shard_dir (--shard-dir)")
    if bundle is None:
        bundle = build_model(spec, torch.Generator().manual_seed(rng_seed),
                             sparse=tr.sparse_emb, device=device, plan=plan)
    if tr.sparse_emb and bundle.vag_fn is None:
        raise ScenarioValidationError(
            f"{arch} has no table_ids declaration; train.sparse_emb "
            f"unsupported")
    from repro_torch.distributed.spmd import data_shard_count
    batcher_cfg = build_batcher_cfg(spec, n_shards=data_shard_count(plan))

    from repro_torch.train.loop import Trainer, TrainLoopConfig
    from repro_torch.train.optim import (adam, default_is_embedding,
                                         make_mixed, rowwise_adagrad)
    opt = make_mixed(adam(tr.lr_dense), rowwise_adagrad(tr.lr_emb),
                     default_is_embedding)
    trainer = Trainer(
        bundle.loss_fn, opt,
        TrainLoopConfig(total_steps=tr.steps, log_every=tr.log_every,
                        ckpt_dir=ckpt_dir, ckpt_every=tr.ckpt_every,
                        keep_last=tr.keep_last, microbatches=tr.microbatches,
                        halt_after_skips=tr.halt_after_skips,
                        ckpt_meta=ckpt_meta(spec)),
        lambda: bundle.params, value_and_grad_fn=bundle.vag_fn,
        metrics_fn=bundle.metrics_fn, device=device, plan=plan)

    if spec.data.source == "synthetic" or arch == "dlrm-mlperf":
        if arch != "dlrm-mlperf":
            raise ScenarioValidationError(
                f"data.source='synthetic' is the dlrm-mlperf field-batch "
                f"path; {arch} trains from the event stream "
                f"(data.source memory|disk)")
        if spec.data.source != "synthetic":
            raise ScenarioValidationError(
                "dlrm-mlperf consumes MLPerf field-dict batches, not ROO "
                "samples — set data.source='synthetic'")
        batches = synthetic_dlrm_batches(spec, bundle.cfg, device=device)
        state = trainer.run(_cycling_iter_fn(batches), rng_seed)
    elif spec.data.source == "disk":
        state = _train_disk(spec, trainer, rng_seed, batcher_cfg, plan,
                            shard_dir=shard_dir, ckpt_dir=ckpt_dir,
                            device=device, log=log)
    elif plan is None:
        from repro_torch.data.batcher import ROOBatcher
        batches = list(ROOBatcher(batcher_cfg, device=device)
                       .batches(build_samples(spec)))
        state = trainer.run(_cycling_iter_fn(batches), rng_seed)
    else:
        # each rank packs the whole batch on the host and keeps its block
        from repro_torch.data.batcher import ROOBatcher
        from repro_torch.distributed.spmd import place_batch
        batches = [place_batch(b, plan).to(device) for b in ROOBatcher(
            batcher_cfg, device="cpu").batches(build_samples(spec))]
        state = trainer.run(_cycling_iter_fn(batches), rng_seed)
    if trainer.skipped_steps:
        log.info("steps-skipped", n=trainer.skipped_steps)
    return trainer, state


def check_mesh(spec: ScenarioSpec) -> int:
    """The reference's refusals of a ``train.mesh`` spec: archs outside
    ``PLAN_ARCHS``, sparse rows, batches the data shards do not divide.
    Returns the number of data shards."""
    from repro_torch.launch.mesh import parse_mesh_spec
    arch = spec.model.arch
    if arch not in PLAN_ARCHS:
        # only archs whose loss threads the plan into sharded lookups may
        # run under a mesh
        raise ScenarioValidationError(
            f"train.mesh supports {', '.join(PLAN_ARCHS)} (their losses "
            f"route lookups through the sharding plan); {arch} would "
            f"train slower sharded than replicated")
    if spec.train.sparse_emb:
        # the GatheredTable proxy gathers rows locally, bypassing the
        # collectives a row-sharded table needs: one regime per run
        raise ScenarioValidationError(
            "train.sparse_emb and train.mesh are mutually exclusive: sparse "
            "row grads assume locally-addressable tables")
    dims, _ = parse_mesh_spec(spec.train.mesh)
    n_data = 1
    for d in dims[:-1]:
        n_data *= d
    if spec.batcher.b_ro % n_data or spec.batcher.b_nro % n_data:
        raise ScenarioValidationError(
            f"batcher.b_ro/b_nro must be divisible by the mesh's "
            f"{n_data} data shard(s)")
    return n_data


def _plan_from_spec(spec: ScenarioSpec, device):
    """The SPMD plan ``train.mesh`` asks for (after :func:`check_mesh`),
    over the world this process is in."""
    check_mesh(spec)
    from repro_torch.distributed.sharding import plan_for_mesh
    from repro_torch.launch.hostdevices import default_backend
    from repro_torch.launch.mesh import make_mesh_from_spec
    try:
        mesh = make_mesh_from_spec(spec.train.mesh, default_backend(device))
    except RuntimeError as e:
        raise ScenarioValidationError(str(e)) from None
    return plan_for_mesh(mesh)


def _cycling_iter_fn(batches):
    def batch_iter(start):
        def gen():
            i = start
            while True:
                yield batches[i % len(batches)]
                i += 1
        return gen()
    return batch_iter


def build_shards(spec: ScenarioSpec, shard_dir: str, log=None):
    """The spec's shards in ``shard_dir``: reused when the directory's
    manifest was built from this spec's data (``provenance_matches``),
    else joined online from the event stream and written. A manifest of
    other data is refused, never overwritten. Returns the manifest."""
    from repro_torch.pipeline import (OnlineJoinConfig, WatermarkJoiner,
                                      load_manifest, write_samples)
    provenance = shard_provenance(spec)
    try:
        manifest = load_manifest(shard_dir)
    except FileNotFoundError:
        from repro_torch.data.events import EventSimulator
        joiner = WatermarkJoiner(OnlineJoinConfig(
            label_wait_s=spec.data.label_wait_s))
        samples = joiner.join(
            EventSimulator(build_stream_cfg(spec)).stream())
        manifest = write_samples(
            shard_dir, samples,
            requests_per_shard=spec.data.requests_per_shard,
            provenance=provenance)
        st = joiner.stats
        if log is not None:
            log.info("shards-built", requests=st.requests_emitted,
                     label_completeness=round(st.label_completeness, 3),
                     mean_close_lag_s=round(st.mean_close_lag_s, 1),
                     shards=len(manifest.shards),
                     mb=round(manifest.n_bytes / 1e6, 2))
        return manifest
    if not provenance_matches(manifest.provenance, spec):
        raise ScenarioValidationError(
            f"[pipeline] {shard_dir} holds shards built with different "
            f"settings:\n  stored:    {manifest.provenance}\n"
            f"  requested: {provenance}\n"
            f"Pick another --shard-dir or delete the old one.")
    if log is not None:
        log.info("shards-reused", n=len(manifest.shards), dir=shard_dir)
    return manifest


def _train_disk(spec, trainer, rng_seed, batcher_cfg, plan, *, shard_dir,
                ckpt_dir, device, log):
    """Disk pipeline: (re)build shards, wire cursor resume, run. The
    loader's threads are joined before this returns, also on an error.
    Under a plan rank 0 builds the shards (the others wait at a barrier),
    each rank's loader thread cuts its block off every batch, and rank 0
    alone writes the cursors."""
    from repro_torch.distributed.spmd import make_batch_sharding_fn
    from repro_torch.pipeline import make_data_source
    rank0 = True
    if plan is not None:
        import torch.distributed as dist
        rank0 = dist.get_rank() == 0
        if rank0:
            build_shards(spec, shard_dir, log)
        dist.barrier()
    manifest = build_shards(spec, shard_dir, log if rank0 else None)
    cursor_dir = os.path.join(ckpt_dir or shard_dir, "cursors")
    source = make_data_source(shard_dir, batcher_cfg, cursor_dir,
                              prefetch=spec.data.prefetch, device=device,
                              strict=spec.data.strict_shards,
                              fingerprint=cursor_fingerprint(spec, manifest),
                              sharding=make_batch_sharding_fn(plan))
    with source:                       # join producer threads on exit
        state = trainer.run(source.batch_iter_fn, rng_seed,
                            on_checkpoint=(source.on_checkpoint if rank0
                                           else None))
    ds_stats = source.loader.dataset.stats
    if rank0 and ds_stats.shards_quarantined:
        log.info("shards-quarantined", n=ds_stats.shards_quarantined,
                 files=ds_stats.quarantined_files)
    return state


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def engine_from_scenario(spec: ScenarioSpec, params=None, rng_seed: int = 0,
                         clock=None, device="cuda"):
    """ScoringEngine for the spec's model (the ``from_scenario`` core), on
    ``device``.

    ``params=None`` initializes fresh parameters from ``rng_seed`` —
    handy for benchmarks; production passes trained params.
    """
    import time as _time

    from repro_torch.serve.bucketing import BucketLadder
    from repro_torch.serve.engine import EnginePolicy, ScoringEngine
    from repro_torch.serve.user_cache import UserStateStore, UserTowerCache

    spec.validate()
    refuse_unported(spec, training=False)
    spec.apply()
    bundle = build_model(spec, torch.Generator().manual_seed(rng_seed),
                         device=device)
    if bundle.serve is None:
        raise ScenarioValidationError(
            f"scenario {spec.name!r}: {spec.model.arch} is not servable "
            f"through the ROO engine (field-dict batches, no ROO forward)")
    sv = spec.serve
    policy = EnginePolicy(max_requests=sv.max_requests,
                          max_impressions=sv.max_impressions,
                          max_delay_ms=sv.max_delay_ms,
                          hist_len=spec.batcher.hist_len,
                          breaker_threshold=sv.breaker_threshold,
                          breaker_cooldown_s=sv.breaker_cooldown_s)
    ladder = (BucketLadder.geometric(
                  min_b_ro=min(4, sv.max_requests),
                  min_b_nro=min(32, sv.max_impressions),
                  max_b_ro=sv.max_requests, max_b_nro=sv.max_impressions)
              if sv.bucketed else
              BucketLadder.fixed(sv.max_requests, sv.max_impressions))
    adapter = bundle.serve
    cache = None
    state_store = None
    if sv.cache_user_tower:
        if not adapter.supports_user_cache:
            raise ScenarioValidationError(
                f"scenario {spec.name!r}: serve.cache_user_tower needs "
                f"split user/score entry points; {spec.model.arch} has a "
                f"fused forward only")
        cache = UserTowerCache(sv.cache_capacity)
    if sv.incremental:
        if not adapter.supports_incremental:
            raise ScenarioValidationError(
                f"scenario {spec.name!r}: serve.incremental needs the "
                f"stateful adapter hooks (init_user_state/score_from_state);"
                f" {spec.model.arch} serves statelessly")
        if adapter.state_hist_len != spec.batcher.hist_len:
            raise ScenarioValidationError(
                f"scenario {spec.name!r}: serve.incremental needs the "
                f"model's state window to equal the batcher window "
                f"(model.hist_len {adapter.state_hist_len} != "
                f"batcher.hist_len {spec.batcher.hist_len}); otherwise "
                f"'prefix of the served history' is ill-defined")
        state_store = UserStateStore(sv.state_capacity)
    return ScoringEngine(
        params if params is not None else bundle.params,
        policy=policy, ladder=ladder, adapter=adapter,
        user_fn=adapter.user_repr if cache is not None else None,
        score_from_user=(adapter.score_from_user
                         if cache is not None else None),
        cache=cache, state_store=state_store,
        attn_backend=spec.knobs.attn_backend, device=device,
        clock=clock if clock is not None else _time.monotonic)
