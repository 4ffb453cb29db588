"""ScenarioSpec — one declarative, serializable config surface per scenario
(torch port of ``repro/scenario/spec.py``; standard library only).

A ``ScenarioSpec`` names everything a run needs — model, batcher, data
source, training, serving, the runtime knobs and observability — and every
consumer (``launch/train.py``, ``ScoringEngine.from_scenario``,
``scenario/smoke.py``) builds itself from the same spec through
``scenario/build.py``, so two runs with equal specs are bit-identical by
construction.

The schema is the reference's, field for field, with the same defaults
and ``schema_version``: a spec's JSON bytes, ``content_hash()`` and
``data_hash()`` are the same in both packages, and a spec written by one
loads in the other. What differs is what the values are checked against:

  * the backend knobs validate against the port's own ladder
    (``attn_backend``: ``cuda | torch-chunked | torch-dense``;
    ``emb_backend``: ``cuda | torch``), so a spec that pins a reference-only
    backend such as ``pallas`` is rejected, naming the port's choices;
  * the ``comms_*`` knobs validate against the reference's choices, copied
    here (so a bare spec round-trip stays standard library only), and
    ``apply()`` installs them on ``distributed/comms.py``'s knobs;
  * ``faults`` parses with the port's ``reliability.faults``, ``obs.mode``
    against the port's ``obs`` modes.

Design rules (the reference's):

  * **Serializable, strictly validated.** ``to_json``/``from_json`` round-
    trip bit-identically; the decoder rejects unknown fields, wrong types
    and future schema versions loudly.
  * **No paths inside the spec.** Checkpoint and telemetry locations are
    runtime arguments, so a spec (and its hash) is portable.
  * **Content-addressed provenance.** :meth:`ScenarioSpec.content_hash`
    fingerprints the whole spec and is stamped into checkpoint
    ``meta.json``; :meth:`ScenarioSpec.data_hash` covers only the
    stream/batcher-deciding sections.
  * **One precedence ladder.** :meth:`ScenarioSpec.apply` installs the
    spec's knobs as process defaults on the port's ladder
    (``scenario/knobs.py``: explicit arg > scoped > default > env > auto).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import typing
from typing import Any, Dict, Mapping, Optional, Tuple

SCHEMA_VERSION = 1


class ScenarioValidationError(ValueError):
    """A spec failed validation (unknown field, bad type, bad value)."""


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What to train/serve. ``arch`` keys the registry; the few shared
    shape knobs cover the recsys zoo (0/"" = the arch's default)."""
    arch: str = ""
    n_items: int = 50000
    hist_len: int = 64
    seq_len: int = 0          # sequence models (dien/bert4rec); 0 = default
    m_targets: int = 16       # GR ranking targets
    embed_dim: int = 0        # 0 = arch default
    variant: str = ""         # lsr mode / two-tower user-tower mode


@dataclasses.dataclass(frozen=True)
class BatcherSpec:
    b_ro: int = 32            # requests per batch
    b_nro: int = 192          # impression slots per batch
    hist_len: int = 64


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Event stream + (for ``source="disk"``) the shard pipeline knobs.
    ``n_items=0`` follows ``model.n_items`` so the stream can never emit
    ids the model's tables don't cover."""
    source: str = "memory"    # memory | disk | synthetic (dlrm field batches)
    n_requests: int = 800
    n_users: int = 200
    n_items: int = 0
    hist_init_max: int = 48
    product: str = "product_a"
    seed: int = 0
    late_fraction: float = 0.0
    label_wait_s: float = 600.0
    requests_per_shard: int = 256
    prefetch: bool = True
    strict_shards: bool = False


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 100
    keep_last: int = 3
    microbatches: int = 1
    lr_dense: float = 1e-3    # Adam on dense weights
    lr_emb: float = 0.05      # row-wise Adagrad on embedding tables
    sparse_emb: bool = False  # COO row grads + touched-rows-only updates
    halt_after_skips: int = 0
    mesh: str = ""            # "" = single device; else "DATAxMODEL" e.g. 2x4


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    max_requests: int = 64
    max_impressions: int = 512
    max_delay_ms: float = 2.0
    bucketed: bool = True
    cache_user_tower: bool = False
    cache_capacity: int = 4096
    incremental: bool = False     # per-user K/V state, O(new events)/request
    state_capacity: int = 256     # users resident in the state store
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 1.0


@dataclasses.dataclass(frozen=True)
class KnobsSpec:
    """Runtime knobs installed as process defaults by ``apply()`` — each
    resolves through the shared ladder in ``scenario.knobs``; ``None``
    leaves the rung unset (env var / auto decide)."""
    attn_backend: Optional[str] = None
    emb_backend: Optional[str] = None
    emb_dedup: Optional[str] = None     # always | never | auto
    faults: Optional[str] = None        # REPRO_TORCH_FAULTS grammar
    # the comms group (distributed/comms.py): wire compression for the
    # sharded-embedding exchange, overlap of lookup collectives with dense
    # compute across the grad-accum microbatches, int8 scale-block width
    comms_compress: Optional[str] = None   # none | bf16 | int8
    comms_overlap: Optional[str] = None    # on | off
    comms_block: Optional[int] = None      # int8 scale-block width


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Observability (repro_torch.obs). ``mode`` rides the knob ladder like
    any other knob (``None`` leaves REPRO_TORCH_OBS / auto in charge);
    ``export``
    asks the run's build path to install a JSONL telemetry emitter (the
    file path stays a runtime argument — specs never carry paths)."""
    mode: Optional[str] = None          # off | metrics | trace
    export: bool = False
    export_every_s: float = 0.0         # min seconds between JSONL lines
    verbosity: Optional[int] = None     # 0=errors 1=progress 2=debug


# the comms group's choices (distributed/comms.py), copied so validate()
# imports nothing
COMMS_COMPRESS_MODES = ("none", "bf16", "int8")
COMMS_OVERLAP_MODES = ("on", "off")
# the backend knobs apply() installs on the port's ladder, and the comms
# group it installs on distributed/comms.py's knobs
LADDER_KNOBS = ("attn_backend", "emb_backend", "emb_dedup")
COMMS_KNOBS = ("comms_compress", "comms_overlap", "comms_block")

_SECTIONS = {"model": ModelSpec, "batcher": BatcherSpec, "data": DataSpec,
             "train": TrainSpec, "serve": ServeSpec, "knobs": KnobsSpec,
             "obs": ObsSpec}


# ---------------------------------------------------------------------------
# Strict decoding helpers
# ---------------------------------------------------------------------------

def _decode_field(value, ftype, path: str):
    """JSON value -> field value, strictly typed (bool is not an int)."""
    origin = typing.get_origin(ftype)
    if origin is typing.Union:                      # Optional[str]
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if value is None:
            return None
        return _decode_field(value, args[0], path)
    if ftype is bool:
        if not isinstance(value, bool):
            raise ScenarioValidationError(f"{path}: expected bool, got "
                                          f"{value!r}")
        return value
    if ftype is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ScenarioValidationError(f"{path}: expected int, got "
                                          f"{value!r}")
        return value
    if ftype is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ScenarioValidationError(f"{path}: expected float, got "
                                          f"{value!r}")
        return float(value)
    if ftype is str:
        if not isinstance(value, str):
            raise ScenarioValidationError(f"{path}: expected str, got "
                                          f"{value!r}")
        return value
    raise ScenarioValidationError(f"{path}: unsupported field type {ftype}")


def _decode_section(cls, obj, path: str):
    if not isinstance(obj, Mapping):
        raise ScenarioValidationError(f"{path}: expected an object, got "
                                      f"{obj!r}")
    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(obj) - set(fields)
    if unknown:
        raise ScenarioValidationError(
            f"{path}: unknown field(s) {sorted(unknown)}; "
            f"valid: {sorted(fields)}")
    kwargs = {name: _decode_field(obj[name], hints[name], f"{path}.{name}")
              for name in obj}
    return cls(**kwargs)


def _coerce(text: Any, ftype):
    """--set string -> typed value (typed values pass through checked)."""
    if not isinstance(text, str):
        return text
    origin = typing.get_origin(ftype)
    if origin is typing.Union:
        if text.lower() in ("none", "null", ""):
            return None
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        return _coerce(text, args[0])
    if ftype is bool:
        if text.lower() in ("1", "true", "yes", "on"):
            return True
        if text.lower() in ("0", "false", "no", "off"):
            return False
        raise ScenarioValidationError(f"can't parse bool from {text!r}")
    if ftype is int:
        return int(text)
    if ftype is float:
        return float(text)
    return text


# ---------------------------------------------------------------------------
# The spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    name: str
    model: ModelSpec
    batcher: BatcherSpec = BatcherSpec()
    data: DataSpec = DataSpec()
    train: TrainSpec = TrainSpec()
    serve: ServeSpec = ServeSpec()
    knobs: KnobsSpec = KnobsSpec()
    obs: ObsSpec = ObsSpec()

    # -- serialization ----------------------------------------------------------
    def to_json(self) -> dict:
        out: Dict[str, Any] = {"schema_version": SCHEMA_VERSION,
                               "name": self.name}
        for sec in _SECTIONS:
            out[sec] = dataclasses.asdict(getattr(self, sec))
        return out

    def to_json_str(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_json(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, obj) -> "ScenarioSpec":
        if isinstance(obj, str):
            obj = json.loads(obj)
        if not isinstance(obj, Mapping):
            raise ScenarioValidationError(f"spec: expected an object, got "
                                          f"{type(obj).__name__}")
        version = obj.get("schema_version")
        if not isinstance(version, int) or isinstance(version, bool):
            raise ScenarioValidationError(
                "spec: missing/invalid schema_version (int required)")
        if version > SCHEMA_VERSION:
            raise ScenarioValidationError(
                f"spec: schema_version {version} is newer than supported "
                f"{SCHEMA_VERSION} — upgrade the code, don't guess")
        unknown = set(obj) - set(_SECTIONS) - {"schema_version", "name"}
        if unknown:
            raise ScenarioValidationError(
                f"spec: unknown section(s) {sorted(unknown)}; "
                f"valid: {sorted(_SECTIONS)}")
        name = obj.get("name")
        if not isinstance(name, str) or not name:
            raise ScenarioValidationError("spec: 'name' (non-empty str) "
                                          "required")
        sections = {sec: _decode_section(scls, obj.get(sec, {}), sec)
                    for sec, scls in _SECTIONS.items()}
        spec = cls(name=name, **sections)
        spec.validate()
        return spec

    @classmethod
    def load(cls, path: str) -> "ScenarioSpec":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json_str() + "\n")

    # -- validation -------------------------------------------------------------
    def validate(self) -> "ScenarioSpec":
        """Value-level checks (types were enforced at decode). Raises
        :class:`ScenarioValidationError`; returns self for chaining."""
        def bad(msg):
            raise ScenarioValidationError(f"scenario {self.name!r}: {msg}")

        if not self.model.arch:
            bad("model.arch is required")
        if self.data.source not in ("memory", "disk", "synthetic"):
            bad(f"data.source {self.data.source!r} not in "
                f"memory|disk|synthetic")
        for field, val in (("train.steps", self.train.steps),
                           ("train.log_every", self.train.log_every),
                           ("train.ckpt_every", self.train.ckpt_every),
                           ("train.microbatches", self.train.microbatches),
                           ("batcher.b_ro", self.batcher.b_ro),
                           ("batcher.b_nro", self.batcher.b_nro),
                           ("data.n_requests", self.data.n_requests),
                           ("data.requests_per_shard",
                            self.data.requests_per_shard)):
            if val <= 0:
                bad(f"{field} must be positive, got {val}")
        if self.train.mesh:
            parts = self.train.mesh.lower().split("x")
            if not (2 <= len(parts) <= 3 and
                    all(p.isdigit() and int(p) > 0 for p in parts)):
                bad(f"train.mesh {self.train.mesh!r} is not DATAxMODEL "
                    f"(e.g. 2x4)")
        # backend knobs validate against the port's own registry (the
        # registering modules are imported lazily, and only when a knob is
        # set, so a bare spec round-trip stays stdlib-only)
        if any(getattr(self.knobs, k) is not None for k in LADDER_KNOBS):
            for kname, knob in _ladder_knobs().items():
                val = getattr(self.knobs, kname)
                if val is not None:
                    try:
                        knob.check(val)
                    except ValueError as e:
                        bad(str(e))
        for kname, choices in (("comms_compress", COMMS_COMPRESS_MODES),
                               ("comms_overlap", COMMS_OVERLAP_MODES)):
            val = getattr(self.knobs, kname)
            if val is not None and val not in choices:
                bad(f"unknown {kname} {val!r}; expected one of {choices}")
        if self.knobs.comms_block is not None and self.knobs.comms_block <= 0:
            bad(f"knobs.comms_block must be positive, "
                f"got {self.knobs.comms_block}")
        if self.knobs.faults is not None:
            from repro_torch.reliability.faults import FaultPlan
            try:
                FaultPlan.parse(self.knobs.faults)
            except ValueError as e:
                bad(f"knobs.faults: {e}")
        if self.serve.incremental and self.serve.cache_user_tower:
            bad("serve.incremental and serve.cache_user_tower are mutually "
                "exclusive: the state store already subsumes the user-tower "
                "memoization for stateful archs — pick one")
        if self.serve.state_capacity <= 0:
            bad(f"serve.state_capacity must be positive, got "
                f"{self.serve.state_capacity}")
        if self.obs.mode is not None:
            from repro_torch.obs.metrics import OBS_MODES
            if self.obs.mode not in OBS_MODES:
                bad(f"obs.mode {self.obs.mode!r} not in "
                    + "|".join(OBS_MODES))
        if self.obs.verbosity is not None and self.obs.verbosity < 0:
            bad(f"obs.verbosity must be >= 0, got {self.obs.verbosity}")
        if self.obs.export_every_s < 0:
            bad(f"obs.export_every_s must be >= 0, got "
                f"{self.obs.export_every_s}")
        return self

    # -- provenance hashes ------------------------------------------------------
    def content_hash(self) -> str:
        """Content address of the WHOLE spec — the provenance fingerprint
        stamped into checkpoint meta, manifests and bench artifacts."""
        blob = json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]

    def data_hash(self) -> str:
        """Hash of only the stream/batcher-deciding sections: two specs
        with equal data_hash produce bit-identical batch streams, so this
        (plus the shard manifest) is what resume cursors key on."""
        obj = {"data": dataclasses.asdict(
                   dataclasses.replace(self.data,
                                       n_items=self.stream_n_items(),
                                       prefetch=True, strict_shards=False)),
               "batcher": dataclasses.asdict(self.batcher)}
        blob = json.dumps(obj, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]

    def stream_n_items(self) -> int:
        return self.data.n_items or self.model.n_items

    # -- overrides (--set key=value) -------------------------------------------
    def with_overrides(self, overrides: Mapping[str, Any]) -> "ScenarioSpec":
        """New spec with dotted-path overrides applied; values may be
        typed or ``--set``-style strings (coerced by field type)."""
        spec = self
        for key, raw in overrides.items():
            if key == "name":
                spec = dataclasses.replace(spec, name=str(raw))
                continue
            try:
                sec_name, field = key.split(".", 1)
            except ValueError:
                raise ScenarioValidationError(
                    f"override {key!r}: expected section.field "
                    f"(e.g. train.steps)") from None
            if sec_name not in _SECTIONS:
                raise ScenarioValidationError(
                    f"override {key!r}: unknown section {sec_name!r}; "
                    f"valid: {sorted(_SECTIONS)}")
            scls = _SECTIONS[sec_name]
            hints = typing.get_type_hints(scls)
            if field not in hints:
                raise ScenarioValidationError(
                    f"override {key!r}: {scls.__name__} has no field "
                    f"{field!r}; valid: {sorted(hints)}")
            value = _coerce(raw, hints[field])
            value = _decode_field(value, hints[field], key)
            section = dataclasses.replace(getattr(spec, sec_name),
                                          **{field: value})
            spec = dataclasses.replace(spec, **{sec_name: section})
        return spec.validate()

    # -- runtime knob installation ---------------------------------------------
    def apply(self) -> "ScenarioSpec":
        """Install the spec's backend and comms knobs as the process
        defaults on the port's ladder (spec beats env, per-call args beat
        the spec), the fault plan when one is named, and the obs mode and
        verbosity. Returns self."""
        if any(getattr(self.knobs, k) is not None
               for k in LADDER_KNOBS + COMMS_KNOBS):
            for kname, knob in _ladder_knobs(comms=True).items():
                val = getattr(self.knobs, kname)
                if val is not None:
                    knob.set_default(val)
        if self.knobs.faults is not None:
            from repro_torch.reliability import faults
            faults.install(faults.FaultPlan.parse(self.knobs.faults))
        if self.obs.mode is not None:
            from repro_torch.obs.metrics import OBS_KNOB
            OBS_KNOB.set_default(self.obs.mode)
        if self.obs.verbosity is not None:
            from repro_torch.obs.log import VERBOSITY_KNOB
            VERBOSITY_KNOB.set_default(self.obs.verbosity)
        return self


def _ladder_knobs(comms: bool = False) -> Dict[str, Any]:
    """The port's backend knobs by spec field name, and with ``comms`` the
    comms group's (imports the modules that register them)."""
    from repro_torch.embeddings.collection import DEDUP_KNOB
    from repro_torch.kernels.dispatch import ATTN_KNOB, EMB_KNOB
    knobs = {"attn_backend": ATTN_KNOB, "emb_backend": EMB_KNOB,
             "emb_dedup": DEDUP_KNOB}
    if comms:
        from repro_torch.distributed import comms as _comms
        knobs.update(comms_compress=_comms.COMPRESS_KNOB,
                     comms_overlap=_comms.OVERLAP_KNOB,
                     comms_block=_comms.BLOCK_KNOB)
    return knobs


def parse_set_args(pairs) -> Dict[str, str]:
    """``--set key=value`` argv fragments -> overrides dict."""
    out: Dict[str, str] = {}
    for pair in pairs or ():
        if "=" not in pair:
            raise ScenarioValidationError(
                f"--set {pair!r}: expected key=value")
        key, value = pair.split("=", 1)
        out[key.strip()] = value.strip()
    return out


def scenario_sections() -> Tuple[str, ...]:
    return tuple(_SECTIONS)
