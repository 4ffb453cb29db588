"""The compressed sparse-embedding exchange (torch port of
``repro/distributed/comms.py``).

  * **Wire compression** (``none | bf16 | int8``): :func:`wire_transform`
    fake-quantizes a lookup's per-shard partial *before* its collective,
    so the value summed is what the compressed bytes carry
    (:func:`wire_bytes` accounts them; the collective itself runs in the
    compute dtype). int8 uses per-block max-abs scales
    (:data:`BLOCK_KNOB` values a scale). The transform is a straight-
    through ``autograd.Function``: the quantized value forward, the
    identity backward, so a compressed lookup's table gradient is exact.
  * **Error feedback** (Karimireddy et al. 2019) for the gradient
    exchange: :func:`ef_init` builds ``state["comms_ef"]``, one f32
    ``(V, D)`` residual per compressed table; :func:`ef_compress_step`
    sends ``q(g + e)`` and keeps ``e' = (g + e) - q(g + e)``.
    ``SparseRows`` gradients compress row-wise: only the batch's unique
    rows ride the quantizer and the residual moves at those rows.
  * **Overlap**: with ``comms_overlap=on`` and microbatches > 1 the train
    step issues each microbatch's gradient reduction asynchronously and
    waits once before the optimizer (``train/loop.py``).
  * **Accounting**: :data:`STATS` (a :class:`CommsStats`) records every
    exchange site — f32 vs on-wire bytes, compression ratio, overlap
    occupancy — and mirrors into ``repro_torch.obs`` as
    ``distributed.comms``. Lookup sites record the exchange's global
    shape (the reference's ``B`` is the whole batch); gradient sites
    record the block a rank sends. The LM's dense exchanges under a plan
    (FSDP gathers, sequence gathers and scatters, the MoE's
    ``all_to_all``) accumulate by call in ``dense_sites``
    (:meth:`CommsStats.record_bytes`).

Knobs (the port's ladder, ``scenario/knobs.py``): ``comms_compress``
(``REPRO_TORCH_COMMS_COMPRESS``), ``comms_overlap``
(``REPRO_TORCH_COMMS_OVERLAP``), ``comms_block``
(``REPRO_TORCH_COMMS_BLOCK``, default 128).
"""
from __future__ import annotations

import math
import re
import threading
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.embeddings import sparse as _sp
from repro_torch.obs import metrics as obs_metrics
from repro_torch.scenario.knobs import UNSET, Knob
from repro_torch.tree import flatten_with_path

COMPRESS_MODES = ("none", "bf16", "int8")

COMPRESS_KNOB = Knob("comms_compress", "REPRO_TORCH_COMMS_COMPRESS",
                     choices=COMPRESS_MODES, auto=lambda: "none")
OVERLAP_KNOB = Knob("comms_overlap", "REPRO_TORCH_COMMS_OVERLAP",
                    choices=("on", "off"), auto=lambda: "off")
BLOCK_KNOB = Knob("comms_block", "REPRO_TORCH_COMMS_BLOCK", parse=int,
                  auto=lambda: 128)

# bytes per element on the wire, excluding int8's per-block scales
_WIRE_BYTES_PER_ELT = {"none": 4, "bf16": 2, "int8": 1}
_SCALE_BYTES = 4   # one f32 scale per block


def compress_mode(arg=UNSET) -> str:
    return COMPRESS_KNOB.resolve(arg)


def overlap_enabled(arg=UNSET) -> bool:
    return OVERLAP_KNOB.resolve(arg) == "on"


def block_size(arg=UNSET) -> int:
    return int(BLOCK_KNOB.resolve(arg))


# ---------------------------------------------------------------------------
# Per-block quantization
# ---------------------------------------------------------------------------

def _effective_block(last_dim: int, block: int) -> int:
    """The scale-block width used for a last dim of ``last_dim``: the
    configured width when it divides evenly, else the whole row."""
    if block > 0 and last_dim % block == 0:
        return min(block, last_dim)
    return last_dim


def quantize_int8(x: torch.Tensor, block: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8: ``(q, scale)`` with blocks along the last
    dim; ``scale`` has shape ``x.shape[:-1] + (n_blocks, 1)``."""
    d = x.shape[-1]
    b = _effective_block(d, block)
    xb = x.reshape(tuple(x.shape[:-1]) + (d // b, b)).to(torch.float32)
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Tuple[int, ...]) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(shape)


def fake_quant(x: torch.Tensor, mode: str, block: int) -> torch.Tensor:
    """``x`` round-tripped through the wire representation (same dtype):
    the value the receiving ranks reconstruct."""
    if mode == "none":
        return x
    if mode == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if mode == "int8":
        q, s = quantize_int8(x, block)
        return dequantize_int8(q, s, tuple(x.shape)).to(x.dtype)
    raise ValueError(f"unknown comms compress mode {mode!r}")


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mode, block):
        return fake_quant(x, mode, block)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def wire_transform(x: torch.Tensor, mode: str, block: int) -> torch.Tensor:
    """Forward: the quantized value (what crosses the wire). Backward: the
    identity (round and clip have zero gradient almost everywhere; the
    gradient's own exchange is compressed by :func:`ef_compress_step`)."""
    if mode == "none":
        return x
    return _StraightThrough.apply(x, mode, block)


def wire_bytes(shape: Tuple[int, ...], mode: str, block: int = 0) -> int:
    """On-wire payload bytes for one exchange of a tensor of ``shape``."""
    n = int(math.prod(shape))
    if n == 0:
        return 0
    total = n * _WIRE_BYTES_PER_ELT[mode]
    if mode == "int8":
        b = _effective_block(int(shape[-1]), block)
        total += (n // b) * _SCALE_BYTES
    return total


# ---------------------------------------------------------------------------
# CommsStats: per-site accounting, mirrored into repro_torch.obs
# ---------------------------------------------------------------------------

class CommsStats:
    """Per-site exchange ledger. Sites are keyed (overwrite by key), so a
    site that fires every step is counted once; the snapshot reports
    per-step totals assuming each site fires once a step."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._sites: Dict[str, dict] = {}
            self._dense: Dict[str, dict] = {}
            self._overlap: Dict[str, Any] = {
                "enabled": False, "microbatches": 1, "occupancy": 0.0,
                "deferred_grad_exchanges_per_step": 0}

    def record_exchange(self, site: str, shape: Tuple[int, ...], *,
                        mode: str, block: int = 0, kind: str = "lookup",
                        collective: str = "psum",
                        dedup: bool = False) -> None:
        f32 = int(math.prod(shape)) * 4
        wire = wire_bytes(tuple(shape), mode, block)
        if collective == "psum_scatter":
            # a reduce-scatter moves each element once instead of an
            # all-reduce's ~2x
            f32 //= 2
            wire //= 2
        with self._lock:
            self._sites[site] = {
                "shape": tuple(int(s) for s in shape), "mode": mode,
                "kind": kind, "collective": collective, "dedup": bool(dedup),
                "f32_bytes": f32, "wire_bytes": wire}
        _ensure_registered()

    def record_bytes(self, site: str, n_bytes: int,
                     collective: str) -> None:
        """Add one call of a dense exchange site (the LM's FSDP gathers,
        sequence gathers and scatters, the MoE's all_to_all): its bytes
        accumulate, so a site that fires once a layer counts every layer
        (``dense_sites`` in the snapshot)."""
        with self._lock:
            e = self._dense.setdefault(site, {"collective": collective,
                                              "bytes": 0, "calls": 0})
            e["bytes"] += int(n_bytes)
            e["calls"] += 1
        _ensure_registered()

    def record_overlap(self, microbatches: int, enabled: bool) -> None:
        m = max(int(microbatches), 1)
        with self._lock:
            self._overlap = {
                "enabled": bool(enabled and m > 1),
                "microbatches": m,
                "occupancy": (m - 1) / m if (enabled and m > 1) else 0.0,
                "deferred_grad_exchanges_per_step": m - 1}
        _ensure_registered()

    def snapshot(self) -> dict:
        with self._lock:
            sites = {k: dict(v) for k, v in self._sites.items()}
            dense = {k: dict(v) for k, v in self._dense.items()}
            overlap = dict(self._overlap)
        f32 = sum(s["f32_bytes"] for s in sites.values())
        wire = sum(s["wire_bytes"] for s in sites.values())
        out = {
            "sites": sites,
            "exchanges": len(sites),
            "dedup_exchanges": sum(1 for s in sites.values() if s["dedup"]),
            "f32_bytes_per_step": f32,
            "wire_bytes_per_step": wire,
            "compression_ratio": (f32 / wire) if wire else 1.0,
            "overlap": overlap,
        }
        if dense:       # the reference's snapshot has no dense sites
            out["dense_sites"] = dense
        return out


STATS = CommsStats()


def _ensure_registered() -> None:
    # re-register on every record: obs_metrics.reset() clears mirrors
    obs_metrics.register_stats("distributed.comms", STATS)


# ---------------------------------------------------------------------------
# Error-feedback residual for the gradient exchange
# ---------------------------------------------------------------------------

_KEY = re.compile(r"^\['(.*)'\]$")


def _names(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """A ``tree`` path of dict keys (``"['item_emb']"``) -> the key names."""
    return tuple(_KEY.match(p).group(1) for p in path)


def ef_paths(params: Any, plan=None) -> List[Tuple[str, ...]]:
    """Paths (tuples of dict keys) of the table leaves whose gradient
    exchange is compressed: 2-D leaves the optimizer's embedding predicate
    matches that the plan shards (with no plan: tables big enough that
    they would shard). ``params`` holds global shapes."""
    from repro_torch.distributed import spmd
    from repro_torch.train.optim import default_is_embedding
    out: List[Tuple[str, ...]] = []
    for path, leaf in flatten_with_path(params):
        shape = tuple(leaf.shape)
        if len(shape) != 2 or not default_is_embedding(path):
            continue
        if plan is not None and plan.enabled:
            if not spmd.table_is_sharded(plan, shape[0]):
                continue
        elif shape[0] < spmd.SHARD_MIN_ROWS:
            continue
        out.append(_names(path))
    return out


def _get_nested(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set_nested(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def ef_init(params: Any, plan=None) -> Dict[str, Any]:
    """Residual tree for ``state["comms_ef"]``: f32 zeros at each
    compressed table's path, nested like ``params`` (so ``param_spec``
    shards each residual like its table)."""
    out: Dict[str, Any] = {}
    for path in ef_paths(params, plan):
        leaf = _get_nested(params, path)
        _set_nested(out, path, torch.zeros(tuple(leaf.shape),
                                           dtype=torch.float32,
                                           device=leaf.device))
    return out


def ef_compress_step(grads: Any, residual: Any, mode: str,
                     block: int) -> Tuple[Any, Any]:
    """One EF step over the grads tree: ``(sent_grads, new_residual)``,
    each leaf of ``residual`` having its grad replaced by ``q(g + e)`` and
    the residual advanced to ``(g + e) - q(g + e)``. Dense grads compress
    whole; ``SparseRows`` grads are merged first and only their unique
    rows ride the quantizer (untouched rows keep their residual)."""
    if mode == "none" or residual is None:
        return grads, residual
    new_grads, new_res = grads, residual
    for path, e in flatten_with_path(residual):
        names = _names(path)
        key = "/".join(names)
        g = _get_nested(grads, names)
        if _sp.is_sparse(g):
            m = g.merged()
            valid = m.ids < m.vocab
            ids = m.ids.long()
            e_rows = e[torch.clamp(ids, max=m.vocab - 1)] * \
                valid[:, None].to(torch.float32)
            g32 = m.rows.to(torch.float32) + e_rows
            sent_rows = fake_quant(g32, mode, block)
            e2 = e.clone()
            e2[ids[valid]] = (g32 - sent_rows)[valid]
            sent = _sp.SparseRows(m.ids, sent_rows.to(m.rows.dtype),
                                  m.vocab, unique=True)
            STATS.record_exchange(
                "grad:" + key, tuple(m.rows.shape), mode=mode, block=block,
                kind="grad", collective="coo", dedup=True)
        else:
            g32 = g.to(torch.float32) + e
            sent32 = fake_quant(g32, mode, block)
            e2 = g32 - sent32
            sent = sent32.to(g.dtype)
            STATS.record_exchange(
                "grad:" + key, tuple(g.shape), mode=mode, block=block,
                kind="grad", collective="psum")
        new_grads = _sp._set_path(new_grads, key, sent)
        new_res = _sp._set_path(new_res, key, e2)
    return new_grads, new_res
