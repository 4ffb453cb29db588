"""Generic training loop: the train step, gradient accumulation,
checkpoint/resume and deterministic data skipping (torch port of
``repro/train/loop.py``).

The loop is model-agnostic: it takes ``loss_fn(params, batch, gen)`` — gen
a ``torch.Generator`` — and an :class:`~repro_torch.train.optim.Optimizer`.
Fault tolerance contract:

  * state = {params, opt, step, rng} checkpointed every ``ckpt_every`` steps
    (async, atomic). ``rng`` is the run's base seed (an int64 tensor); the
    step's generator is seeded from (base, step) and, under accumulation,
    microbatch i's from (base, step, i). Because the base seed is part of
    the checkpointed state, a resumed run continues bit for bit even if the
    caller passes a different seed to ``run()``;
  * on (re)start, ``run()`` restores the newest committed step and asks the
    data iterator for batches from that step on (iterator keyed by step),
    so a preempted-and-restarted run replays nothing and skips nothing;
  * a non-finite loss or gradient keeps the old params and optimizer state
    (``torch.where`` on the device: no host sync per step unless
    ``halt_after_skips > 0``).

Sparse-row training: ``value_and_grad_fn`` (``make_train_step`` and
``Trainer``) replaces the default autograd ``value_and_grad``;
``embeddings.sparse.make_sparse_value_and_grad`` plugs in here, and its
``SparseRows`` grad leaves flow through accumulation and into the
optimizer. With microbatches the dense part is summed in fp32 and divided
once, and the ``SparseRows`` parts are concatenated in microbatch order
and scaled by 1/microbatches (a COO sum is a concatenation; the
optimizer's merge folds the duplicates), as the reference's unrolled
accumulation does. The grad norm squares each ``SparseRows``' entries
(``sq_sum``). When the grads hold a ``SparseRows`` the step hands the
optimizer its finite flag (``update(..., ok=ok)``): row-wise Adagrad then
writes the touched rows in place, guarded row by row, and the step's
``torch.where`` guard skips the leaves that come back as the same tensors,
so no pass over a whole table is left (``train/optim.py``'s in-place
contract: the step consumes the state it is given). The ``Trainer`` owns
its state: ``init_state`` copies the ``init_params_fn()`` tree, as the
reference's functional update leaves the caller's tree as it was, so two
``run()``s from one tree start from the same params.

The port's generators are not JAX's PRNG, so a loss that draws random
numbers gives other draws than the reference; everything else follows the
reference step for step.

SPMD (``plan=``, ``distributed/``): one process per rank. The Trainer
places its state with ``spmd.place_state``: each leaf as this rank's block
by its spec (tables, their row-wise accumulators and ``comms_ef``
residuals by rows over ``model``; dense leaves of >= 2 dims by their FSDP
rows and TP columns, where the mesh divides them), and builds the step
with the state's specs. A model that reads its dense leaves whole (the
recsys archs) gets them gathered inside the step's loss
(``spmd.gather_dense``: the gather's backward reduce-scatters each
gradient over the batch axes); a model that gathers its own weights (the
LM: ``param_specs=`` and ``grad_axes=``) gets its blocks. The batch
iterator yields what the loss takes (``spmd.place_batch``, or the loader's
``sharding=``; the LM takes the global tokens). The loss sums its batch
reductions over the batch axes (so each rank's loss is the global one and
its gradient its own part); after backward the step applies the one
gradient rule (``spmd.reduce_grads``: each leaf summed over its use's
axes, the batch axes unless ``grad_axes`` says more, less the axes it is
split on), and the grad norm adds each leaf's squares over the axes it is
split on once, so the non-finite guard is the same on every rank. With
``comms_compress`` on and a ``state["comms_ef"]`` the table gradients go
through error feedback (``comms.ef_compress_step``) before the optimizer,
with or without a plan (the reference's single-process simulation of the
exchange); ``comms_overlap=on`` with microbatches issues each
microbatch's reduction asynchronously and waits once before the
optimizer. Checkpoints under a plan gather every block on rank 0, which
writes the reference's sharded layout (``train/checkpoint.py``).

Observability and faults mirror the reference: the Trainer registers its
``snapshot`` as ``train``; in ``trace`` mode each step is a ``train.step``
span over ``train.data`` (the next batch), ``train.compute`` (the step's
dispatch and the syncs it holds: no span synchronizes the card), and at
logging and checkpoint steps ``train.log`` / ``train.checkpoint``; inside
``train.compute`` the device-timed phases (``obs.trace``'s
``device=True``) ``train.forward`` and ``train.backward`` (one pair a
microbatch, from ``value_and_grad`` or the sparse one) and
``train.optimizer`` (the guard's norm, the update and the guard); each logging step
offers a telemetry line (``train.log``). The ``train.batch`` fault site
(kind ``nan``) fills the batch's first float leaf with NaNs on its device,
which the non-finite guard then skips. ``run(on_checkpoint=)`` is called
with the step at every checkpoint save.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.distributed import comms as _comms
from repro_torch.embeddings.sparse import (concat_sparse, is_sparse,
                                           merge_sparse, split_sparse,
                                           sq_sum)
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.reliability import faults
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optim import Optimizer
from repro_torch.tree import leaves, tree_map, unflatten


class NonFiniteLossError(RuntimeError):
    """Raised when ``halt_after_skips`` consecutive steps produced a
    non-finite loss/gradient — the run is diverging, not glitching."""


def _poison_batch(batch):
    """Replace the first float leaf (flatten order) with NaNs on its device
    (``train.batch`` nan fault); no value is read back."""
    flat = leaves(batch)
    for i, leaf in enumerate(flat):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            flat[i] = torch.full_like(leaf, float("nan"))
            break
    return unflatten(batch, flat)


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    microbatches: int = 1          # grad accumulation factor
    ckpt_dir: Optional[str] = None
    keep_last: int = 3
    # halt after this many CONSECUTIVE non-finite (skipped) steps; 0 keeps
    # the guard passive (skips counted in metrics, loop never halts).
    # Enabling it reads the skip flag every step (one small host sync).
    halt_after_skips: int = 0
    # extra provenance merged into every checkpoint's meta.json
    ckpt_meta: Optional[Dict[str, Any]] = None


def step_generator(base: int, *keys: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from (base, *keys) — the port's
    ``fold_in``: distinct keys give unrelated streams."""
    seed = np.random.SeedSequence([int(base) & (2 ** 63 - 1),
                                   *map(int, keys)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch, gen) -> (loss, grads)`` by autograd; ``grads`` has
    the params' tree shape (zeros for a leaf the loss does not use)."""
    def vag(params, batch, gen):
        with obs_trace.span("train.forward", device=True):
            flat = [p.detach().requires_grad_(True) for p in leaves(params)]
            loss = loss_fn(unflatten(params, flat), batch, gen)
        with obs_trace.span("train.backward", device=True):
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = unflatten(params, [torch.zeros_like(p) if g is None else g
                                       for p, g in zip(flat, grads)])
        return loss.detach(), grads
    return vag


def make_train_step(loss_fn: Callable, opt: Optimizer,
                    microbatches: int = 1,
                    value_and_grad_fn: Optional[Callable] = None,
                    plan=None, state_shardings=None, grad_axes=None,
                    gathers_own: bool = False):
    """Returns ``step(state, batch, base_seed, step) -> (state, metrics)``.

    With microbatches > 1, every tensor leaf of ``batch`` has a leading
    microbatch axis; dense gradients are summed over the microbatches in
    fp32 and divided once, as the reference's accumulation does,
    ``SparseRows`` gradients concatenated and scaled (module note), and
    each microbatch gets its own generator. ``value_and_grad_fn(params,
    batch, gen) -> (loss, grads)`` replaces ``value_and_grad(loss_fn)``.
    Metrics stay on the device: ``loss``, ``grad_norm`` and ``skipped``
    (int32 0/1).

    With an enabled ``plan`` and the state's spec tree
    (``spmd.state_shardings`` of the global state) the step runs SPMD
    (module note): ``gathers_own`` says the loss gathers its own split
    leaves (else the step gathers the dense ones for it) and
    ``grad_axes`` is the tree of the axes each param's use is split over
    (None: the batch axes). The comms knobs resolve here, at
    construction.
    """
    spmd_on = plan is not None and plan.enabled
    if spmd_on:
        from repro_torch.distributed import spmd
        if state_shardings is None:
            raise ValueError("make_train_step(plan=...) needs the state's "
                             "specs (spmd.state_shardings)")
        p_specs = state_shardings["params"]
        if not gathers_own:
            if value_and_grad_fn is not None:
                raise ValueError("sparse row gradients and an SPMD plan "
                                 "are mutually exclusive")
            inner = loss_fn

            def loss_fn(p, b, g):
                return inner(spmd.gather_dense(p, p_specs, plan), b, g)
    vag = value_and_grad_fn or value_and_grad(loss_fn)
    comms_mode = _comms.compress_mode()
    comms_block = _comms.block_size()
    overlap = _comms.overlap_enabled() and microbatches > 1
    _comms.STATS.record_overlap(microbatches, overlap)
    if spmd_on:
        def reduce_grads(g, async_op=False):
            if any(map(is_sparse, leaves(g, is_leaf=is_sparse))):
                raise ValueError("sparse row gradients and an SPMD plan "
                                 "are mutually exclusive")
            return spmd.reduce_grads(g, p_specs, plan, grad_axes, async_op)

    def step(state, batch, base: int, step_idx: int):
        params = state["params"]
        device = leaves(params)[0].device
        if microbatches > 1:
            acc, losses, sparse_parts, pending = None, [], [], []
            for i in range(microbatches):
                mb = tree_map(lambda x, i=i: x[i], batch)
                loss_i, g = vag(params, mb, step_generator(
                    base, step_idx, i, device=device))
                dense_g, sparse_g = split_sparse(g)
                dense_g = tree_map(lambda x: x.float(), dense_g)
                if spmd_on and overlap:
                    # this microbatch's reduction runs while the next
                    # one's forward and backward are issued
                    pending.append(reduce_grads(dense_g, async_op=True))
                else:
                    acc = dense_g if acc is None else tree_map(
                        torch.add, acc, dense_g)
                sparse_parts.append(sparse_g)
                losses.append(loss_i)
            for finish in pending:
                done = finish()
                acc = done if acc is None else tree_map(torch.add, acc, done)
            if spmd_on and not overlap:
                acc = reduce_grads(acc)
            grads = merge_sparse(tree_map(lambda g: g / microbatches, acc),
                                 concat_sparse(sparse_parts,
                                               1.0 / microbatches))
            loss = torch.mean(torch.stack(losses))
        else:
            loss, grads = vag(params, batch, step_generator(
                base, step_idx, device=device))
            if spmd_on:
                grads = reduce_grads(grads)

        # compressed gradient exchange with error feedback: send q(g + e),
        # carry e' = (g + e) - q(g + e) beside the optimizer state
        new_ef = None
        if comms_mode != "none" and "comms_ef" in state:
            grads, new_ef = _comms.ef_compress_step(
                grads, state["comms_ef"], comms_mode, comms_block)

        # the guard's norm, the update and the guard: one device-timed phase
        with obs_trace.span("train.optimizer", device=True):
            g_leaves = leaves(grads, is_leaf=is_sparse)
            if spmd_on:
                # each leaf's squares summed over the axes it is split on, once
                gnorm = torch.sqrt(spmd.grad_sq_norm(g_leaves, p_specs, plan,
                                                     sq_sum) + 1e-20)
            else:
                gnorm = torch.sqrt(sum(sq_sum(g) for g in g_leaves) + 1e-20)
            # non-finite guard: a NaN/Inf loss or gradient must not poison the
            # parameters — keep the old params/opt for this step (the step
            # counter still advances so data alignment is unchanged) and
            # surface the skip in the metrics
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            # with SparseRows grads the optimizer writes the touched rows in
            # place under the guard, and returns those tensors as they are
            sparse = {"ok": ok} if any(map(is_sparse, g_leaves)) else {}
            if spmd_on:
                # a clip norm is the whole gradient's (over the mesh), of
                # whichever leaves an optimizer is handed
                spec_of = {id(p): sp for p, sp in zip(
                    leaves(params), leaves(p_specs, is_leaf=spmd.is_spec))}
                sparse["sq_norm"] = lambda gl, pl: spmd.grad_sq_norm(
                    gl, [spec_of[id(p)] for p in pl], plan, sq_sum)
            new_params, new_opt = opt.update(grads, state["opt"], params,
                                             **sparse)

            def keep(new, old):
                return new if new is old else torch.where(ok, new, old)
            new_state = {**state,
                         "params": tree_map(keep, new_params, params),
                         "opt": tree_map(keep, new_opt, state["opt"]),
                         "step": state["step"] + 1}
            if new_ef is not None:
                # the residual reverts with params on a skipped step
                new_state["comms_ef"] = tree_map(keep, new_ef,
                                                 state["comms_ef"])
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "skipped": (~ok).to(torch.int32)}

    return step


class Trainer:
    def __init__(self, loss_fn: Callable, opt: Optimizer,
                 cfg: TrainLoopConfig, init_params_fn: Callable[[], Any], *,
                 value_and_grad_fn: Optional[Callable] = None,
                 metrics_fn: Optional[Callable] = None, device="cuda",
                 plan=None, param_specs=None, grad_axes=None):
        self.loss_fn = loss_fn
        self.opt = opt
        self.cfg = cfg
        self.init_params_fn = init_params_fn
        self.device = torch.device(device)
        self.plan = plan
        self.value_and_grad_fn = value_and_grad_fn
        # extra metrics (e.g. NE) run only at logging steps, without
        # autograd — a quality metric read 1-in-log_every times must not
        # cost a second model forward on every step
        self.metrics_fn = metrics_fn
        self._spmd = plan is not None and plan.enabled
        # a model's own spec tree and per-leaf use axes (the LM's): it then
        # gathers its own weights (make_train_step's gathers_own)
        self.param_specs = param_specs
        self.grad_axes = grad_axes
        self._specs = None       # the state's spec tree, under a plan
        # under a plan the step needs the state's specs: built in run()
        self.step_fn = (None if self._spmd else make_train_step(
            loss_fn, opt, cfg.microbatches, value_and_grad_fn))
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, cfg.keep_last,
                                       meta=cfg.ckpt_meta)
                     if cfg.ckpt_dir else None)
        self.history: list = []
        self.skipped_steps = 0   # non-finite steps the guard neutralized
        self._last_step = 0
        obs_metrics.register_stats("train", self)

    def snapshot(self) -> dict:
        """Trainer view for ``obs.snapshot()``: progress + the guard's
        skip count + the latest logged metrics row."""
        return {"last_step": self._last_step,
                "total_steps": self.cfg.total_steps,
                "skipped_steps": self.skipped_steps,
                "last_log": dict(self.history[-1]) if self.history else None}

    def _to_device(self, tree):
        return tree_map(lambda t: t.to(self.device), tree)

    def init_state(self, seed: int = 0) -> Dict:
        """A fresh state that owns its params: each leaf of the
        ``init_params_fn()`` tree is copied to the device, also when it is
        there already (``.to`` would hand the same tensor back), so the
        sparse step's in-place row writes never reach the caller's tree."""
        params = tree_map(lambda t: t.to(self.device, copy=True),
                          self.init_params_fn())
        state = {"params": params, "opt": self.opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=self.device),
                 "rng": torch.tensor(int(seed), dtype=torch.int64)}
        self._ensure_comms_ef(state)
        return state

    def _ensure_comms_ef(self, state: Dict) -> None:
        """Back-fill the error-feedback residual when the compressed
        exchange is on and the (global) state has none yet."""
        if _comms.compress_mode() == "none" or "comms_ef" in state:
            return
        ef = _comms.ef_init(state["params"], self.plan)
        if ef:
            state["comms_ef"] = ef

    def _prepare(self, state: Dict) -> Dict:
        """Under a plan: this rank's part of the global state, and the
        SPMD step built with the state's specs."""
        if not self._spmd:
            return state
        from repro_torch.distributed import spmd
        self._specs = spmd.state_shardings(state, self.plan,
                                           param_specs=self.param_specs)
        state = spmd.place_state(state, self.plan, specs=self._specs)
        self.step_fn = make_train_step(
            self.loss_fn, self.opt, self.cfg.microbatches,
            self.value_and_grad_fn, plan=self.plan,
            state_shardings=self._specs, grad_axes=self.grad_axes,
            gathers_own=self.param_specs is not None)
        return state

    def gather_state(self, state: Dict) -> Dict:
        """The global state from every rank's part (a collective every rank
        calls; the state itself without a plan)."""
        if not self._spmd:
            return state
        from repro_torch.distributed import spmd
        return spmd.gather_state(state, self._specs, self.plan)

    def run(self, batch_iter_fn: Callable[[int], Iterator], seed: int = 0,
            stop_after: Optional[int] = None,
            on_checkpoint: Optional[Callable[[int], None]] = None) -> Dict:
        """batch_iter_fn(start_step) must yield batches from that step on
        (the deterministic-skip contract). ``seed`` is the base seed of a
        fresh run; a restored run keeps its checkpointed one.
        ``on_checkpoint(step)`` fires at every checkpoint save so data
        sources can persist their resume cursor for exactly that step."""
        state = None
        start = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            restored = self.ckpt.restore()
            start = int(restored["step"])
            # pre-rng checkpoints: adopt the caller's seed
            rng = restored.pop("rng", torch.tensor(int(seed),
                                                   dtype=torch.int64))
            state = {**self._to_device(restored), "rng": rng}
            self._ensure_comms_ef(state)
        if state is None:
            state = self.init_state(seed)
        state = self._prepare(state)
        base = int(state["rng"])      # the checkpointed base seed wins
        it = batch_iter_fn(start)
        t0 = time.monotonic()
        consecutive_skips = 0
        for step in range(start, self.cfg.total_steps):
            with obs_trace.span("train.step", step=step + 1):
                with obs_trace.span("train.data", step=step + 1):
                    batch = next(it)
                    spec = faults.fire("train.batch")
                    if spec is not None and spec.kind == "nan":
                        batch = _poison_batch(batch)
                # host time: the step's dispatch and the syncs it holds; the
                # card's work runs on into the next data span (the device
                # time of its phases is on train.forward / backward /
                # optimizer)
                with obs_trace.span("train.compute", step=step + 1):
                    state, metrics = self.step_fn(state, batch, base, step)
                self._last_step = step + 1
                if self.cfg.halt_after_skips > 0:
                    if int(metrics["skipped"]):
                        consecutive_skips += 1
                        self.skipped_steps += 1
                        if consecutive_skips >= self.cfg.halt_after_skips:
                            raise NonFiniteLossError(
                                f"{consecutive_skips} consecutive non-finite "
                                f"steps ending at step {step + 1} — halting "
                                f"instead of spinning on a diverged run")
                    else:
                        consecutive_skips = 0
                if (step + 1) % self.cfg.log_every == 0:
                    with obs_trace.span("train.log", step=step + 1):
                        self.history.append(self._log_row(
                            state, metrics, batch, base, step, start, t0))
                    obs_export.maybe_emit("train.log")
                if (self.ckpt is not None
                        and (step + 1) % self.cfg.ckpt_every == 0):
                    with obs_trace.span("train.checkpoint", step=step + 1):
                        self.ckpt.save(step + 1, state, blocking=False,
                                       plan=self.plan, specs=self._specs)
                        if on_checkpoint is not None:
                            on_checkpoint(step + 1)
                if stop_after is not None and (step + 1 - start) >= stop_after:
                    break   # simulated preemption (tests)
        if self.ckpt is not None:
            self.ckpt.wait()
        return state

    def _log_row(self, state, metrics, batch, base: int, step: int,
                 start: int, t0: float) -> Dict[str, float]:
        """One history row: the step's metrics read back to the host, the
        rate since the run started and, with a ``metrics_fn``, its extra
        metrics (no autograd) on the step's first microbatch."""
        rate = (step + 1 - start) / max(time.monotonic() - t0, 1e-9)
        row = {"step": step + 1, "loss": float(metrics["loss"]),
               "steps_per_s": rate}
        row.update({k: float(v) for k, v in metrics.items() if k not in row})
        if self.metrics_fn is not None:
            mb = (tree_map(lambda x: x[0], batch)
                  if self.cfg.microbatches > 1 else batch)
            params = state["params"]
            if self._spmd and self.param_specs is None:
                from repro_torch.distributed import spmd
                params = spmd.gather_dense(params, self._specs["params"],
                                           self.plan)
            with torch.no_grad():
                extra = self.metrics_fn(
                    params, mb,
                    step_generator(base, step, device=self.device))
            row.update({k: float(v) for k, v in extra.items()})
        return row
