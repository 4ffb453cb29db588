"""Cell framework: every (architecture x input-shape) dry-run cell is a
``Cell`` — abstract state + abstract inputs + a step function + specs
(torch port of ``repro/configs/base.py``).

The reference lowers ``jax.jit(cell.step, in_shardings=...)`` on
ShapeDtypeStruct stand-ins. The port has no XLA: ``launch/dryrun.py`` runs
the step itself, on this rank's blocks of meta tensors, under
``launch/op_analysis.py``'s counters. Nothing is ever allocated: ``sds``
is an empty meta tensor, and :func:`abstract` runs an init function with
every factory call sent to the meta device (its generator dropped: the
values of a meta tensor do not exist).

A cell's step runs one rank's program: ``step(state, inputs)`` takes this
rank's block of each leaf (``Cell.shardings`` says which block; the
builders close over the plan) and says every collective itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed.sharding import ShardingPlan, normalize_spec


def sds(shape, dtype=torch.float32) -> torch.Tensor:
    """The meta stand-in of ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class _MetaFactories(TorchDispatchMode):
    """Factory calls land on the meta device; a generator is dropped."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        if kwargs.get("generator") is not None:
            kwargs["generator"] = None
        return func(*args, **kwargs)


def abstract(init_fn: Callable[[], Any]) -> Any:
    """``init_fn()`` with every tensor it makes a meta tensor (the port's
    ``jax.eval_shape`` of an init): shapes and dtypes, no storage."""
    with _MetaFactories():
        return init_fn()


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                               # "train" | "serve"
    step: Callable                          # (state, inputs) -> outputs
    abstract_state: Callable[[], Any]       # tree of meta tensors
    state_pspecs: Callable[[ShardingPlan], Any]   # tree of spec tuples
    input_specs: Callable[[], Dict[str, Any]]
    input_pspecs: Callable[[ShardingPlan], Dict[str, Any]]
    model_flops: float = 0.0                # analytic "useful" FLOPs per step
    notes: str = ""
    # input name -> filler(spec, gen, device): what each input means, for
    # :meth:`inputs`
    fill: Dict[str, Callable] = dataclasses.field(default_factory=dict)

    def inputs(self, gen: torch.Generator, device) -> Dict[str, Any]:
        """Concrete global inputs of ``input_specs()``'s shapes on
        ``device``, each drawn from ``gen`` by its builder's filler; an
        input no filler covers is refused."""
        specs = self.input_specs()
        missing = sorted(set(specs) - set(self.fill))
        if missing:
            raise KeyError(f"{self.arch}/{self.shape}: no filler for the "
                           f"inputs {missing}")
        return {k: self.fill[k](v, gen, device) for k, v in specs.items()}

    def shardings(self, plan: ShardingPlan):
        """(state specs, input specs), each spec normalized
        (``sharding.normalize_spec``): what ``dryrun.place`` realizes on
        ``plan``'s mesh (the reference returns NamedShardings)."""
        from repro_torch.distributed.spmd import is_spec
        from repro_torch.tree import tree_map

        def norm(tree):
            return tree_map(normalize_spec, tree, is_leaf=is_spec)
        return norm(self.state_pspecs(plan)), norm(self.input_pspecs(plan))


def whole_batch(x: torch.Tensor, b: int, plan: ShardingPlan) -> torch.Tensor:
    """The global (b, ...) batch from this rank's block of it (an
    all-gather over the batch axes when the block is a part; no
    gradient)."""
    from repro_torch.distributed import spmd
    return spmd.gather_batch(x, plan) if x.shape[0] < b else x


def cell_train_step(cell_loss: Callable, opt, plan: ShardingPlan,
                    param_specs: Callable[[], Any], grad_axes: Any = None):
    """A train cell's ``step(state, inputs)``, the reference's: the loss
    and its gradient, the gradient summed by the plan's rule
    (``spmd.reduce_grads`` with the params' realized specs from
    ``param_specs()``, taken once, and the use axes ``grad_axes``:
    None for the batch axes), then ``opt``. No guard and no metrics: the
    Trainer's step adds those."""
    from repro_torch.distributed import spmd
    from repro_torch.train.loop import value_and_grad
    vag = value_and_grad(lambda p, b, _: cell_loss(p, b))
    memo = {}

    def step(state, inputs):
        loss, grads = vag(state["params"], inputs, None)
        if plan.enabled:
            if "specs" not in memo:
                memo["specs"] = param_specs()
            grads = spmd.reduce_grads(grads, memo["specs"], plan, grad_axes)
        new_p, new_opt = opt.update(grads, state["opt"], state["params"])
        return {"params": new_p, "opt": new_opt,
                "step": state["step"] + 1}, loss
    return step


# fillers for Cell.fill: (meta spec, generator, device) -> tensor

def normal(spec, gen, device) -> torch.Tensor:
    return torch.randn(tuple(spec.shape), generator=gen,
                       device=device).to(spec.dtype)


def all_true(spec, gen, device) -> torch.Tensor:
    return torch.ones(tuple(spec.shape), dtype=torch.bool, device=device)


def coin(spec, gen, device) -> torch.Tensor:
    """0 / 1 labels, each 1 with probability 1/2."""
    return (torch.rand(tuple(spec.shape), generator=gen, device=device)
            < 0.5).to(spec.dtype)


def ids_below(hi: int) -> Callable:
    """Ids drawn uniformly from [0, hi)."""
    def draw(spec, gen, device):
        return torch.randint(0, hi, tuple(spec.shape), generator=gen,
                             device=device, dtype=spec.dtype)
    return draw


def lengths_upto(hi: int) -> Callable:
    """Lengths drawn uniformly from [1, hi]."""
    def draw(spec, gen, device):
        return torch.randint(1, hi + 1, tuple(spec.shape), generator=gen,
                             device=device, dtype=spec.dtype)
    return draw


def in_order(n: int) -> Callable:
    """Owner ids in order: row i of m belongs to ``i * n // m`` (each of n
    requests or graphs owns one run of rows)."""
    def draw(spec, gen, device):
        m = spec.shape[0]
        return (torch.arange(m, device=device) * n // m).to(spec.dtype)
    return draw


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def round_batch(n: int, plan_divisor: int = 32) -> int:
    return pad_to(n, plan_divisor)
