"""Multi-pod dry run: trace every (arch x shape) cell on the production
meshes and extract roofline terms (torch port of
``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm-mlperf \\
      --shape train_batch [--multi-pod] [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference lowers and compiles each cell with XLA on 256 / 512 forced
host devices. The port has no compiler: the process joins a fake world of
256 (16 x 16) or 512 (2 x 16 x 16) ranks as rank 0
(``hostdevices.init_fake_world``), cuts each leaf of the cell's global
meta state and inputs to rank 0's block (``spmd.local_block`` of its spec
fitted to the shape), and runs the cell's step once on those meta blocks
under ``launch/op_analysis.py``. Nothing is allocated and no collective
moves a byte; the counts are rank 0's, per device, as the reference's
SPMD module's are. ``--mesh DATAxMODEL`` (or ``PODxDATAxMODEL``) runs on
another fake world, as the tests do at 2 x 4.

Per cell it records: per-device memory (arguments, outputs, the peak of
live storages), the step's FLOPs and unfused bytes, per-collective byte
totals and their split by mesh axis, and the three roofline terms against
an H100 SXM's peaks (``launch/mesh.py``). Each axis's collective bytes are
charged to the link its groups cross (``mesh.axis_link``): NVLink inside
an 8-card node, the node network across nodes.
"""
import argparse
import inspect
import json
import math
import os
import sys
import time
import traceback
import warnings

import torch

def _world_and_mesh(spec: str):
    """The fake world of ``spec``'s size (made once a process) and a mesh
    over it."""
    import torch.distributed as dist

    from repro_torch.launch.hostdevices import init_fake_world
    from repro_torch.launch.mesh import make_mesh_from_spec, parse_mesh_spec
    need = math.prod(parse_mesh_spec(spec)[0])
    if not dist.is_initialized():
        init_fake_world(need)
    elif dist.get_backend() != "fake" or dist.get_world_size() != need:
        raise RuntimeError(
            f"the dry run needs a fake world of {need} ranks; this process "
            f"has a {dist.get_backend()} world of {dist.get_world_size()}")
    return make_mesh_from_spec(spec)


def place(tree, specs, plan):
    """Rank 0's block of each global meta leaf: its spec fitted to its
    shape (``spmd.fit_spec``: an axis that does not divide a dim leaves it
    whole), then ``spmd.local_block``."""
    from repro_torch.distributed import spmd
    from repro_torch.tree import leaves, unflatten
    xs = leaves(tree)
    ss = leaves(specs, is_leaf=spmd.is_spec)
    if len(xs) != len(ss):
        raise ValueError(f"{len(xs)} leaves but {len(ss)} specs")
    return unflatten(tree, [
        spmd.local_block(x, spmd.fit_spec(s, tuple(x.shape), plan), plan)
        for x, s in zip(xs, ss)])


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             opt_level: str = "baseline", mesh_spec: str = None) -> dict:
    from repro_torch.distributed.sharding import plan_for_mesh
    from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, axis_link,
                                         link_bandwidth)
    from repro_torch.launch.op_analysis import analyze

    from repro_torch.embeddings.collection import DEDUP_KNOB
    if DEDUP_KNOB.resolve() == "always":
        raise ValueError("the dry run cannot force emb_dedup=always: "
                         "torch.unique has no meta kernel")
    t0 = time.time()
    spec = mesh_spec or ("2x16x16" if multi_pod else "16x16")
    mesh = _world_and_mesh(spec)
    n_chips = mesh.size
    plan = plan_for_mesh(mesh)
    donate = opt_level.endswith("_donate")
    cell = build_cell(arch, shape, plan,
                      opt_level[:-7] if donate else opt_level)

    st_specs, in_specs = cell.shardings(plan)
    state = place(cell.abstract_state(), st_specs, plan)
    inputs = place(cell.input_specs(), in_specs, plan)
    a = analyze(cell.step, state, inputs, mesh=mesh)
    del a["outputs"]
    trace_s = time.time() - t0

    flops = a["flops"]
    hbm_bytes = a["memory_bytes"]
    links = {ax: axis_link(mesh, ax) for ax in mesh.axis_names}
    by_axis = a["collective_bytes_by_axis"]
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = hbm_bytes / HBM_BW
    collective_s = sum(b / link_bandwidth(links.get(ax, "network"))
                       for ax, b in by_axis.items())
    peak = a["peak_bytes"]
    if donate:
        # the new state reuses the donated one's buffers
        peak -= min(a["output_bytes"], a["argument_bytes"])

    result = {
        "arch": arch, "shape": shape, "kind": cell.kind,
        "mesh": spec,
        "n_chips": n_chips,
        "opt_level": opt_level,
        "ok": True,
        "trace_s": round(trace_s, 2),
        "memory_analysis": {
            "bytes_per_device": peak - a["argument_bytes"],
            "argument_bytes": a["argument_bytes"],
            "output_bytes": a["output_bytes"],
            "peak_bytes": peak,
        },
        "cost_analysis": {"flops": flops, "bytes_accessed": hbm_bytes},
        "collectives": a["collectives"],
        "collective_bytes": a["collective_bytes"],
        "collective_bytes_by_axis": by_axis,
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": max(
                [("compute", compute_s), ("memory", memory_s),
                 ("collective", collective_s)], key=lambda kv: kv[1])[0],
        },
        "model_flops": cell.model_flops,
        # model_flops is global-per-step; the analyzer's flops are per device
        "useful_flops_ratio": (cell.model_flops / n_chips / flops)
        if flops else None,
        "notes": cell.notes,
        "analysis": {
            "basis": "rank 0's step on meta tensors (op_analysis): plain "
                     "versions' products (2mnk), bytes_accessed unfused "
                     "(every aten op's inputs + outputs; gathers and "
                     "scatters by rows touched)",
            "device": "H100 SXM peaks (launch/mesh.py)",
            "links": links,
            "tensor_devices": a["devices"],
        },
    }
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
    if mesh_spec:
        tag += f"__{mesh_spec}"
    if opt_level != "baseline":
        tag += f"__{opt_level}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def build_cell(arch: str, shape: str, plan, opt_level: str = "baseline"):
    """The registry's cell, ``opt_level`` passed where the module's
    ``build_cell`` takes one (the LM's through ``build_lm_cell``); a level
    the arch does not have is refused, where the reference's run_cell
    builds the baseline under the level's name."""
    from repro_torch.configs.registry import get_arch
    mod = get_arch(arch)
    if opt_level != "baseline" and mod.FAMILY == "lm":
        from repro_torch.configs.lm_cells import build_lm_cell
        return build_lm_cell(mod.CONFIG, shape, plan, opt_level)
    if "opt_level" in inspect.signature(mod.build_cell).parameters:
        return mod.build_cell(shape, plan, opt_level=opt_level)
    if opt_level != "baseline":
        raise ValueError(f"{arch} has no opt level {opt_level!r}")
    return mod.build_cell(shape, plan)


def materialize(cell, device, seed: int = 0):
    """Concrete (state, inputs) of a cell's global shapes on ``device``,
    drawn from a generator seeded with ``seed``: params N(0, 0.02²),
    optimizer state and step zeros, then the inputs by the cell's own
    fillers (``Cell.inputs``)."""
    from repro_torch.tree import flatten_with_path, unflatten
    gen = torch.Generator(device=device).manual_seed(seed)
    st = cell.abstract_state()
    state = unflatten(st, [
        torch.zeros(x.shape, dtype=x.dtype, device=device)
        if (p[0] != "['params']" or not x.is_floating_point()) else
        (torch.randn(x.shape, generator=gen, device=device) * 0.02).to(
            x.dtype) for p, x in flatten_with_path(st)])
    return state, cell.inputs(gen, device)


def run_on_card(arch: str, shape: str, device, steps: int = 3,
                seed: int = 0, opt_level: str = "baseline") -> dict:
    """The cell on one card under a 1 x 1 NCCL plan (the caller's world of
    one): its state and inputs from a seeded generator, one step under
    ``FlopCounterMode`` (its FLOPs, and the card's peak memory over it
    from a reset taken with the state and inputs allocated, less what the
    process held before the state was made), then ``steps`` timed steps
    (a train cell fed its own new state)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.sharding import plan_for_mesh
    from repro_torch.launch.mesh import make_mesh_from_spec
    plan = plan_for_mesh(make_mesh_from_spec("1x1", backend="nccl"))
    cell = build_cell(arch, shape, plan, opt_level)
    # what the process held before (earlier work, cuBLAS workspaces) is
    # not the cell's
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state, inputs = materialize(cell, device, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    args = torch.cuda.memory_allocated() - base
    fc = FlopCounterMode(display=False)
    with torch.enable_grad(), fc:
        out = cell.step(state, inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if cell.kind == "train":
        state = out[0]
    del out
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        with torch.enable_grad():
            out = cell.step(state, inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if cell.kind == "train":
            state = out[0]
        del out
    del state, inputs
    torch.cuda.empty_cache()
    return {"flops": float(fc.get_total_flops()), "peak_bytes": peak,
            "argument_bytes": args, "step_s": times}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--opt-level", default="baseline")
    ap.add_argument("--mesh", default=None,
                    help="another mesh than the production one, e.g. 2x4")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch/shape[/opt_level] cells")
    ap.add_argument("--shard", default=None,
                    help="K/N: every N-th cell from the K-th (0-based), to "
                         "spread --all over N processes")
    args = ap.parse_args()

    from repro_torch.configs.registry import all_cells

    # torch.distributed's deprecation notes for the collectives' names
    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_grad_enabled(True)
    if args.all:
        cells = all_cells()
    elif args.cells:
        cells = [tuple(c.split("/")) for c in args.cells.split(",")]
    else:
        cells = [(args.arch, args.shape)]
    if args.shard:
        k, n = (int(x) for x in args.shard.split("/"))
        cells = cells[k::n]
    failures = 0
    for arch, shape, *level in cells:
        try:
            r = run_cell(arch, shape, args.multi_pod, args.out,
                         level[0] if level else args.opt_level, args.mesh)
            rf = r["roofline"]
            print(f"OK  {arch:24s} {shape:15s} {r['mesh']:7s} "
                  f"flops={r['cost_analysis']['flops']:.3e} "
                  f"coll={r['collective_bytes']:.3e}B "
                  f"dom={rf['dominant']:10s} trace={r['trace_s']:.1f}s",
                  flush=True)
        except Exception as e:
            failures += 1
            print(f"FAIL {arch} {shape}: {e}", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
