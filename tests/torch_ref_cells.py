"""The reference's dry-run cells, the oracle of the port's cell tests
(``test_torch_cells.py``, ``test_torch_dryrun.py``,
``test_torch_cells_spmd.py``).

Run as a subprocess: ``python tests/torch_ref_cells.py JOB OUT_DIR``. Each
job forces its host device count before JAX starts and builds its mesh
with **Auto** axes (``jax.make_mesh(..., axis_types=(AxisType.Auto,) *
n)``): the reference's ``launch/mesh.py`` calls ``jax.make_mesh`` without
axis types, which on this JAX gives Explicit axes, where its cells do not
lower. Nothing of ``src/repro`` is changed.

Jobs:
  * ``cells``: every cell (and opt level) on ``replicated_plan()``: kind,
    notes, model_flops, the abstract state's and the inputs' shapes and
    dtypes by tree path; and the state and input specs of every cell on
    a 16 x 16 mesh of 256 forced host devices (plans only, no compile)
    -> ``ref_cells.json``;
  * ``dryrun``: the seven cells of ``torch_spmd_ranks.DRYRUN_CELLS`` lowered,
    compiled and analyzed (``hlo_analysis``) on a 2 x 4 mesh of 8 forced
    host devices -> ``ref_dryrun.json``;
  * ``spmd``: the MIND, BERT4Rec and DIEN cell losses, gradients and
    serving outputs at ``torch_spmd_ranks``' small shapes on a 2 x 2 mesh
    of 4 forced host devices, on the inputs and params that
    ``test_torch_cells_spmd`` writes (``inputs.npz``) -> ``ref_spmd.npz``.
"""
import json
import os
import sys

JOB = sys.argv[1] if __name__ == "__main__" else None
_DEVICES = {"cells": 256, "dryrun": 8, "spmd": 4}
if JOB in _DEVICES:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={_DEVICES[JOB]}")
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_spmd_ranks as R  # noqa: E402


def auto_mesh(dims, axes):
    return jax.make_mesh(dims, axes, axis_types=(AxisType.Auto,) * len(dims))


def path_key(path) -> str:
    return "".join(str(k) for k in path)


def norm_spec(spec):
    """A PartitionSpec as ``sharding.normalize_spec`` writes it (lists)."""
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else (list(e) if e else None)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return out


def spec_table(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P) or x is None)
    return {path_key(p): norm_spec(s if s is not None else P())
            for p, s in flat}


def shape_table(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_key(p): [list(x.shape), str(jnp.dtype(x.dtype))]
            for p, x in flat}


def build(arch, shape, level, plan):
    from repro.configs.lm_cells import build_lm_cell
    from repro.configs.registry import get_arch
    mod = get_arch(arch)
    if level != "baseline" and getattr(mod, "FAMILY", "") == "lm":
        return build_lm_cell(mod.CONFIG, shape, plan, level)
    if level != "baseline":
        return mod.build_cell(shape, plan, opt_level=level)
    return mod.build_cell(shape, plan)


def run_cells(out):
    from repro.configs import registry
    from repro.distributed.sharding import plan_for_mesh, replicated_plan
    rplan = replicated_plan()
    plan = plan_for_mesh(auto_mesh((16, 16), ("data", "model")))
    res = {}
    for arch, shape, level in R.all_levels(registry):
        tag = f"{arch}/{shape}/{level}"
        c = build(arch, shape, level, rplan)
        res[tag] = {"kind": c.kind, "notes": c.notes,
                    "model_flops": float(c.model_flops),
                    "state": shape_table(c.abstract_state()),
                    "inputs": shape_table(c.input_specs())}
        cp = build(arch, shape, level, plan)
        res[tag]["state_specs"] = spec_table(cp.state_pspecs(plan))
        res[tag]["input_specs"] = spec_table(cp.input_pspecs(plan))
    with open(os.path.join(out, "ref_cells.json"), "w") as f:
        json.dump(res, f)


def run_dryrun(out):
    from repro.distributed.sharding import plan_for_mesh
    from repro.launch.hlo_analysis import analyze
    mesh = auto_mesh((2, 4), ("data", "model"))
    plan = plan_for_mesh(mesh)
    res = {}
    for arch, shape, level in R.DRYRUN_CELLS:
        cell = build(arch, shape, level, plan)
        st_sh, in_sh = cell.shardings(plan)
        with mesh:
            c = jax.jit(cell.step, in_shardings=(st_sh, in_sh)).lower(
                cell.abstract_state(), cell.input_specs()).compile()
        a = analyze(c.as_text())
        m = c.memory_analysis()
        res[f"{arch}/{shape}/{level}"] = {
            "flops": a["flops"], "collective_bytes": a["collective_bytes"],
            "collectives": a["collectives"],
            "memory_bytes": a["memory_bytes"],
            "argument_bytes": int(m.argument_size_in_bytes),
            "model_flops": float(cell.model_flops)}
    with open(os.path.join(out, "ref_dryrun.json"), "w") as f:
        json.dump(res, f)


def ref_cell(rc, arch, shape, plan):
    """The reference's small cell and (train) its loss function, caught
    on its way into ``_train_cell``."""
    caught = {}
    orig = rc._train_cell

    def catch(arch_, shape_, sh, plan_, init_fn, cell_loss, *rest):
        caught["loss"] = cell_loss
        return orig(arch_, shape_, sh, plan_, init_fn, cell_loss, *rest)
    rc._train_cell = catch
    try:
        with R.small_shapes(rc):
            cell = getattr(rc, f"build_{arch}_cell")(shape, plan)
    finally:
        rc._train_cell = orig
    return cell, caught.get("loss")


def run_spmd(out):
    """Each small cell's loss + grads (train) or output (serve) on the
    2 x 2 Auto mesh, the test's params and global inputs placed by the
    cell's own shardings."""
    from repro.configs import recsys_cells as rc
    from repro.distributed.sharding import plan_for_mesh
    mesh = auto_mesh((2, 2), ("data", "model"))
    plan = plan_for_mesh(mesh)
    data = np.load(os.path.join(out, "inputs.npz"))
    res = {}
    for arch, shape in R.REF_CELLS:
        pre = f"{arch}/{shape}/"
        params = R.nested({k[len(pre) + 2:]: jnp.asarray(data[k])
                           for k in data.files if k.startswith(pre + "p/")})
        inputs = {k[len(pre) + 2:]: jnp.asarray(data[k]) for k in data.files
                  if k.startswith(pre + "i/")}
        cell, loss_fn = ref_cell(rc, arch, shape, plan)
        st_sh, in_sh = cell.shardings(plan)
        with mesh:
            pp = jax.device_put(params, st_sh["params"])
            ii = jax.device_put(inputs, in_sh)
            if cell.kind == "train":
                loss, grads = jax.jit(jax.value_and_grad(loss_fn))(pp, ii)
                res[pre + "loss"] = np.asarray(loss)
                flat, _ = jax.tree_util.tree_flatten_with_path(grads)
                for p, v in flat:
                    key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                   for k in p)
                    res[pre + "g/" + key] = np.asarray(v)
            else:
                res[pre + "out"] = np.asarray(
                    jax.jit(cell.step)({"params": pp}, ii))
    np.savez(os.path.join(out, "ref_spmd.npz"), **res)


if __name__ == "__main__":
    out_dir = sys.argv[2]
    {"cells": run_cells, "dryrun": run_dryrun, "spmd": run_spmd}[JOB](out_dir)
    print(f"REF_{JOB.upper()}_DONE")
