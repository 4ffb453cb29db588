"""The port's inventory: everything the JAX package offers, the port offers.

An AST scan of every ``src/repro/**/*.py`` beside its port file
(``launch/hlo_analysis.py`` maps to ``launch/op_analysis.py``). A case
fails on any public module-level name (functions, classes, assignments
and names imported from inside the package, i.e. re-exports), any
public class member (methods, properties, fields) or any parameter name
of a public function or method that the reference has and the port lacks.

``EXCLUDED`` is the one list of reasoned gaps. Each key names one gap as
the scan prints it, each value says why the port has no such thing: a TPU
tiling knob, a JAX object the plan or a ``torch.Generator`` replaces, a
TPU-only constant, or an argument the reference never reads. A missing
function that computes something is never excluded: port it instead. The
second case fails when an exclusion names something the port now has (or
the reference no longer has), so the list cannot go stale.

To add an exclusion, run this file, copy the failing key from the
message, and give it a reason of the kinds above.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
RENAMED = {"launch/hlo_analysis.py": "launch/op_analysis.py"}

TILING = "TPU tiling knob of the Pallas kernels; the CUDA kernels pick " \
         "their own tiles"
MESH = "JAX mesh argument: the port's SPMD plan (one process a rank, " \
       "explicit collectives) replaces it"
SHARD_MAP = "jax.shard_map wrapper: each port rank already holds only its " \
            "block, so there is nothing to map"
PYTREE = "JAX pytree registration; the port's tree.py walks dataclasses"
RNG = "a JAX PRNG key; the port draws from a torch.Generator (gen) or a " \
      "base seed (seed) in the same position"
JAX_OBJECT = "returns a JAX sharding object; the port's plan gives spec " \
             "tuples (distributed/sharding.normalize_spec, " \
             "spmd.batch_spec, spmd.param_spec)"
HLO = "parses XLA HLO text; the port counts ops on meta tensors " \
      "(launch/op_analysis.py) and has no HLO"
TPU_ONLY = "TPU-only constant: the reference's 'auto' dedups only on a TPU " \
           "and the port's auto never dedups"

EXCLUDED = {
    # TPU tiling knobs
    "kernels/dispatch.py::hstu_attention(block_q)": TILING,
    "kernels/dispatch.py::hstu_attention(block_k)": TILING,
    "kernels/dispatch.py::hstu_attention_prefix(block_q)": TILING,
    "kernels/dispatch.py::hstu_attention_prefix(block_k)": TILING,
    "kernels/hstu_attention.py::hstu_attention(block_q)": TILING,
    "kernels/hstu_attention.py::hstu_attention(block_k)": TILING,
    "kernels/hstu_attention.py::hstu_attention(interpret)": TILING,
    "kernels/hstu_attention.py::hstu_attention_prefix(block_q)": TILING,
    "kernels/hstu_attention.py::hstu_attention_prefix(block_k)": TILING,
    "kernels/hstu_attention.py::hstu_attention_prefix(interpret)": TILING,
    "kernels/dot_interaction.py::dot_interaction(block_b)": TILING,
    "kernels/dot_interaction.py::dot_interaction(interpret)": TILING,
    # JAX mesh arguments that the plan replaces
    "core/fanout.py::fanout_local(mesh)": MESH,
    "core/fanout.py::fanout_local(batch_axes)": MESH,
    "embeddings/sharded.py::sharded_bag_lookup(mesh)": MESH,
    "embeddings/sharded.py::sharded_bag_lookup(model_axis)": MESH,
    "embeddings/sharded.py::sharded_bag_lookup(batch_axes)": MESH,
    "embeddings/sharded.py::sharded_bag_lookup_rs(mesh)": MESH,
    "embeddings/sharded.py::sharded_bag_lookup_rs(model_axis)": MESH,
    "embeddings/sharded.py::sharded_bag_lookup_rs(batch_axes)": MESH,
    "embeddings/sharded.py::sharded_jagged_bag_lookup(mesh)": MESH,
    "embeddings/sharded.py::sharded_jagged_bag_lookup(model_axis)": MESH,
    "embeddings/sharded.py::sharded_seq_lookup(mesh)": MESH,
    "embeddings/sharded.py::sharded_seq_lookup(model_axis)": MESH,
    "embeddings/sharded.py::sharded_seq_lookup(batch_axes)": MESH,
    "pipeline/resume.py::make_data_source(sharding)":
        MESH + " (a batch is cut by PrefetchLoader(sharding=spmd."
               "make_batch_sharding_fn(plan)))",
    "train/checkpoint.py::CheckpointManager.restore_sharded(mesh)":
        MESH + " (restore_sharded(plan, step))",
    "train/checkpoint.py::CheckpointManager.restore_resharded(shardings)":
        MESH + " (a NamedSharding tree; the port takes a spec tree and the "
               "plan: restore_resharded(specs, plan, step))",
    "configs/recsys_cells.py::shard_map": SHARD_MAP,
    "core/fanout.py::shard_map": SHARD_MAP,
    "distributed/sharding.py::shard_map": SHARD_MAP,
    "embeddings/sharded.py::shard_map": SHARD_MAP,
    "models/lm/moe.py::shard_map": SHARD_MAP,
    "models/lm/transformer.py::shard_map": SHARD_MAP,
    # members that return JAX objects
    "distributed/sharding.py::ShardingPlan.spec": JAX_OBJECT,
    "distributed/sharding.py::ShardingPlan.named": JAX_OBJECT,
    "distributed/sharding.py::ShardingPlan.batch_spec": JAX_OBJECT,
    "distributed/sharding.py::ShardingPlan.replicated": JAX_OBJECT,
    "launch/hlo_analysis.py::parse_hlo": HLO,
    "launch/hlo_analysis.py::Instr": HLO,
    "launch/hlo_analysis.py::Computation": HLO,
    "launch/hlo_analysis.py::COLLECTIVES": HLO,
    "launch/hlo_analysis.py::analyze(text)": HLO,
    "launch/dryrun.py::parse_collectives":
        HLO + " (collectives are counted by axis in op_analysis.analyze)",
    # TPU-only constants
    "embeddings/collection.py::DEDUP_MIN_VOCAB": TPU_ONLY,
    "embeddings/collection.py::DEDUP_MIN_IDS": TPU_ONLY,
    "launch/mesh.py::ICI_BW_PER_LINK":
        "TPU interconnect rate; the port's roofline uses the H100's "
        "NVLink and network rates (launch/mesh.py)",
    "launch/hostdevices.py::apply_host_device_env":
        "sets XLA's forced host device count; the port's ranks are "
        "processes (hostdevices.spawn, init_fake_world)",
    "launch/train.py::apply_host_device_env":
        "re-export of the XLA host device flag helper (see "
        "launch/hostdevices.py)",
    "scenario/smoke.py::apply_host_device_env":
        "re-export of the XLA host device flag helper (see "
        "launch/hostdevices.py)",
    # a group of one
    "kernels/embedding_bag.py::embedding_bag_coo_grad":
        "a group of one in embedding_bag_grouped_coo_grad (one table is "
        "a group of one on every port route)",
    # unused arguments
    "models/bert4rec.py::cloze_loss(n_negatives)":
        "the reference never reads it",
    # JAX pytree protocol
    "core/expansion.py::ImpressionBatch.tree_flatten": PYTREE,
    "core/expansion.py::ImpressionBatch.tree_unflatten": PYTREE,
    "core/roo_batch.py::ROOBatch.tree_flatten": PYTREE,
    "core/roo_batch.py::ROOBatch.tree_unflatten": PYTREE,
    "data/jagged.py::JaggedTensor.tree_flatten": PYTREE,
    "data/jagged.py::JaggedTensor.tree_unflatten": PYTREE,
    "data/jagged.py::KeyedJagged.tree_flatten": PYTREE,
    "data/jagged.py::KeyedJagged.tree_unflatten": PYTREE,
    "embeddings/sparse.py::GatheredTable.tree_flatten": PYTREE,
    "embeddings/sparse.py::GatheredTable.tree_unflatten": PYTREE,
    "embeddings/sparse.py::SparseRows.tree_flatten": PYTREE,
    "embeddings/sparse.py::SparseRows.tree_unflatten": PYTREE,
    # JAX PRNG keys
    "core/hstu.py::hstu_init(rng)": RNG,
    "core/hstu.py::hstu_layer_init(rng)": RNG,
    "core/lce.py::lce_init(rng)": RNG,
    "core/lce.py::userarch_init(rng)": RNG,
    "core/sequence.py::roo_sequence_init(rng)": RNG,
    "embeddings/collection.py::EmbeddingCollection.init(rng)": RNG,
    "embeddings/collection.py::init_tables(rng)": RNG,
    "models/bert4rec.py::bert4rec_init(rng)": RNG,
    "models/bert4rec.py::bert4rec_loss(rng)": RNG,
    "models/bert4rec.py::cloze_loss(rng)": RNG,
    "models/din_dien.py::dien_init(rng)": RNG,
    "models/dlrm.py::dlrm_init(rng)": RNG,
    "models/gnn/mace.py::mace_init(rng)": RNG,
    "models/gr.py::gr_init(rng)": RNG,
    "models/interactions.py::dcnv2_init(rng)": RNG,
    "models/lm/moe.py::moe_init(rng)": RNG,
    "models/lm/transformer.py::lm_init(rng)": RNG,
    "models/lsr.py::lsr_init(rng)": RNG,
    "models/mind.py::mind_init(rng)": RNG,
    "models/mlp.py::mlp_init(rng)": RNG,
    "models/two_tower.py::two_tower_init(rng)": RNG,
    "scenario/build.py::build_model(rng)": RNG,
    "train/loop.py::Trainer.init_state(rng)": RNG,
    "train/loop.py::Trainer.run(rng)": RNG,
}


def _public(name: str) -> bool:
    return not name.startswith("_") or (name.startswith("__")
                                        and name.endswith("__"))


def _params(fn) -> set:
    a = fn.args
    names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    names |= {x.arg for x in (a.vararg, a.kwarg) if x is not None}
    return names


def _target_names(target):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from _target_names(e)


def inventory(path: Path, package: str):
    """(names, {class: members}, {function or Class.method: params}) of a
    module's public API, branches of module-level if / try included."""
    names, members, params = set(), {}, {}

    def walk(body):
        for node in body:
            if isinstance(node, ast.If):
                walk(node.body)
                walk(node.orelse)
            elif isinstance(node, ast.Try):
                walk(node.body)
                walk(node.orelse)
                walk(node.finalbody)
                for h in node.handlers:
                    walk(h.body)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
                params[node.name] = _params(node)
            elif isinstance(node, ast.ClassDef):
                names.add(node.name)
                found = set()
                for c in node.body:
                    if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        found.add(c.name)
                        params[f"{node.name}.{c.name}"] = _params(c)
                    elif isinstance(c, ast.AnnAssign):
                        found.update(_target_names(c.target))
                    elif isinstance(c, ast.Assign):
                        for t in c.targets:
                            found.update(_target_names(t))
                members[node.name] = found
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    names.update(_target_names(t))
            elif isinstance(node, ast.AnnAssign):
                names.update(_target_names(node.target))
            elif isinstance(node, ast.ImportFrom) and (
                    node.level > 0
                    or (node.module or "").split(".")[0] == package):
                names.update(a.asname or a.name for a in node.names)

    walk(ast.parse(path.read_text(), filename=str(path)).body)
    names = {n for n in names if not n.startswith("_")}
    members = {c: {m for m in ms if _public(m)}
               for c, ms in members.items() if not c.startswith("_")}
    params = {f: ps for f, ps in params.items()
              if all(_public(part) for part in f.split("."))}
    return names, members, params


REF_FILES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def gaps(rel: str):
    """Keys of everything ``rel`` of the reference has and its port lacks."""
    port = PORT / RENAMED.get(rel, rel)
    if not port.exists():
        return [f"{rel}::<module>"]
    r_names, r_members, r_params = inventory(REF / rel, "repro")
    p_names, p_members, p_params = inventory(port, "repro_torch")
    out = [f"{rel}::{n}" for n in sorted(r_names - p_names)]
    for cls, ms in sorted(r_members.items()):
        if cls in p_members:
            out += [f"{rel}::{cls}.{m}" for m in sorted(ms - p_members[cls])]
    for fn, ps in sorted(r_params.items()):
        if fn in p_params:
            out += [f"{rel}::{fn}({p})" for p in sorted(ps - p_params[fn])]
    return out


@pytest.mark.parametrize("rel", REF_FILES)
def test_port_has_the_reference_api(rel):
    missing = [k for k in gaps(rel) if k not in EXCLUDED]
    assert not missing, (
        f"the port lacks {missing}: port it, or add a reasoned entry to "
        f"EXCLUDED if it is a kind the module note allows")


def test_exclusions_are_reasoned_and_current():
    """Every exclusion has a reason and names a gap that still exists."""
    assert all(isinstance(v, str) and v.strip() for v in EXCLUDED.values())
    current = {k for rel in REF_FILES for k in gaps(rel)}
    stale = sorted(set(EXCLUDED) - current)
    assert not stale, f"stale exclusions (the port has these now): {stale}"


def test_scan_sees_each_kind_of_gap(tmp_path, monkeypatch):
    """The scan reports a dropped name, member and parameter (and no
    false gap for a port file equal to the reference's)."""
    ref, port = tmp_path / "repro", tmp_path / "repro_torch"
    ref.mkdir()
    port.mkdir()
    src = ("from repro.x import helper\n"
           "A = 1\n"
           "def f(a, *, b=0):\n    pass\n"
           "class C:\n    x: int = 0\n    def m(self, y):\n        pass\n")
    (ref / "mod.py").write_text(src)
    (port / "mod.py").write_text(src.replace("repro.x", "repro_torch.x"))
    monkeypatch.setitem(globals(), "REF", ref)
    monkeypatch.setitem(globals(), "PORT", port)
    assert gaps("mod.py") == []
    (port / "mod.py").write_text(
        "A = 1\ndef f(a):\n    pass\nclass C:\n    def m(self):\n"
        "        pass\n")
    assert gaps("mod.py") == ["mod.py::helper", "mod.py::C.x",
                              "mod.py::C.m(y)", "mod.py::f(b)"]
