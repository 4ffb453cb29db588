"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py``, not the port's examples (``examples/torch_*.py``) and
not the port's scripts (``scripts/*_ablations.py``, ``scripts/torch_*.py``)
imports ``jax`` or the JAX package ``repro``
(the card's machine has neither). An AST scan, so imports inside
functions count too.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SCRIPT_FILES = sorted(set((ROOT / "scripts").glob("*_ablations.py"))
                      | set((ROOT / "scripts").glob("torch_*.py")))
EXAMPLE_FILES = sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_has_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES}
    assert {"kernels/hstu_attention.py", "kernels/dispatch.py",
            "kernels/hstu_attention_prefix.py", "serve/serving.py",
            "serve/user_cache.py", "serve/engine.py", "models/gr.py",
            "interop.py", "kernels/hstu_attention_bwd.py", "tree.py",
            "train/optim.py", "train/loop.py", "train/checkpoint.py",
            "train/metrics.py", "kernels/embedding_bag.py",
            "kernels/dot_interaction.py", "models/interactions.py",
            "embeddings/collection.py", "models/dlrm.py",
            "scenario/build.py", "scenario/spec.py", "scenario/smoke.py",
            "configs/registry.py", "launch/train.py", "obs/metrics.py",
            "obs/log.py", "obs/trace.py", "obs/export.py", "obs/report.py",
            "obs/__init__.py", "reliability/faults.py",
            "core/joiner.py", "data/storage.py", "pipeline/__init__.py",
            "pipeline/shards.py", "pipeline/joiner.py",
            "pipeline/prefetch.py", "pipeline/resume.py",
            "distributed/sharding.py", "distributed/spmd.py",
            "distributed/comms.py", "distributed/collectives.py",
            "embeddings/sharded.py", "launch/mesh.py",
            "launch/hostdevices.py", "train/compression.py",
            "models/lm/transformer.py", "models/lm/moe.py",
            "models/lm/decode.py", "models/gnn/irreps.py",
            "models/gnn/mace.py", "models/gnn/sampler.py",
            "configs/starcoder2_15b.py", "configs/deepseek_coder_33b.py",
            "configs/phi3_medium_14b.py", "configs/qwen3_moe_235b_a22b.py",
            "configs/granite_moe_3b_a800m.py", "configs/mace.py",
            "kernels/ops.py"} <= names


def test_port_has_examples():
    """Each example of the reference has its port beside it."""
    ref = {p.name for p in (ROOT / "examples").glob("*.py")
           if not p.name.startswith("torch_")}
    assert {"torch_" + n for n in ref} == {p.name for p in EXAMPLE_FILES}


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"] + SCRIPT_FILES
    + EXAMPLE_FILES,
    ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [(root, line) for root, line in imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
