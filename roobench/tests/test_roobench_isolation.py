"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level module names are
compared whole: ``repro_torch`` is not ``repro``."""
import ast
import pathlib

from roobench import harness

PKG = pathlib.Path(harness.PKG)
NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
# what the plain reference may use
REFERENCE_MAY = {"__future__", "math", "typing", "torch", "numpy"}


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".", 1)[0])
    return names


def test_names_are_compared_whole():
    assert top_level_imports("import repro_torch.models") == {"repro_torch"}
    assert top_level_imports("from repro.models import x") == {"repro"}
    assert not top_level_imports("import repro_torch") & NEVER


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = top_level_imports(path.read_text()) & NEVER
        assert not bad, f"{path.relative_to(PKG)} imports {sorted(bad)}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / "reference").rglob("*.py")):
        names = top_level_imports(path.read_text())
        assert names <= REFERENCE_MAY, f"{path.name}: {sorted(names)}"
        assert "repro_torch" not in names and "roobench" not in names
