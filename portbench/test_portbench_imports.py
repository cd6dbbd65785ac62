"""No module of the benchmark imports JAX or the JAX package, and no
reference imports the program: top-level module names compared whole."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in
                ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    banned = FORBIDDEN | ({"repro_torch"} if "refs" in path.parts else set())
    assert not imported(path) & banned


def test_guard_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.models\nimport jaxtyping\n"
                   "from repro.core import x\n")
    assert imported(src) == {"repro_torch", "jaxtyping", "repro"}
    assert imported(src) & FORBIDDEN == {"repro"}


def test_harness_refuses_forbidden_modules():
    from portbench import harness
    assert harness.loaded_forbidden(["repro_torch.models", "torch",
                                     "jaxtyping"]) == []
    assert harness.loaded_forbidden(["repro_torch", "jax.numpy", "repro",
                                     "flax.linen"]) == ["flax", "jax",
                                                        "repro"]
