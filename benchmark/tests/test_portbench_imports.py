"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: `favae_tpu_torch` begins with `favae_tpu`), and the
reference imports nothing of the port."""

import ast

import pytest

from benchmark.harness import BENCH, FORBIDDEN_MODULES, forbidden_modules

FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    found = set(top_level_imports(path)) & set(FORBIDDEN_MODULES)
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.parts],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "favae_tpu_torch" not in set(top_level_imports(path))


def test_forbidden_modules_compares_whole_names():
    assert forbidden_modules(["favae_tpu_torch", "favae_tpu_torch.ops",
                              "jaxtyping", "flaxy"]) == []
    assert forbidden_modules(["favae_tpu.config", "jax.numpy",
                              "optax"]) == ["favae_tpu", "jax", "optax"]


def test_run_refuses_a_process_that_holds_jax(monkeypatch, capsys):
    import sys
    import types
    from benchmark import run
    assert not run.refuse_modules("before its result")
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.refuse_modules("before its result")
    assert "['jax'] before its result" in capsys.readouterr().err
