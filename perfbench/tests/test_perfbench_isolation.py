"""Nothing under perfbench/ imports JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the system under test."""

import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "mapfree_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert imported(path) <= {"__future__", "contextlib", "torch"}


def test_the_whole_name_is_compared():
    # the harness drives the port, whose name begins with the JAX package's
    assert "mapfree_tpu_torch" not in BANNED
    assert "mapfree_tpu_torch" in imported(BENCH_DIR / "harness" / "sweep.py")


def test_banned_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    from perfbench.harness import cell as C

    assert C.banned_modules() == []
    monkeypatch.setitem(sys.modules, "mapfree_tpu_torch_fake", types.ModuleType("x"))
    assert C.banned_modules() == []
    monkeypatch.setitem(sys.modules, "mapfree_tpu.ops", types.ModuleType("x"))
    assert C.banned_modules() == ["mapfree_tpu"]
