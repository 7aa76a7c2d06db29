"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference and the generator (with every module of the benchmark they import)
import nothing of the program either.  Names compare whole at the top level:
``haslr_tpu_torch`` begins with ``haslr_tpu`` and is not it."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "flax", "haslr_tpu"}
REFERENCE = NEVER | {"haslr_tpu_torch"}


def imports_of(path):
    """Top-level module names a file imports, and the benchmark modules
    it imports (dotted)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops, local = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module] + [f"{node.module}.{a.name}"
                                     for a in node.names]
        else:
            continue
        for n in names:
            tops.add(n.split(".")[0])
            if n.split(".")[0] == "benchmark":
                local.add(n)
    return tops, local


def module_file(name):
    rel = name.split(".")[1:]
    base = os.path.join(BENCH, *rel)
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None   # a name imported from a module, not a module


def py_files():
    for d, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(py_files()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    tops, _ = imports_of(path)
    assert not tops & NEVER


def test_reference_imports_nothing_of_the_program():
    """The reference and the generator whose truth it judges by."""
    todo = [os.path.join(BENCH, d, f) for d in ("reference", "gen")
            for f in os.listdir(os.path.join(BENCH, d)) if f.endswith(".py")]
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        tops, local = imports_of(path)
        assert not tops & REFERENCE, (path, tops & REFERENCE)
        todo.extend(f for f in map(module_file, local) if f)
    assert any(p.endswith(os.path.join("gen", "truepaf.py")) for p in seen)
    assert any(p.endswith(os.path.join("reference", "assembly.py"))
               for p in seen)


def test_the_guard_compares_whole_names():
    from benchmark import run

    assert "haslr_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert "haslr_tpu" in run.FORBIDDEN
