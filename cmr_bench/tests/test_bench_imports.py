"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
in the reference nothing of the port."""

import ast
import os
import sys

from conftest import ROOT

from cmr_bench import run

JAX_SIDE = {"jax", "jaxlib", "flax", "complex_materials_renderer_tpu"}
PORT = "complex_materials_renderer_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                yield arg.value.split(".")[0]


def _sources(sub=""):
    base = os.path.join(ROOT, "cmr_bench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_imports(path)) & JAX_SIDE
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert PORT not in set(_imports(path)), path
        assert PORT not in open(path).read(), path


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    before = set(run.banned_modules())
    monkeypatch.setitem(sys.modules, PORT + ".fake", object())
    assert set(run.banned_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.banned_modules()


def test_harness_sets_no_port_variable():
    for path in _sources():
        if os.sep + "tests" + os.sep not in path:
            assert "CMR" + "_" not in open(path).read(), path
