"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the package it judges.  Module names are
compared by their top-level name, whole: ``openimpala_tpu_torch`` starts
with ``openimpala_tpu`` and is not it."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

from conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")
NEVER = {"jax", "jaxlib", "flax", "openimpala_tpu"}


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in dirpath.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("sub,never", [
    ("", NEVER),
    ("reference", NEVER | {"openimpala_tpu_torch"}),
])
def test_sources_import_no_forbidden_package(sub, never):
    found = {p: _top_level_imports(p) & never for p in _sources(sub)}
    assert not {p: n for p, n in found.items() if n}
    assert found  # the walk saw files


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "openimpala_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "openimpala_tpu.ops", sys)
    assert harness.forbidden_modules() == ["openimpala_tpu"]


def test_reference_loads_nothing_of_the_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.props, portbench.kinds.tortuosity; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'openimpala_tpu', "
            "'openimpala_tpu_torch'}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"
