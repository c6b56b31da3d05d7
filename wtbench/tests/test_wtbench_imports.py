"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program.  Top-level module names are
compared whole: ``wavelet_tpu_torch`` begins with ``wavelet_tpu``."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from wtbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = os.path.join(ROOT, "wtbench")
JAX = {"jax", "jaxlib", "flax", "wavelet_tpu"}


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax():
    mods = _loaded_after("from wtbench.tests import tiny\n"
                         "assert tiny.run_cell('nyx_rank64.regen')['correct']")
    assert "wavelet_tpu_torch" in mods
    assert not mods & JAX, mods & JAX


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded_after("import wtbench.reference.check, "
                         "wtbench.reference.archive, wtbench.control")
    assert not mods & (JAX | {"wavelet_tpu_torch"}), mods


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    for d, _dirs, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, PKG))
def test_no_source_imports_jax(path):
    assert not _imports(path) & JAX


def test_reference_sources_import_nothing_of_the_program():
    for path in _sources("reference"):
        assert not _imports(path) & (JAX | {"wavelet_tpu_torch"}), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "wavelet_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]
