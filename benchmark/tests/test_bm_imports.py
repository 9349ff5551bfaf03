"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Top-level module names are
compared whole: ``trialign_torch`` begins with ``trialign``."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "trialign"}


def _sources(*parts):
    top = os.path.join(BENCH, *parts)
    for base, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax(path):
    assert not set(_top_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_top_imports(path)) & (FORBIDDEN | {"trialign_torch"})


def test_a_run_loads_no_jax(toy):
    """A whole run on the CPU, in a process of its own: after it, no loaded
    module's top-level name is JAX's or the JAX package's, and the
    reference's modules loaded nothing of the program."""
    root, bench = toy
    code = f"""
import sys
from benchmark import harness, control, run
from benchmark.reference import dp, rescore
assert not [m for m in sys.modules if m.split('.')[0] == 'trialign_torch']
harness.run_cell('tinydna.single', 5, 0.2, False, 'cpu', root={root!r},
                 bench_dir={bench!r})
found = harness.forbidden_modules()
assert not found, found
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_forbidden_names_are_whole():
    from benchmark import harness

    sys.modules.setdefault("trialign_torch_like", sys)
    try:
        assert "trialign_torch_like" not in harness.forbidden_modules()
    finally:
        del sys.modules["trialign_torch_like"]
