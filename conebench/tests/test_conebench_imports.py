"""Nothing the benchmark runs loads jax or the JAX package, and the
reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conebench import spec

DRY = r"""
import json, sys
sys.path.insert(0, {root!r})
from conebench.tests.conftest import tiny_cell
from conebench.harness import run_cell, forbidden_modules
for trace in (False, True):
    run_cell(tiny_cell("control07.mixed", pool=1), 7, 0.1, trace,
             device="cpu", log=lambda line: None)
print(json.dumps(forbidden_modules()))
"""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_after_a_dry_pass():
    out = subprocess.run([sys.executable, "-c", DRY.format(
        root=str(spec.ROOT))], capture_output=True, text=True, timeout=600,
        cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_source_imports_jax():
    for path in spec.BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "sedumi_tpu"), (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "numpy", "scipy"), \
                (path, name)
    code = ("import sys; sys.path.insert(0, %r); "
            "import conebench.reference.certificate; "
            "print([m for m in sys.modules if m.startswith('sedumi')])"
            % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def test_forbidden_names_are_whole_top_level_names():
    from conebench.harness import FORBIDDEN, forbidden_modules

    assert "sedumi_tpu_torch" not in FORBIDDEN
    sys.modules["jaxlike_probe"] = sys
    try:
        assert "jaxlike_probe" not in forbidden_modules()
    finally:
        del sys.modules["jaxlike_probe"]
