"""Import hygiene of the port: sedumi_tpu_torch and chip_smoke.py import
neither jax nor the reference package sedumi_tpu, and the entry point runs
on the CUDA device unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "sedumi_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "sedumi_tpu")


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, sedumi_tpu_torch, sedumi_tpu_torch.convert, "
            "sedumi_tpu_torch.__main__, sedumi_tpu_torch.profiling, "
            "sedumi_tpu_torch.io_sdpa, sedumi_tpu_torch.io_mps, "
            "sedumi_tpu_torch.io_pack; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'sedumi_tpu')); "
            "print(repr(bad))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path.name, names)


def test_default_device_is_cuda_and_never_falls_back():
    import sedumi_tpu_torch as pt

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run is valid")
    A = np.array([[1.0, 1.0]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.sedumi(A, np.array([1.0]), np.array([1.0, 2.0]), {"l": 2},
                  {"fid": 0})
