"""On the card: one short run of each cell through the benchmark's
command, correct and with every metric of its line.  Skips without a
CUDA card (decided inside the test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conebench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_short_run_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "conebench/run.py", "--workload", name, "--seed",
         str(2**31 + 77), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-3000:]
    assert set(res["metrics"]) == {"solve_s", "setup_s"}
    assert res["device"]["platform"] == "gpu"
