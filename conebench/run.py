"""Run one cell of BENCHMARK.json once on the card and print one JSON line.

    python3 conebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (setup_s) runs from the start of
this process: torch and CUDA, the program's kernel libraries (built by
nvcc into sedumi_tpu_torch/_build/ at a checkout's first run, loaded
after), the pool of instances drawn from the seed and one warm-up solve
of an instance of the same shapes outside the pool.  With --trace 0 the
line carries the cell's end-to-end metrics, with --trace 1 its per-layer
metrics.  Exits non-zero, printing no result, without a CUDA card, without
the program, or if jax, jaxlib, flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this folder, heads the import path
ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "conebench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from conebench.hostload import limit_threads  # noqa: E402

limit_threads()


def _finite(obj):
    """The object with every non-finite float written as a string, so the
    line stays JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().replace("\n", "; ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from conebench import spec

    cell = spec.cell(args.workload)
    chips = cell["workload"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"conebench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    parts = {"torch_cuda_s": time.perf_counter() - T_START}

    t0 = time.perf_counter()
    try:
        from sedumi_tpu_torch import kernels
    except ImportError as exc:
        print(f"conebench: the program is not here: {exc}", file=sys.stderr)
        return 3
    built = kernels.build_all()
    for src, fns in kernels.SOURCES.items():
        for fn in fns:
            kernels.bound(src, fn)
    parts["kernels_s"] = time.perf_counter() - t0
    if built:
        parts["nvcc_s"] = max(built.values())

    from conebench.harness import forbidden_modules, run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START, setup_parts=parts,
                      log=lambda line: print(line, file=sys.stderr),
                      note=lambda: f"card: {_power_limit()}")
    bad = forbidden_modules()
    if bad:
        print(f"conebench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print(json.dumps(_finite(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
