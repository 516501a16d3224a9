"""The readings a cell's limits are set from, on the card, in one process.

    python3 conebench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        [--pars '{"dtype": "float32"}'] [--solves 8]

For each seed, draws the cell's pool as a run does and solves the first
`--solves` instances with the cell's pars updated by --pars (the control:
{"dtype": "float32"}, the program's lower precision), after one warm-up
solve, then prints one JSON line a seed: the worst of each number the
cell compares, as a run reads it, and each solve's numbers, wall and
iterations.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "conebench" / "tools":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from conebench.hostload import limit_threads  # noqa: E402

limit_threads()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--pars", default="{}")
    ap.add_argument("--solves", type=int, default=8)
    args = ap.parse_args(argv)

    from conebench import spec
    from conebench.certify import judge_all
    from conebench.harness import _solve, _sync
    from conebench.instance import make_pool

    cell = spec.cell(args.workload)
    pars = {**cell["traffic"]["pars"], **json.loads(args.pars)}
    from sedumi_tpu_torch import kernels

    kernels.build_all()
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        pool, warm = make_pool(cell["config"], seed, cell["traffic"]["pool"])
        if k == 0:
            _solve(warm, pars, "cuda")
        solves, walls = [], []
        for inst in pool[:args.solves]:
            t0 = time.perf_counter()
            solves.append(_solve(inst, pars, "cuda"))
            _sync("cuda")
            walls.append(time.perf_counter() - t0)
        worst, per_solve = judge_all(solves, cell["checks"])
        print(json.dumps({
            "workload": args.workload, "seed": seed, "pars": pars,
            "worst": worst, "per_solve": per_solve, "wall_s": walls,
            "iter": [s.get("info", {}).get("iter") for s in solves]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
