"""K8 and K10 beside an earlier build of the same kernels, on one card.

    python3 tile_bench.py --parent DIR [--plans lp20k,sdp5k,sdp1200]

DIR holds another checkout of this repository (for example the parent
commit, unpacked with git archive).  Its sedumi_tpu_torch is loaded under
another module name, so both builds of the tile kernels (each compiled
into its own package's _build/) run in this one process, on the same
plans and inputs: the plans of chip_smoke.py's sparse solves (the host
plan of SPARSE_SOLVES' problems, seed 12345), the tile storage A H A' at
a random interior point (chip_smoke.tile_case), factored by this tree's
K8/K9.

Per plan and storage dtype it times the whole tile solve (K10, K10-f32)
in turns (earlier, this, this, earlier) and reports the earlier build's
mean time and this one's, and their largest difference; at lp20k's widest
level it times K8's diagonal and off launches apart for both builds and
checks that they agree bit for bit (the blocked K8 keeps the unblocked
order of operations).  Prints one JSON line, the card's name and power
limit.  Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def load_package(root: str, name: str):
    """Import ROOT/sedumi_tpu_torch as module `name`."""
    init = os.path.join(root, "sedumi_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def plan_of(make, pars):
    """The host plan route_engine makes for a problem (chip_smoke's
    solves take the same route)."""
    from sedumi_tpu_torch import solver
    from sedumi_tpu_torch.params import Pars
    from sedumi_tpu_torch.transform import pretransfo

    A, b, c, K = make(np.random.default_rng(12345))
    p = Pars.make(pars)
    pre = pretransfo(A, b, c, K, p)
    kind, plan = solver.route_engine(pre.At, pre.c, pre.layout, p)
    if kind != "sparse":
        raise RuntimeError("the problem did not take the sparse route")
    return plan


def diag_off_ms(kern, st, lv, reg, canceltol, sfx):
    """(diag ms, off ms) of one build's K8 launches at level lv; kern is
    that build's kernels module."""
    from chip_smoke import cuda_ms

    work = st.clone()
    rung = torch.empty(lv["dslot"].numel(), dtype=torch.int32,
                       device=st.device)
    B = st.shape[-1]

    def diag():
        work.copy_(st)
        kern.launch("tile_chol.cu", f"tile_diag{sfx}_launch",
                    work.data_ptr(), lv["dslot"].data_ptr(), rung.data_ptr(),
                    lv["dslot"].numel(), B, float(reg), float(canceltol))

    diag()
    after = work.clone()

    def off():
        work.copy_(after)
        kern.launch("tile_chol.cu", f"tile_off{sfx}_launch",
                    work.data_ptr(), lv["off_slot"].data_ptr(),
                    lv["off_dslot"].data_ptr(), lv["off_slot"].numel(), B)

    copy = cuda_ms(lambda: work.copy_(st), 20)
    off()
    return cuda_ms(diag, 20) - copy, cuda_ms(off, 20) - copy, work.clone()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--plans", default="lp20k,sdp5k,sdp1200")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: tile_bench.py needs one card", file=sys.stderr)
        sys.exit(1)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch import sparse_chol as sc

    old = load_package(os.path.abspath(args.parent), "sedumi_tpu_torch_old")
    t0 = time.time()
    kernels.build_all(["tile_chol.cu", "tile_update.cu", "tile_solve.cu"])
    old.kernels.build_all(["tile_chol.cu", "tile_solve.cu"])
    print(f"built both builds' tile kernels in {time.time() - t0:.1f}s",
          flush=True)
    osc = old.sparse_chol
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(20261016)
    solves = {name: (make, pars) for name, make, pars, _ in cs.SPARSE_SOLVES}
    out = {}
    for name in args.plans.split(","):
        t0 = time.time()
        plan = plan_of(*solves[name])
        print(f"{name}: host plan {time.time() - t0:.1f}s", flush=True)
        for dtype in (torch.float64, torch.float32):
            sfx = "_f32" if dtype == torch.float32 else ""
            rng = np.random.default_rng(20261016)
            aop, st = cs.tile_case(plan, dev, rng, dtype)
            levels = aop.levels
            row = {}
            if name == "lp20k":
                wide = max(range(len(levels)),
                           key=lambda i: (levels[i]["cols"].numel(),
                                          levels[i]["pair_a"].numel()))
                before = st.clone()
                for lv in levels[:wide]:
                    sc.tile_factor(before, lv, 0.0)
                    sc.tile_update(before, lv)
                lv = levels[wide]
                d_old, o_old, w_old = diag_off_ms(old.kernels, before, lv, 0.0,
                                                  1e-12, sfx)
                d_new, o_new, w_new = diag_off_ms(kernels, before, lv, 0.0,
                                                  1e-12, sfx)
                row["k8_widest"] = {
                    "cols": lv["dslot"].numel(),
                    "off_tiles": lv["off_slot"].numel(),
                    "diag_ms": {"earlier": d_old, "this": d_new},
                    "off_ms": {"earlier": o_old, "this": o_new},
                    "bit_equal": cs.bit_diff(w_old, w_new)[0]}
            L = sc.factor_tiles(st, levels, 0.0)
            rhs = torch.randn(aop.meta["ntiles_n"], generator=gen,
                              dtype=torch.float64).to(dev, dtype)
            x_new = sc.tile_solve(L, rhs, levels)
            x_old = osc.tile_solve(L, rhs, levels)
            ms = {"earlier": [], "this": []}
            for who in ("earlier", "this", "this", "earlier"):
                fn = osc.tile_solve if who == "earlier" else sc.tile_solve
                ms[who].append(cs.cuda_ms(lambda: fn(L, rhs, levels), 10))
            row["k10_ms"] = {k: sum(v) / len(v) for k, v in ms.items()}
            row["k10_ms_runs"] = ms
            row["k10_max_diff"] = float((x_new - x_old).abs().max())
            row["max_abs_x"] = float(x_old.abs().max())
            row["levels"] = len(levels)
            out[f"{name}{sfx}"] = row
            print(f"{name}{sfx}: {json.dumps(row)}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"tile_bench": out}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)


if __name__ == "__main__":
    main()
