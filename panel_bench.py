"""K14 and K15 beside an earlier build of the same kernels, on one card.

    python3 panel_bench.py --parent DIR

DIR holds another checkout of this repository (for example the parent
commit, unpacked with git archive).  Its sedumi_tpu_torch is loaded under
another module name (tile_bench.load_package), so both builds of the
Schur-panel kernels (each compiled into its own package's _build/) run in
this one process on the same inputs: chip_smoke.py's panel cases (a
Jacobi-scaled SPD matrix of cond ~1e6, every block column as
dist_cholesky hands it to K14, both substitutions over two panels) at the
mesh path's panel shapes, OH's (bs 128, mp 1024) and nb's (bs 32, mp 128).

Per shape it times, in turns (earlier, this, this, earlier), K14 on
column 0 and over the nb columns of one factor, and K15's forward step on
the last block row, the backward contribution of panel 1 to column 0 and
one back solve: back to back between CUDA events and as the replay of a
captured CUDA graph (chip_smoke.graph_ms; null where a build's call
cannot be captured).  It reports each build's mean, checks that the two
builds agree within chip_smoke.PANEL_TOL (of max|L|, of max|x|) and that
this build equals the emulation of its order bit for bit, and prints one
JSON line, the card's name and power limit.  Needs a CUDA device; exits 1
without one.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import torch


def steps(pn, c, bs: int, mp: int) -> dict:
    """name -> a call of one build's wrapper (pn: its parallel.panels) on
    the case's inputs, as chip_smoke.check_panel_kernels times them."""
    nb = mp // bs
    nb_loc = nb // 2
    Cs, L, x, b = c["Cs"], c["L"], c["x"], c["b"]
    row = L[(nb - 1) * bs:].contiguous()
    bj = b[(nb - 1) * bs:].contiguous()
    L3 = L[nb_loc * bs:].contiguous()
    Ljj = L[:bs, :bs].contiguous()

    def factor():
        return [pn.panel_chol_step(C, j) for j, C in enumerate(Cs)]

    return {
        "k14_column0": lambda: pn.panel_chol_step(Cs[0], 0),
        "k14_factor": factor,
        "k15_fwd": lambda: pn.trisolve_fwd_step(row, x, bj, nb - 1),
        "k15_contrib": lambda: pn.trisolve_bwd_contrib(L3, x, bs, nb_loc, 0),
        "k15_bwd_solve": lambda: pn.trisolve_bwd_solve(Ljj, b[:bs], x[:bs]),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: panel_bench.py needs one card",
              file=sys.stderr)
        sys.exit(1)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "tests"))
    import chip_smoke as cs
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.parallel import panels as pn
    from tile_bench import load_package

    old = load_package(os.path.abspath(args.parent), "sedumi_tpu_torch_old")
    old_pn = importlib.import_module("sedumi_tpu_torch_old.parallel.panels")
    srcs = ["panel_chol.cu", "panel_solve.cu"]
    t0 = time.time()
    kernels.build_all(srcs)
    old.kernels.build_all(srcs)
    print(f"built both builds' panel kernels in {time.time() - t0:.1f}s",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(20261016)
    out = {}
    for bs, mp in cs.PANEL_SHAPES:
        c = cs.panel_case(bs, mp, gen, dev)
        if not c["emu_ok"]:
            cs.fail(f"this build differs from its emulation at bs={bs}")
        calls = {"earlier": steps(old_pn, c, bs, mp),
                 "this": steps(pn, c, bs, mp)}
        lmax = float(c["L"].abs().max())
        xmax = float(c["x"].abs().max())
        shape = {}
        for name in calls["this"]:
            got = {who: calls[who][name]() for who in calls}
            if name == "k14_factor":
                got = {who: torch.stack(v) for who, v in got.items()}
            diff = float((got["this"] - got["earlier"]).abs().max())
            scale = lmax if name.startswith("k14") else xmax
            if not diff <= cs.PANEL_TOL * scale:
                cs.fail(f"{name} bs={bs}: the builds differ by {diff!r}")
            ev = {"earlier": [], "this": []}
            gr = {"earlier": [], "this": []}
            for who in ("earlier", "this", "this", "earlier"):
                ev[who].append(cs.cuda_ms(calls[who][name], 20))
                gr[who].append(cs.try_graph_ms(f"{who} {name}",
                                               calls[who][name]))
            shape[name] = {
                "event_ms": {k: sum(v) / len(v) for k, v in ev.items()},
                "graph_ms": {k: None if None in v else sum(v) / len(v)
                             for k, v in gr.items()},
                "event_ms_runs": ev, "graph_ms_runs": gr,
                "max_diff": diff, "of": scale}
            print(f"bs={bs} mp={mp} {name}: {json.dumps(shape[name])}",
                  flush=True)
        out[f"bs{bs}_mp{mp}"] = shape
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"panel_bench": out, "card": smi}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
