"""Command-line interface:  python -m sedumi_tpu_torch problem.dat-s [options].

Solves a sparse-SDPA problem (or a .mat file with At/b/c/K in the SeDuMi
convention) and prints the objective values, status and DIMACS errors,
with the options, defaults, output lines, JSON keys and exit code of the
reference's CLI (sedumi_tpu/__main__.py).  The solve runs on the CUDA
device, and raises where there is none; --cpu runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sedumi_tpu_torch",
        description="symmetric-cone interior-point solver (PyTorch, CUDA)",
    )
    ap.add_argument("problem", help="path to .dat-s (sparse SDPA) or .mat file")
    ap.add_argument("--eps", type=float, default=1e-8, help="accuracy target")
    ap.add_argument("--maxiter", type=int, default=150)
    ap.add_argument("--alg", type=int, default=2, choices=[0, 1, 2])
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU instead of the CUDA device")
    ap.add_argument("--json", action="store_true", help="print a JSON summary")
    ap.add_argument("--save", help="save x,y to this .npz file")
    args = ap.parse_args(argv)

    from sedumi_tpu_torch import sedumi
    from sedumi_tpu_torch.io_sdpa import read_sdpa

    if args.problem.endswith(".mat"):
        from scipy.io import loadmat
        import scipy.sparse as sp

        d = loadmat(args.problem)
        At, b, c, K = d["At"], d["b"], d["c"], d["K"]
        b = np.asarray(b.todense() if sp.issparse(b) else b).ravel()
        c = np.asarray(c.todense() if sp.issparse(c) else c).ravel()
    else:
        At, b, c, K = read_sdpa(args.problem)

    pars = {"eps": args.eps, "maxiter": args.maxiter, "alg": args.alg,
            "fid": 0 if args.quiet else 1}
    x, y, info = sedumi(At, b, c, K, pars,
                        device="cpu" if args.cpu else "cuda")
    cx = float(np.real(np.vdot(c, x)))
    by = float(np.real(np.vdot(b, y)))

    if args.save:
        np.savez(args.save, x=x, y=y)
    if args.json:
        print(json.dumps({
            "cx": cx, "by": by, "iter": info["iter"], "pinf": info["pinf"],
            "dinf": info["dinf"], "numerr": info["numerr"],
            "err": info.get("err"), "wallsec": info["wallsec"],
        }))
    else:
        print(f"c'x = {cx:.10e}")
        print(f"b'y = {by:.10e}")
        print(f"iterations = {info['iter']}, pinf={info['pinf']}, "
              f"dinf={info['dinf']}, numerr={info['numerr']}")
    return 0 if info["numerr"] < 2 and not (info["pinf"] or info["dinf"]) else 1


if __name__ == "__main__":
    sys.exit(main())
