"""Smoke test of sedumi_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Kernel phase: builds every CUDA kernel of the port from csrc/ (one nvcc
   per source, in parallel) and holds each against its plain-PyTorch twin
   on the card at the shapes the solver gives it, with the tolerance
   stated; times both, and the card's least time (bound) for the work.
2. Path phase: sedumi_tpu_torch.sedumi() on all six bundled examples at
   full size (quantum, nb, arch0, control07, trto3, OH), plus nb with one
   redundant all-zero constraint (its Schur complement is singular, so
   every iteration takes the masked-LDL' fallback).  Launch counts are
   zeroed just before and read just after; every kernel must have
   launched.  quantum, nb and the redundant-row nb must pass the reference
   gate (rel <= 1e-6 vs the published optimum, pinf = dinf = 0,
   numerr < 2); the others must finish with finite outputs, and each
   prints its rel, pinf, dinf and numerr.
3. Prints {"kernels": [...]}, the card's name and power limit, and as the
   last line {"ok": true, "device": {...}}.  Any failure exits non-zero
   before the last line.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the f64
# tensor-core rate, the highest f64 rate the card has
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 67e12


def bound_ms(nbytes: float, flops: float):
    t_b = nbytes / PEAK_BYTES_PER_S
    t_f = flops / PEAK_F64_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------


def check_dd_residual(dev, gen):
    """K1 at control07's Schur order m = 666, cond ~ 1e14, v = M^{-1} rhs
    so the residual is pure cancellation."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.pcg import dd_matvec_residual, \
        dd_matvec_residual_plain

    m = 666
    q, _ = torch.linalg.qr(torch.randn(m, m, generator=gen, dtype=torch.float64,
                                       device="cpu"))
    ev = torch.logspace(0, -14, m, dtype=torch.float64)
    M = ((q * ev) @ q.T).to(dev)
    M = 0.5 * (M + M.T)
    rhs = torch.randn(m, generator=gen, dtype=torch.float64).to(dev)
    v = torch.linalg.solve(M, rhs)
    n0 = kernels.LAUNCHES["dd_matvec_residual"]
    r_k = dd_matvec_residual(M, v, rhs)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["dd_matvec_residual"] != n0 + 1:
        fail("dd_matvec_residual did not launch its kernel")
    r_p = dd_matvec_residual_plain(M, v, rhs)
    eps = float(np.finfo(np.float64).eps)
    tol = 2 * eps * torch.abs(r_p) + 1e-28 * (torch.abs(M) @ torch.abs(v))
    err = torch.abs(r_k - r_p)
    print(f"K1 dd_matvec_residual m={m}: max|r|={float(r_p.abs().max()):.3e} "
          f"max err={float(err.max()):.3e} worst err/tol="
          f"{float((err / tol).max()):.3e}", flush=True)
    if not bool(torch.all(err <= tol)):
        fail("dd_matvec_residual kernel disagrees with its plain version")
    ms = cuda_ms(lambda: dd_matvec_residual(M, v, rhs), 200)
    plain = cuda_ms(lambda: dd_matvec_residual_plain(M, v, rhs), 20)
    lib = cuda_ms(lambda: torch.addmv(rhs, M, v, alpha=-1.0), 200)
    nbytes = 8.0 * (m * m + 3 * m)
    # per element: product + fma error term + TwoSum (6) + 2 adds
    b_ms, b_by = bound_ms(nbytes, 11.0 * m * m)
    return dict(name="dd_matvec_residual", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_residual.cu",
                replaces="sedumi_tpu/pcg.py:56",
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def check_psd_coo(dev, gen):
    """K2 on arch0's COO bucket (the port's build_coo_aop) and W = R R'
    from a random well-conditioned R."""
    from sedumi_tpu_torch import kernels, transform
    from sedumi_tpu_torch.examples import load_example
    from sedumi_tpu_torch.opA import build_coo_aop
    from sedumi_tpu_torch.params import Pars
    from sedumi_tpu_torch.schur import _psd_contrib_coo_kernel, \
        _psd_contrib_coo_plain, psd_gram

    ex = load_example("arch0")
    prob = transform.pretransfo(ex.At, ex.b, ex.c, ex.K, Pars(fid=0))
    aop = build_coo_aop(prob.At, prob.c, prob.layout, device=dev)
    bi = [i for i, meta in enumerate(aop.s_meta) if meta[0] == "coo"]
    if not bi:
        fail("arch0 has no COO PSD bucket (expected one, opA.py:251)")
    part, (rep, k, d, G, pad2, T) = aop.s_parts[bi[0]], aop.s_meta[bi[0]]
    mp1 = aop.m + 1
    r = (torch.randn(k, d, d, generator=gen, dtype=torch.float64) / d ** 0.5
         + torch.eye(d, dtype=torch.float64)).to(dev)
    W = psd_gram(r)
    n0 = kernels.LAUNCHES["psd_contrib_coo"]
    M_k = _psd_contrib_coo_kernel(part, k, d, G, pad2, mp1, W)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["psd_contrib_coo"] != n0 + 1:
        fail("_psd_contrib_coo did not launch its kernels")
    M_p = _psd_contrib_coo_plain(part, k, d, G, pad2, mp1, W)
    err = float(torch.abs(M_k - M_p).max())
    scale = float(torch.abs(M_p).max())
    print(f"K2 psd_contrib_coo arch0 (k={k} d={d} G={G} pad2={pad2} T={T} "
          f"m+1={mp1}): max|M|={scale:.3e} max err={err:.3e} "
          f"(tol 1e-12*max|M|)", flush=True)
    if not err <= 1e-12 * scale:
        fail("psd_contrib_coo kernel disagrees with its plain version")
    ms = cuda_ms(lambda: _psd_contrib_coo_kernel(part, k, d, G, pad2, mp1,
                                                 W), 50)
    plain = cuda_ms(lambda: _psd_contrib_coo_plain(part, k, d, G, pad2, mp1,
                                                   W), 5)
    flops = 2.0 * G * pad2 * d * d + 2.0 * T * mp1
    nbytes = 8.0 * (k * d * d + 4 * G * pad2 + 2 * G + 3 * T + mp1 + 1
                    + mp1 * mp1)
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(name="psd_contrib_coo", route="cuda",
                source="sedumi_tpu_torch/csrc/psd_coo.cu",
                replaces="sedumi_tpu/schur.py:60",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def indefinite_matrix(m: int, gen) -> torch.Tensor:
    """SPD B B' + I with two kinds of broken pivots: decoupled negative
    diagonals (cancellation add, no skip) and coupled ones (the lifted
    pivot makes |L| > maxu: skip)."""
    B = torch.randn(m, m, generator=gen, dtype=torch.float64)
    M = B @ B.T / m + torch.eye(m, dtype=torch.float64)
    for j in range(10, m, 37):      # add only
        M[j, :] = 0.0
        M[:, j] = 0.0
        M[j, j] = -1.0
    for j in range(25, m, 41):      # add, then skip
        M[j, j] = -1.0
    return M


def check_ldl_masked(dev, gen):
    """K3 on an indefinite 174 x 174 matrix (arch0's Schur order) built to
    trigger both the add and the skip rule."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.chol import ldl_masked, ldl_masked_plain

    m = 174
    M = indefinite_matrix(m, gen).to(dev)
    n0 = kernels.LAUNCHES["ldl_masked"]
    fk = ldl_masked(M)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["ldl_masked"] != n0 + 1:
        fail("ldl_masked did not launch its kernel")
    fp_ = ldl_masked_plain(M)
    n_skip, n_add = int(fp_.skip.sum()), int((fp_.diagadd > 0).sum())
    same_masks = bool(torch.equal(fk.skip, fp_.skip)
                      and torch.equal(fk.diagadd > 0, fp_.diagadd > 0))
    fin = torch.isfinite(fp_.d)
    err = max(float(torch.abs(fk.L - fp_.L).max()),
              float(torch.abs(fk.d[fin] - fp_.d[fin]).max()),
              float(torch.abs(fk.diagadd - fp_.diagadd).max()))
    scale = max(float(torch.abs(fp_.L).max()),
                float(torch.abs(fp_.d[fin]).max()))
    print(f"K3 ldl_masked m={m}: skipped {n_skip}, added {n_add}, masks "
          f"equal {same_masks}, max err={err:.3e} (tol 1e-12*{scale:.3e})",
          flush=True)
    if not (n_skip > 0 and n_add > n_skip):
        fail("the K3 test matrix did not trigger both add and skip")
    if not (same_masks and torch.equal(torch.isfinite(fk.d), fin)
            and err <= 1e-12 * scale):
        fail("ldl_masked kernel disagrees with its plain version")
    ms = cuda_ms(lambda: ldl_masked(M), 10)
    plain = cuda_ms(lambda: ldl_masked_plain(M), 2, warmup=1)
    keep = (~fp_.skip).cpu().numpy()
    flops = sum(3.0 * (m - j - 1) * (m - j) / 2 + (m - j - 1)
                for j in range(m) if keep[j])
    nbytes = 8.0 * (2 * m * m + 3 * m) + m
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(name="ldl_masked", route="cuda",
                source="sedumi_tpu_torch/csrc/ldl_masked.cu",
                replaces="sedumi_tpu/chol.py:95",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# --------------------------------------------------------------------------
# path phase
# --------------------------------------------------------------------------


def with_zero_row(ex):
    """ex with one all-zero constraint appended (b = 0): redundant, so the
    optimum is unchanged, but A H A' is singular."""
    import scipy.sparse as sp

    At = sp.hstack([sp.csc_matrix(ex.At),
                    sp.csc_matrix((ex.At.shape[0], 1))]).tocsc()
    return ex._replace(name=ex.name + "+zero-row", At=At,
                       b=np.concatenate([ex.b, [0.0]]))


def run_example(ex, gate: bool):
    import sedumi_tpu_torch as st
    from sedumi_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    x, y, info = st.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0},
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    cx = float(np.real(np.vdot(ex.c, x)))
    by = float(np.real(np.vdot(ex.b, y)))
    rel = max(abs(cx - ex.optval), abs(by - ex.optval)) / abs(ex.optval)
    counts = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    print(f"{ex.name}: iter={info['iter']} cx={cx!r} by={by!r} "
          f"rel={rel:.3e} pinf={info['pinf']} dinf={info['dinf']} "
          f"numerr={info['numerr']} wall={wall:.2f}s launches={counts}",
          flush=True)
    finite = bool(np.all(np.isfinite(x)) and np.all(np.isfinite(y)))
    if not finite:
        fail(f"{ex.name}: non-finite solution")
    if gate and not (rel <= 1e-6 and info["pinf"] == 0
                     and info["dinf"] == 0 and info["numerr"] < 2):
        fail(f"{ex.name}: reference gate not met")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        sys.exit(1)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.examples import load_example

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    times = kernels.build_all()
    print(f"built kernels in {time.time() - t0:.1f}s: "
          + ", ".join(f"{s} {t:.1f}s" for s, t in times.items()), flush=True)

    gen = torch.Generator().manual_seed(20261016)
    rows = [check_dd_residual(dev, gen), check_psd_coo(dev, gen),
            check_ldl_masked(dev, gen)]

    kernels.reset_launch_counts()
    plan = [("quantum", True), ("nb", True), ("arch0", False),
            ("control07", False), ("trto3", False),
            ("OH_2Pi_STO-6GN9r12g1T2", False)]
    for name, gate in plan:
        counts = run_example(load_example(name), gate)
        if counts["dd_matvec_residual"] == 0:
            fail(f"{name}: the compensated-residual kernel never ran")
        if name == "arch0" and counts["psd_contrib_coo"] == 0:
            fail("arch0: the sparse PSD Schur kernel never ran")
    counts = run_example(with_zero_row(load_example("nb")), True)
    if counts["ldl_masked"] == 0:
        fail("nb+zero-row: the masked-LDL' fallback never ran")
    total = dict(kernels.LAUNCHES)
    for row in rows:
        row["launches"] = total[row["name"]]
        if row["launches"] == 0:
            fail(f"kernel {row['name']} never launched on the path")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
