"""Smoke test of sedumi_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Kernel phase: builds every CUDA kernel of the port from csrc/ (one nvcc
   per source, in parallel) and holds each against its plain-PyTorch twin
   on the card at the shapes the solver gives it, with the tolerance
   stated (K1, K2, K6 within error bounds; K3, K4, K5, K7 bit for bit);
   times both, and the card's least time (bound) for the work.
2. Path phase: sedumi_tpu_torch.sedumi() on all six bundled examples at
   full size (quantum, nb, arch0, control07, trto3, OH), plus nb with one
   redundant all-zero constraint (its Schur complement is singular, so
   every iteration takes the masked-LDL' fallback).  Launch counts are
   zeroed just before and read just after; every kernel must have
   launched.  arch0 must enter the dd64 phase and launch K4-K7 in its
   solve.  quantum, nb, arch0 and the redundant-row nb must pass the
   reference gate (rel <= 1e-6 vs the published optimum, pinf = dinf = 0,
   numerr < 2); the others must finish with finite outputs, and each
   prints its rel, pinf, dinf, numerr and phases.
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


def wide_matrix(shape, gen) -> torch.Tensor:
    """Gaussian entries scaled over 2^-20..2^20, every 7th an exact power
    of two (frexp's f == 0.5 case), every 11th zero."""
    a = torch.randn(*shape, generator=gen, dtype=torch.float64)
    a = a * torch.exp2(torch.randint(-20, 21, shape, generator=gen)
                       .to(torch.float64))
    flat = a.view(-1)
    flat[::7] = torch.exp2(torch.randint(-20, 21, flat[::7].shape,
                                         generator=gen).to(torch.float64))
    flat[::11] = 0.0
    return a


def bit_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[bool, float]:
    """(bit-identical, max |a - b| over finite entries)."""
    same = a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(torch.int64), b.contiguous().view(torch.int64)))
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float(torch.abs(a[fin] - b[fin]).max()) if bool(fin.any()) else 0.0
    return same, err


def check_ozaki_split(dev, gen):
    """K4 on control07's Gram operand B (667 x 16384, per-row scale, and
    its transpose, which the dd Gram splits per column), on arch0's
    congruence input (175*161 x 161) and on an R_k (161 x 161, per
    column): bit for bit against the plain version."""
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels

    B = wide_matrix((667, 16384), gen).to(dev)
    Ak = wide_matrix((175 * 161, 161), gen).to(dev)
    Rk = wide_matrix((161, 161), gen).to(dev)
    cases = [("B", B, 16384, -1), ("B'", B.T, 16384, 0),
             ("A_k", Ak, 161, -1), ("R_k", Rk, 161, 0)]
    worst = 0.0
    for label, X, k, axis in cases:
        n0 = kernels.LAUNCHES["ozaki_split"]
        got = dd.ozaki_split(X, k, axis)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["ozaki_split"] != n0 + 1:
            fail("ozaki_split did not launch its kernel")
        want = dd.ozaki_split_plain(X, k, axis)
        for g, w in zip(got, want):
            same, err = bit_diff(g, w)
            worst = max(worst, err)
            if not same:
                fail(f"ozaki_split kernel differs from its plain version "
                     f"on {label} (max err {err:.3e})")
    print(f"K4 ozaki_split: B 667x16384 (both axes), A_k 28175x161, "
          f"R_k 161x161: bit for bit", flush=True)
    ms = cuda_ms(lambda: dd.ozaki_split(B, 16384, -1), 50)
    plain = cuda_ms(lambda: dd.ozaki_split_plain(B, 16384, -1), 10)
    n = B.numel()
    # read A once, write three slices; |.|, max, 2 x (add, sub, sub) x 2
    b_ms, b_by = bound_ms(32.0 * n, 10.0 * n)
    return dict(name="ozaki_split", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_split.cu",
                replaces="sedumi_tpu/ddlinalg.py:86",
                max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_dd_elem(dev, gen):
    """K5's three entry points bit for bit against the plain versions:
    the accumulation (with and without the normalise) on control07's B
    shape and on arch0's congruence product (28175 x 161), dd_add and
    dd_sub at control07's Schur order (667 x 667, with and without a low
    part), two_prod by a broadcast row on B's shape."""
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels

    worst = 0.0

    def same(label, got, want):
        nonlocal worst
        for g, w in zip(got, want):
            ok, err = bit_diff(g, w)
            worst = max(worst, err)
            if not ok:
                fail(f"dd_accumulate kernel differs from its plain version "
                     f"({label}, max err {err:.3e})")

    n0 = kernels.LAUNCHES["dd_accumulate"]
    for shape in ((667, 16384), (175 * 161, 161)):
        Sh, P = wide_matrix(shape, gen).to(dev), wide_matrix(shape, gen)
        P = P.to(dev)
        Sl = Sh * 2.0**-60
        for normalize in (False, True):
            kh, kl = dd.dd_accumulate(Sh.clone(), Sl.clone(), P, normalize)
            ph, pl = dd.dd_accumulate_plain(Sh.clone(), Sl.clone(), P,
                                            normalize)
            same(f"accumulate {shape} normalize={normalize}", (kh, kl),
                 (ph, pl))
    ah, bh = (wide_matrix((667, 667), gen).to(dev) for _ in range(2))
    al, bl = ah * 2.0**-58, bh * 2.0**-57
    for lo in (bl, None):
        same("dd_add", dd.dd_add(ah, al, bh, lo),
             dd.dd_add_plain(ah, al, bh, lo))
        same("dd_sub", dd.dd_sub(ah, al, bh, lo),
             dd.dd_sub_plain(ah, al, bh, lo))
    A = wide_matrix((667, 16384), gen).to(dev)
    v = wide_matrix((16384,), gen).to(dev)
    same("two_prod_cols", dd.two_prod_cols(A, v),
         dd.two_prod_cols_plain(A, v))
    torch.cuda.synchronize()
    if kernels.LAUNCHES["dd_accumulate"] != n0 + 9:
        fail("dd_accumulate's entry points did not launch their kernels")
    print(f"K5 dd_accumulate: accumulate on 667x16384 and 28175x161, "
          f"dd_add/dd_sub on 667x667, two_prod_cols on 667x16384: bit "
          f"for bit", flush=True)
    # timed at control07's congruence product, 85376 x 128
    Sh = wide_matrix((667 * 128, 128), gen).to(dev)
    Sl, P = Sh * 2.0**-60, wide_matrix((667 * 128, 128), gen).to(dev)
    ms = cuda_ms(lambda: dd.dd_accumulate(Sh, Sl, P), 200)
    plain = cuda_ms(lambda: dd.dd_accumulate_plain(Sh, Sl, P), 20)
    n = Sh.numel()
    # read Sh, Sl, P, write Sh, Sl; TwoSum (6) + 1 add
    b_ms, b_by = bound_ms(40.0 * n, 7.0 * n)
    return dict(name="dd_accumulate", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_elem.cu",
                replaces="sedumi_tpu/ddlinalg.py:113",
                max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_dd_gemv(dev, gen):
    """K6 at m = n = 666 (the refinement's M x) and on the dd_chol_solve
    panel views (L[p0:p1, :p0] and L[p1:, p0:p1]'), against the plain
    version (the reference's Ozaki route).  The two sum in different
    orders; each is within (n + 4)^2 u^2 sum_j |A_ij| |x_j| of the exact
    product on these Gaussian inputs (K6: the compensation sum of the
    TwoSum chain is the n^2 term; the Ozaki route: its remainder slices lie
    within 4 n u of the row scale), so the tolerance is
    2 (n + 4)^2 u^2 sum_j |A_ij| |x_j|, u = 2^-53."""
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels

    m = 666
    u = 2.0**-53
    Ah = torch.randn(m, m, generator=gen, dtype=torch.float64).to(dev)
    Al = Ah * 2.0**-54 * torch.rand(m, m, generator=gen,
                                    dtype=torch.float64).to(dev)
    xh = torch.randn(m, generator=gen, dtype=torch.float64).to(dev)
    xl = xh * 2.0**-54 * torch.rand(m, generator=gen,
                                    dtype=torch.float64).to(dev)
    cases = [("M x", Ah, Al, xh, xl),
             ("L[48:96, :48] x", Ah[48:96, :48], Al[48:96, :48], xh[:48],
              xl[:48]),
             ("L[96:, 48:96]' x", Ah[96:, 48:96].T, Al[96:, 48:96].T,
              xh[96:], xl[96:])]
    worst_err, worst_ratio = 0.0, 0.0
    for label, A, Alo, x, xlo in cases:
        n0 = kernels.LAUNCHES["dd_gemv"]
        kh, kl = dd.dd_gemv(A, Alo, x, xlo)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["dd_gemv"] != n0 + 1:
            fail("dd_gemv did not launch its kernel")
        ph, pl = dd.dd_gemv_plain(A, Alo, x, xlo)
        n = A.shape[1]
        err = torch.abs((kh - ph) + (kl - pl))
        tol = 2.0 * (n + 4) ** 2 * u * u * (torch.abs(A) @ torch.abs(x))
        worst_err = max(worst_err, float(err.max()))
        worst_ratio = max(worst_ratio, float((err / tol).max()))
        if not bool(torch.all(err <= tol)):
            fail(f"dd_gemv kernel outside its bound on {label}")
    print(f"K6 dd_gemv m=666 and both panel orientations: max err="
          f"{worst_err:.3e}, worst err/tol={worst_ratio:.3e}", flush=True)
    ms = cuda_ms(lambda: dd.dd_gemv(Ah, Al, xh, xl), 200)
    plain = cuda_ms(lambda: dd.dd_gemv_plain(Ah, Al, xh, xl), 20)
    # read Ah, Al, xh, xl, write yh, yl; ~14 flops per element
    b_ms, b_by = bound_ms(16.0 * m * m + 48.0 * m, 14.0 * m * m)
    return dict(name="dd_gemv", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_gemv.cu",
                replaces="sedumi_tpu/ddlinalg.py:130",
                max_abs_err=worst_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def spd_with_cond(m: int, cond: float, gen) -> torch.Tensor:
    q, _ = torch.linalg.qr(torch.randn(m, m, generator=gen,
                                       dtype=torch.float64))
    ev = torch.logspace(0, -float(np.log10(cond)), m, dtype=torch.float64)
    M = (q * ev) @ q.T
    return 0.5 * (M + M.T)


def check_dd_panel_chol(dev, gen):
    """K7 inside dd_chol on a 666 x 666 matrix of cond 1e14 (14 panels)
    and on one with a forced non-positive pivot, against dd_chol with the
    plain panel: L, the panel inverses and ok bit for bit."""
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels

    m = 666
    A1 = spd_with_cond(m, 1e14, gen).to(dev)
    B = torch.randn(m, m, generator=gen, dtype=torch.float64)
    A2 = (B @ B.T / m + torch.eye(m, dtype=torch.float64)).to(dev)
    A2[300, 300] = -5.0                    # pivot 300 goes negative
    worst = 0.0
    for label, A, want_ok in (("cond 1e14", A1, True),
                              ("non-positive pivot", A2, False)):
        n0 = kernels.LAUNCHES["dd_panel_chol"]
        fk = dd.dd_chol(A)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["dd_panel_chol"] != n0 + 14:
            fail("dd_chol did not launch the panel kernel per panel")
        kernel_panel = dd.dd_panel_chol
        dd.dd_panel_chol = dd.dd_panel_chol_plain
        try:
            fp_ = dd.dd_chol(A)
        finally:
            dd.dd_panel_chol = kernel_panel
        pairs = [(fk.Lh, fp_.Lh), (fk.Ll, fp_.Ll)] + [
            (a, b) for pk, pp in zip(fk.inv_diag, fp_.inv_diag)
            for a, b in zip(pk, pp)]
        for a, b in pairs:
            same, err = bit_diff(a, b)
            worst = max(worst, err)
            if not same:
                fail(f"dd_panel_chol kernel differs from its plain version "
                     f"({label}, max err {err:.3e})")
        if bool(fk.ok) != want_ok or bool(fp_.ok) != want_ok:
            fail(f"dd_chol ok flag wrong on the {label} matrix")
    print("K7 dd_panel_chol: dd_chol of 666x666 at cond 1e14 and with a "
          "forced non-positive pivot: bit for bit, ok flags right",
          flush=True)
    Sh = A1[:, :48].contiguous()
    Sl = torch.zeros_like(Sh)
    ms = cuda_ms(lambda: dd.dd_panel_chol(Sh, Sl), 50)
    plain = cuda_ms(lambda: dd.dd_panel_chol_plain(Sh, Sl), 3, warmup=1)
    w = 48
    # dd updates: rows r > j of column j, columns j < c < w; the inverse's
    # (w - j - 1) w; ~25 flops each (TwoProd, 3 adds, dd_sub)
    upd = sum((m - j - 1) * (w - j - 1) + (w - j - 1) * w for j in range(w))
    b_ms, b_by = bound_ms(16.0 * (2 * m * w + w * w), 25.0 * upd)
    return dict(name="dd_panel_chol", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_chol.cu",
                replaces="sedumi_tpu/ddlinalg.py:166",
                max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b_ms,
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
          f"numerr={info['numerr']} wall={wall:.2f}s "
          f"phases={json.dumps(info['phases'])} launches={counts}",
          flush=True)
    finite = bool(np.all(np.isfinite(x)) and np.all(np.isfinite(y)))
    if not finite:
        fail(f"{ex.name}: non-finite solution")
    if gate and not (rel <= 1e-6 and info["pinf"] == 0
                     and info["dinf"] == 0 and info["numerr"] < 2):
        fail(f"{ex.name}: reference gate not met")
    return counts, info


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
            check_ldl_masked(dev, gen), check_ozaki_split(dev, gen),
            check_dd_elem(dev, gen), check_dd_gemv(dev, gen),
            check_dd_panel_chol(dev, gen)]
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    plan = [("quantum", True), ("nb", True), ("arch0", True),
            ("control07", False), ("trto3", False),
            ("OH_2Pi_STO-6GN9r12g1T2", False)]
    dd_kernels = ("ozaki_split", "dd_accumulate", "dd_gemv", "dd_panel_chol")
    for name, gate in plan:
        counts, info = run_example(load_example(name), gate)
        if counts["dd_matvec_residual"] == 0:
            fail(f"{name}: the compensated-residual kernel never ran")
        if name == "arch0":
            if counts["psd_contrib_coo"] == 0:
                fail("arch0: the sparse PSD Schur kernel never ran")
            if "dd64" not in info["phases"]:
                fail("arch0 never entered the dd64 phase")
            if any(counts[k] == 0 for k in dd_kernels):
                fail("arch0: a dd64 kernel never ran in its solve")
    counts, _ = run_example(with_zero_row(load_example("nb")), True)
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
