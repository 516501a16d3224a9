"""Smoke test of sedumi_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Kernel phase: builds every CUDA kernel of the port from csrc/ (one nvcc
   per source, in parallel) and holds K1-K7, the f32 builds of K1-K3 and
   K11 (the double-float GEMV and GEMV-transpose) against their
   plain-PyTorch twins on the card at the shapes the solver gives them,
   with the tolerance stated (K1, K2, K6, K11 and the f32 K1, K2 within
   error bounds; K3, K4, K5, K7 and the f32 K3 bit for bit); times both,
   and the card's least time (bound) for the work.  K8-K10 follow the
   sparse path (4.), on its plans.
2. Dense path: sedumi_tpu_torch.sedumi() on all six bundled examples at
   full size (quantum, nb, arch0, control07, trto3, OH), plus nb with one
   redundant all-zero constraint (its Schur complement is singular, so
   every iteration takes the masked-LDL' fallback).  arch0 must enter the
   dd64 phase and launch K4-K7 in its solve.  quantum, nb, arch0 and the
   redundant-row nb must pass the reference gate (rel <= 1e-6 vs the
   published optimum, pinf = dinf = 0, numerr < 2); the others must finish
   with finite outputs, and each prints its rel, pinf, dinf, numerr and
   phases.
3. Mixed-ladder path: pars.dtype='mixed' (f32 -> hybrid -> host64 ->
   dd64) on nb, arch0, control07, nb+zero-row and a dense SOCP from the
   reference's feasible_problem generator (copied below), whose hybrid
   phase takes the double-float operator: K1-f32 must launch in every
   solve, K2-f32 on arch0, K3-f32 on nb+zero-row and K11 on the SOCP.  The
   solves the reference package itself passes with 'mixed' on a CPU (nb,
   arch0, nb+zero-row: the reference gate; the SOCP: its own test's gate
   against the f64 solve) are gated; control07 (rel 1.288e-6, numerr 1 in
   the reference) must finish finite.
4. Sparse path: five problems through the sparse tile engine
   (SPARSE_SOLVES: an LP with m = 20000, SDPs with m = 5000 and m = 1200,
   an SOCP with m = 850, an LP with three dense columns).  Each must take
   the sparse engine, finish with finite outputs and launch K8-K10; the
   SDPs must launch K2 and the dense-column LP K3.  All but the SDP with
   m = 5000 are gated as the reference's tests gate them (pinf = dinf = 0,
   max(err) < 1e-7).  Each
   prints its host plan time, iterations, phases, wall time and launches.
   Then K8-K10 and K2's group layout are held against their plain twins
   on the plans these solves built (LP 20k and SDP 5k).
   Launch counts are zeroed just before each path and read just after;
   every kernel must have launched on the paths.
5. Prints {"kernels": [...]}, the card's name and power limit, and as the
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

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the f64
# tensor-core rate (the highest f64 rate the card has) and the f32 rate
# outside the tensor cores, which the f32 kernels use
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 67e12
PEAK_F32_PER_S = 67e12


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_F64_PER_S):
    t_b = nbytes / PEAK_BYTES_PER_S
    t_f = flops / peak
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
# the precision ladder's kernels: f32 builds of K1-K3, and K11
# --------------------------------------------------------------------------

U32 = 2.0**-24     # f32 unit roundoff
UDF = 2.0**-48     # double-float resolution


def check_dd_residual_f32(dev, gen):
    """K1-f32 at control07's Schur order m = 666, cond ~ 1e6 (what f32
    carries), v = M^-1 rhs.  Both versions are compensated: each is within
    u |r| + c u^2 sum_j |M_ij v_j| of the exact residual (u = 2^-24), c =
    2L + 10 for the kernel (L = ceil(n/32) TwoSums per lane, 5 tree
    levels) and n + 2D + 4 for the plain pairwise tree (depth D, its e
    terms summed in any order), so the tolerance is
    2u|r| + (n + 2L + 2D + 14) u^2 sum_j |M_ij v_j|."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.pcg import dd_matvec_residual, \
        dd_matvec_residual_plain

    m = 666
    M = spd_with_cond(m, 1e6, gen).to(torch.float32).to(dev)
    rhs = torch.randn(m, generator=gen, dtype=torch.float64).to(
        torch.float32).to(dev)
    v = torch.linalg.solve(M.double(), rhs.double()).float()
    n0 = kernels.LAUNCHES["dd_matvec_residual_f32"]
    r_k = dd_matvec_residual(M, v, rhs)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["dd_matvec_residual_f32"] != n0 + 1:
        fail("dd_matvec_residual did not launch its f32 kernel")
    r_p = dd_matvec_residual_plain(M, v, rhs)
    L, D = -(-m // 32), int(np.ceil(np.log2(m)))
    c = m + 2 * L + 2 * D + 14
    S = torch.abs(M.double()) @ torch.abs(v.double())
    err = torch.abs(r_k.double() - r_p.double())
    tol = 2 * U32 * torch.abs(r_p.double()) + c * U32 * U32 * S
    print(f"K1-f32 dd_matvec_residual m={m}: max|r|="
          f"{float(r_p.abs().max()):.3e} max err={float(err.max()):.3e} "
          f"worst err/tol={float((err / tol).max()):.3e} (c={c})",
          flush=True)
    if not bool(torch.all(err <= tol)):
        fail("dd_matvec_residual f32 kernel disagrees with its plain version")
    ms = cuda_ms(lambda: dd_matvec_residual(M, v, rhs), 200)
    plain = cuda_ms(lambda: dd_matvec_residual_plain(M, v, rhs), 20)
    lib = cuda_ms(lambda: torch.addmv(rhs, M, v, alpha=-1.0), 200)
    b_ms, b_by = bound_ms(4.0 * (m * m + 3 * m), 11.0 * m * m,
                          PEAK_F32_PER_S)
    return dict(name="dd_matvec_residual_f32", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_residual.cu",
                replaces="sedumi_tpu/pcg.py:56",
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def check_psd_coo_f32(dev, gen):
    """K2-f32 on arch0's COO bucket, built at f32 as the ladder's f32 and
    hybrid phases build it.  Both versions form the same sums of products
    in f32 in different orders: each is within gamma_N sum|terms| of the
    exact value, N = pad2 + Tmax + 3 (Tmax the longest row of the gather),
    so the tolerance is 2 N u M_abs, with M_abs the same function of |W|,
    |gv| and |b_val| in f64."""
    from sedumi_tpu_torch import kernels, transform
    from sedumi_tpu_torch.examples import load_example
    from sedumi_tpu_torch.opA import build_coo_aop
    from sedumi_tpu_torch.params import Pars
    from sedumi_tpu_torch.schur import _psd_contrib_coo_kernel, \
        _psd_contrib_coo_plain, psd_gram

    ex = load_example("arch0")
    prob = transform.pretransfo(ex.At, ex.b, ex.c, ex.K, Pars(fid=0))
    aop = build_coo_aop(prob.At, prob.c, prob.layout, device=dev,
                        dtype=torch.float32)
    bi = [i for i, meta in enumerate(aop.s_meta) if meta[0] == "coo"][0]
    part, (rep, k, d, G, pad2, T) = aop.s_parts[bi], aop.s_meta[bi]
    mp1 = aop.m + 1
    r = (torch.randn(k, d, d, generator=gen, dtype=torch.float64) / d ** 0.5
         + torch.eye(d, dtype=torch.float64)).to(torch.float32).to(dev)
    W = psd_gram(r)
    n0 = kernels.LAUNCHES["psd_contrib_coo_f32"]
    M_k = _psd_contrib_coo_kernel(part, k, d, G, pad2, mp1, W)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["psd_contrib_coo_f32"] != n0 + 1:
        fail("_psd_contrib_coo did not launch its f32 kernels")
    M_p = _psd_contrib_coo_plain(part, k, d, G, pad2, mp1, W)
    absp = {key: (v.abs().double() if v.is_floating_point() else v)
            for key, v in part.items()}
    M_abs = _psd_contrib_coo_plain(absp, k, d, G, pad2, mp1,
                                   W.abs().double())
    tmax = int(torch.diff(part["b_rowptr"]).max())
    c = 2 * (pad2 + tmax + 3)
    err = torch.abs(M_k.double() - M_p.double())
    ratio = float((err / (c * U32 * M_abs).clamp_min(1e-300)).max())
    print(f"K2-f32 psd_contrib_coo arch0 (G={G} pad2={pad2} Tmax={tmax}): "
          f"max|M|={float(M_p.abs().max()):.3e} max err="
          f"{float(err.max()):.3e} worst err/tol={ratio:.3e} (c={c})",
          flush=True)
    if not bool(torch.all(err <= c * U32 * M_abs)):
        fail("psd_contrib_coo f32 kernel disagrees with its plain version")
    ms = cuda_ms(lambda: _psd_contrib_coo_kernel(part, k, d, G, pad2, mp1,
                                                 W), 50)
    plain = cuda_ms(lambda: _psd_contrib_coo_plain(part, k, d, G, pad2, mp1,
                                                   W), 5)
    flops = 2.0 * G * pad2 * d * d + 2.0 * T * mp1
    nbytes = 4.0 * (k * d * d + G * pad2 + T + mp1 * mp1) \
        + 8.0 * (3 * G * pad2 + 2 * G + 2 * T + mp1 + 1)
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_F32_PER_S)
    return dict(name="psd_contrib_coo_f32", route="cuda",
                source="sedumi_tpu_torch/csrc/psd_coo.cu",
                replaces="sedumi_tpu/schur.py:60",
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_ldl_masked_f32(dev, gen):
    """K3-f32 on the indefinite 174 x 174 matrix of the f64 check, in f32:
    masks, pivots and L bit for bit against the plain version."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.chol import ldl_masked, ldl_masked_plain

    m = 174
    M = indefinite_matrix(m, gen).to(torch.float32).to(dev)
    n0 = kernels.LAUNCHES["ldl_masked_f32"]
    fk = ldl_masked(M)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["ldl_masked_f32"] != n0 + 1:
        fail("ldl_masked did not launch its f32 kernel")
    fp_ = ldl_masked_plain(M)
    n_skip, n_add = int(fp_.skip.sum()), int((fp_.diagadd > 0).sum())
    same = all(bit_diff(a, b)[0] for a, b in
               ((fk.L, fp_.L), (fk.d, fp_.d), (fk.diagadd, fp_.diagadd)))
    same = same and bool(torch.equal(fk.skip, fp_.skip))
    fin = torch.isfinite(fp_.d)
    err = max(bit_diff(fk.L, fp_.L)[1], bit_diff(fk.d, fp_.d)[1])
    print(f"K3-f32 ldl_masked m={m}: skipped {n_skip}, added {n_add}, bit "
          f"for bit {same}", flush=True)
    if not (n_skip > 0 and n_add > n_skip):
        fail("the K3-f32 test matrix did not trigger both add and skip")
    if not (same and torch.equal(torch.isfinite(fk.d), fin)):
        fail("ldl_masked f32 kernel disagrees with its plain version")
    ms = cuda_ms(lambda: ldl_masked(M), 10)
    plain = cuda_ms(lambda: ldl_masked_plain(M), 2, warmup=1)
    keep = (~fp_.skip).cpu().numpy()
    flops = sum(3.0 * (m - j - 1) * (m - j) / 2 + (m - j - 1)
                for j in range(m) if keep[j])
    b_ms, b_by = bound_ms(4.0 * (2 * m * m + 3 * m) + m, flops,
                          PEAK_F32_PER_S)
    return dict(name="ldl_masked_f32", route="cuda",
                source="sedumi_tpu_torch/csrc/ldl_masked.cu",
                replaces="sedumi_tpu/chol.py:95",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_df_gemv(dev, gen):
    """K11's two entry points against the plain versions (the reference's
    chunked pairwise tree) on nb's double-float operator (its one Lorentz
    bucket, [124, 2383]) and at a full width of [1001, 65536] (four of the
    reference's 16384-chunks).  In df arithmetic (u^2 = 2^-48) each version
    is within c u^2 S of the exact product, S = sum_j |a_j x_j|: the
    kernel with c = 3L + 30 (L terms per sequential sum: ceil(n/32) lanes'
    worth for df_matvec, the rows for df_vecmat), the reference's tree with
    c = (D + k)(D + k + 2) + 7 (depth D over k chunks).  Tolerance: the sum
    of the two."""
    from sedumi_tpu_torch import df, kernels, transform
    from sedumi_tpu_torch.examples import load_example
    from sedumi_tpu_torch.params import Pars

    ex = load_example("nb")
    prob = transform.pretransfo(ex.At, ex.b, ex.c, ex.K, Pars(fid=0))
    adf = df.build_df_aop(prob.At, prob.c, prob.layout, device=dev)
    nb_pair = max([adf.Al] + list(adf.Aq) + list(adf.As),
                  key=lambda p: p[0].numel())
    wide64 = torch.randn(1001, 65536, generator=gen,
                         dtype=torch.float64).to(dev)
    cases = [("nb", nb_pair), ("1001x65536", df.df_split64(wide64))]
    worst = {"df_matvec": (0.0, 0.0), "df_vecmat": (0.0, 0.0)}
    for label, (Ah, Al) in cases:
        rows, n = Ah.shape
        A64 = Ah.double() + Al.double()
        for fn in ("df_matvec", "df_vecmat"):
            length = rows if fn == "df_vecmat" else n
            x64 = torch.randn(length, generator=gen,
                              dtype=torch.float64).to(dev)
            xh, xl = df.df_split64(x64)
            x_df = xh.double() + xl.double()
            n0 = kernels.LAUNCHES[fn]
            if fn == "df_matvec":
                got = df.df_matvec(Ah, Al, xh, xl)
                want = df.df_matvec_plain(Ah, Al, xh, xl)
                S = torch.abs(A64) @ torch.abs(x_df)
                L, D, k = -(-n // 32) + 5, 14, -(-n // 16384)
            else:
                got = df.df_vecmat(xh, xl, Ah, Al)
                want = df.df_vecmat_plain(xh, xl, Ah, Al)
                S = torch.abs(x_df) @ torch.abs(A64)
                L, D, k = rows, int(np.ceil(np.log2(rows))), 1
            torch.cuda.synchronize()
            if kernels.LAUNCHES[fn] != n0 + 1:
                fail(f"{fn} did not launch its kernel")
            c = (3 * L + 30) + ((D + k) * (D + k + 2) + 7)
            err = torch.abs(df.df_to64(*got) - df.df_to64(*want))
            ratio = float((err / (c * UDF * S).clamp_min(1e-300)).max())
            worst[fn] = (max(worst[fn][0], float(err.max())),
                         max(worst[fn][1], ratio))
            print(f"K11 {fn} {label} [{rows}, {n}]: max err="
                  f"{float(err.max()):.3e} worst err/tol={ratio:.3e} "
                  f"(c={c})", flush=True)
            if not bool(torch.all(err <= c * UDF * S)):
                fail(f"{fn} kernel outside its bound on {label}")
    Ah, Al = cases[1][1]
    A64 = Ah.double() + Al.double()
    rows, n = Ah.shape
    out = []
    for fn in ("df_matvec", "df_vecmat"):
        length = rows if fn == "df_vecmat" else n
        xh, xl = df.df_split64(torch.randn(length, generator=gen,
                                           dtype=torch.float64).to(dev))
        x64 = xh.double() + xl.double()
        if fn == "df_matvec":
            ms = cuda_ms(lambda: df.df_matvec(Ah, Al, xh, xl), 50)
            plain = cuda_ms(lambda: df.df_matvec_plain(Ah, Al, xh, xl), 3,
                            warmup=1)
            lib = cuda_ms(lambda: torch.mv(A64, x64), 50)
        else:
            ms = cuda_ms(lambda: df.df_vecmat(xh, xl, Ah, Al), 50)
            plain = cuda_ms(lambda: df.df_vecmat_plain(xh, xl, Ah, Al), 3,
                            warmup=1)
            lib = cuda_ms(lambda: torch.mv(A64.T, x64), 50)
        # read the hi/lo pairs and x once, write the df result; ~25 f32
        # operations per element
        b_ms, b_by = bound_ms(8.0 * (rows * n + length)
                              + 8.0 * (rows + n - length),
                              25.0 * rows * n, PEAK_F32_PER_S)
        out.append(dict(name=fn, route="cuda",
                        source="sedumi_tpu_torch/csrc/df_gemv.cu",
                        replaces="sedumi_tpu/df.py:"
                        + ("94" if fn == "df_matvec" else "127"),
                        max_abs_err=worst[fn][0], ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    print(f"K11 timed at 1001x65536 (hi/lo {8 * rows * n / 1e6:.0f} MB); "
          f"library: torch.mv on the f64 operator (f64 rounding, not df)",
          flush=True)
    return out


# --------------------------------------------------------------------------
# sparse-engine kernels (K8-K10, and K2's group layout), on the plans the
# sparse path built
# --------------------------------------------------------------------------


def interior_scaling(meta, dev, rng):
    """NT scaling at a random interior point of a plan's cone layout."""
    from sedumi_tpu_torch import nt
    from sedumi_tpu_torch.structs import ConeVec

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    def point():
        q = [np.concatenate([rng.random((c, 1)) + 2.0,
                             0.3 * rng.standard_normal((c, d - 1))], axis=1)
             for c, d in meta["q_shapes"]]
        s = []
        for k, d in meta["s_shapes"]:
            a = rng.standard_normal((k, d, d))
            s.append(a @ a.transpose(0, 2, 1) / d + 2.0 * np.eye(d))
        return ConeVec(l=t(rng.random(meta["nl"]) + 0.5),
                       q=tuple(map(t, q)), s=tuple(map(t, s)))

    return nt.compute_scaling(point(), point())


def tile_case(plan, dev, rng):
    """(operator, tile storage of A H A') of a sparse plan at a random
    interior point: the factor's input as TileSchurEngine.prepare
    assembles it."""
    from sedumi_tpu_torch import sparse_chol as sc
    from sedumi_tpu_torch import sparse_engine as se

    arrays, meta = plan
    aop = se.make_sparse_lq_op(arrays, meta, device=dev)
    S = interior_scaling(meta, dev, rng)
    vals, _, _ = se.ada_values(aop, S)
    st = sc.assemble_tiles(meta["nslot"], meta["B"], aop.arrays["asm"], vals,
                           aop.arrays["pad_idx"])
    return aop, st


def escalation_tiles(B: int, gen) -> torch.Tensor:
    """Three diagonal tiles (lower triangles): SPD; indefinite by less than
    dmax + 1 (fails the lifted factor only); indefinite beyond it (fails
    both rungs)."""
    G = torch.randn(B, B, generator=gen, dtype=torch.float64)
    D = G @ G.T / B + torch.eye(B, dtype=torch.float64)
    first, both = D.clone(), D.clone()
    first[3, 3] = -0.5
    both[5, 4] = both[4, 5] = 50.0
    return torch.stack([torch.tril(a) for a in (D, first, both)])


def check_tile_kernels(plans, dev, gen, rng, reg=0.0, canceltol=1e-12):
    """K8 and K9 level by level on the LP 20k and SDP plans, at ADA = A H A'
    of a random interior point: each level's K8 against the plain version
    from the same storage (rungs equal, factor within 1e-9 of the level's
    max|L|), then K9 from the same post-K8 storage (within
    2 (B + P + 1) eps (|D| + sum_pairs |A| |B|'), P = the destination's
    pair count); K10 on the kernels' factor against the plain solve
    (within 1e-9 of max|x|).  K8 also on three 128 x 128 tiles built for
    rungs 0, 1 and 2 (the rung-2 diagonal bit for bit).  Times K8 and K9 at
    the LP's widest level and K10's whole solve there."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch import sparse_chol as sc

    B = 128
    st = escalation_tiles(B, gen).to(dev)
    ref = st.clone()
    lv3 = {"dslot": torch.arange(3, device=dev),
           "off_slot": torch.zeros(0, dtype=torch.int64, device=dev),
           "off_dslot": torch.zeros(0, dtype=torch.int64, device=dev)}
    rk = sc.tile_factor(st, lv3, reg, canceltol)
    rp = sc.tile_factor_plain(ref, lv3, reg, canceltol)
    err_esc = float(torch.abs(st[:2] - ref[:2]).max())
    print(f"K8 escalation tiles: rungs kernel {rk.tolist()} plain "
          f"{rp.tolist()}, max err rungs 0-1 {err_esc:.3e}, rung-2 tile "
          f"bit for bit {bit_diff(st[2], ref[2])[0]}", flush=True)
    if rk.tolist() != [0, 1, 2] or rp.tolist() != [0, 1, 2]:
        fail("tile_factor: the escalation tiles took the wrong rungs")
    if not (err_esc <= 1e-12 * float(torch.abs(ref[:2]).max())
            and bit_diff(st[2], ref[2])[0]):
        fail("tile_factor kernel disagrees with its plain version on the "
             "escalation tiles")

    eps = float(np.finfo(np.float64).eps)
    worst = {"tile_factor": err_esc, "tile_update": 0.0, "tile_solve": 0.0}
    timing = {}
    for label, plan in plans.items():
        aop, st = tile_case(plan, dev, rng)
        levels = aop.levels
        wide = max(range(len(levels)),
                   key=lambda i: (levels[i]["cols"].numel(),
                                  levels[i]["pair_a"].numel()))
        n_rung = [0, 0, 0]
        ratio9 = 0.0
        for i, lv in enumerate(levels):
            if label == "lp20k" and i == wide:
                timing["before"] = st.clone()
            ref = st.clone()
            n0 = kernels.LAUNCHES["tile_factor"]
            rk = sc.tile_factor(st, lv, reg, canceltol)
            torch.cuda.synchronize()
            if kernels.LAUNCHES["tile_factor"] == n0:
                fail("tile_factor did not launch its kernel")
            rp = sc.tile_factor_plain(ref, lv, reg, canceltol)
            if not torch.equal(rk, rp):
                fail(f"tile_factor: rungs differ on {label} level {i}")
            for r in rk.tolist():
                n_rung[r] += 1
            slots = torch.cat([lv["dslot"], lv["off_slot"]])
            err = float(torch.abs(st[slots] - ref[slots]).max())
            worst["tile_factor"] = max(worst["tile_factor"], err)
            if not err <= 1e-9 * float(torch.abs(ref[slots]).max()):
                fail(f"tile_factor kernel disagrees with its plain version "
                     f"on {label} level {i} (max err {err:.3e})")
            if not lv["pair_a"].numel():
                continue
            dst, ptr = lv["pair_dst"], lv["pair_ptr"]
            didx = torch.repeat_interleave(
                torch.arange(dst.numel(), device=dev), torch.diff(ptr))
            bound = torch.abs(st[dst]).index_add_(
                0, didx, torch.abs(st[lv["pair_a"]])
                @ torch.abs(st[lv["pair_b"]]).mT)
            c = 2.0 * (B + float(torch.diff(ptr).max()) + 1.0)
            ref = st.clone()
            n0 = kernels.LAUNCHES["tile_update"]
            sc.tile_update(st, lv)
            torch.cuda.synchronize()
            if kernels.LAUNCHES["tile_update"] != n0 + 1:
                fail("tile_update did not launch its kernel")
            sc.tile_update_plain(ref, lv)
            diff = torch.abs(st[dst] - ref[dst])
            worst["tile_update"] = max(worst["tile_update"],
                                       float(diff.max()))
            ratio9 = max(ratio9, float((diff / (c * eps * bound)).max()))
            if not bool(torch.all(diff <= c * eps * bound)):
                fail(f"tile_update kernel outside its bound on {label} "
                     f"level {i}")
        rhs = torch.randn(aop.meta["ntiles_n"], generator=gen,
                          dtype=torch.float64).to(dev)
        n0 = kernels.LAUNCHES["tile_solve"]
        xk = sc.tile_solve(st, rhs, levels)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["tile_solve"] == n0:
            fail("tile_solve did not launch its kernels")
        xp = sc.tile_solve_plain(st, rhs, levels)
        err = float(torch.abs(xk - xp).max())
        worst["tile_solve"] = max(worst["tile_solve"], err)
        print(f"K8-K10 {label}: ntc={aop.meta['ntc']} "
              f"levels={len(levels)} widest={levels[wide]['cols'].numel()} "
              f"cols, rungs {n_rung}, worst K9 err/bound={ratio9:.3e}, K10 "
              f"max err {err:.3e} (max|x| {float(xp.abs().max()):.3e})",
              flush=True)
        if not err <= 1e-9 * float(torch.abs(xp).max()):
            fail(f"tile_solve kernel disagrees with its plain version on "
                 f"{label}")
        if label == "lp20k":
            timing.update(levels=levels, wide=wide, L=st, rhs=rhs)

    # --- times at the LP 20k plan: K8 and K9 at its widest level, K10's
    # whole solve
    levels, lv, before = timing["levels"], timing["levels"][timing["wide"]], \
        timing["before"]
    L, rhs = timing["L"], timing["rhs"]
    work = before.clone()

    def restore():
        work.copy_(before)

    def k8():
        restore()
        sc.tile_factor(work, lv, reg, canceltol)

    def p8():
        restore()
        sc.tile_factor_plain(work, lv, reg, canceltol)

    t_copy = cuda_ms(restore, 20)
    D = before[lv["dslot"]]
    D = torch.tril(D) + torch.tril(D, -1).mT
    dmax = torch.abs(torch.diagonal(D, dim1=-2, dim2=-1)).amax(-1)
    Dl = D + (canceltol * dmax + 1e-300)[:, None, None] \
        * torch.eye(B, dtype=D.dtype, device=dev)
    nc, no = lv["dslot"].numel(), lv["off_slot"].numel()
    b8 = bound_ms(16.0 * B * B * (nc + no), nc * B**3 / 3.0 + no * B**3)
    row8 = dict(name="tile_factor", route="cuda",
                source="sedumi_tpu_torch/csrc/tile_chol.cu",
                replaces="sedumi_tpu/sparse_chol.py:469",
                max_abs_err=worst["tile_factor"],
                ms=cuda_ms(k8, 20) - t_copy, plain_ms=cuda_ms(p8, 5) - t_copy,
                bound_ms=b8[0], bound_by=b8[1],
                library_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(Dl), 20))
    np_ = lv["pair_a"].numel()
    nsrc = torch.unique(torch.cat([lv["pair_a"], lv["pair_b"]])).numel()
    b9 = bound_ms(8.0 * B * B * (nsrc + 2 * lv["pair_dst"].numel()),
                  2.0 * B**3 * np_)
    work9 = before.clone()
    row9 = dict(name="tile_update", route="cuda",
                source="sedumi_tpu_torch/csrc/tile_update.cu",
                replaces="sedumi_tpu/sparse_chol.py:514",
                max_abs_err=worst["tile_update"],
                ms=cuda_ms(lambda: sc.tile_update(work9, lv), 20),
                plain_ms=cuda_ms(lambda: sc.tile_update_plain(work9, lv), 5),
                bound_ms=b9[0], bound_by=b9[1], library_ms=None)
    ntiles = sum(v["dslot"].numel() + v["off_slot"].numel() for v in levels)
    noff = sum(v["off_slot"].numel() for v in levels)
    b10 = bound_ms(8.0 * B * B * ntiles + 16.0 * rhs.numel(),
                   2.0 * B * B * (ntiles - noff) + 4.0 * B * B * noff)
    dsl = torch.cat([v["dslot"] for v in levels])
    Ld, yd = L[dsl], rhs.reshape(-1, B, 1)[:dsl.numel()].clone()
    row10 = dict(name="tile_solve", route="cuda",
                 source="sedumi_tpu_torch/csrc/tile_solve.cu",
                 replaces="sedumi_tpu/sparse_chol.py:525",
                 max_abs_err=worst["tile_solve"],
                 ms=cuda_ms(lambda: sc.tile_solve(L, rhs, levels), 20),
                 plain_ms=cuda_ms(lambda: sc.tile_solve_plain(L, rhs, levels),
                                  5),
                 bound_ms=b10[0], bound_by=b10[1],
                 library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
                     Ld, yd, upper=False), 20))
    print(f"K8/K9 timed at the LP 20k widest level: {nc} columns, {no} off "
          f"tiles, {np_} pairs; K10 over {len(levels)} levels, {ntiles} "
          f"tiles", flush=True)
    return [row8, row9, row10]


def check_psd_outer_groups(plan, dev, rng):
    """K2's group build with the sparse engine's output slots (0..G-1) on
    the SDP plan's largest bucket, against the plain version (within
    1e-12 of max|B~|)."""
    from sedumi_tpu_torch import schur
    from sedumi_tpu_torch import sparse_engine as se

    arrays, meta = plan
    aop = se.make_sparse_lq_op(arrays, meta, device=dev)
    S = interior_scaling(meta, dev, rng)
    bi = max(range(len(meta["s_G"])), key=lambda i: meta["s_G"][i])
    G = meta["s_G"][bi]
    a = aop.arrays
    W = schur.psd_gram(S.s_r[bi])
    args = (W, a["sg_blk"][bi], a["sg_p"][bi], a["sg_q"][bi], a["sg_v"][bi],
            torch.arange(G, device=dev), G)
    got = schur._psd_outer_kernel(*args)
    want = schur.psd_outer_plain(*args)
    err = float(torch.abs(got - want).max())
    scale = float(torch.abs(want).max())
    print(f"K2 group layout, SDP bucket {bi} (G={G}, d={W.shape[-1]}): "
          f"max|B~|={scale:.3e} max err={err:.3e} (tol 1e-12*max|B~|)",
          flush=True)
    if not err <= 1e-12 * scale:
        fail("psd_outer kernel disagrees with its plain version on the "
             "sparse engine's group layout")
    return err


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


def run_example(ex, gate: bool, pars=None):
    import sedumi_tpu_torch as st
    from sedumi_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    x, y, info = st.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0, **(pars or {})},
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    cx = float(np.real(np.vdot(ex.c, x)))
    by = float(np.real(np.vdot(ex.b, y)))
    rel = max(abs(cx - ex.optval), abs(by - ex.optval)) / abs(ex.optval)
    counts = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    counts = {k: v for k, v in counts.items() if v}
    label = ex.name + (f" {json.dumps(pars)}" if pars else "")
    print(f"{label}: iter={info['iter']} cx={cx!r} by={by!r} "
          f"rel={rel:.3e} pinf={info['pinf']} dinf={info['dinf']} "
          f"numerr={info['numerr']} wall={wall:.2f}s "
          f"phases={json.dumps(info['phases'])} launches={counts}",
          flush=True)
    finite = bool(np.all(np.isfinite(x)) and np.all(np.isfinite(y)))
    if not finite:
        fail(f"{label}: non-finite solution")
    if gate and not (rel <= 1e-6 and info["pinf"] == 0
                     and info["dinf"] == 0 and info["numerr"] < 2):
        fail(f"{label}: reference gate not met")
    return counts, info


def feasible_problem(K: dict, m: int, seed: int, density: float = 0.8):
    """A copy of the reference's generators.feasible_problem for real LP
    and Lorentz cones (the same draws from numpy.random.default_rng(seed)):
    a strictly feasible pair (x0, y0, z0), b = A x0, c = A'y0 + z0.
    Returns (At, b, c) with At in the SeDuMi transpose convention."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)

    def interior():
        parts = [rng.uniform(0.5, 2.0, K.get("l", 0))]
        for d in K.get("q", []):
            bar = rng.normal(size=d - 1) * 0.4
            parts.append(np.concatenate(
                [[np.linalg.norm(bar) + rng.uniform(0.5, 1.5)], bar]))
        return np.concatenate(parts)

    x0, z0 = interior(), interior()
    y0 = rng.normal(size=m)
    n = x0.size
    A = rng.normal(size=(m, n))
    A *= rng.random((m, n)) < density
    return sp.csc_matrix(A.T), A @ x0, A.T @ y0 + z0


# The mixed-ladder path's dense SOCP: eight Lorentz cones of order 50 and
# m = 120 (nb's scale), A 80% dense.  Of the bundled examples none takes
# the double-float operator in the reference's ladder: nb, whose A is
# dense, rejects an f32 direction before real progress, so its f32
# iterates are discarded and the hybrid rung skipped (reference
# solver.py:855-875), and the others' A are under 2% dense.  This instance
# enters the hybrid phase in the reference and in the port on a CPU; where
# the f32 phase ends moves with the f32 summation order (reference: f32 7,
# a rejected hybrid step, host64 9; port: f32 5, hybrid 2, host64 7).
SOCP_DENSE = ({"q": [50] * 8}, 120, 7)


def run_mixed_socp():
    """The dense SOCP with pars.dtype='mixed' against its f64 solve: the
    gate of the reference's test_mixed_ladder_with_df_operator_e2e
    (pinf = dinf = 0, numerr = 0, c'x within 1e-6 (1 + |c'x|))."""
    import sedumi_tpu_torch as st
    from sedumi_tpu_torch import kernels

    K, m, seed = SOCP_DENSE
    At, b, c = feasible_problem(K, m, seed)
    x64, _, _ = st.sedumi(At, b, c, K, {"fid": 0}, device="cuda")
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    x, y, info = st.sedumi(At, b, c, K, {"fid": 0, "dtype": "mixed"},
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    cx64, cx = float(c @ x64), float(c @ x)
    rel = abs(cx - cx64) / (1.0 + abs(cx64))
    print(f"socp-dense (q 8x50, m=120) {{\"dtype\": \"mixed\"}}: "
          f"iter={info['iter']} cx={cx!r} cx_f64={cx64!r} rel={rel:.3e} "
          f"pinf={info['pinf']} dinf={info['dinf']} "
          f"numerr={info['numerr']} wall={wall:.2f}s "
          f"phases={json.dumps(info['phases'])} "
          f"launches={ {k: v for k, v in counts.items() if v} }", flush=True)
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        fail("socp-dense: non-finite solution")
    if not (info["pinf"] == 0 and info["dinf"] == 0 and info["numerr"] == 0
            and rel <= 1e-6):
        fail("socp-dense: the reference test's gate not met")
    return counts


# The sparse problems: copies of the generators of
# tests/test_sparse_engine.py (which imports the reference package), each
# drawn from a fresh numpy.random.default_rng(12345) as tests/conftest.py
# seeds them.


def random_sparse_lp(m, n_extra, rng, density=3, dense_cols=0):
    """Feasible sparse LP: n = m + n_extra variables, ~density nonzeros per
    column, dense_cols columns hitting half the constraints."""
    import scipy.sparse as sp

    n = m + n_extra
    perm = rng.permutation(m)
    rows, cols, vals = [perm], [np.arange(m)], [rng.random(m) + 0.5]
    for j in range(m, n):
        k = rng.integers(1, density + 1)
        rows.append(rng.choice(m, size=k, replace=False))
        cols.append(np.full(k, j))
        vals.append(rng.standard_normal(k))
    for j in range(dense_cols):
        r = rng.choice(m, size=m // 2, replace=False)
        rows.append(r)
        cols.append(np.full(r.size, j + m))
        vals.append(rng.standard_normal(r.size) * 0.3)
    A = sp.csc_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(m, n))
    x0 = rng.random(n) + 0.5
    b = A @ x0
    y0 = rng.standard_normal(m) * 0.1
    c = A.T @ y0 + rng.random(n) + 0.5
    return A, b, c, {"l": n}


def random_sparse_sdp(m, nb, d, rng, touch=2):
    """Feasible sparse SDP: nb PSD blocks of order d, each constraint
    touching `touch` blocks with a few symmetric entries."""
    import scipy.sparse as sp

    rows, cols, vals = [], [], []
    for i in range(m):
        for bk in rng.choice(nb, size=touch, replace=False):
            p = int(rng.integers(0, d))
            q = int(rng.integers(0, d))
            v = float(rng.standard_normal())
            base = bk * d * d
            ent = {(p, q): 0.5 * v, (q, p): 0.5 * v} if p != q \
                else {(p, p): v}
            dg = int(rng.integers(0, d))
            ent[(dg, dg)] = ent.get((dg, dg), 0.0) + float(
                rng.standard_normal())
            for (a, bq), vv in ent.items():
                rows.append(i)
                cols.append(base + a * d + bq)
                vals.append(vv)
    A = sp.csc_matrix((vals, (rows, cols)), shape=(m, nb * d * d))
    b = A @ np.tile(np.eye(d).ravel(), nb)
    c = A.T @ (rng.standard_normal(m) * 0.1) \
        + np.tile((np.eye(d) * 1.5).ravel(), nb)
    return A, b, c, {"s": [d] * nb}


def sparse_socp(rng, m=850, ncones=60):
    """test_sparse_socp_with_cones's problem: a sparse LP plus `ncones`
    Lorentz cones of dimension 3, each touching 3 random constraints."""
    import scipy.sparse as sp

    A, _, _, _ = random_sparse_lp(m, 100, rng)
    n = A.shape[1]
    qdims = [3] * ncones
    rows, cols, vals = [], [], []
    off = 0
    for d in qdims:
        r = rng.choice(m, size=3, replace=False)
        for j in range(d):
            rows.append(r)
            cols.append(np.full(r.size, n + off + j))
            vals.append(rng.standard_normal(r.size) * 0.2)
        off += d
    Aq = sp.lil_matrix(sp.csc_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m, n + sum(qdims))))
    Aq[:, :n] = A
    Aq = sp.csc_matrix(Aq)
    xq, zq = np.zeros(sum(qdims)), np.zeros(sum(qdims))
    o = 0
    for d in qdims:
        xq[o] = 2.0
        xq[o + 1:o + d] = rng.standard_normal(d - 1) * 0.3
        o += d
    bq = Aq @ np.concatenate([rng.random(n) + 0.5, xq])
    o = 0
    for d in qdims:
        zq[o] = 1.5
        zq[o + 1:o + d] = rng.standard_normal(d - 1) * 0.2
        o += d
    cq = Aq.T @ (rng.standard_normal(m) * 0.1) + np.concatenate(
        [rng.random(n) + 0.5, zq])
    return Aq, bq, cq, {"l": n, "q": qdims}


# (name, generator, pars, gated): the problems of the reference's tests
# for the sparse path (tests/test_sparse_engine.py), all but the last on
# the automatic route.  The SDP runs at both of the reference's sizes.
# lp20k and sdp5k run without the terminal conic refinement (refine.py,
# host numpy with dense m x m face Grams), which would put this script
# past its time limit: at m = 5000 it took 660 s of a 764 s solve on the
# card's host, and with it lp20k had not returned after 1700 s there.
# Without it sdp5k's endgame lands at the gate (max(err) 3.2e-8 and
# 9.5e-8 in two card runs), so it runs ungated, as trto3 and OH do on the
# dense path, and the reference's gate holds on sdp1200.
SPARSE_SOLVES = [
    ("lp20k", lambda rng: random_sparse_lp(20000, 4000, rng),
     {"fid": 0, "optstep": 0, "refine": 0}, True),
    ("sdp5k", lambda rng: random_sparse_sdp(5000, 2500, 4, rng),
     {"fid": 0, "optstep": 0, "refine": 0}, False),
    ("sdp1200", lambda rng: random_sparse_sdp(1200, 600, 4, rng),
     {"fid": 0, "optstep": 0}, True),
    ("socp850", sparse_socp, {"fid": 0, "optstep": 0}, True),
    ("lp900+3dense", lambda rng: random_sparse_lp(900, 200, rng,
                                                  dense_cols=3),
     {"fid": 0, "sparse": 1, "optstep": 0}, True),
]


def run_sparse(name, make, pars, gate, plans):
    """One sparse solve on the card.  The solver's route_engine is wrapped
    to time the host plan and keep it (for the kernel checks).  Every solve
    must take the sparse engine and finish with finite outputs; a gated one
    must also meet the reference's gate."""
    import sedumi_tpu_torch as st
    from sedumi_tpu_torch import kernels, solver

    A, b, c, K = make(np.random.default_rng(12345))
    route = solver.route_engine
    planned = {}

    def timed_route(*args):
        t = time.time()
        kind, plan = route(*args)
        planned.update(sec=time.time() - t, plan=plan)
        return kind, plan

    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    solver.route_engine = timed_route
    try:
        x, y, info = st.sedumi(A, b, c, K, pars, device="cuda")
    finally:
        solver.route_engine = route
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    meta = planned["plan"][1] if planned.get("plan") else {}
    res = float(np.linalg.norm(A @ x - b) / (1.0 + np.abs(b).max()))
    print(f"{name}: m={A.shape[0]} n={A.shape[1]} "
          f"engine={info['lin_engine']} plan={planned.get('sec', 0.0):.2f}s "
          f"(ntc={meta.get('ntc')} levels={meta.get('nlev')} "
          f"Kd={meta.get('Kd')} ADA density={meta.get('ada_density', 0):.4f}) "
          f"iter={info['iter']} cx={float(c @ x)!r} "
          f"max(err)={max(info['err']):.3e} |Ax-b|={res:.3e} "
          f"pinf={info['pinf']} dinf={info['dinf']} numerr={info['numerr']} "
          f"wall={wall:.2f}s phases={json.dumps(info['phases'])} "
          f"launches={counts}", flush=True)
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        fail(f"{name}: non-finite solution")
    if info["lin_engine"] != "sparse":
        fail(f"{name}: the sparse engine was not taken")
    if gate and not (info["pinf"] == 0 and info["dinf"] == 0
                     and max(info["err"]) < 1e-7):
        fail(f"{name}: the reference's sparse-path gate not met")
    if any(counts[k] == 0 for k in ("tile_factor", "tile_update",
                                    "tile_solve")):
        fail(f"{name}: a tile-Cholesky kernel never ran in its solve")
    plans[name] = planned["plan"]
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

    # f32 matrix products must run at full f32, never TF32
    print(f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}",
          flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmul is on: the f32 phases need full f32 products")

    gen = torch.Generator().manual_seed(20261016)
    rows = [check_dd_residual(dev, gen), check_psd_coo(dev, gen),
            check_ldl_masked(dev, gen), check_ozaki_split(dev, gen),
            check_dd_elem(dev, gen), check_dd_gemv(dev, gen),
            check_dd_panel_chol(dev, gen), check_dd_residual_f32(dev, gen),
            check_psd_coo_f32(dev, gen), check_ldl_masked_f32(dev, gen)]
    rows += check_df_gemv(dev, gen)
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    plan = [("quantum", True), ("nb", True), ("arch0", True),
            ("control07", False), ("trto3", False),
            ("OH_2Pi_STO-6GN9r12g1T2", False)]
    dd_kernels = ("ozaki_split", "dd_accumulate", "dd_gemv", "dd_panel_chol")
    for name, gate in plan:
        counts, info = run_example(load_example(name), gate)
        if counts.get("dd_matvec_residual", 0) == 0:
            fail(f"{name}: the compensated-residual kernel never ran")
        if name == "arch0":
            if counts.get("psd_contrib_coo", 0) == 0:
                fail("arch0: the sparse PSD Schur kernel never ran")
            if "dd64" not in info["phases"]:
                fail("arch0 never entered the dd64 phase")
            if any(counts.get(k, 0) == 0 for k in dd_kernels):
                fail("arch0: a dd64 kernel never ran in its solve")
    counts, _ = run_example(with_zero_row(load_example("nb")), True)
    if counts.get("ldl_masked", 0) == 0:
        fail("nb+zero-row: the masked-LDL' fallback never ran")
    total = dict(kernels.LAUNCHES)
    torch.cuda.empty_cache()

    # the mixed precision ladder, its counts zeroed just before and read
    # just after.  Gated where the reference package meets the gate with
    # 'mixed' on a CPU: nb (f32 8, host64 16; rel 9.17e-8), arch0 (f32 13,
    # host64 44, dd64 8; rel 4.85e-7), nb+zero-row (as nb); control07
    # (f32 15, hybrid 5, host64 12, dd64 11) lands at rel 1.288e-6, numerr
    # 1 there, so it is ungated
    kernels.reset_launch_counts()
    mixed = {"dtype": "mixed"}
    t_mixed = time.time()
    for name, gate in (("nb", True), ("arch0", True), ("control07", False),
                       ("nb+zero-row", True)):
        ex = with_zero_row(load_example("nb")) if name == "nb+zero-row" \
            else load_example(name)
        counts, info = run_example(ex, gate, mixed)
        if "f32" not in info["phases"] \
                or counts.get("dd_matvec_residual_f32", 0) == 0:
            fail(f"{name}: the f32 phase or its K1-f32 residual never ran")
        if name == "arch0" and counts.get("psd_contrib_coo_f32", 0) == 0:
            fail("arch0: K2-f32 never formed the f32 Schur complement")
        if name == "nb+zero-row" and counts.get("ldl_masked_f32", 0) == 0:
            fail("nb+zero-row: the f32 masked-LDL' fallback never ran")
    counts = run_mixed_socp()
    if counts["df_matvec"] == 0 or counts["df_vecmat"] == 0:
        fail("socp-dense: the double-float operator (K11) never ran")
    print(f"mixed-ladder path: {time.time() - t_mixed:.1f}s", flush=True)
    for k, v in kernels.LAUNCHES.items():
        total[k] += v
    torch.cuda.empty_cache()

    # the sparse path, its counts zeroed just before and read just after
    kernels.reset_launch_counts()
    plans = {}
    for name, make, pars, gate in SPARSE_SOLVES:
        counts = run_sparse(name, make, pars, gate, plans)
        if name.startswith("sdp") and counts["psd_contrib_coo"] == 0:
            fail(f"{name}: K2 never built the PSD groups in its solve")
        if name == "lp900+3dense" and counts["ldl_masked"] == 0:
            fail("lp900+3dense: K3 never factored the Woodbury capacitance")
        torch.cuda.empty_cache()
    for k, v in kernels.LAUNCHES.items():
        total[k] += v

    # the sparse engine's kernels at the plans' shapes
    rng = np.random.default_rng(20261016)
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"],
                                 check_psd_outer_groups(plans["sdp5k"], dev,
                                                        rng))
    rows += check_tile_kernels({k: plans[k] for k in ("lp20k", "sdp5k")},
                               dev, gen, rng)
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
