"""Numpy emulation of the dd GEMV kernel's order of operations.

K6 (csrc/dd_gemv.cu, dd_gemv_kernel) and the fused triangular solve of
ddlinalg.dd_chol_solve (dd_chol_solve_kernel in the same source) sum each
output row in one fixed order: lane l of a warp takes j = l, l + 32, ...
in ascending order, TwoSum-ing the products a_ij x_j into (s, comp) and
their exact errors and the cross terms into lo; the 32 lanes' partials
merge by the shuffle tree (lane l takes lane l + off's partial, or its
own where l + off >= 32, for off = 16, 8, 4, 2, 1); lane 0 normalises
(s, comp + lo).  These functions repeat that arithmetic step for step
(one rounding per product and per sum, as the kernels do under nvcc
--fmad=false; the product's exact error by Dekker's split, which equals
the kernels' fma(a, b, -p) whenever the split does not overflow), so on
the CPU they show that the order solves the reference's systems, and on
the card the kernels can be held to them bit for bit.  jax-free: the card
tests import it too.
"""

from __future__ import annotations

import numpy as np

LANES = 32


def two_sum(a, b):
    s = a + b
    v = s - a
    return s, (a - (s - v)) + (b - v)


def _split(a):
    c = 134217729.0 * a           # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """(p, e) with p + e = a b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def gemv(Ah, Al, xh, xl):
    """(Ah + Al)(xh + xl) in K6's lane order: A [m, n], x [n] numpy f64."""
    Ah, Al = np.asarray(Ah, np.float64), np.asarray(Al, np.float64)
    xh, xl = np.asarray(xh, np.float64), np.asarray(xl, np.float64)
    m, n = Ah.shape
    s = np.zeros((m, LANES))
    comp = np.zeros((m, LANES))
    lo = np.zeros((m, LANES))
    lanes = np.arange(LANES)
    for j0 in range(0, n, LANES):
        live = lanes[j0 + lanes < n]
        j = j0 + live
        a, al, b, bl = Ah[:, j], Al[:, j], xh[j], xl[j]
        p, e = two_prod(a, b)
        t, err = two_sum(s[:, live], p)
        s[:, live] = t
        comp[:, live] = comp[:, live] + err
        lo[:, live] = lo[:, live] + (e + (a * bl + al * b))
    for off in (16, 8, 4, 2, 1):
        src = np.where(lanes + off < LANES, lanes + off, lanes)
        s2, c2, l2 = s[:, src], comp[:, src], lo[:, src]
        t, err = two_sum(s, s2)
        s = t
        comp = (comp + c2) + err
        lo = lo + l2
    return two_sum(s[:, 0], comp[:, 0] + lo[:, 0])


def dd_sub(ah, al, bh, bl):
    """(ah + al) - (bh + bl) as dd_elem.cu's add_kernel with negate_b."""
    sh, se = two_sum(ah, -bh)
    return two_sum(sh, (se + al) + -bl)


def dd_chol_solve(Lh, Ll, inv_diag, nb, bh, bl=None, gemv=gemv):
    """L L' z = b as ddlinalg.dd_chol_solve_panels composes it (and the
    fused kernel runs it): per panel the product with the finished part
    of the solution, dd_sub from the right-hand side, the product with
    the diagonal inverse.  Lh, Ll [m, m], inv_diag the (Ih, Il) of each
    panel (rows of inv(L_kk)), numpy f64; `gemv` the product used."""
    m = Lh.shape[0]
    bh = np.asarray(bh, np.float64)
    bl = np.zeros(m) if bl is None else np.asarray(bl, np.float64)
    yh, yl = np.zeros(m), np.zeros(m)
    for k, p0 in enumerate(range(0, m, nb)):
        p1 = min(p0 + nb, m)
        rh, rl = bh[p0:p1], bl[p0:p1]
        if p0:
            uh, ul = gemv(Lh[p0:p1, :p0], Ll[p0:p1, :p0], yh[:p0], yl[:p0])
            rh, rl = dd_sub(rh, rl, uh, ul)
        yh[p0:p1], yl[p0:p1] = gemv(*inv_diag[k], rh, rl)
    zh, zl = np.zeros(m), np.zeros(m)
    for k, p0 in reversed(list(enumerate(range(0, m, nb)))):
        p1 = min(p0 + nb, m)
        rh, rl = yh[p0:p1], yl[p0:p1]
        if p1 < m:
            uh, ul = gemv(Lh[p1:, p0:p1].T, Ll[p1:, p0:p1].T, zh[p1:],
                          zl[p1:])
            rh, rl = dd_sub(rh, rl, uh, ul)
        Ih, Il = inv_diag[k]
        zh[p0:p1], zl[p0:p1] = gemv(Ih.T, Il.T, rh, rl)
    return zh, zl
