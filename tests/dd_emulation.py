"""Numpy emulations of the dd kernels' order of operations.

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

panel_chol repeats K7 (csrc/dd_chol.cu): the diagonal block's
right-looking factor on its lower triangle, each row below as its own
chain over the columns against that block, each column of the inverse as
its own forward substitution, with the kernel's division qdiv (a zero
numerator's signed zero from the sign bits).
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


# ----------------------------------------------------------------- K7

_SIGN = np.int64(-0x8000000000000000)


def qdiv(x, d):
    """x / d as K7's qdiv computes it: a zero x over a d that is neither
    zero nor NaN gets the zero whose sign is sign(x) xor sign(d), without
    dividing; anything else divides."""
    x, d = np.broadcast_arrays(np.asarray(x, np.float64),
                               np.asarray(d, np.float64))
    z = (x == 0.0) & (d != 0.0) & (d == d)
    with np.errstate(all="ignore"):
        q = np.where(z, 1.0, x) / np.where(z, 1.0, d)
    sign = (x.view(np.int64) ^ d.view(np.int64)) & _SIGN
    return np.where(z, sign.view(np.float64), q)


def dd_div(ah, al, bh, bl):
    q1 = qdiv(ah, bh)
    with np.errstate(all="ignore"):
        ph, pe = two_prod(q1, bh)
        ph, pl = two_sum(ph, (pe + q1 * bl) + 0.0 * bh)
        rh, rl = dd_sub(ah, al, ph, pl)
        return two_sum(q1, qdiv(rh + rl, bh))


def dd_sqrt(ah, al):
    with np.errstate(all="ignore"):
        s = np.sqrt(np.maximum(ah, 0.0))
        ph, pl = two_prod(s, s)
        rh, rl = dd_sub(ah, al, ph, pl)
        return two_sum(s, qdiv(rh + rl, np.maximum(2.0 * s, 1e-300)))


def dd_update(sh, sl, ah, al, bh, bl):
    """(sh, sl) - a b in dd: TwoProd of the highs, the lows (pe + a_h b_l)
    + a_l b_h, then dd_sub."""
    with np.errstate(all="ignore"):
        ph, pe = two_prod(ah, bh)
        return dd_sub(sh, sl, ph, (pe + ah * bl) + al * bh)


def panel_chol(Sh, Sl):
    """(Lh, Ll, Ih, Il, ok) of one panel S [nr, w] in K7's arrangement."""
    Sh, Sl = np.array(Sh, np.float64), np.array(Sl, np.float64)
    nr, w = Sh.shape
    Dh, Dl = Sh[:w].copy(), Sl[:w].copy()
    ph, pl = np.zeros(w), np.zeros(w)
    ok = True
    for j in range(w):
        dh, dl = Dh[j, j], Dl[j, j]
        if not dh > 0:
            v = abs(dh)
            dh, dl, ok = (1e-300 if 1e-300 > v else v), 0.0, False
        ph[j], pl[j] = dd_sqrt(dh, dl)
        Dh[j:, j], Dl[j:, j] = dd_div(Dh[j:, j], Dl[j:, j], ph[j], pl[j])
        for r in range(j + 1, w):      # the lower triangle j < c <= r
            c = slice(j + 1, r + 1)
            Dh[r, c], Dl[r, c] = dd_update(Dh[r, c], Dl[r, c], Dh[r, j],
                                           Dl[r, j], Dh[c, j], Dl[c, j])
    Xh, Xl = Sh[w:].copy(), Sl[w:].copy()       # rows below, one chain each
    for j in range(w):
        Xh[:, j], Xl[:, j] = dd_div(Xh[:, j], Xl[:, j], ph[j], pl[j])
        c = slice(j + 1, w)
        Xh[:, c], Xl[:, c] = dd_update(Xh[:, c], Xl[:, c], Xh[:, j, None],
                                       Xl[:, j, None], Dh[None, c, j],
                                       Dl[None, c, j])
    Eh, El = np.eye(w), np.zeros((w, w))        # columns of the inverse
    for j in range(w):
        Eh[j], El[j] = dd_div(Eh[j], El[j], Dh[j, j], Dl[j, j])
        Eh[j + 1:], El[j + 1:] = dd_update(
            Eh[j + 1:], El[j + 1:], Dh[j + 1:, j, None], Dl[j + 1:, j, None],
            Eh[None, j], El[None, j])
    low = np.tril(np.ones((w, w), bool))
    Lh = np.concatenate([np.where(low, Dh, 0.0), Xh])
    Ll = np.concatenate([np.where(low, Dl, 0.0), Xl])
    return Lh, Ll, Eh, El, ok
