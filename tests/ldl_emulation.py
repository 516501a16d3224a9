"""A numpy emulation of K3's schedule (csrc/ldl_masked.cu).

The kernel is left-looking, a column a warp at a time: warp g builds
columns g, g + nw, ... in turn.  It takes column c of M, applies each
published column j < c to it in order as soon as the progress counter
shows it (x_r - w_j * (col_r * col_c), absd + w_j * (col_c * col_c)), and
once column c - 1 is in finalizes it: the pivot, the add rule, col,
max|col| (RN(max|x| / |d|) from the largest bit pattern of |x|; the
quotients' own for d == 0), the skip; it stores col (0 for
a skip) and the weight w_c (d_c, 0 when d_c is not finite or the column
skipped) into column c of a packed lower triangle and publishes it.
`ldl` runs that schedule step for step in numpy (one rounding per
product, sum and quotient, as the kernel under nvcc --fmad=false), the
warps taking a step each in turn: a step applies every published column
the warp has not applied yet, or finalizes.  Any interleaving the card
runs gives the same bits, since every entry sees its updates in column
order.  The warp variant (m <= 32, a lane a row) has the order of nw = 1.
jax-free: the card tests import it too.
"""

from __future__ import annotations

import numpy as np


def _uint(dtype):
    return np.uint32 if dtype == np.float32 else np.uint64


def _max_abs(q: np.ndarray, dtype) -> np.floating:
    """max|q| as the kernel takes it: the largest bit pattern of |q| (NaN
    above +inf; 0 for an empty column)."""
    u = _uint(dtype)
    mx = np.abs(q).view(u).max() if q.size else u(0)
    return np.array([mx], dtype=u).view(dtype)[0]


def ldl(M, canceltol: float = 1e-12, maxu: float = 5e5,
        abstol: float = 1e-20, skip_pivots: bool = True, nw: int = 1):
    """(L, d, skip, diagadd) of the masked LDL' of M (float64 or float32,
    lower triangle read) in K3's order with nw warps in all."""
    M = np.asarray(M)
    dt = M.dtype.type
    m = M.shape[0]
    ct, mu, at = dt(canceltol), dt(maxu), dt(abstol)
    inf, zero = dt(np.inf), dt(0)
    off = [c * m - c * (c - 1) // 2 for c in range(m)]
    tri = np.zeros(m * (m + 1) // 2, dtype=dt)
    d = np.empty(m, dtype=dt)
    diagadd = np.empty(m, dtype=dt)
    skip = np.zeros(m, dtype=bool)

    def col(c):                     # rows c .. m-1 of column c (a view)
        return tri[off[c]:off[c] + m - c]

    def start(c):                   # [c, updates in, rows c.. of M, absd]
        return [c, 0, M[c:, c].copy(), np.abs(M[c, c])]

    def finalize(c, x, ab):
        acc = x[0]
        lb = ct * ab + at
        canc = acc < lb
        dj = lb if canc else acc
        q = x[1:] / dj
        # max|col| as the kernel takes it: RN(max|x| / |d|) (rounding is
        # monotone), the quotients' own maximum for d == 0
        qm = abs(_max_abs(x[1:], dt) / dj) if dj != 0 else _max_abs(q, dt)
        sk = bool(skip_pivots) and qm > mu
        cc = col(c)
        cc[1:] = zero if sk else q
        cc[0] = zero if sk else (dj if np.isfinite(dj) else zero)
        d[c] = inf if sk else dj
        skip[c] = sk
        diagadd[c] = lb - acc if canc else zero

    warps = [start(g) for g in range(min(nw, m))]
    published = 0
    with np.errstate(all="ignore"):
        while published < m:
            for w in warps:
                c, j0, x, ab = w
                if c >= m:
                    continue
                j1 = min(published, c)
                for j in range(j0, j1):
                    cj = col(j)
                    wt, lc = cj[0], cj[c - j]
                    ab = ab + wt * (lc * lc)
                    x = x - wt * (cj[c - j:] * lc)
                if j1 < c:
                    w[:] = [c, j1, x, ab]
                    continue
                finalize(c, x, ab)
                published += 1
                w[:] = start(c + nw) if c + nw < m else [m, 0, None, 0]
    L = np.zeros((m, m), dtype=dt)
    for c in range(m):
        L[c + 1:, c] = col(c)[1:]
        L[c, c] = 1
    return L, d, skip, diagadd


def indefinite(m, seed):
    """SPD part plus decoupled negative pivots (add only) and coupled ones
    (add, then skip); tests/test_torch_kernels.py's matrix."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((m, m))
    M = B @ B.T / m + np.eye(m)
    for j in range(3, m, 11):
        M[j, :] = 0.0
        M[:, j] = 0.0
        M[j, j] = -1.0
    for j in range(7, m, 13):
        M[j, j] = -1.0
    return M


def scaled(m, dtype, emax, seed=0):
    """S A S for an SPD A with random mantissas and S = diag(2^e), e
    uniform in [-emax, emax]: L's quotients A_rc-like times 2^(e_r - e_c)
    span the exponents (the kernel's quotient rule against its fallback,
    with skip_pivots=False so every quotient shows in L)."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((m, m))
    A = B @ B.T / m + np.eye(m)
    S = np.exp2(rng.integers(-emax, emax + 1, m).astype(np.float64))
    return (S[:, None] * A * S[None, :]).astype(dtype)


def adversarial(case, dtype, m=40):
    """(M, keyword arguments) of one adversarial column kind at order m
    (m >= 40), in dtype (a numpy float type)."""
    M = indefinite(m, 8)
    kw = {}
    tiny = np.finfo(dtype).tiny
    if case == "nan_entry":
        M[21, 9] = np.nan
    elif case == "nan_pivot":
        M[12, 12] = np.nan
    elif case == "inf_pivot":
        M[5, 5] = np.inf
        M[30, 30] = np.inf
    elif case == "inf_entry":
        M[17, 4] = np.inf
    elif case == "subnormal_pivot":
        # lb = 0: pivots of tiny / 8 stay subnormal, and their columns
        # (subnormal entries) divide by them
        kw = dict(canceltol=0.0, abstol=0.0)
        for j in (2, 9, 20):
            M[j, :] = 0.0
            M[:, j] = 0.0
            M[j, j] = tiny / 8
            M[j + 1, j] = M[j, j + 1] = tiny / 16
            M[j + 5, j] = M[j, j + 5] = -3 * tiny / 32
    elif case == "zero_pivot":
        # lb = 0 and a zero diagonal: 0 / 0 and x / 0 in one column
        kw = dict(canceltol=0.0, abstol=0.0)
        M[6, 6] = 0.0
        M[15, 6] = M[6, 15] = 0.0
    elif case == "cancelled":
        # pairs whose second pivot cancels to exactly 0 < lb: the add rule
        # alone (nothing below them to skip)
        M = np.eye(m)
        for j in range(0, m - 1, 4):
            M[j, j + 1] = M[j + 1, j] = 1.0
    elif case == "all_skipped":
        # a tiny diagonal under O(1) couplings: every column but the last
        # (which has no rows) is skipped
        M = np.random.default_rng(9).standard_normal((m, m))
        M = M + M.T
        np.fill_diagonal(M, 1e-14)
    elif case == "no_skip":
        kw = dict(skip_pivots=False)
    return M.astype(dtype), kw


CASES = ["nan_entry", "nan_pivot", "inf_pivot", "inf_entry",
         "subnormal_pivot", "zero_pivot", "cancelled", "all_skipped",
         "no_skip"]
