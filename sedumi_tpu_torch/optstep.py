"""Mehrotra-Ye optimal-face projection for pure LP (finite termination).

Reference analog: optstep.m:42-138 — near convergence of an LP, guess the
optimal basis B from the relative sizes of the primal/dual iterates, zero
the non-basic scaling, and project onto the guessed optimal face:

  primal:  x_N = 0,  x_B = xbar_B + D_B A_B' psi,  M psi = b - A_B xbar_B
  dual:    M dy = A_B D_B (c_B - A_B' ybar),  y+ = ybar + dy,  z = c - A'y+

with M = A_B D_B A_B' and D = diag(x/z) the LP NT scaling.  The guess is
*verified* exactly like the reference (optstep.m:86-131): x_B >= 0, the
primal residual must not deteriorate, z_N >= 0, and |z_B| must stay at
rounding level; on any failure the IPM iterate is kept unchanged.

This is a one-shot host-side finisher (scipy sparse solve) — it runs once
per solve, off the device hot path, so a sparse factorization is the right
tool here even though the per-iteration Schur solves are dense on device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def optstep_lp(At: sp.spmatrix, b: np.ndarray, c: np.ndarray,
               x: np.ndarray, y: np.ndarray, z: np.ndarray,
               eps: float = 1e-8):
    """Attempt the optimal-face projection.  Inputs are the *internal* LP
    data (At: n x m sparse) and the final scaled iterate (x = x/tau etc.).

    Returns (x_exact, y_exact) or (None, None) when the basis guess fails
    verification (optstep.m returns [] in that case).
    """
    n, m = At.shape
    x = np.asarray(x, np.float64).ravel()
    z = np.asarray(z, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    c = np.asarray(c, np.float64).ravel()
    if x.size != n or z.size != n:
        return None, None

    # basis guess: basic where the primal dominates the dual slack
    # (the dxmdz<0 rule of optstep.m:55-59 at the limit point)
    basic = x > z
    if not basic.any():
        return None, None
    d = np.where(basic, x / np.maximum(z, 1e-300), 0.0)
    # guard absurd scalings
    d = np.minimum(d, 1e16)

    A = At.T.tocsr()                      # m x n
    AB = A.multiply(d[None, :])           # A D (zero on N)
    M = (AB @ A.T).tocsc()                # A_B D_B A_B'
    Mreg = M + sp.identity(m, format="csc") * (1e-14 * (M.diagonal().max() + 1.0))
    try:
        lu = spla.splu(Mreg)
    except RuntimeError:
        return None, None

    # --- primal projection ---
    r = b - A @ np.where(basic, x, 0.0)
    psi = lu.solve(r)
    x_new = np.where(basic, x + d * (A.T @ psi), 0.0)
    res_new = np.linalg.norm(A @ x_new - b, np.inf)
    res_old = np.linalg.norm(A @ x - b, np.inf)
    if x_new.min() < 0.0 or res_new > max(2.0 * res_old, eps * (1.0 + np.abs(b).max())):
        return None, None

    # --- dual projection: make z_B = 0 exactly (up to solve accuracy) ---
    rz = c - A.T @ y
    dy = lu.solve(AB @ rz)
    y_new = y + dy
    z_new = c - A.T @ y_new
    zB = np.where(basic, z_new, 0.0)
    zN = z_new[~basic] if (~basic).any() else np.zeros(0)
    norm_zB = np.abs(zB).max() if zB.size else 0.0
    if (zN.size and zN.min() < 0.0) or \
            norm_zB > 5.0 * max(1e-10 * (1.0 + np.abs(c).max()), eps):
        return None, None

    # duality-gap sanity (optstep.m:120-131)
    gap = float(c @ x_new - b @ y_new)
    if gap < -(5e-8) * (1.0 + abs(b @ y_new) + np.abs(b).max()) or \
            abs(gap) > 1e-6 * (1.0 + abs(c @ x_new) + abs(b @ y_new)):
        return None, None

    return x_new, y_new
