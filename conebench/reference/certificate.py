"""Judge an answer (x, y) of  min c'x s.t. At'x = b, x in K  by the
certificate it forms, on the benchmark's own data.

x primal feasible, z = c - At y in the dual cone and a small gap together
prove that c'x is optimal to within the gap, so no second solve is
needed.  The six measures are DIMACS's (Mittelmann, "An independent
benchmarking of SDP and SOCP solvers", Math. Prog. 95, 2003), in plain
NumPy: K is {"l": int, "q": [orders], "s": [orders]} in this order, each
PSD block stored whole in column-major order, as SeDuMi stores it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def cone_min(v: np.ndarray, K: dict) -> float:
    """The least eigenvalue of v over the cones of K (each SOC block
    x0 - ||x1:||, each PSD block the least eigenvalue of its symmetric
    part); +inf for an empty K."""
    out = np.inf
    pos = int(K.get("l", 0))
    if pos:
        out = min(out, float(np.min(v[:pos])))
    for d in K.get("q", []):
        blk = v[pos:pos + d]
        out = min(out, float(blk[0] - np.linalg.norm(blk[1:])))
        pos += d
    for d in K.get("s", []):
        blk = v[pos:pos + d * d].reshape(d, d, order="F")
        out = min(out, float(np.linalg.eigvalsh((blk + blk.T) / 2.0)[0]))
        pos += d * d
    if pos != v.size:
        raise ValueError(f"K covers {pos} entries, the vector has {v.size}")
    return out


def dimacs(At, b, c, K: dict, x, y) -> dict:
    """The six DIMACS errors of (x, y), as absolute values."""
    At = sp.csc_matrix(At)
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    c = np.asarray(c, np.float64).ravel()
    z = c - At @ y
    normb = 1.0 + float(np.max(np.abs(b)))
    normc = 1.0 + float(np.max(np.abs(c)))
    cx, by = float(c @ x), float(b @ y)
    denom = 1.0 + abs(cx) + abs(by)
    return {
        "p_res": float(np.linalg.norm(At.T @ x - b)) / normb,
        "p_cone": max(0.0, -cone_min(x, K)) / normb,
        "d_res": 0.0,      # z is c - At y exactly
        "d_cone": max(0.0, -cone_min(z, K)) / normc,
        "gap": abs(cx - by) / denom,
        "comp": abs(float(x @ z)) / denom,
        "cx": cx,
        "by": by,
    }


def worst(errs: dict) -> float:
    """The largest of the six errors."""
    return max(errs[k] for k in ("p_res", "p_cone", "d_res", "d_cone",
                                 "gap", "comp"))
