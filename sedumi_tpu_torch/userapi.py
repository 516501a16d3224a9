"""User-facing helper API: eigK, eyeK, cellK, mat, vec.

Reference parity: eigK.m, eyeK.m, cellK.m, mat.m, vec.m — including the
reference's sqrt(1/2) Lorentz and 0.5*eig(X+X') PSD normalizations
(eigK.m:82-127) so downstream users (DIMACS error computation, CVX/YALMIP
shims) get identical numbers.  These operate on the *external* cone format
(user's K with f/l/q/r/s and complex blocks) and plain numpy vectors.
"""

from __future__ import annotations

import numpy as np

from .cones import ConeSpec


def vec(X: np.ndarray) -> np.ndarray:
    """Matrix -> column vector (column-major, matching the MATLAB vec.m)."""
    return np.asarray(X).reshape(-1, order="F")


def mat(x: np.ndarray, n: int | None = None) -> np.ndarray:
    """Vector -> n x n matrix (column-major, matching mat.m)."""
    x = np.asarray(x).ravel()
    if n is None:
        n = int(round(np.sqrt(x.size)))
    return x.reshape(n, n, order="F")


def eigK(x: np.ndarray, K) -> np.ndarray:
    """Spectral values of x w.r.t. K in the external format (eigK.m).

    LP entries map to themselves; each Lorentz cone yields
    sqrt(1/2)*(x0 -/+ ||xbar||); each rotated cone
    0.5*(x1+x2 -/+ ||[x1-x2; 2 xbar]||); each PSD block the eigenvalues of
    0.5*(X+X') (Hermitian blocks: complex data with re/im stacked).
    """
    K = ConeSpec.make(K)
    x = np.asarray(x).ravel()
    lab: list[np.ndarray] = []
    off = K.f
    lab.append(np.real(x[off : off + K.l]))
    off += K.l
    tmp = np.sqrt(0.5)
    for d in K.q:
        x0 = np.real(x[off])
        nb = np.linalg.norm(x[off + 1 : off + d])
        lab.append(np.array([tmp * (x0 - nb), tmp * (x0 + nb)]))
        off += d
    for d in K.r:
        # Rotated cone 2*x1*x2 >= ||xbar||^2 (sedumi.m:73-75): spectral
        # values via the orthogonal rotation to Lorentz
        # (pretransfo.m:408-432), lab = 0.5*(x1+x2 -/+ sqrt((x1-x2)^2
        # + 2||xbar||^2)) — zero exactly on the cone boundary.  NOTE the
        # reference's eigK.m:110 uses 2*xbar here, inconsistent with its
        # own pretransfo rotation (boundary points of K.r would grade
        # strictly infeasible); we keep the rotation-consistent factor.
        x1, x2 = np.real(x[off]), np.real(x[off + 1])
        nb = np.linalg.norm(np.concatenate(
            [[x1 - x2],
             np.sqrt(2.0) * np.atleast_1d(x[off + 2 : off + d])]))
        lab.append(np.array([0.5 * (x1 + x2 - nb), 0.5 * (x1 + x2 + nb)]))
        off += d
    herm = set(K.scomplex)
    for i, d in enumerate(K.s, start=1):
        n2 = d * d
        X = x[off : off + n2]
        off += n2
        if i in herm and not np.iscomplexobj(x):
            X = X + 1j * x[off : off + n2]
            off += n2
        X = X.reshape(d, d, order="F")
        lab.append(np.linalg.eigvalsh(0.5 * (X + X.conj().T)).real)
    return np.concatenate(lab) if lab else np.zeros(0)


def eyeK(K) -> np.ndarray:
    """Identity element of K in the external format (eyeK.m): zeros on free
    vars, ones on LP, sqrt(2)*e0 on Lorentz cones, (1,1,0..) on rotated
    cones, vec(I) on PSD blocks."""
    K = ConeSpec.make(K)
    parts: list[np.ndarray] = [np.zeros(K.f), np.ones(K.l)]
    for d in K.q:
        e = np.zeros(d)
        e[0] = np.sqrt(2.0)
        parts.append(e)
    for d in K.r:
        e = np.zeros(d)
        e[0] = 1.0
        e[1] = 1.0
        parts.append(e)
    herm = set(K.scomplex)
    for i, d in enumerate(K.s, start=1):
        parts.append(np.eye(d).reshape(-1))
        if i in herm:
            pass  # identity has zero imaginary part; complex storage handled by caller
    return np.concatenate(parts) if parts else np.zeros(0)


def cellK(x: np.ndarray, K) -> list[np.ndarray]:
    """Split a solution vector into per-cone pieces (cellK.m): free and LP
    parts as vectors, each Lorentz/rotated cone as a vector, each PSD block
    reshaped to a matrix."""
    K = ConeSpec.make(K)
    x = np.asarray(x).ravel()
    out: list[np.ndarray] = []
    off = 0
    if K.f:
        out.append(x[:K.f])
        off += K.f
    if K.l:
        out.append(x[off : off + K.l])
        off += K.l
    for d in list(K.q) + list(K.r):
        out.append(x[off : off + d])
        off += d
    herm = set(K.scomplex)
    for i, d in enumerate(K.s, start=1):
        n2 = d * d
        X = x[off : off + n2].reshape(d, d, order="F")
        off += n2
        if i in herm and not np.iscomplexobj(x):
            X = X + 1j * x[off : off + n2].reshape(d, d, order="F")
            off += n2
        out.append(X)
    return out
