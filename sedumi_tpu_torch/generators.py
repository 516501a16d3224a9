"""Random feasible problem generators.

Copied from the reference package (sedumi_tpu/generators.py; numpy only).
Reference analog: conversion/feasreal.m and conversion/feascpx.m — the
reference's only synthetic-instance tooling (SURVEY.md section 4).  We
generate a strictly feasible primal-dual pair (x0, y0, z0) and derive
b = A x0, c = A'y0 + z0, so the instance is solvable with zero duality gap
and known-feasible interior; mixed cones and optional complex data.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .cones import ConeSpec


def _interior_point(rng, K: ConeSpec, complex_data: bool = False) -> np.ndarray:
    """A strictly interior point of K in the external vector format."""
    parts: list[np.ndarray] = []
    parts.append(rng.normal(size=K.f) if K.f else np.zeros(0))
    parts.append(rng.uniform(0.5, 2.0, K.l))
    for d in K.q:
        bar = rng.normal(size=d - 1) * 0.4
        parts.append(np.concatenate([[np.linalg.norm(bar) + rng.uniform(0.5, 1.5)], bar]))
    for d in K.r:
        bar = rng.normal(size=d - 2) * 0.4
        x1 = rng.uniform(0.5, 1.5)
        x2 = (np.dot(bar, bar) / (2 * x1)) + rng.uniform(0.5, 1.5)
        parts.append(np.concatenate([[x1, x2], bar]))
    herm = set(K.scomplex)
    for i, d in enumerate(K.s, start=1):
        if i in herm:
            M = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
            X = M @ M.conj().T + 0.5 * np.eye(d)
        else:
            M = rng.normal(size=(d, d))
            X = M @ M.T + 0.5 * np.eye(d)
        parts.append(X.reshape(-1, order="F"))
    return np.concatenate([np.asarray(p) for p in parts])


def feasible_problem(
    K, m: int, seed: int = 0, density: float = 0.8, complex_data: bool = False
):
    """Generate (At, b, c, K) with a known strictly feasible pair.

    Returns At in the SeDuMi transpose convention (n x m).  With
    complex_data=True, Hermitian blocks must be listed in K.scomplex and all
    data on them is complex (feascpx.m analog); rows touching complex data
    are listed in K.ycomplex by the caller if complex equality is desired.
    """
    K = ConeSpec.make(K)
    rng = np.random.default_rng(seed)
    n = K.dim
    x0 = _interior_point(rng, K)
    z0 = _interior_point(rng, K)
    # free part of the dual slack must be zero
    if K.f:
        z0[: K.f] = 0.0
    y0 = rng.normal(size=m)
    dt = np.complex128 if complex_data else np.float64
    A = rng.normal(size=(m, n)).astype(dt)
    if complex_data:
        A = A + 1j * rng.normal(size=(m, n))
    A *= rng.random((m, n)) < density
    # Hermitian/symmetric block structure on the PSD segments
    off = K.f + K.l + sum(K.q) + sum(K.r)
    herm = set(K.scomplex)
    for i, d in enumerate(K.s, start=1):
        blk = A[:, off : off + d * d].reshape(m, d, d)
        if i in herm:
            blk = 0.5 * (blk + np.conj(blk.transpose(0, 2, 1)))
        else:
            blk = 0.5 * (blk + blk.transpose(0, 2, 1))
            blk = np.real(blk)
        A[:, off : off + d * d] = blk.reshape(m, -1)
        off += d * d
    # Inner-product convention (sedumi.m:773-807, MATLAB x'*At): the i-th
    # constraint imposes Re(a_i^H x) = b_i with a_i = At[:, i] — so b uses
    # the CONJUGATED product and c = At @ y0 + z0 (dual z = c - At*y).
    if complex_data:
        b = np.real(np.conj(A) @ x0)
        c = A.T @ y0 + z0
    else:
        b = A @ x0
        c = A.T @ y0 + z0
    return sp.csc_matrix(A.T), np.real(b).astype(np.float64), c, K
