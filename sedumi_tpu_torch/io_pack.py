"""SDPPack-format conversion (SeDuMi <-> SDPpack-0.9-beta).

The port's copy of sedumi_tpu/io_pack.py, unchanged but for this note:
numpy, scipy and the port's own modules only.

Reference analog: conversion/frompack.m (+ blk2vec.m, the SDPPACK `smat`
it assumes on the path) and conversion/writesdp.m (Borchers' SeDuMi ->
SDPpack text writer).  SDPPack represents a mixed (SDP, SOC, LP) problem
as (A, b, C, blk) with

  blk.l          LP count,  blk.q  list of SOC dims,  blk.s  list of PSD dims
  A['l']  m x l, A['q']  m x sum(q),  A['s']  m x sum(d_i(d_i+1)/2)
  C['l']  l,     C['q']  sum(q),      C['s']  block-diag matrix (or svec)

where the PSD rows of A are in *svec* form: stacked upper triangles,
column-major per block, off-diagonal entries scaled by sqrt(2) (so that
<svec(X), svec(Y)> = <X, Y>).  frompack.m turns each svec row back into a
block-diag matrix (`smat`) and then into SeDuMi's full d^2 vec per block
(`blk2vec.m:13-20`); we do the same with vectorized index maps.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

_SQRT2 = np.sqrt(2.0)


def _svec_maps(dims):
    """Index/scale maps between stacked svec and stacked full vec.

    Returns (full_idx, scale, nsvec, nfull): for svec entry k,
    full_idx[k,0]=(i,j) position and full_idx[k,1]=(j,i) mirror inside the
    stacked full d^2 layout, scale[k] = 1 on the diagonal, 1/sqrt(2) off.
    """
    pos1, pos2, scale = [], [], []
    foff = 0
    for d in dims:
        for j in range(d):
            for i in range(j + 1):
                pos1.append(foff + j * d + i)
                pos2.append(foff + i * d + j)
                scale.append(1.0 if i == j else 1.0 / _SQRT2)
        foff += d * d
    return (np.asarray(pos1, np.int64), np.asarray(pos2, np.int64),
            np.asarray(scale), foff)


def smat_rows(S, dims):
    """[m, nsvec] svec rows -> [m, nfull] full-vec rows (SDPPACK smat +
    blk2vec per row, vectorized)."""
    S = sp.csc_matrix(S)
    m = S.shape[0]
    p1, p2, sc, nfull = _svec_maps(dims)
    coo = S.tocoo()
    k = coo.col
    vals = coo.data * sc[k]
    rows = np.concatenate([coo.row, coo.row[p1[k] != p2[k]]])
    cols = np.concatenate([p1[k], p2[k][p1[k] != p2[k]]])
    data = np.concatenate([vals, vals[p1[k] != p2[k]]])
    return sp.csc_matrix((data, (rows, cols)), shape=(m, nfull))


def svec_rows(F, dims):
    """[m, nfull] full-vec rows -> [m, nsvec] svec rows (inverse of
    smat_rows for symmetric input)."""
    F = sp.csc_matrix(F)
    p1, p2, sc, _ = _svec_maps(dims)
    up = F[:, p1]
    lo = F[:, p2]
    return sp.csc_matrix(0.5 * (up + lo).multiply(1.0 / sc[None, :]))


def blockdiag_to_vec(C, dims):
    """Block-diagonal matrix -> stacked full vecs (blk2vec.m:13-20)."""
    C = sp.csc_matrix(C)
    parts = []
    off = 0
    for d in dims:
        parts.append(np.asarray(C[off:off + d, off:off + d].todense()).ravel(order="F"))
        off += d
    return np.concatenate(parts) if parts else np.zeros(0)


def from_sdppack(A, b, C, blk):
    """(A, b, C, blk) in SDPPack form -> (At, b, c, K) for sedumi().

    A and C are dicts with optional keys 'l', 'q', 's' (frompack.m:47-80);
    A['s'] rows are svecs; C['s'] is a block-diagonal matrix or an svec.
    """
    b = np.asarray(b).ravel()
    m = b.size
    dims_s = [int(d) for d in np.asarray(blk.get("s", []), np.int64).ravel()]
    dims_q = [int(d) for d in np.asarray(blk.get("q", []), np.int64).ravel()]
    nl = int(blk.get("l", 0) or 0)

    At_parts, c_parts = [], []
    if nl:
        Al = sp.csc_matrix(A["l"])
        assert Al.shape == (m, nl)
        At_parts.append(Al.T)
        cl = np.asarray(
            C["l"].todense() if sp.issparse(C["l"]) else C["l"]
        ).ravel()
        c_parts.append(cl)
    if dims_q:
        Aq = sp.csc_matrix(A["q"])
        At_parts.append(Aq.T)
        cq = np.asarray(
            C["q"].todense() if sp.issparse(C["q"]) else C["q"]
        ).ravel()
        c_parts.append(cq)
    if dims_s:
        As_full = smat_rows(A["s"], dims_s)      # m x nfull
        At_parts.append(As_full.T)
        Cs = C["s"]
        if sp.issparse(Cs) and Cs.shape[0] == Cs.shape[1] and \
                Cs.shape[0] == sum(dims_s):
            cs = blockdiag_to_vec(Cs, dims_s)
        else:
            Cs = np.asarray(Cs.todense() if sp.issparse(Cs) else Cs).ravel()
            if Cs.size == sum(d * (d + 1) // 2 for d in dims_s):
                cs = np.asarray(
                    smat_rows(sp.csc_matrix(Cs[None, :]), dims_s).todense()
                ).ravel()
            else:
                cs = Cs
        c_parts.append(cs)

    At = sp.vstack(At_parts, format="csc") if At_parts else sp.csc_matrix((0, m))
    c = np.concatenate(c_parts) if c_parts else np.zeros(0)
    K = {"l": nl, "q": dims_q, "s": dims_s}
    return At, b, c, K


def to_sdppack(At, b, c, K):
    """(At, b, c, K) -> (A, b, C, blk): inverse of from_sdppack."""
    from .cones import ConeSpec

    Ks = ConeSpec.make(K)
    if Ks.f or Ks.r or Ks.scomplex:
        raise ValueError("SDPPack supports only l/q/s cones with real data")
    At = sp.csc_matrix(At)
    c = np.asarray(c.todense() if sp.issparse(c) else c).ravel()
    nl, nq = Ks.l, int(sum(Ks.q))
    A = {}
    C = {}
    if nl:
        A["l"] = At[:nl, :].T.tocsc()
        C["l"] = c[:nl]
    if Ks.q:
        A["q"] = At[nl:nl + nq, :].T.tocsc()
        C["q"] = c[nl:nl + nq]
    if Ks.s:
        dims = list(Ks.s)
        A["s"] = svec_rows(At[nl + nq:, :].T, dims)
        C["s"] = np.asarray(
            svec_rows(sp.csc_matrix(c[None, nl + nq:]), dims).todense()
        ).ravel()
    blk = {"l": nl, "q": list(Ks.q), "s": list(Ks.s)}
    return A, b, C, blk


def write_sdppack(fname: str, At, b, c, K) -> None:
    """SeDuMi problem -> SDPpack text file (conversion/writesdp.m).

    Format (writesdp.m:55-200): m; b one entry per line; SDP part (block
    count, sizes, C blocks then per-constraint blocks as sparse triu
    [i, j, val] triples each preceded by '1' and a count line); quadratic
    part (block count, sizes, dense C.q, dense A.q rows); linear part
    (size, dense C.l, dense A.l rows).  18-digit floats.
    """
    from .cones import ConeSpec

    Ks = ConeSpec.make(K)
    if Ks.f or Ks.r or Ks.scomplex:
        raise ValueError("writesdp: only real l/q/s problems are supported")
    At = sp.csc_matrix(At)
    b = np.asarray(b).ravel()
    c = np.asarray(c.todense() if sp.issparse(c) else c).ravel()
    m = b.size
    nl, nq = Ks.l, int(sum(Ks.q))
    base_s = nl + nq

    def _triu_triples(vec, d):
        M = vec.reshape(d, d, order="F")
        M = 0.5 * (M + M.T)
        ii, jj = np.nonzero(np.triu(M))
        return ii + 1, jj + 1, M[ii, jj]

    with open(fname, "w") as f:
        f.write(f"{m} \n")
        for v in b:
            f.write(f"{v:.18e}\n")

        # SDP part
        if not Ks.s:
            f.write("0\n")
        else:
            f.write(f"{len(Ks.s)}\n")
            for d in Ks.s:
                f.write(f"{d}\n")
            off = base_s
            for d in Ks.s:
                f.write("1\n")
                ii, jj, vv = _triu_triples(c[off:off + d * d], d)
                f.write(f"{len(ii)}\n")
                for i, j, v in zip(ii, jj, vv):
                    f.write(f"{i}\n{j}\n{v:.18e}\n")
                off += d * d
            for k in range(m):
                col = np.asarray(At[:, k].todense()).ravel()
                off = base_s
                for d in Ks.s:
                    f.write("1\n")
                    ii, jj, vv = _triu_triples(col[off:off + d * d], d)
                    f.write(f"{len(ii)}\n")
                    for i, j, v in zip(ii, jj, vv):
                        f.write(f"{i}\n{j}\n{v:.18e}\n")
                    off += d * d

        # quadratic part
        if not Ks.q:
            f.write("0\n")
        else:
            f.write(f"{len(Ks.q)}\n")
            for d in Ks.q:
                f.write(f"{d}\n")
            for v in c[nl:nl + nq]:
                f.write(f"{v:.18e}\n")
            for k in range(m):
                col = np.asarray(At[nl:nl + nq, k].todense()).ravel()
                for v in col:
                    f.write(f"{v:.18e}\n")

        # linear part
        if not nl:
            f.write("0\n")
        else:
            f.write(f"{nl}\n")
            for v in c[:nl]:
                f.write(f"{v:.18e}\n")
            for k in range(m):
                col = np.asarray(At[:nl, k].todense()).ravel()
                for v in col:
                    f.write(f"{v:.18e}\n")
