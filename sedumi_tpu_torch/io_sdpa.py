"""Sparse-SDPA (.dat-s) reader/writer.

The port's copy of sedumi_tpu/io_sdpa.py, unchanged but for this note:
numpy, scipy and the port's own modules only.

Reference analog: conversion/fromsdpa.m (reader; conventions mirrored
exactly — SDPA maximizes, so c = -F0; diagonal/negative/size-1 blocks map
to K.l and come first in the variable layout; entries are upper-triangular
and symmetrized into full vecs) and conversion/writesdp.m (writer role;
we emit .dat-s, the format the ecosystem actually exchanges).
"""

from __future__ import annotations

import re

import numpy as np
import scipy.sparse as sp


def read_sdpa(fname: str):
    """Read a sparse SDPA file -> (At, b, c, K) in SeDuMi convention.

    At: (N x m) csc; b: (m,); c: (N,); K: {"l": nl, "s": [..]}.
    """
    with open(fname) as f:
        lines = f.read().splitlines()
    pos = 0

    def next_data_line():
        nonlocal pos
        while pos < len(lines):
            ln = lines[pos]
            pos += 1
            stripped = ln.strip()
            if stripped and not stripped.startswith(('"', "*", "#")):
                return ln
        raise ValueError("Invalid SDPA file: unexpected end of file")

    m = int(re.sub(r"[^\d-]", " ", next_data_line()).split()[0])
    nblocks = int(re.sub(r"[^\d-]", " ", next_data_line()).split()[0])
    dims = [int(t) for t in re.sub(r"[.,(){}]", " ", next_data_line()).split()][:nblocks]
    if len(dims) != nblocks or any(d == 0 for d in dims):
        raise ValueError("Invalid SDPA file: bad block dimensions")
    dims = np.asarray(dims)
    b = np.array(
        [float(t) for t in re.sub(r"[,(){}]", " ", next_data_line()).split()]
    )
    if b.size != m:
        raise ValueError("Invalid SDPA file: rhs has wrong length")

    # layout: LP part (diag blocks and 1-dim blocks, in order) first,
    # then PSD blocks as full vecs (fromsdpa.m:75-90)
    loffset = 0
    sdpoffset = int(np.sum(np.abs(dims[dims <= 1])))
    offset = np.zeros(nblocks, np.int64)
    stride = np.where(dims < 0, 0, dims)
    for i, d in enumerate(dims):
        if d <= 1:
            offset[i] = loffset
            loffset += abs(d)
        else:
            offset[i] = sdpoffset
            sdpoffset += d * d
    N = int(-np.sum(dims[dims < 0]) + np.sum(dims[dims > 1] ** 2) + np.sum(dims == 1))

    entries = []
    for ln in lines[pos:]:
        t = ln.split()
        if len(t) >= 5 and not ln.lstrip().startswith(('"', "*", "#")):
            entries.append(
                (int(t[0]), int(t[1]), int(t[2]), int(t[3]), float(t[4]))
            )
    E = np.asarray(entries, dtype=np.float64).reshape(-1, 5)
    matno = E[:, 0].astype(np.int64)
    blk = E[:, 1].astype(np.int64) - 1
    ii = E[:, 2].astype(np.int64)
    jj = E[:, 3].astype(np.int64)
    val = E[:, 4]

    # position of (i,j) and its mirror inside the flat vector
    p1 = offset[blk] + (ii - 1) * stride[blk] + jj
    p2 = offset[blk] + (jj - 1) * stride[blk] + ii
    mirror = np.where(ii == jj, 0.0, val)  # do not double diagonal

    is_obj = matno == 0
    # SDPA maximizes tr(F0 Y): SeDuMi minimizes -> c = -F0 (fromsdpa.m:125)
    c = np.zeros(N)
    np.add.at(c, p1[is_obj] - 1, -val[is_obj])
    np.add.at(c, p2[is_obj] - 1, -mirror[is_obj])

    con = ~is_obj
    rows = np.concatenate([p1[con] - 1, p2[con] - 1])
    cols = np.concatenate([matno[con] - 1, matno[con] - 1])
    vals = np.concatenate([val[con], mirror[con]])
    At = sp.csc_matrix((vals, (rows, cols)), shape=(N, m))

    K = {
        "l": int(-np.sum(dims[dims < 0]) + np.sum(dims == 1)),
        "s": [int(d) for d in dims[dims > 1]],
    }
    return At, b, c, K


def write_sdpa(fname: str, At, b, c, K) -> None:
    """Write (At, b, c, K) with K = l/s cones to sparse SDPA format."""
    from .cones import ConeSpec

    Ks = ConeSpec.make(K)
    if Ks.f or Ks.q or Ks.r or Ks.scomplex:
        raise ValueError("SDPA format supports only l and real s cones")
    At = sp.csc_matrix(At)
    b = np.asarray(b).ravel()
    c = np.asarray(c.todense() if sp.issparse(c) else c).ravel()
    m = b.size
    dims: list[int] = ([-Ks.l] if Ks.l else []) + list(Ks.s)

    def block_of(flat_idx: int):
        """(blkno 1-based, i, j) for a flat SeDuMi index."""
        if flat_idx < Ks.l:
            return (1 if Ks.l else 0), flat_idx + 1, flat_idx + 1
        off = Ks.l
        bno = 1 if Ks.l else 0
        for d in Ks.s:
            bno += 1
            if flat_idx < off + d * d:
                k = flat_idx - off
                j, i = divmod(k, d)  # column-major
                return bno, i + 1, j + 1
            off += d * d
        raise IndexError(flat_idx)

    with open(fname, "w") as f:
        f.write(f"{m}\n{len(dims)}\n")
        f.write(" ".join(str(d) for d in dims) + "\n")
        f.write(" ".join(repr(float(v)) for v in b) + "\n")

        def emit(matno: int, vec: np.ndarray, sign: float) -> None:
            nz = np.nonzero(vec)[0]
            seen = set()
            for idx in nz:
                bno, i, j = block_of(int(idx))
                if (bno, j, i) in seen:
                    continue
                seen.add((bno, i, j))
                if i <= j:
                    f.write(f"{matno} {bno} {i} {j} {repr(sign * float(vec[idx]))}\n")
                else:
                    f.write(f"{matno} {bno} {j} {i} {repr(sign * float(vec[idx]))}\n")

        emit(0, c, -1.0)
        for k in range(m):
            col = np.asarray(At[:, k].todense()).ravel()
            emit(k + 1, col, 1.0)
