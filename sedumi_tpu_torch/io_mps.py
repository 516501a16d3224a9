"""MPS linear-program loader -> standard-form LP.

The port's copy of sedumi_tpu/io_mps.py, unchanged but for this note:
numpy, scipy and the port's own modules only.

Reference analog: conversion/prelp.m + conversion/getproblem.m — the
reference delegates the actual MPS parsing to LIPSOL (`prelp.m:59-62`) and
returns a standard-form LP

    min c'x   s.t.  A x = b,  x >= 0

with upper-bound slacks appended after the `lenx` structural variables and
the lower-bound shift returned in `lbounds` (`prelp.m:1-18`).  This module
is self-contained (no LIPSOL): a fixed/free-format MPS parser plus the
same standardization: inequality rows get slack columns, RANGES become
bounded slacks, lower bounds are shifted out, upper bounds become extra
rows `x_j + t_j = u_j`, free variables are split into x+ - x-.

API:
  read_mps(fname)           -> MpsProblem (raw, bounds kept)
  prelp(fname)              -> (A, b, c, lenx, lbounds, objconst)
  read_mps_as_sedumi(fname) -> (At, b, c, K) ready for sedumi()
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

_INF = float("inf")


@dataclass
class MpsProblem:
    name: str
    ncols: int
    row_names: list[str]
    col_names: list[str]
    row_types: list[str]          # 'N','L','G','E' per row (objective excluded)
    obj_name: str
    A: sp.csc_matrix              # nrows x ncols (objective row excluded)
    c: np.ndarray                 # ncols
    rhs: np.ndarray               # nrows
    ranges: dict = field(default_factory=dict)   # row index -> range value
    lb: np.ndarray = None         # ncols
    ub: np.ndarray = None         # ncols
    objconst: float = 0.0


def read_mps(fname: str) -> MpsProblem:
    """Parse an MPS file (free-format tokenization; fixed files parse too)."""
    rows: list[tuple[str, str]] = []          # (type, name), N rows kept aside
    obj_name = None
    row_index: dict[str, int] = {}
    row_types: list[str] = []
    row_names: list[str] = []
    col_names: list[str] = []
    col_index: dict[str, int] = {}
    entries: list[tuple[int, int, float]] = []  # (row, col, val)
    cvals: dict[int, float] = {}
    rhs: dict[int, float] = {}
    ranges: dict[int, float] = {}
    lb: dict[int, float] = {}
    ub: dict[int, float] = {}
    objconst = 0.0
    name = ""
    section = None
    integer_mode = False

    with open(fname) as f:
        for raw in f:
            if not raw.strip() or raw.lstrip().startswith("*"):
                continue
            if raw[0] not in " \t":           # section header
                tok = raw.split()
                section = tok[0].upper()
                if section == "NAME":
                    name = tok[1] if len(tok) > 1 else ""
                if section == "ENDATA":
                    break
                continue
            tok = raw.split()
            if section == "ROWS":
                rtype = tok[0].upper()
                rname = tok[1]
                if rtype == "N":
                    if obj_name is None:
                        obj_name = rname
                    # extra N rows are ignored (standard MPS semantics)
                    continue
                row_index[rname] = len(row_names)
                row_names.append(rname)
                row_types.append(rtype)
            elif section == "COLUMNS":
                if len(tok) >= 3 and tok[1].upper() == "'MARKER'":
                    kw = tok[2].upper().strip("'")
                    integer_mode = kw == "INTORG"
                    continue
                cname = tok[0]
                if cname not in col_index:
                    col_index[cname] = len(col_names)
                    col_names.append(cname)
                j = col_index[cname]
                for rname, val in zip(tok[1::2], tok[2::2]):
                    v = float(val)
                    if rname == obj_name:
                        cvals[j] = cvals.get(j, 0.0) + v
                    elif rname in row_index:
                        entries.append((row_index[rname], j, v))
            elif section == "RHS":
                # first token is the RHS set name (may be omitted in
                # sloppy files -> detect by whether it names a row)
                toks = tok if tok[0] in row_index or tok[0] == obj_name else tok[1:]
                for rname, val in zip(toks[0::2], toks[1::2]):
                    v = float(val)
                    if rname == obj_name:
                        objconst = -v     # MPS: rhs on obj row = -constant
                    elif rname in row_index:
                        rhs[row_index[rname]] = v
            elif section == "RANGES":
                toks = tok if tok[0] in row_index else tok[1:]
                for rname, val in zip(toks[0::2], toks[1::2]):
                    if rname in row_index:
                        ranges[row_index[rname]] = float(val)
            elif section == "BOUNDS":
                btype = tok[0].upper()
                # bound set name may be omitted
                cname = tok[1] if tok[1] in col_index else (
                    tok[2] if len(tok) > 2 and tok[2] in col_index else tok[1]
                )
                if cname not in col_index:
                    continue
                j = col_index[cname]
                val = float(tok[-1]) if btype not in ("FR", "MI", "PL", "BV") else 0.0
                if btype == "UP":
                    ub[j] = val
                    if val < 0 and j not in lb:
                        lb[j] = -_INF
                elif btype == "LO":
                    lb[j] = val
                elif btype == "FX":
                    lb[j] = val
                    ub[j] = val
                elif btype == "FR":
                    lb[j] = -_INF
                elif btype == "MI":
                    lb[j] = -_INF
                elif btype == "PL":
                    ub[j] = _INF
                elif btype == "BV":
                    lb[j] = 0.0
                    ub[j] = 1.0
                elif btype in ("UI",):
                    ub[j] = val
                elif btype in ("LI",):
                    lb[j] = val
    del integer_mode  # LP relaxation: integrality markers are ignored

    n = len(col_names)
    nr = len(row_names)
    c = np.zeros(n)
    for j, v in cvals.items():
        c[j] = v
    bb = np.zeros(nr)
    for i, v in rhs.items():
        bb[i] = v
    lbv = np.zeros(n)
    ubv = np.full(n, _INF)
    for j, v in lb.items():
        lbv[j] = v
    for j, v in ub.items():
        ubv[j] = v
    if entries:
        ii, jj, vv = zip(*entries)
        A = sp.csc_matrix((vv, (ii, jj)), shape=(nr, n))
    else:
        A = sp.csc_matrix((nr, n))
    return MpsProblem(
        name=name, ncols=n, row_names=row_names, col_names=col_names,
        row_types=row_types, obj_name=obj_name or "", A=A, c=c, rhs=bb,
        ranges=ranges, lb=lbv, ub=ubv, objconst=objconst,
    )


def standardize(p: MpsProblem):
    """Standard form: min c'x, Ax=b, x>=0 (the LIPSOL preprocess role).

    Returns (A, b, c, lenx, lbounds, objconst):
      lenx     -- number of structural-variable columns (free splits count
                  once; their negative parts and all slacks come after)
      lbounds  -- lower-bound shift per structural variable (x_orig =
                  x_std + lbounds), prelp.m:16-18 contract
      objconst -- constant to add to c'x to recover the original objective
    """
    A = p.A.tolil().tocsc()
    b = p.rhs.copy()
    c = p.c.copy()
    n = p.ncols
    lbv = p.lb.copy()
    ubv = p.ub.copy()
    objconst = p.objconst

    # inequality rows -> slacks; RANGES bound the slack
    slack_cols = []            # (row, sign, slack_ub)
    for i, t in enumerate(p.row_types):
        if t == "L":           # a'x <= b: a'x + s = b
            r = p.ranges.get(i)
            slack_cols.append((i, 1.0, abs(r) if r is not None else _INF))
        elif t == "G":         # a'x >= b: a'x - s = b
            r = p.ranges.get(i)
            slack_cols.append((i, -1.0, abs(r) if r is not None else _INF))
        elif t == "E" and i in p.ranges:
            r = p.ranges[i]
            # E row with range: b <= a'x <= b + |r| (r>=0) else [b-|r|, b]
            sign = 1.0 if r >= 0 else -1.0
            slack_cols.append((i, -sign, abs(r)))

    # free-variable split: x = x+ - x-  (pars.free=0 style; the conic
    # Lorentz embedding lives in pretransfo, not here)
    free = np.where(np.isinf(lbv) & (lbv < 0))[0]
    # shift finite lower bounds to zero
    finite_lb = np.where(np.isfinite(lbv) & (lbv != 0))[0]
    lbounds = np.where(np.isfinite(lbv), lbv, 0.0)
    if finite_lb.size:
        b = b - A[:, finite_lb] @ lbv[finite_lb]
        objconst = objconst + float(c[finite_lb] @ lbv[finite_lb])
        ubv[finite_lb] = ubv[finite_lb] - lbv[finite_lb]

    blocks_A = [A]
    blocks_c = [c]
    # negative parts for free variables
    if free.size:
        blocks_A.append(-A[:, free])
        blocks_c.append(-c[free])
    # slack columns for inequality rows
    if slack_cols:
        si = [r for r, _, _ in slack_cols]
        sv = [s for _, s, _ in slack_cols]
        S = sp.csc_matrix((sv, (si, range(len(slack_cols)))),
                          shape=(A.shape[0], len(slack_cols)))
        blocks_A.append(S)
        blocks_c.append(np.zeros(len(slack_cols)))
    A2 = sp.hstack(blocks_A, format="csc")
    c2 = np.concatenate(blocks_c)

    # upper bounds (structural vars after shift, and ranged slacks):
    # x_j + t = u  as extra equality rows
    ub_entries = []
    nslack0 = n + free.size
    for j in range(n):
        if np.isfinite(ubv[j]):
            ub_entries.append((j, ubv[j]))
    for k, (_, _, su) in enumerate(slack_cols):
        if np.isfinite(su):
            ub_entries.append((nslack0 + k, su))
    if ub_entries:
        nub = len(ub_entries)
        ncur = A2.shape[1]
        rowsE = sp.csc_matrix(
            (np.ones(nub), ([*range(nub)], [j for j, _ in ub_entries])),
            shape=(nub, ncur),
        )
        A2 = sp.vstack(
            [sp.hstack([A2, sp.csc_matrix((A2.shape[0], nub))]),
             sp.hstack([rowsE, sp.identity(nub, format="csc")])],
            format="csc",
        )
        b = np.concatenate([b, [u for _, u in ub_entries]])
        c2 = np.concatenate([c2, np.zeros(nub)])

    return A2.tocsc(), b, c2, n, lbounds, objconst


def prelp(fname: str):
    """prelp.m-compatible convenience: (A, b, c, lenx, lbounds, objconst)."""
    return standardize(read_mps(fname))


def read_mps_as_sedumi(fname: str):
    """(At, b, c, K) ready for sedumi(): K = {'l': n}."""
    A, b, c, _, _, objconst = prelp(fname)
    return A.T.tocsc(), b, c, {"l": A.shape[1]}, objconst
