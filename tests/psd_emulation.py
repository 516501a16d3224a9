"""Numpy emulation of kernel K2's order of operations (csrc/psd_coo.cu).

K2 forms the scaled operator B~ of a (constraint, block) group,

    B~_g[a, e] = sum_t gv_t W[p_t, a] W[q_t, e],

only at the locations its gather reads, and then the Schur entries

    M[i, j] = sum_{t in row i} b_val_t B~_{(j, blk_t)}[loc_t]

(a missing group of row j in block blk reads zeros).  Each entry keeps
one order: pa = W[p_t, a] * gv_t rounded, then acc = fma(pa, W[q_t, e],
acc) for t ascending from 0 over the padded group (padded slots have
gv = 0 and still run); the gather takes t ascending over row i with
acc += B * b_val, the product rounded before the sum.  The sparse
engine's pair entry forms B~_g at its pairs (group sp_g, flat location
sp_loc) and multiplies by sp_val.

exact=True runs that order with an exact fma (the product and sum in exact
rational arithmetic, integers scaled by a power of two, rounded once to the
working type: f64 or f32), so the card's kernels can be held
to it bit for bit on small buckets; exact=False runs the same order
vectorized in numpy with the fma's product rounded (for tolerance checks
at a real bucket's size).  contrib_coo builds the needed locations from
b_loc alone (np.unique); contrib_chunks walks the port's own arrays
(opA.needed_entries: items, chunks, b_uidx, g_of) chunk by chunk as the
kernel does, the sums M[i, j] carried from chunk to chunk, so the two
agree bit for bit exactly when those arrays are right (here each chunk
adds zero products for the other chunks' entries, where the kernel skips
them: a sum that starts at +0 is never -0, so the bits are the same).  jax-free: the
card tests import it.
"""

from __future__ import annotations

import math
import numpy as np


def _scaled(x: float):
    """(m, e) with x = m 2^e exactly, m an integer."""
    f, e = math.frexp(x)
    return int(f * 2.0**53), e - 53


def round_to(S: int, E: int, dtype) -> float:
    """S 2^E (exact integers) rounded to nearest-even in f64 or f32, normal
    or subnormal (no overflow)."""
    p, emin = (53, -1022) if np.dtype(dtype) == np.float64 else (24, -126)
    neg, S = S < 0, abs(S)
    e = max(S.bit_length() - 1 + E, emin)      # the result's exponent
    shift = e - p + 1 - E                      # its ulp over 2^E
    if shift > 0:
        q, r = S >> shift, S & ((1 << shift) - 1)
        half = 1 << (shift - 1)
        if r > half or (r == half and q & 1):
            q += 1
        S, E = q, E + shift
    val = math.ldexp(S, E)                     # exact: S has <= p + 1 bits
    return -val if neg else val


def fma(a, b, c, dtype):
    """a b + c rounded once to dtype (a, b, c finite values of dtype):
    the product and the sum exact in integers scaled by a power of two
    (exact rational arithmetic), one rounding at the end."""
    dt = np.dtype(dtype).type
    a, b, c = float(a), float(b), float(c)
    (ma, ea), (mb, eb), (mc, ec) = _scaled(a), _scaled(b), _scaled(c)
    mp, ep = ma * mb, ea + eb
    if mp == 0 and mc == 0:    # -0 only for (-0) + (-0)
        neg = math.copysign(1.0, a) * math.copysign(1.0, b) < 0 \
            and math.copysign(1.0, c) < 0
        return dt(-0.0 if neg else 0.0)
    E = min(ep if mp else ec, ec if mc else ep)
    S = (mp << (ep - E) if mp else 0) + (mc << (ec - E) if mc else 0)
    return dt(round_to(S, E, dtype)) if S else dt(0.0)


def entry(Wb, p, q, gv, a, e, dtype, exact=True):
    """B~[a, e] of one group: rows p, q and values gv of its padded
    slots, Wb its block of W."""
    dt = np.dtype(dtype).type
    acc = dt(0.0)
    for pt, qt, vt in zip(p, q, gv):
        pa = dt(Wb[pt, a]) * dt(vt)
        if exact:
            acc = fma(pa, Wb[qt, e], acc, dtype)
        else:
            acc = dt(acc + dt(pa * dt(Wb[qt, e])))
    return acc


def contrib_coo(part: dict, k: int, d: int, mp1: int, W, dtype=np.float64,
                exact: bool = True) -> np.ndarray:
    """M [mp1, mp1] of one COO bucket in K2's order; part holds numpy
    arrays (b_row, b_loc, b_val, b_rowptr, g_row, g_blk, gp, gq, gv)."""
    W = np.asarray(W, dtype)
    b_loc = np.asarray(part["b_loc"])
    b_val = np.asarray(part["b_val"], dtype)
    rowptr = np.asarray(part["b_rowptr"])
    g_row, g_blk = np.asarray(part["g_row"]), np.asarray(part["g_blk"])
    gp, gq = np.asarray(part["gp"]), np.asarray(part["gq"])
    gv = np.asarray(part["gv"], dtype)
    dd = d * d
    U = np.unique(b_loc)
    uidx = np.searchsorted(U, b_loc)
    blkU, aU, eU = U // dd, (U % dd) // d, U % d
    vals = np.zeros((mp1, U.size), dtype)      # B~_j at U (zeros: no group)
    for blk in range(k):
        ub = np.flatnonzero(blkU == blk)
        gs = np.flatnonzero(g_blk == blk)
        if not ub.size or not gs.size:
            continue
        Wb = W[blk]
        if exact:
            for g in gs:
                for u in ub:
                    vals[g_row[g], u] = entry(Wb, gp[g], gq[g], gv[g],
                                              aU[u], eU[u], dtype)
            continue
        acc = np.zeros((gs.size, ub.size), dtype)
        for t in range(gp.shape[1]):
            pa = Wb[gp[gs, t]][:, aU[ub]] * gv[gs, t][:, None]
            acc = acc + pa * Wb[gq[gs, t]][:, eU[ub]]
        vals[np.ix_(g_row[gs], ub)] = acc
    M = np.zeros((mp1, mp1), dtype)
    counts = np.diff(rowptr)
    for s in range(int(counts.max()) if counts.size else 0):
        rows = np.flatnonzero(counts > s)
        t = rowptr[rows] + s
        M[rows, :] = M[rows, :] + vals[:, uidx[t]].T * b_val[t][:, None]
    return M


def contrib_chunks(part: dict, k: int, d: int, mp1: int, W,
                   dtype=np.float64, exact: bool = True) -> np.ndarray:
    """contrib_coo's M, walking opA.needed_entries' chunks and items as
    the kernel does: each chunk's entries formed item by item, then every
    row's sum continued over all its entries, with zero products for the
    entries outside the chunk."""
    W = np.asarray(W, dtype)
    b_row, b_uidx = np.asarray(part["b_row"]), np.asarray(part["b_uidx"])
    b_val = np.asarray(part["b_val"], dtype)
    gp, gq = np.asarray(part["gp"]), np.asarray(part["gq"])
    gv = np.asarray(part["gv"], dtype)
    u_e, it = np.asarray(part["u_e"]), np.asarray(part["it"])
    ch = np.asarray(part["ch"])
    g_of = np.asarray(part["g_of"]).reshape(mp1, k)
    M = np.zeros((mp1, mp1), dtype)
    rows = b_row
    first = np.r_[True, rows[1:] != rows[:-1]]
    pos = np.arange(rows.size) - np.flatnonzero(first)[np.cumsum(first) - 1]
    for c in range(ch.shape[0] - 1):
        (i0, u0, a_lo, a_hi), (i1, u1) = ch[c], ch[c + 1, :2]
        blk = it[i0, 0] // d
        a = np.empty(u1 - u0, np.int64)
        for ab, ua, n in it[i0:i1]:
            n = n & 15        # the slots' rotation changes no arithmetic
            assert a_lo <= ab % d <= a_hi and ab // d == blk
            a[ua - u0:ua - u0 + n] = ab % d
        e = u_e[u0:u1]
        vals = np.zeros((mp1, u1 - u0), dtype)
        js = np.flatnonzero(g_of[:, blk] >= 0)
        gs = g_of[js, blk]
        Wb = W[blk]
        if exact:
            for j, g in zip(js, gs):
                for x in range(u1 - u0):
                    vals[j, x] = entry(Wb, gp[g], gq[g], gv[g], a[x], e[x],
                                       dtype)
        elif js.size:
            acc = np.zeros((js.size, u1 - u0), dtype)
            for t in range(gp.shape[1]):
                pa = Wb[gp[gs, t]][:, a] * gv[gs, t][:, None]
                acc = acc + pa * Wb[gq[gs, t]][:, e]
            vals[js] = acc
        inside = (b_uidx >= u0) & (b_uidx < u1)
        prod = np.zeros((b_uidx.size, mp1), dtype)      # [T, j]
        prod[inside] = vals[:, b_uidx[inside] - u0].T \
            * b_val[inside][:, None]
        for s in range(int(pos.max()) + 1 if pos.size else 0):
            t = np.flatnonzero(pos == s)
            M[rows[t], :] = M[rows[t], :] + prod[t]
    return M


def pair_values(W, g_blk, gp, gq, gv, sp_g, sp_loc, sp_val,
                dtype=np.float64, exact: bool = True) -> np.ndarray:
    """The sparse engine's pair values: B~_{sp_g}[sp_loc] * sp_val."""
    dt = np.dtype(dtype).type
    W = np.asarray(W, dtype)
    gv = np.asarray(gv, dtype)
    d = W.shape[-1]
    out = np.empty(len(sp_g), dtype)
    for n, (g, loc) in enumerate(zip(sp_g, sp_loc)):
        b = entry(W[g_blk[g]], gp[g], gq[g], gv[g], loc // d, loc % d,
                  dtype, exact)
        out[n] = dt(b * dt(sp_val[n]))
    return out
