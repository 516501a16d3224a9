"""Numpy emulations of K1's and K11's order of operations.

K1 (csrc/dd_residual.cu, pcg.dd_matvec_residual) and K11
(csrc/df_gemv.cu, df.df_matvec / df.df_vecmat) fix who sums which
elements and in what order; these functions repeat that arithmetic step
for step (one rounding per product and per sum, as the kernels do under
nvcc --fmad=false; a product's exact error by Dekker's split, which
equals the kernels' fma(a, b, -p) whenever the split does not overflow),
so on the CPU they show that the order meets the reference's error
bounds, and on the card the kernels can be held to them bit for bit.
jax-free: the card tests and chip_smoke.py import it too.

The alignment peel (row_peel): a row starts `phase + i lda` elements past
a 16-byte boundary (phase = the pointer's offset in elements, lda the
row stride).  Its first h elements, up to the boundary (at most n), are
the head; the next nv W-wide vectors (W = 16 bytes / element size) the
body; the last tl < W elements the tail.

K1, residual(): a row is cut into `parts` parts (a power of two from 32
to 256; on the card one or more warps play them, csrc/dd_residual.cu).
Part t takes head element t (t < h) first, then body vectors t,
t + parts, ... in ascending order (each vector's W elements in order),
then tail element t (t < tl).  Each element adds M_ij v_j into (s, comp,
elo): p + e = M_ij v_j exactly, TwoSum(s, p) = s' + err, comp += err,
elo += e; with `lo`, also q += M_ij lo_j (one rounding each).  The
partials merge by a shuffle tree inside each group of 32 parts (part l
takes part l + off, or its own where l + off >= 32, for off = 16, 8, 4,
2, 1) and then across the row's groups (group g takes group g + off for
off = nw/2, ..., 1, nw = parts / 32): TwoSum on s, comp' = (comp +
comp2) + err, elo and q by plain sums.  Then r = d + (derr - (comp + elo)) with d + derr = TwoSum(rhs,
-s), and with `lo`, r - q.

K11, df_matvec(): a warp owns a (row, slab): the row's body is cut into
`nslab` slabs of `vps` float4 vectors; the warp's lane l takes the
slab's vectors l, l + 32, ... in ascending order, slab 0 also head
element l (l < h) first and the last slab tail element l (l < tl) last.
Each element is df_madd; the lanes merge by the shuffle tree of df_add,
and the slabs' partials in ascending slab order (the first partial, then
df_add of each next one).

K11, df_vecmat(): a thread owns four adjacent columns; the rows are cut
into `nslab` slabs of `rps` rows, each summed in ascending row order by
df_madd, and the slabs' partials merge in ascending slab order.  The
loads' width (float4 or scalars, by the rows' alignment) does not change
the arithmetic, so no peel enters the order.
"""

from __future__ import annotations

import numpy as np

LANES = 32


def two_sum(a, b):
    s = a + b
    v = s - a
    return s, (a - (s - v)) + (b - v)


def _split(a):
    c = a.dtype.type(134217729.0 if a.dtype == np.float64 else 4097.0) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """(p, e) with p + e = a b exactly (Dekker, in a's dtype)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def phase_of(t) -> int:
    """A tensor's offset past a 16-byte boundary, in elements."""
    return (t.data_ptr() % 16) // t.element_size()


def row_peel(m: int, n: int, W: int, phase: int = 0, lda: int | None = None):
    """(h, nv, tl) per row: head elements to the 16-byte boundary, W-wide
    body vectors, tail elements."""
    lda = n if lda is None else lda
    mis = (phase + np.arange(m, dtype=np.int64) * lda) % W
    h = np.minimum((W - mis) % W, n)
    nv = (n - h) // W
    return h, nv, n - h - nv * W


def _where(mask, new, old):
    return tuple(np.where(mask, a, b) for a, b in zip(new, old))


# ----------------------------------------------------------------- K1


def _k1_add(acc, a, b, l, mask):
    s, comp, elo, q = acc
    p, e = two_prod(a, b)
    t, err = two_sum(s, p)
    new = (t, comp + err, elo + e, q + a * l)
    return _where(mask, new, acc)


def _k1_merge(acc, src):
    s, comp, elo, q = acc
    s2, c2, e2, q2 = (x[..., src] for x in acc)
    t, err = two_sum(s, s2)
    return t, (comp + c2) + err, elo + e2, q + q2


def residual(M, v, rhs, lo=None, parts: int = 32, phase: int = 0,
             lda: int | None = None):
    """K1's rhs - M v (with `lo`: minus the plain sum of M lo) in its
    order; M [m, n], v [n], rhs [m] numpy f64 or f32 (one dtype)."""
    M = np.asarray(M)
    dt = M.dtype
    v, rhs = np.asarray(v, dt), np.asarray(rhs, dt)
    lov = np.zeros_like(v) if lo is None else np.asarray(lo, dt)
    m, n = M.shape
    W = 16 // dt.itemsize
    if parts < LANES or parts > 256 or parts & (parts - 1):
        raise ValueError(f"parts={parts}: a power of two from 32 to 256")
    out = np.empty(m, dt)
    heads, nvs, tls = row_peel(m, n, W, phase, lda)
    thr = np.arange(parts)
    for h in np.unique(heads):
        rows = np.nonzero(heads == h)[0]
        nv, tl = int(nvs[rows[0]]), int(tls[rows[0]])
        A = M[rows]
        zero = np.zeros((rows.size, parts), dt)
        acc = (zero, zero, zero, zero)

        def step(j, mask):
            jj = np.clip(j, 0, max(n - 1, 0))
            return _k1_add(acc, A[:, jj], v[jj], lov[jj], mask[None, :])

        if h:
            acc = step(thr, thr < h)
        for r in range(-(-nv // parts)):
            k = r * parts + thr
            for c in range(W):
                acc = step(h + k * W + c, k < nv)
        if tl:
            acc = step(h + nv * W + thr, thr < tl)
        acc = tuple(x.reshape(rows.size, parts // LANES, LANES)
                    for x in acc)
        lanes = np.arange(LANES)
        for off in (16, 8, 4, 2, 1):
            acc = _k1_merge(acc, np.where(lanes + off < LANES, lanes + off,
                                          lanes))
        acc = tuple(x[..., 0] for x in acc)       # [rows, nw]
        nw = parts // LANES
        warps = np.arange(nw)
        off = nw // 2
        while off:
            acc = _k1_merge(acc, np.where(warps + off < nw, warps + off,
                                          warps))
            off //= 2
        s, comp, elo, q = (x[:, 0] for x in acc)
        d, derr = two_sum(rhs[rows], -s)
        r = d + (derr - (comp + elo))
        out[rows] = r - q if lo is not None else r
    return out


# ---------------------------------------------------------------- K11


def df_madd(ah, al, xh, xl, s, t):
    """(s, t) + (ah + al)(xh + xl) as the kernels' df_madd."""
    p, e = two_prod(ah, xh)
    c = (e + ah * xl) + al * xh
    s1, err = two_sum(s, p)
    t = t + (err + c)
    return two_sum(s1, t)


def df_add(s2, t2, s, t):
    h, err = two_sum(s, s2)
    t = (t + t2) + err
    return two_sum(h, t)


def _merge_slabs(S, T):
    """Partials [..., nslab] merged in ascending slab order."""
    s, t = S[..., 0], T[..., 0]
    for k in range(1, S.shape[-1]):
        s, t = df_add(S[..., k], T[..., k], s, t)
    return s, t


def df_matvec(Ah, Al, xh, xl, nslab: int, vps: int, phase: int = 0,
              lda: int | None = None):
    """K11's y = A x in df, (hi, lo) f32: A [rows, n], x [n]."""
    f = np.float32
    Ah, Al = np.asarray(Ah, f), np.asarray(Al, f)
    xh, xl = np.asarray(xh, f), np.asarray(xl, f)
    rows, n = Ah.shape
    yh, yl = np.empty(rows, f), np.empty(rows, f)
    heads, nvs, tls = row_peel(rows, n, 4, phase, lda)
    lanes = np.arange(LANES)
    slabs = np.arange(nslab)[:, None]
    for h in np.unique(heads):
        rr = np.nonzero(heads == h)[0]
        nv, tl = int(nvs[rr[0]]), int(tls[rr[0]])
        a_h, a_l = Ah[rr], Al[rr]
        s = np.zeros((rr.size, nslab, LANES), f)
        t = np.zeros_like(s)

        def step(j, mask, s, t):
            jj = np.clip(j, 0, max(n - 1, 0))
            new = df_madd(a_h[:, jj], a_l[:, jj], xh[jj], xl[jj], s, t)
            return _where(mask[None], new, (s, t))

        if h:
            s, t = step(np.broadcast_to(lanes, (nslab, LANES)),
                        (slabs == 0) & (lanes < h), s, t)
        v0 = slabs * vps
        v1 = np.minimum(v0 + vps, nv)
        for r in range(-(-vps // LANES)):
            k = v0 + r * LANES + lanes
            for c in range(4):
                s, t = step(h + 4 * k + c, k < v1, s, t)
        if tl:
            s, t = step(np.broadcast_to(h + 4 * nv + lanes, (nslab, LANES)),
                        (slabs == nslab - 1) & (lanes < tl), s, t)
        for off in (16, 8, 4, 2, 1):
            src = np.where(lanes + off < LANES, lanes + off, lanes)
            s, t = df_add(s[..., src], t[..., src], s, t)
        yh[rr], yl[rr] = _merge_slabs(s[..., 0], t[..., 0])
    return yh, yl


def df_vecmat(xh, xl, Ah, Al, nslab: int, rps: int):
    """K11's y = x A in df, (hi, lo) f32: x [rows], A [rows, n]."""
    f = np.float32
    Ah, Al = np.asarray(Ah, f), np.asarray(Al, f)
    xh, xl = np.asarray(xh, f), np.asarray(xl, f)
    rows, n = Ah.shape
    s = np.zeros((n, nslab), f)
    t = np.zeros_like(s)
    for r in range(rps):
        i = np.arange(nslab) * rps + r
        live = i < rows
        ii = np.minimum(i, rows - 1)
        new = df_madd(Ah[ii].T, Al[ii].T, xh[ii], xl[ii], s, t)
        s, t = _where(live[None, :], new, (s, t))
    return _merge_slabs(s, t)
