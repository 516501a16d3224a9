"""Plain-torch emulations of the tile kernels' order of operations.

K8 (csrc/tile_chol.cu) and K10 (csrc/tile_solve.cu) are blocked in panels
of 32 and sum in fixed orders; these functions repeat their arithmetic
step for step (one rounding per product and per sum, as the kernels do
under nvcc --fmad=false), so on the CPU they show that the blocked order
solves the same systems as the plain versions and the reference, and on
the card the kernels can be held to them bit for bit.  K9
(csrc/tile_update.cu) multiplies on the tensor cores, whose inner order
is the card's: tile_update repeats its work list (chunk sums, a split
destination's sums added in chunk order) with torch's products.
jax-free: the card tests import it too.
"""

from __future__ import annotations

import numpy as np
import torch

PANEL = 32      # panel width of K8 and K10
NWARPS = 8      # K10's warps per block (the partials' row split)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded, as the card's sqrt is (torch's CPU sqrt can miss
    by an ulp)."""
    return torch.as_tensor(np.sqrt(x.numpy()))


def panels(B: int):
    """(start, width) of the panels of a B x B tile."""
    return [(p0, min(PANEL, B - p0)) for p0 in range(0, B, PANEL)]


# ---------------------------------------------------------------- K10


def fwd_diag(Ld: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y <- Ld^-1 y as K10 does it: per panel the triangle by substitution
    (a division per row), then each row below takes the panel's sum
    s = ((0 + l_0 y_0) + l_1 y_1) + ... and y_r - s."""
    y = y.clone()
    B = y.numel()
    for p0, P in panels(B):
        for c in range(P):
            k = p0 + c
            y[k] = y[k] / Ld[k, k]
            y[k + 1:p0 + P] = y[k + 1:p0 + P] - Ld[k + 1:p0 + P, k] * y[k]
        if p0 + P < B:
            s = torch.zeros(B - p0 - P, dtype=y.dtype)
            for c in range(P):
                s = s + Ld[p0 + P:, p0 + c] * y[p0 + c]
            y[p0 + P:] = y[p0 + P:] - s
    return y


def bwd_diag(Ld: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """z <- Ld^-T z as K10 does it, panels from the bottom."""
    z = z.clone()
    B = z.numel()
    for p0, P in reversed(panels(B)):
        for c in reversed(range(P)):
            k = p0 + c
            z[k] = z[k] / Ld[k, k]
            z[p0:k] = z[p0:k] - Ld[k, p0:k] * z[k]
        if p0:
            s = torch.zeros(p0, dtype=z.dtype)
            for c in range(P):
                s = s + Ld[p0 + c, :p0] * z[p0 + c]
            z[:p0] = z[:p0] - s
    return z


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """[..., B] -> [..., 32, nt]: entry b at lane b % 32, step b // 32,
    zero-padded to whole warps."""
    B = x.shape[-1]
    nt = -(-B // 32)
    pad = torch.zeros(*x.shape[:-1], 32 * nt - B, dtype=x.dtype)
    return torch.cat([x, pad], -1).reshape(*x.shape[:-1], nt, 32).mT


def row_dots(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """T v as K10's scatter forms it: lane l sums T[a, l + 32 t] v[l + 32 t]
    over t, then the warp's shuffle-down tree (16, 8, 4, 2, 1) to lane 0."""
    Tl, vl = _lanes(T), _lanes(v)
    s = torch.zeros(T.shape[0], 32, dtype=T.dtype)
    for t in range(Tl.shape[-1]):
        s = s + Tl[..., t] * vl[..., t]
    for off in (16, 8, 4, 2, 1):
        s = torch.cat([s[:, :off] + s[:, off:2 * off], s[:, off:]], 1)
    return s[:, 0]


def col_dots(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """T' v as K10's partials form it: warp w sums rows w, w + 8, ... in
    order, then the eight warps' sums are added in warp order."""
    B = T.shape[0]
    red = []
    for w in range(NWARPS):
        s = torch.zeros(T.shape[1], dtype=T.dtype)
        for a in range(w, B, NWARPS):
            s = s + T[a] * v[a]
        red.append(s)
    t = red[0]
    for s in red[1:]:
        t = t + s
    return t


def tile_solve(L: torch.Tensor, rhs: torch.Tensor, flat: dict) -> torch.Tensor:
    """L L' x = rhs in K10's order, from the flattened level arrays."""
    B = L.shape[-1]
    f = {k: v.tolist() for k, v in flat.items() if k != "bar"}
    y = rhs.reshape(-1, B).clone()
    nlev = len(f["lev_cols"]) - 1
    for l in range(nlev):
        for j in range(f["lev_cols"][l], f["lev_cols"][l + 1]):
            y[f["cols"][j]] = fwd_diag(L[f["dslot"][j]], y[f["cols"][j]])
        for d in range(f["lev_fs"][l], f["lev_fs"][l + 1]):
            acc = torch.zeros(B, dtype=L.dtype)
            for q in range(f["fs_ptr"][d], f["fs_ptr"][d + 1]):
                acc = acc + row_dots(L[f["fs_slot"][q]], y[f["fs_col"][q]])
            r = f["fs_row"][d]
            y[r] = y[r] - acc
    part = torch.zeros(len(f["off_slot"]), B, dtype=L.dtype)
    for l in reversed(range(nlev)):
        for o in range(f["lev_off"][l], f["lev_off"][l + 1]):
            part[o] = col_dots(L[f["off_slot"][o]], y[f["off_row"][o]])
        for j in range(f["lev_cols"][l], f["lev_cols"][l + 1]):
            corr = torch.zeros(B, dtype=L.dtype)
            for o in range(f["col_off"][j], f["col_off"][j + 1]):
                corr = corr + part[o]
            c = f["cols"][j]
            y[c] = bwd_diag(L[f["dslot"][j]], y[c] - corr)
    return y.reshape(-1)


# ---------------------------------------------------------------- K8


def chol_blocked(A: torch.Tensor):
    """K8's blocked right-looking Cholesky of A's lower triangle, in place:
    per panel the diagonal block (warp 0), the rows below (TRSM), the
    trailing rank-P update (SYRK), each entry updated one product at a
    time in k order.  Returns (A, ok), ok False at the first pivot not in
    (0, inf)."""
    B = A.shape[0]
    inf = float("inf")
    for p0, P in panels(B):
        e = p0 + P
        for j in range(p0, e):
            piv = float(A[j, j])
            if not (0.0 < piv < inf):
                return A, False
            ljj = _sqrt(A[j, j])
            A[j, j] = ljj
            A[j + 1:e, j] = A[j + 1:e, j] / ljj
            for t in range(j + 1, e):
                A[t:e, t] = A[t:e, t] - A[t:e, j] * A[t, j]
        if e >= B:
            break
        for c in range(p0, e):
            A[e:, c] = A[e:, c] / A[c, c]
            for t in range(c + 1, e):
                A[e:, t] = A[e:, t] - A[e:, c] * A[t, c]
        for k in range(p0, e):
            A[e:, e:] = A[e:, e:] - A[e:, k, None] * A[None, e:, k]
    return A, True


def _nanmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a if bool(a > b) or bool(torch.isnan(a)) else b


def diag_factor(tile: torch.Tensor, reg: float, canceltol: float):
    """K8's diagonal tile: (L_D, rung), constants rounded to the tile's
    dtype as the kernel rounds them."""
    dt = tile.dtype
    B = tile.shape[0]
    dmax = torch.zeros((), dtype=dt)
    for i in range(B):
        dmax = _nanmax(dmax, torch.abs(tile[i, i]))
    lift = _nanmax(torch.tensor(reg, dtype=dt),
                   torch.tensor(canceltol, dtype=dt) * dmax) \
        + torch.tensor(1e-300, dtype=dt)
    up = dmax + torch.ones((), dtype=dt)
    A = torch.tril(tile).clone()
    idx = torch.arange(B)
    A[idx, idx] = A[idx, idx] + lift
    A, ok = chol_blocked(A)
    if ok:
        return torch.tril(A), 0
    A = torch.tril(tile).clone()
    A[idx, idx] = (A[idx, idx] + lift) + up
    A, ok = chol_blocked(A)
    if ok:
        return torch.tril(A), 1
    return torch.diag(_sqrt(torch.abs(torch.diagonal(tile) + lift)
                            + up)), 2


def off_solve(T: torch.Tensor, Ld: torch.Tensor) -> torch.Tensor:
    """X = T Ld^-T as K8's off part does it (rows are independent): per
    column panel, column by column, the division, then the column's
    products into the panel's later columns; then the panel's products
    into the remaining columns, one at a time in k order."""
    X = T.clone()
    B = T.shape[1]
    for p0, P in panels(B):
        e = p0 + P
        for c in range(p0, e):
            X[:, c] = X[:, c] / Ld[c, c]
            for t in range(c + 1, e):
                X[:, t] = X[:, t] - X[:, c] * Ld[t, c]
        for k in range(p0, e):
            X[:, e:] = X[:, e:] - X[:, k, None] * Ld[None, e:, k]
    return X


def tile_factor(st: torch.Tensor, lv: dict, reg: float,
                canceltol: float = 1e-12) -> torch.Tensor:
    """One level of K8 in its order, in place; returns the rungs."""
    rungs = []
    for d in lv["dslot"].tolist():
        st[d], r = diag_factor(st[d], reg, canceltol)
        rungs.append(r)
    for s, d in zip(lv["off_slot"].tolist(), lv["off_dslot"].tolist()):
        st[s] = off_solve(st[s], st[d])
    return torch.tensor(rungs, dtype=torch.int32)


# ----------------------------------------------------------------- K9


def tile_update(st: torch.Tensor, lv: dict) -> None:
    """One level of K9 over its work list (sparse_chol.update_chunks), in
    place: each chunk's sum over its pairs in plan order; a destination
    of one chunk subtracts it, a split one subtracts its chunks' sums
    added in chunk order (its scratch slots, dst_part and part_chunk)."""
    ptr, a, b = lv["chunk_ptr"], lv["pair_a"], lv["pair_b"]
    sums = []
    for i in range(lv["chunk_dst"].numel()):
        s = torch.zeros_like(st[0])
        for p in range(int(ptr[i]), int(ptr[i + 1])):
            s = s + st[a[p]] @ st[b[p]].mT
        sums.append(s)
    for d in range(lv["pair_dst"].numel()):
        c0, c1 = int(lv["dst_chunk"][d]), int(lv["dst_chunk"][d + 1])
        slot = int(lv["dst_part"][d])
        if slot < 0:
            total = sums[c0]
        else:
            chunks = lv["part_chunk"][slot:slot + c1 - c0].tolist()
            total = sums[chunks[0]]
            for c in chunks[1:]:
                total = total + sums[c]
        st[lv["pair_dst"][d]] -= total
