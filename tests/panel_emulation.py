"""Plain-torch emulations of the Schur-panel kernels' order of operations.

K14 (csrc/panel_chol.cu) and K15 (csrc/panel_solve.cu) are built from the
tile kernels' pieces, so their arithmetic is tile_emulation's, step for
step (one rounding per product and per sum, as the kernels do under nvcc
--fmad=false):

* K14, one block column: the diagonal block by K8's blocked right-looking
  order (chol_blocked), each block below by K8's off-tile solve
  (off_solve), no explicit inverse; NaN from block j on when the pivot
  chain fails, 0 above;
* K15's forward step: the row-panel product in column groups of
  FWD_GROUP (each group's rows summed as K10's scatter sums a tile row,
  row_dots; the groups added in order), then K10's fwd_diag;
* K15's backward contribution: the rows in groups of BWD_GROUP (each as
  K10's partials, col_dots; the groups added in order);
* K15's back solve: K10's bwd_diag of bj - contrib.

The group sizes fix every sum's order whatever the kernels' grid, so on
the CPU these show what the kernels compute against the plain versions and
the reference, and on the card the kernels are held to them bit for bit.
The kernels form their quotients by one reciprocal and two fma
corrections (csrc/div_rn.cuh), the IEEE quotient bit for bit where that
rule's range holds and the division itself where it does not, and K14's
one-launch schedule keeps every entry's order; so the emulation divides.

Two modes, by the inputs' dtype (all alike): float64 emulates K14/K15,
float32 their f32 builds K14-f32/K15-f32 (the f32 phase of the precision
ladder under a mesh).  Every product, sum, division and square root is
then one IEEE f32 operation, as in the kernels (nvcc --fmad=false, IEEE
division and square root); tile_emulation's square root is numpy's,
correctly rounded in either type.  jax-free: the card tests import it too.
"""

from __future__ import annotations

import torch

import tile_emulation as emu

FWD_GROUP = 128   # columns of the forward step's row product per partial
BWD_GROUP = 64    # rows of the backward contribution per partial
MODES = (torch.float64, torch.float32)   # K14/K15, K14-f32/K15-f32


def _mode(*tensors: torch.Tensor) -> None:
    """The emulation's mode is its inputs' dtype: f64 or f32, all alike
    (no operation widens or narrows)."""
    dts = {t.dtype for t in tensors}
    if len(dts) != 1 or not dts <= set(MODES):
        raise ValueError(f"the panel emulation takes float64 or float32 "
                         f"inputs of one dtype, got {sorted(map(str, dts))}")


def _in_order(parts: list, n: int, like: torch.Tensor) -> torch.Tensor:
    """((p0 + p1) + p2) + ..., or zeros when there is no part."""
    if not parts:
        return torch.zeros(n, dtype=like.dtype)
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


def chol_column(C: torch.Tensor, j: int) -> torch.Tensor:
    """K14: Lcol [nb, bs, bs] of the gathered block column C."""
    _mode(C)
    nb, bs, _ = C.shape
    out = torch.zeros_like(C)
    A, ok = emu.chol_blocked(torch.tril(C[j]))
    if not ok:
        out[j:] = float("nan")
        return out
    Ljj = torch.tril(A)
    out[j] = Ljj
    for k in range(j + 1, nb):
        out[k] = emu.off_solve(C[k], Ljj)
    return out


def fwd_step(row: torch.Tensor, x: torch.Tensor, bj: torch.Tensor,
             j: int) -> torch.Tensor:
    """K15's forward step: xj = Ljj^-1 (bj - row[:, :j bs] x)."""
    _mode(row, x, bj)
    bs = row.shape[0]
    k0 = j * bs
    parts = [emu.row_dots(row[:, g:min(g + FWD_GROUP, k0)],
                          x[g:min(g + FWD_GROUP, k0)])
             for g in range(0, k0, FWD_GROUP)]
    return emu.fwd_diag(row[:, k0:k0 + bs], bj - _in_order(parts, bs, row))


def bwd_contrib(L3: torch.Tensor, x: torch.Tensor, bs: int, g0: int,
                j: int) -> torch.Tensor:
    """K15's backward contribution: sum over the local block rows g > j of
    L[g, j]' x_g."""
    _mode(L3, x)
    nb_loc = L3.shape[0] // bs
    r0 = max(j - g0 + 1, 0)
    T = L3[r0 * bs:, j * bs:(j + 1) * bs]
    v = x[(g0 + r0) * bs:(g0 + nb_loc) * bs]
    parts = [emu.col_dots(T[g:g + BWD_GROUP], v[g:g + BWD_GROUP])
             for g in range(0, T.shape[0], BWD_GROUP)]
    return _in_order(parts, bs, L3)


def bwd_solve(Ljj: torch.Tensor, bj: torch.Tensor,
              contrib: torch.Tensor) -> torch.Tensor:
    """K15's back solve: xj = Ljj^-T (bj - contrib)."""
    _mode(Ljj, bj, contrib)
    return emu.bwd_diag(Ljj, bj - contrib)


def dist_cholesky(M: torch.Tensor, bs: int, step=None,
                  n: int = 1) -> torch.Tensor:
    """The block-cyclic factor's arithmetic in one process: per block
    column K14's step (or `step(C, j)`: the CPU path's plain version),
    then dist_cholesky's trailing update (torch) on the rows below, one
    product for each of n ranks' block-cyclic rows as the port forms it
    (a library product's sums may depend on its row count); the strict
    upper triangle 0.  With the port's n, rank p's contiguous panel of
    its factor is rows p mp/n on of this, bit for bit."""
    step = step or chol_column
    mp = M.shape[0]
    nb = mp // bs
    A = M.clone().reshape(nb, bs, mp)
    for j in range(nb):
        cols = slice(j * bs, (j + 1) * bs)
        Lcol = step(A[:, :, cols].contiguous(), j)
        W = Lcol.reshape(mp, bs)
        for d in range(n):
            rows = [g for g in range(d, nb, n) if g > j]
            if rows:
                A[rows] -= torch.einsum("rab,kb->rak", Lcol[rows], W)
        A[j:, :, cols] = Lcol[j:]
    return torch.tril(A.reshape(mp, mp))


def dist_solve(L: torch.Tensor, b: torch.Tensor, bs: int,
               n: int) -> torch.Tensor:
    """L L' x = b by K15's steps as n contiguous row panels take them in
    _dist_trisolve, in one process: a forward step has one owner, and the
    backward contributions are added in rank order from zero."""
    mp = L.shape[0]
    nb = mp // bs
    nb_loc = nb // n
    y = torch.zeros(mp, dtype=L.dtype)
    for j in range(nb):
        y[j * bs:(j + 1) * bs] = fwd_step(L[j * bs:(j + 1) * bs], y,
                                          b[j * bs:(j + 1) * bs], j)
    x = torch.zeros(mp, dtype=L.dtype)
    for j in range(nb - 1, -1, -1):
        blk = slice(j * bs, (j + 1) * bs)
        c = torch.zeros(bs, dtype=L.dtype)
        for p in range(n):
            c = c + bwd_contrib(L[p * nb_loc * bs:(p + 1) * nb_loc * bs], x,
                                bs, p * nb_loc, j)
        x[blk] = bwd_solve(L[blk, blk], y[blk], c)
    return x
