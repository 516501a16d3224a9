"""Schur-panel parallelism: distributed block Cholesky and triangular
solves over one mesh axis, and the engine that uses them.

Counterpart of the reference's sedumi_tpu/parallel/panels.py.  The
reference runs these under shard_map on a jax mesh; here every rank of the
axis runs the same loop (SPMD) and exchanges blocks with the mesh's
collectives (all_reduce of zero-filled buffers: the reference's masked
psum).  The per-step bodies are kernels on the card:

* K14 (csrc/panel_chol.cu, panel_chol_step): one block column of the
  block-cyclic factor -- Ljj = chol(C[j]), Lcol = C Ljj^-T below the
  diagonal block (reference :75-87; the kernel solves against Ljj where
  the reference multiplies by its explicit inverse);
* K15 (csrc/panel_solve.cu): the substitution steps -- the owner's
  forward step (the row-panel product over a thread-block cluster, then
  the bs-triangle solve, :135-146), every rank's backward contribution
  (:156-162) and the backward triangle solve after the psum (:170-171).

On CPU tensors the same functions run their plain PyTorch versions
(*_plain); on a CUDA tensor they launch the kernel or raise.  The trailing
update (a [nb_loc bs, bs] x [bs, mp] product), the strict-upper zeroing
and ADA v are plain torch.

The formation is the replicated (or data-split, mesh.ShardedAOp) build:
every rank holds the whole padded matrix and factors its block-cyclic
rows (natural block k on the rank k mod n of the axis).  dist_cholesky
returns the factor in natural order on every rank, as the reference's
global array; _dist_trisolve reads only the rank's contiguous row panel.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..schur import build_schur
from .mesh import Mesh


def _pad_up(m: int, mult: int) -> int:
    return -(-m // mult) * mult


# --------------------------------------------------------------------------
# K14: one block column of the factor
# --------------------------------------------------------------------------


def panel_chol_plain(C: torch.Tensor, j: int) -> torch.Tensor:
    """Lcol [nb, bs, bs] from the gathered block column C (natural order):
    Lcol[j] = chol(C[j]) (all NaN if C[j] is not PD, as
    jnp.linalg.cholesky gives), Lcol[k] = C[k] Ljj^-T for k > j, 0 above."""
    nb, bs, _ = C.shape
    Ljj, info = torch.linalg.cholesky_ex(C[j])
    bad = (info != 0) | ~torch.all(torch.isfinite(Ljj))
    Ljj = torch.where(bad, torch.full_like(Ljj, float("nan")), Ljj)
    Linv = torch.linalg.solve_triangular(
        Ljj, torch.eye(bs, dtype=C.dtype, device=C.device), upper=False)
    Lcol = torch.einsum("kab,cb->kac", C, Linv)
    k = torch.arange(nb, device=C.device)[:, None, None]
    Lcol = torch.where(k > j, Lcol, torch.zeros((), dtype=C.dtype,
                                                device=C.device))
    return torch.where(k == j, Ljj[None], Lcol)


def _panel_chol_kernel(C: torch.Tensor, j: int) -> torch.Tensor:
    kernels.check_cuda(C, dtype=torch.float64)
    nb, bs, _ = C.shape
    if bs > 128:
        raise ValueError(f"panel_chol takes bs <= 128, got {bs}")
    Lcol = torch.empty_like(C)
    kernels.launch("panel_chol.cu", "panel_chol_launch", C.data_ptr(),
                   Lcol.data_ptr(), nb, bs, j)
    kernels.LAUNCHES["dist_panel_chol"] += 1
    return Lcol


def panel_chol_step(C: torch.Tensor, j: int) -> torch.Tensor:
    """One block column of dist_cholesky (K14 on the card)."""
    if C.is_cuda:
        return _panel_chol_kernel(C, j)
    return panel_chol_plain(C, j)


# --------------------------------------------------------------------------
# K15: the substitution steps
# --------------------------------------------------------------------------


def trisolve_fwd_plain(row: torch.Tensor, x: torch.Tensor, bj: torch.Tensor,
                       j: int) -> torch.Tensor:
    """xj = Ljj^-1 (bj - row x) for block row j of L, row [bs, mp]; x is
    zero at and beyond block j, so only its first j*bs entries count."""
    bs = row.shape[0]
    k0 = j * bs
    acc = row[:, :k0] @ x[:k0]
    return torch.linalg.solve_triangular(
        row[:, k0:k0 + bs], (bj - acc)[:, None], upper=False)[:, 0]


def trisolve_bwd_contrib_plain(L3: torch.Tensor, x: torch.Tensor, bs: int,
                               g0: int, j: int) -> torch.Tensor:
    """sum over the local block rows g > j of L[g, j]' x_g; L3 is the
    contiguous panel [nb_loc bs, mp] whose first block row is g0."""
    nb_loc = L3.shape[0] // bs
    r0 = max(j - g0 + 1, 0)
    if r0 >= nb_loc:
        return torch.zeros(bs, dtype=L3.dtype, device=L3.device)
    col = L3[r0 * bs:, j * bs:(j + 1) * bs]
    return x[(g0 + r0) * bs:(g0 + nb_loc) * bs] @ col


def trisolve_bwd_solve_plain(Ljj: torch.Tensor, bj: torch.Tensor,
                             contrib: torch.Tensor) -> torch.Tensor:
    """xj = Ljj^-T (bj - contrib)."""
    return torch.linalg.solve_triangular(
        Ljj.T, (bj - contrib)[:, None], upper=True)[:, 0]


def _check_bs(bs: int) -> None:
    if bs > 128:
        raise ValueError(f"the panel solve kernels take bs <= 128, got {bs}")


def _fwd_step_kernel(row, x, bj, j: int, ncta: int = 0) -> torch.Tensor:
    """K15's forward step on a cluster of ncta CTAs (0: one a column group
    of the row product, at most 8); the result does not depend on it."""
    kernels.check_cuda(row, x, bj, dtype=torch.float64)
    bs, mp = row.shape
    _check_bs(bs)
    xj = torch.empty(bs, dtype=row.dtype, device=row.device)
    kernels.launch("panel_solve.cu", "panel_fwd_step_launch", row.data_ptr(),
                   x.data_ptr(), bj.data_ptr(), xj.data_ptr(), bs, mp, j,
                   ncta)
    kernels.LAUNCHES["dist_trisolve_fwd"] += 1
    return xj


def trisolve_fwd_step(row, x, bj, j: int) -> torch.Tensor:
    """The owner's forward step (K15 fwd on the card)."""
    if not row.is_cuda:
        return trisolve_fwd_plain(row, x, bj, j)
    return _fwd_step_kernel(row, x, bj, j)


def _bwd_contrib_kernel(L3, x, bs: int, g0: int, j: int,
                        ncta: int = 0) -> torch.Tensor:
    """K15's backward contribution on clusters of ncta CTAs (0: one a row
    group, at most 8); the result does not depend on it."""
    kernels.check_cuda(L3, x, dtype=torch.float64)
    _check_bs(bs)
    contrib = torch.empty(bs, dtype=L3.dtype, device=L3.device)
    kernels.launch("panel_solve.cu", "panel_bwd_contrib_launch",
                   L3.data_ptr(), x.data_ptr(), contrib.data_ptr(), bs,
                   L3.shape[1], L3.shape[0] // bs, g0, j, ncta)
    kernels.LAUNCHES["dist_trisolve_bwd_contrib"] += 1
    return contrib


def trisolve_bwd_contrib(L3, x, bs: int, g0: int, j: int) -> torch.Tensor:
    """This rank's backward contribution (K15 bwd_contrib on the card)."""
    if not L3.is_cuda:
        return trisolve_bwd_contrib_plain(L3, x, bs, g0, j)
    return _bwd_contrib_kernel(L3, x, bs, g0, j)


def trisolve_bwd_solve(Ljj, bj, contrib) -> torch.Tensor:
    """The backward triangle solve (K15 bwd_solve on the card)."""
    if not Ljj.is_cuda:
        return trisolve_bwd_solve_plain(Ljj, bj, contrib)
    kernels.check_cuda(Ljj, bj, contrib, dtype=torch.float64)
    bs = Ljj.shape[0]
    _check_bs(bs)
    xj = torch.empty(bs, dtype=Ljj.dtype, device=Ljj.device)
    kernels.launch("panel_solve.cu", "panel_bwd_solve_launch",
                   Ljj.data_ptr(), bj.data_ptr(), contrib.data_ptr(),
                   xj.data_ptr(), bs)
    kernels.LAUNCHES["dist_trisolve_bwd_solve"] += 1
    return xj


# --------------------------------------------------------------------------
# the distributed factor and solves
# --------------------------------------------------------------------------


def dist_cholesky(Mp: torch.Tensor, mesh: Mesh, axis: str,
                  bs: int) -> torch.Tensor:
    """Cholesky of an SPD matrix with BLOCK-CYCLIC row ownership
    (reference panels.py:47): natural block row k is factored by the rank
    k mod n of the axis.  Mp: [mp, mp], mp divisible by n*bs, natural
    order, the same on every rank.  Returns the lower L with L L' = Mp in
    natural order on every rank (strict upper triangle exactly 0); no
    pivoting, a non-PD matrix gives NaN."""
    n = mesh.axis_size(axis)
    my = mesh.axis_index(axis)
    mp = Mp.shape[0]
    nb = mp // bs
    nb_loc = nb // n
    if nb_loc * n * bs != mp:
        raise ValueError(f"mp = {mp} is not a multiple of n*bs = {n * bs}")
    dev, dt = Mp.device, Mp.dtype
    g = [my + n * r for r in range(nb_loc)]     # natural block rows owned
    g_t = torch.tensor(g, device=dev)
    rows = (g_t[:, None] * bs + torch.arange(bs, device=dev)).reshape(-1)
    A = Mp[rows].reshape(nb_loc, bs, mp)
    for j in range(nb):
        cols = slice(j * bs, (j + 1) * bs)
        colj = A[:, :, cols].contiguous()
        # gathered [n, nb_loc, ...] rank-major: natural block r*n + d sits
        # at (d, r), so a transpose restores natural order
        C = mesh.all_gather(colj, axis).transpose(0, 1) \
            .reshape(nb, bs, bs).contiguous()
        Lcol = panel_chol_step(C, j)
        # trailing update A[g] -= Lcol[g] W' on the owned rows g > j (W is
        # the stacked column, zero above block j), then column j itself
        r_upd = sum(1 for gg in g if gg <= j)
        if r_upd < nb_loc:
            W = Lcol.reshape(mp, bs)
            A[r_upd:] -= torch.einsum("rab,kb->rak", Lcol[g_t[r_upd:]], W)
        r_new = sum(1 for gg in g if gg < j)
        if r_new < nb_loc:
            A[r_new:, :, cols] = Lcol[g_t[r_new:]]
    # zero the strict upper triangle the trailing updates leave behind
    A4 = A.reshape(nb_loc, bs, nb, bs)
    kb = torch.arange(nb, device=dev)[None, None, :, None]
    gb = g_t[:, None, None, None]
    r_in = torch.arange(bs, device=dev)[None, :, None, None]
    c_in = torch.arange(bs, device=dev)[None, None, None, :]
    keep = (kb < gb) | ((kb == gb) & (c_in <= r_in))
    Lloc = torch.where(keep, A4, torch.zeros((), dtype=dt, device=dev))
    # natural order on every rank: rank d's slot r holds block r*n + d
    full = mesh.all_gather(Lloc.reshape(nb_loc, bs, mp), axis)
    return full.transpose(0, 1).reshape(mp, mp)


def _dist_trisolve(L: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str,
                   bs: int, lower: bool) -> torch.Tensor:
    """Solve L x = b (lower=True) or L' x = b (lower=False) with each rank
    of the axis owning a CONTIGUOUS row panel of L (reference panels.py:
    117): per block step the owner solves its bs-triangle and the result
    is broadcast by a masked psum; backward, every rank adds its partial
    products and the owner its diagonal block in one psum.  L [mp, mp]
    (only this rank's panel is read) and b [mp] the same on every rank;
    returns x on every rank."""
    n = mesh.axis_size(axis)
    my = mesh.axis_index(axis)
    mp = L.shape[0]
    nb = mp // bs
    nb_loc = nb // n
    g0 = my * nb_loc
    L3 = L[g0 * bs:(g0 + nb_loc) * bs]
    x = torch.zeros(mp, dtype=L.dtype, device=L.device)
    if lower:
        for j in range(nb):
            owner, r = divmod(j, nb_loc)
            if my == owner:
                xj = trisolve_fwd_step(L3[r * bs:(r + 1) * bs], x,
                                       b[j * bs:(j + 1) * bs], j)
            else:
                xj = torch.zeros(bs, dtype=L.dtype, device=L.device)
            x[j * bs:(j + 1) * bs] = mesh.psum(xj, axis)
        return x
    for j in range(nb - 1, -1, -1):
        owner, r = divmod(j, nb_loc)
        packed = torch.zeros(bs + 1, bs, dtype=L.dtype, device=L.device)
        packed[0] = trisolve_bwd_contrib(L3, x, bs, g0, j)
        if my == owner:
            packed[1:] = L3[r * bs:(r + 1) * bs, j * bs:(j + 1) * bs]
        packed = mesh.psum(packed, axis)
        x[j * bs:(j + 1) * bs] = trisolve_bwd_solve(
            packed[1:], b[j * bs:(j + 1) * bs], packed[0])
    return x


class PanelCtx:
    """Factorization context: the padded ADA and the factor (natural
    order), the Jacobi scale, m and the padded size."""

    def __init__(self, ADApad, L, dg, m, mp, bs):
        self.ADApad = ADApad
        self.L = L
        self.dg = dg
        self.m = m
        self.mp = mp
        self.bs = bs


class PanelSchurEngine:
    """Linear-system backend with the Schur complement factored and solved
    in panels over one mesh axis (the prepare/solve contract of
    ipm.DenseSchurEngine; reference panels.py:192-272).

    prepare() Jacobi-scales ADA + reg*s*I, pads it with the identity to a
    multiple of n*bs and factors it with dist_cholesky; ok = every entry
    of the gathered factor finite (the factor is the all-reduced global
    one, so the flag agrees on every rank).  solve() runs the two
    distributed substitutions and refine_iters refinement passes against
    the padded ADA.  The Schur complement and each right-hand side are
    global rank 0's, so the ranks solve one system; agree() makes a host
    decision of the step rank 0's, so every rank takes the same branches
    and issues the same collectives in the same order."""

    def __init__(self, mesh: Mesh, axis: str = "blocks", bs: int | None = None,
                 refine_iters: int = 2, factor_dtype=None):
        self.mesh = mesh
        self.axis = axis
        self.bs = bs                # None: adaptive (128 down to fit m)
        self.n = mesh.axis_size(axis)
        self.refine_iters = refine_iters
        # a factor dtype above the formation's (the hybrid phase's f64
        # factor of an f32-formed matrix), set by ipm.make_step
        self.factor_dtype = factor_dtype

    def _bs_for(self, m: int) -> int:
        if self.bs is not None:
            return self.bs
        bs = 128
        while self.n * bs > max(m, 1) and bs > 4:
            bs //= 2
        return bs

    def agree(self, flag) -> bool:
        return self.mesh.agree(flag)

    def prepare(self, aop, S, reg):
        m = aop.m
        bs = self._bs_for(m)
        # every rank factors global rank 0's matrix: on the card each rank's
        # formation rounds differently (atomic sums), and a factor built
        # from rows of different matrices wanders in the endgame
        Maug = self.mesh.broadcast([build_schur(aop, S)])[0]
        ADA = Maug[:m, :m]
        if self.factor_dtype is not None and self.factor_dtype != ADA.dtype:
            ADA = ADA.to(self.factor_dtype)
        dt, dev = ADA.dtype, ADA.device
        tiny = torch.finfo(dt).tiny
        scale = torch.mean(torch.abs(torch.diagonal(ADA))) + tiny
        mp = _pad_up(m, self.n * bs)
        Mr = ADA + (reg * scale) * torch.eye(m, dtype=dt, device=dev)
        dg = torch.sqrt(torch.clamp_min(torch.diagonal(Mr), tiny))
        Mpad = torch.eye(mp, dtype=dt, device=dev)
        Mpad[:m, :m] = Mr / (dg[:, None] * dg[None, :])
        ADApad = torch.eye(mp, dtype=dt, device=dev)
        ADApad[:m, :m] = ADA
        L = dist_cholesky(Mpad, self.mesh, self.axis, bs)
        ok = bool(torch.all(torch.isfinite(L)))
        return PanelCtx(ADApad, L, dg, m, mp, bs), Maug[:m, m], \
            Maug[m, m], ok

    def _base_solve(self, ctx: PanelCtx, rhs_pad):
        y = _dist_trisolve(ctx.L, rhs_pad, self.mesh, self.axis, ctx.bs,
                           lower=True)
        return _dist_trisolve(ctx.L, y, self.mesh, self.axis, ctx.bs,
                              lower=False)

    def solve(self, ctx: PanelCtx, rhs: torch.Tensor) -> torch.Tensor:
        m, mp, dt = ctx.m, ctx.mp, ctx.L.dtype
        rhs = self.mesh.broadcast([rhs])[0]       # rank 0's, as prepare's
        dgp = torch.ones(mp, dtype=dt, device=rhs.device)
        dgp[:m] = ctx.dg
        b = torch.zeros(mp, dtype=dt, device=rhs.device)
        b[:m] = rhs.to(dt)
        x = self._base_solve(ctx, b / dgp) / dgp
        for _ in range(self.refine_iters):
            r = b - torch.mv(ctx.ADApad, x)
            x = x + self._base_solve(ctx, r / dgp) / dgp
        return x[:m].to(rhs.dtype)
