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
(*_plain), in the tensors' dtype; on a CUDA tensor they launch the
kernel's build for the dtype (f64: K14/K15; f32: K14-f32/K15-f32, the f32
phase of the precision ladder under a mesh) or raise.  The trailing
update (a [nb_loc bs, bs] x [bs, mp] product), the strict-upper zeroing
and ADA v are plain torch.

The layout is the reference's: the matrix and its factor live in row
panels, mp/n rows a rank, and no rank keeps the whole [mp, mp] matrix
after prepare.  The formation is the replicated (or data-split,
mesh.ShardedAOp) build, and global rank 0's matrix is the one factored:
each rank receives, by one scatter, its BLOCK-CYCLIC row panel of the
scaled matrix (natural block k on the rank k mod n of the axis), which
dist_cholesky factors, and its CONTIGUOUS row panel of the padded ADA;
dist_cholesky hands the factor back as contiguous row panels (one
all-to-all), the layout _dist_trisolve and the refinement read.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..schur import build_schur
from .mesh import Mesh


def _pad_up(m: int, mult: int) -> int:
    return -(-m // mult) * mult


# the kernels' builds: entry point and launch counter suffix per dtype
_BUILDS = {torch.float64: "", torch.float32: "_f32"}


def _build(*tensors: torch.Tensor) -> str:
    """The suffix of the build for the tensors' dtype (f64 or f32, all
    alike) after kernels.check_cuda; anything else raises."""
    dt = tensors[0].dtype
    if dt not in _BUILDS:
        raise ValueError(f"the panel kernels take float64 or float32, got "
                         f"{dt}")
    kernels.check_cuda(*tensors, dtype=dt)
    return _BUILDS[dt]


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


def _panel_chol_kernel(C: torch.Tensor, j: int,
                       ncta: int = 0) -> torch.Tensor:
    """K14 on a grid of ncta CTAs (0: one wave of the card, a CTA a chunk
    of 32 rows up to the CTAs resident at once); the result does not
    depend on it."""
    sfx = _build(C)
    nb, bs, _ = C.shape
    if bs > 128:
        raise ValueError(f"panel_chol takes bs <= 128, got {bs}")
    Lcol = torch.empty_like(C)
    kernels.launch("panel_chol.cu", "panel_chol_launch" + sfx, C.data_ptr(),
                   Lcol.data_ptr(), nb, bs, j, ncta)
    kernels.LAUNCHES["dist_panel_chol" + sfx] += 1
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
    sfx = _build(row, x, bj)
    bs, mp = row.shape
    _check_bs(bs)
    xj = torch.empty(bs, dtype=row.dtype, device=row.device)
    kernels.launch("panel_solve.cu", "panel_fwd_step_launch" + sfx,
                   row.data_ptr(), x.data_ptr(), bj.data_ptr(), xj.data_ptr(),
                   bs, mp, j, ncta)
    kernels.LAUNCHES["dist_trisolve_fwd" + sfx] += 1
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
    sfx = _build(L3, x)
    _check_bs(bs)
    contrib = torch.empty(bs, dtype=L3.dtype, device=L3.device)
    kernels.launch("panel_solve.cu", "panel_bwd_contrib_launch" + sfx,
                   L3.data_ptr(), x.data_ptr(), contrib.data_ptr(), bs,
                   L3.shape[1], L3.shape[0] // bs, g0, j, ncta)
    kernels.LAUNCHES["dist_trisolve_bwd_contrib" + sfx] += 1
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
    sfx = _build(Ljj, bj, contrib)
    bs = Ljj.shape[0]
    _check_bs(bs)
    xj = torch.empty(bs, dtype=Ljj.dtype, device=Ljj.device)
    kernels.launch("panel_solve.cu", "panel_bwd_solve_launch" + sfx,
                   Ljj.data_ptr(), bj.data_ptr(), contrib.data_ptr(),
                   xj.data_ptr(), bs)
    kernels.LAUNCHES["dist_trisolve_bwd_solve" + sfx] += 1
    return xj


# --------------------------------------------------------------------------
# the distributed factor and solves
# --------------------------------------------------------------------------


def cyclic_rows(n: int, my: int, nb_loc: int, bs: int, device=None):
    """The rows of the block-cyclic panel of the rank at position my of n:
    natural blocks my, my + n, ..., each bs rows (reference panels.py:47,
    natural block k on device k mod n, local slot k // n)."""
    g = torch.arange(nb_loc, device=device) * n + my
    return (g[:, None] * bs + torch.arange(bs, device=device)).reshape(-1)


def dist_cholesky(A: torch.Tensor, mesh: Mesh, axis: str,
                  bs: int) -> torch.Tensor:
    """Cholesky of an SPD matrix with BLOCK-CYCLIC row ownership
    (reference panels.py:47): natural block row k is factored by the rank
    k mod n of the axis.  A: this rank's block-cyclic row panel
    [nb_loc bs, mp] (the rows cyclic_rows gives) of the [mp, mp] matrix,
    mp divisible by n*bs.  Returns this rank's CONTIGUOUS row panel of the
    lower L with L L' = M (rows my nb_loc bs on, strict upper triangle
    exactly 0), the layout _dist_trisolve reads: the cyclic panels are
    redistributed by one all-to-all, each rank receiving only its rows.
    A is overwritten (the trailing updates run in place on it).  No
    pivoting; a non-PD matrix gives NaN."""
    n = mesh.axis_size(axis)
    my = mesh.axis_index(axis)
    mp = A.shape[1]
    nb = mp // bs
    nb_loc = nb // n
    if nb_loc * n * bs != mp or A.shape[0] != nb_loc * bs:
        raise ValueError(f"a panel [{A.shape[0]}, {mp}] of an mp = {mp} "
                         f"matrix over n*bs = {n * bs}")
    dev, dt = A.device, A.dtype
    g = [my + n * r for r in range(nb_loc)]     # natural block rows owned
    g_t = torch.tensor(g, device=dev)
    A = A.view(nb_loc, bs, mp)
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
    del A, A4
    # cyclic -> contiguous: block k goes to the rank k // nb_loc.  This
    # rank's blocks are ascending, so its rows leave in destination order;
    # rank p's arrive source by source and are put in natural order.
    sends = [sum(1 for k in g if k // nb_loc == p) * bs for p in range(n)]
    arrive = [k for d in range(n) for k in range(d, nb, n)
              if k // nb_loc == my]
    recvs = [sum(1 for k in range(d, nb, n) if k // nb_loc == my) * bs
             for d in range(n)]
    got = mesh.all_to_all(Lloc.reshape(nb_loc * bs, mp), sends, recvs, axis)
    order = torch.tensor(sorted(range(nb_loc), key=arrive.__getitem__),
                         device=dev)
    return got.reshape(nb_loc, bs, mp)[order].reshape(nb_loc * bs, mp)


def _dist_trisolve(L3: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str,
                   bs: int, lower: bool) -> torch.Tensor:
    """Solve L x = b (lower=True) or L' x = b (lower=False) with each rank
    of the axis owning a CONTIGUOUS row panel of L (reference panels.py:
    117): per block step the owner solves its bs-triangle and the result
    is broadcast by a masked psum; backward, every rank adds its partial
    products and the owner its diagonal block in one psum.  L3: this
    rank's panel [nb_loc bs, mp] (dist_cholesky's result); b [mp] the same
    on every rank; returns x on every rank."""
    n = mesh.axis_size(axis)
    my = mesh.axis_index(axis)
    mp = L3.shape[1]
    nb = mp // bs
    nb_loc = nb // n
    g0 = my * nb_loc
    x = torch.zeros(mp, dtype=L3.dtype, device=L3.device)
    if lower:
        for j in range(nb):
            owner, r = divmod(j, nb_loc)
            if my == owner:
                xj = trisolve_fwd_step(L3[r * bs:(r + 1) * bs], x,
                                       b[j * bs:(j + 1) * bs], j)
            else:
                xj = torch.zeros(bs, dtype=L3.dtype, device=L3.device)
            x[j * bs:(j + 1) * bs] = mesh.psum(xj, axis)
        return x
    for j in range(nb - 1, -1, -1):
        owner, r = divmod(j, nb_loc)
        packed = torch.zeros(bs + 1, bs, dtype=L3.dtype, device=L3.device)
        packed[0] = trisolve_bwd_contrib(L3, x, bs, g0, j)
        if my == owner:
            packed[1:] = L3[r * bs:(r + 1) * bs, j * bs:(j + 1) * bs]
        packed = mesh.psum(packed, axis)
        x[j * bs:(j + 1) * bs] = trisolve_bwd_solve(
            packed[1:], b[j * bs:(j + 1) * bs], packed[0])
    return x


def scaled_padded(ADA: torch.Tensor, reg: float, mp: int):
    """(Mpad, ADApad, dg) of prepare: ADA + reg*s*I (s the mean |diagonal|)
    Jacobi-scaled by dg = sqrt(its diagonal), and ADA itself, each padded
    with the identity to [mp, mp]."""
    m, dt, dev = ADA.shape[0], ADA.dtype, ADA.device
    tiny = torch.finfo(dt).tiny
    scale = torch.mean(torch.abs(torch.diagonal(ADA))) + tiny
    Mr = ADA + (reg * scale) * torch.eye(m, dtype=dt, device=dev)
    dg = torch.sqrt(torch.clamp_min(torch.diagonal(Mr), tiny))
    Mpad = torch.eye(mp, dtype=dt, device=dev)
    Mpad[:m, :m] = Mr / (dg[:, None] * dg[None, :])
    ADApad = torch.eye(mp, dtype=dt, device=dev)
    ADApad[:m, :m] = ADA
    return Mpad, ADApad, dg


def all_finite(L3: torch.Tensor, mesh: Mesh) -> bool:
    """Whether every rank's panel is finite: each rank checks its own and
    the flags are reduced, so every rank gets the same answer."""
    return mesh.all_true(bool(torch.all(torch.isfinite(L3))))


class PanelCtx:
    """Factorization context: this rank's contiguous row panels [mp/n, mp]
    of the padded ADA and of the factor (rows my mp/n on), the Jacobi
    scale, m, the padded size and the block width."""

    def __init__(self, ADApad, L, dg, m, mp, bs):
        self.ADApad = ADApad
        self.L = L
        self.dg = dg
        self.m = m
        self.mp = mp
        self.bs = bs


class PanelSchurEngine:
    """Linear-system backend with the Schur complement factored and solved
    in row panels over one mesh axis (the prepare/solve contract of
    ipm.DenseSchurEngine; reference panels.py:192-272).

    prepare() forms the augmented Schur complement on every rank (split
    over the data axes, mesh.ShardedAOp) and factors global rank 0's: the
    root of each panel group (the rank at panel coordinate 0, which first
    takes rank 0's values over the data axes when there are any)
    Jacobi-scales ADA + reg*s*I, pads it with the identity to a multiple
    of n*bs and scatters to each rank of the axis its block-cyclic row
    panel of that matrix (for the factor) and its contiguous row panel of
    the padded ADA (for the refinement); the last column of the augmented
    matrix and the scale dg are broadcast whole.  No rank keeps an
    [mp, mp] tensor.  dist_cholesky returns each rank's contiguous panel
    of the factor; ok = every rank's panel finite, agreed by all.  solve()
    runs the two distributed substitutions and refine_iters refinement
    passes against the padded ADA (each rank's panel times x,
    all-gathered).  Each right-hand side is rank 0's too, so the ranks
    solve one system; agree() makes a host decision of the step rank 0's,
    so every rank takes the same branches and issues the same collectives
    in the same order."""

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
        mesh, axis, n = self.mesh, self.axis, self.n
        mp = _pad_up(m, n * bs)
        rows = mp // n
        Maug = build_schur(aop, S)
        dt = self.factor_dtype or Maug.dtype
        # every rank factors global rank 0's matrix: on the card each rank's
        # formation rounds differently (atomic sums), and a factor built
        # from rows of different matrices wanders in the endgame
        chunks = None
        if mesh.axis_index(axis) == 0:
            data = tuple(a for a in mesh.axis_names if a != axis)
            if data and mesh.axis_size(data) > 1:
                Maug = mesh.broadcast([Maug], axis=data)[0]
            Mpad, ADApad, dg = scaled_padded(Maug[:m, :m].to(dt), reg, mp)
            chunks = [torch.stack([Mpad[cyclic_rows(n, d, rows // bs, bs,
                                                    Mpad.device)],
                                   ADApad[d * rows:(d + 1) * rows]])
                      for d in range(n)]
            del Mpad, ADApad
        else:
            dg = torch.empty(m, dtype=dt, device=Maug.device)
        ahc, chc, dg = mesh.broadcast([Maug[:m, m].clone(), Maug[m, m].clone(),
                                       dg])
        like = torch.empty(2, rows, mp, dtype=dt, device=Maug.device)
        del Maug
        panels = mesh.scatter(chunks, like, axis)
        del chunks, like
        # the context's ADA panel gets a storage of its own, so the factor's
        # panel (overwritten by dist_cholesky) is freed once it is factored
        Mloc, ADAloc = panels[0], panels[1].clone()
        del panels
        L = dist_cholesky(Mloc, mesh, axis, bs)
        del Mloc
        ok = all_finite(L, mesh)
        return PanelCtx(ADAloc, L, dg, m, mp, bs), ahc, chc, ok

    def _base_solve(self, ctx: PanelCtx, rhs_pad):
        y = _dist_trisolve(ctx.L, rhs_pad, self.mesh, self.axis, ctx.bs,
                           lower=True)
        return _dist_trisolve(ctx.L, y, self.mesh, self.axis, ctx.bs,
                              lower=False)

    def _matvec(self, ctx: PanelCtx, x: torch.Tensor) -> torch.Tensor:
        """ADApad x on every rank: each rank's panel rows, all-gathered
        (the reference's panel GEMM, panels.py:263-266)."""
        return self.mesh.all_gather(torch.mv(ctx.ADApad, x),
                                    self.axis).reshape(-1)

    def solve(self, ctx: PanelCtx, rhs: torch.Tensor) -> torch.Tensor:
        m, mp, dt = ctx.m, ctx.mp, ctx.L.dtype
        rhs = self.mesh.broadcast([rhs])[0]       # rank 0's, as prepare's
        dgp = torch.ones(mp, dtype=dt, device=rhs.device)
        dgp[:m] = ctx.dg
        b = torch.zeros(mp, dtype=dt, device=rhs.device)
        b[:m] = rhs.to(dt)
        x = self._base_solve(ctx, b / dgp) / dgp
        for _ in range(self.refine_iters):
            r = b - self._matvec(ctx, x)
            x = x + self._base_solve(ctx, r / dgp) / dgp
        return x[:m].to(rhs.dtype)
