"""Dense Cholesky of the Schur complement with SeDuMi's robustness
semantics.

Counterpart of the reference's chol.py (reference analog: blkchol.c /
blkchol2.c, a supernodal LDL' that never fails):

* chol_factor / chol_solve -- library Cholesky (cuSOLVER / LAPACK) of
  M + reg*scale*I, Jacobi-scaled by default for f32 factors (the
  reference's chol.py:38-62), and two library triangular solves.
* ldl_masked -- kernel K3: LDL' with the canceltol add / maxu skip pivot
  rules (blkchol2.c:96-167), the fallback when the Cholesky fails.  On a
  CUDA tensor it launches csrc/ldl_masked.cu (its f64 build, or K3-f32 for
  an f32 matrix) in the variant ldl_plan picks from the order and dtype
  (one warp, one block over shared memory, or a grid over device memory;
  a plan the card refuses raises); on a CPU tensor it runs
  ldl_masked_plain.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import kernels
from .lax_eigh import NUM_SMS, SMEM_MAX, _sm_count
from .linalg_ops import cholesky


class CholFactor(NamedTuple):
    L: torch.Tensor       # lower factor of the (Jacobi-scaled) M + reg*s*I
    d: torch.Tensor | None  # Jacobi scale: L L' = (M + reg*s*I)/(d d');
    #                         None when unscaled
    ok: torch.Tensor      # scalar bool: factor finite


def chol_factor(M: torch.Tensor, reg, jacobi: bool | None = None
                ) -> CholFactor:
    """Cholesky of M + reg*s*I with s = mean|diag M|, or of its Jacobi
    scaling D^-1/2 (M + reg*s*I) D^-1/2 (default: for f32 only, where it
    absorbs the ~1/mu^2 diagonal range that an f32 factor cannot carry);
    ok = all(isfinite(L)) (reference chol.py:38-62).  The unscaled factor
    skips the reference's division by d = 1, which is exact."""
    m = M.shape[0]
    if jacobi is None:
        jacobi = M.dtype == torch.float32
    tiny = torch.finfo(M.dtype).tiny
    scale = torch.mean(torch.abs(torch.diagonal(M))) + tiny
    Mr = M + (reg * scale) * torch.eye(m, dtype=M.dtype, device=M.device)
    dg = None
    if jacobi:
        dg = torch.sqrt(torch.clamp_min(torch.diagonal(Mr), tiny))
        Mr = Mr / (dg[:, None] * dg[None, :])
    L = cholesky(Mr)
    return CholFactor(L=L, d=dg, ok=torch.all(torch.isfinite(L)))


def chol_solve(f: CholFactor, b: torch.Tensor) -> torch.Tensor:
    if f.d is not None:
        b = b / f.d
    y = torch.linalg.solve_triangular(f.L, b[:, None], upper=False)
    x = torch.linalg.solve_triangular(f.L.T, y, upper=True)[:, 0]
    return x if f.d is None else x / f.d


def refine_solve(matvec: Callable[[torch.Tensor], torch.Tensor], f,
                 b: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Solve matvec(x) = b with f (a CholFactor or a callable), polished by
    `iters` rounds of iterative refinement."""
    solve = f if callable(f) else (lambda bb: chol_solve(f, bb))
    x = solve(b)
    for _ in range(iters):
        x = x + solve(b - matvec(x))
    return x


class LdlFactor(NamedTuple):
    """Unit-lower LDL' with SeDuMi pivot bookkeeping (blkchol.c:393-421)."""

    L: torch.Tensor          # unit lower triangular
    d: torch.Tensor          # pivots after add/skip (skip: inf)
    skip: torch.Tensor       # bool[m]: pivot was skipped
    diagadd: torch.Tensor    # float[m]: amount added to the pivot


def ldl_masked_plain(M: torch.Tensor, canceltol: float = 1e-12,
                     maxu: float = 5e5, abstol: float = 1e-20,
                     skip_pivots: bool = True) -> LdlFactor:
    """Right-looking LDL' with masked add/skip pivots (plain PyTorch; the
    reference's chol.ldl_masked column by column):
      lb = canceltol * absd_j + abstol,  absd_j = |M_jj| + sum_k L_jk^2 d_k
      d_j < lb  -> d_j := lb  (diagadd_j = lb - d_j)
      max|L_:j| > maxu and skipping -> L_:j := e_j, d_j := inf
    """
    m = M.shape[0]
    dt, dev = M.dtype, M.device
    A = M.clone()
    L = torch.zeros(m, m, dtype=dt, device=dev)
    d = torch.zeros(m, dtype=dt, device=dev)
    skip = torch.zeros(m, dtype=torch.bool, device=dev)
    diagadd = torch.zeros(m, dtype=dt, device=dev)
    absd = torch.abs(torch.diagonal(M)).clone()
    below = torch.arange(m, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    for j in range(m):
        ajj = A[j, j]
        lbj = canceltol * absd[j] + abstol
        cancelled = ajj < lbj
        dj = torch.where(cancelled, lbj, ajj)
        add = torch.where(cancelled, lbj - ajj, zero)
        col = torch.where(below > j, A[:, j] / dj, zero)
        do_skip = torch.logical_and(torch.tensor(bool(skip_pivots),
                                                 device=dev),
                                    torch.max(torch.abs(col)) > maxu)
        colf = torch.where(do_skip, zero, col)
        dj = torch.where(do_skip, inf, dj)
        djf = torch.where(torch.isfinite(dj), dj, zero)
        A = A - djf * torch.outer(colf, colf)
        absd = absd + djf * colf**2
        colf = colf.clone()
        colf[j] = colf[j] + 1.0
        L[:, j] = colf
        d[j] = dj
        skip[j] = do_skip
        diagadd[j] = add
    return LdlFactor(L=L, d=d, skip=skip, diagadd=diagadd)


# K3's variants (csrc/ldl_masked.cu), their C codes in that order
LDL_VARIANTS = ("warp", "shared", "device")
WARP_MAX_M = 32       # the warp variant's largest order: a lane a row
# the shared variant's columns a warp, 4 to 16 warps; the device variant's
# warps a block and columns a block (parent_bench.py --cases ldl's sweep)
SHARED_COLS, SHARED_WARPS = 16, (4, 16)
DEVICE_WARPS, DEVICE_COLS = 2, 10


def ldl_smem_bytes(m: int, dtype: torch.dtype) -> int:
    """Shared memory of K3's shared variant at order m: the packed lower
    triangle and the progress counter."""
    size = 4 if dtype == torch.float32 else 8
    return size * (m * (m + 1) // 2) + 4


def ldl_plan(m: int, dtype: torch.dtype, sms: int = NUM_SMS
             ) -> tuple[str, int, int]:
    """(variant, blocks, warps a block) of K3 (K3-f32 for f32) at order m:
    one warp up to WARP_MAX_M; one block holding the triangle in shared
    memory while it fits (f64 up to 240, f32 up to 340), SHARED_COLS
    columns a warp within SHARED_WARPS; else a cooperative grid over a
    device-memory triangle, DEVICE_COLS columns a block of DEVICE_WARPS
    warps (fewer where a warp's column buffer, m entries, would not fit),
    at most one block an SM."""
    if m < 1:
        raise ValueError(f"ldl_plan: order {m} < 1")
    if m <= WARP_MAX_M:
        return "warp", 1, 1
    if ldl_smem_bytes(m, dtype) <= SMEM_MAX:
        lo, hi = SHARED_WARPS
        return "shared", 1, min(hi, max(lo, -(-m // SHARED_COLS)))
    size = 4 if dtype == torch.float32 else 8
    warps = max(1, min(DEVICE_WARPS, SMEM_MAX // (size * m)))
    return "device", min(sms, -(-m // DEVICE_COLS)), warps


_LDL_NAMES = {torch.float64: "ldl_masked", torch.float32: "ldl_masked_f32"}


def _ldl_cuda(M: torch.Tensor, canceltol: float, maxu: float, abstol: float,
              skip_pivots: bool, plan: tuple[str, int, int] | None = None
              ) -> LdlFactor:
    """K3 (K3-f32) on the card with `plan` (default ldl_plan's); a plan the
    card refuses raises.  M is read through its row stride, never
    written; the kernel writes all of L (one allocation with d and
    diagadd)."""
    m = M.shape[0]
    name = _LDL_NAMES.get(M.dtype)
    if name is None or M.shape != (m, m):
        raise ValueError(f"ldl_masked needs a square f64 or f32 matrix, "
                         f"got {tuple(M.shape)} {M.dtype}")
    if m and M.stride(1) != 1:
        M = M.contiguous()
    kernels.check_cuda(M, contiguous=False)
    dt, dev = M.dtype, M.device
    L, d, diagadd = torch.empty(m * (m + 2), dtype=dt, device=dev).split(
        [m * m, m, m])
    L = L.view(m, m)
    skip = torch.empty(m, dtype=torch.uint8, device=dev)
    out = LdlFactor(L=L, d=d, skip=skip.view(torch.bool), diagadd=diagadd)
    if m == 0:
        return out
    if plan is None:
        plan = ldl_plan(m, dt)
        if plan[0] == "device":
            plan = ldl_plan(m, dt, _sm_count(dev))
    variant, blocks, warps = plan
    tri = prog = None
    if variant == "device":
        tri = torch.empty(m * (m + 1) // 2, dtype=dt, device=dev)
        prog = torch.zeros(1, dtype=torch.int32, device=dev)
    kernels.launch("ldl_masked.cu", name + "_launch", M.data_ptr(),
                   M.stride(0), L.data_ptr(), d.data_ptr(), skip.data_ptr(),
                   diagadd.data_ptr(),
                   None if tri is None else tri.data_ptr(),
                   None if prog is None else prog.data_ptr(), m,
                   float(canceltol), float(maxu), float(abstol),
                   int(bool(skip_pivots)), LDL_VARIANTS.index(variant),
                   blocks, warps)
    kernels.count(name, f"{m}", variant)
    return out


def ldl_masked(M: torch.Tensor, canceltol: float = 1e-12, maxu: float = 5e5,
               abstol: float = 1e-20, skip_pivots: bool = True) -> LdlFactor:
    """Masked LDL' (kernel K3 on the card, K3-f32 for an f32 matrix, in
    ldl_plan's variant); see ldl_masked_plain."""
    if not M.is_cuda:
        return ldl_masked_plain(M, canceltol, maxu, abstol, skip_pivots)
    return _ldl_cuda(M, canceltol, maxu, abstol, skip_pivots)


def ldl_solve(f: LdlFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve with the (possibly pivot-skipped) LDL': skipped pivots have
    d = inf so their components contribute zero (deninfac.m:86-94)."""
    y = torch.linalg.solve_triangular(f.L, b[:, None], upper=False,
                                      unitriangular=True)[:, 0]
    y = torch.where(torch.isfinite(f.d), y / f.d, 0.0)
    return torch.linalg.solve_triangular(
        f.L.T, y[:, None], upper=True, unitriangular=True)[:, 0]
