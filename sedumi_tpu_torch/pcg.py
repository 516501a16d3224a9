"""Compensated (double-double) refinement and PCG for the Schur solves.

Counterpart of the reference's pcg.py (reference analog: wrapPcg.m,
loopPcg.m, quadadd.c).  The residual r = rhs - M v is evaluated with
error-free transformations, which pushes the refinement floor from
cond(M) eps down by another ~2^27 (f64) or ~2^12 (f32).  Everything
here works in the dtype of its inputs, f64 or f32, with that dtype's
Veltkamp constant (fp.split_const).

:func:`dd_matvec_residual` is kernel K1: on a CUDA tensor it launches the
hand-written kernel csrc/dd_residual.cu (its f64 or f32 build, and raises
if it cannot); on a CPU tensor it runs :func:`dd_matvec_residual_plain`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import kernels
from .chol import chol_solve
from .fp import split_const


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _split(a):
    c = split_const(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_matvec_residual_plain(M: torch.Tensor, v: torch.Tensor,
                             rhs: torch.Tensor) -> torch.Tensor:
    """rhs - M v in compensated arithmetic, rounded to M's dtype (plain
    PyTorch).

    Every product M_ij v_j is split exactly (TwoProd); the row sums of the
    high parts run as a pairwise TwoSum tree whose errors, with the low
    parts, are summed separately.  The reference sums the columns
    sequentially; the pairwise order has the same error bound."""
    s, e = two_prod(M, v[None, :])
    comp = torch.zeros_like(s)
    while s.shape[1] > 1:
        if s.shape[1] % 2:
            pad = torch.zeros_like(s[:, :1])
            s = torch.cat([s, pad], dim=1)
            comp = torch.cat([comp, pad], dim=1)
        t, err = two_sum(s[:, 0::2], s[:, 1::2])
        comp = (comp[:, 0::2] + comp[:, 1::2]) + err
        s = t
    total_lo = comp[:, 0] + torch.sum(e, dim=1)
    d, derr = two_sum(rhs, -s[:, 0])
    return d + (derr - total_lo)


def dd_matvec_residual(M: torch.Tensor, v: torch.Tensor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """rhs - M v in compensated arithmetic (kernel K1 on the card: its
    f64 build, or K1-f32 for f32 operands)."""
    if not M.is_cuda:
        return dd_matvec_residual_plain(M, v, rhs)
    M, v, rhs = M.contiguous(), v.contiguous(), rhs.contiguous()
    f32 = M.dtype == torch.float32
    kernels.check_cuda(M, v, rhs, dtype=torch.float32 if f32
                       else torch.float64)
    m, n = M.shape
    if v.shape != (n,) or rhs.shape != (m,):
        raise ValueError(f"shapes M {tuple(M.shape)}, v {tuple(v.shape)}, "
                         f"rhs {tuple(rhs.shape)} do not match")
    out = torch.empty(m, dtype=M.dtype, device=M.device)
    name = "dd_matvec_residual_f32" if f32 else "dd_matvec_residual"
    kernels.launch("dd_residual.cu", name + "_launch", M.data_ptr(),
                   v.data_ptr(), rhs.data_ptr(), out.data_ptr(), m, n)
    kernels.LAUNCHES[name] += 1
    return out


def refine_solve_dd(M: torch.Tensor, f, rhs: torch.Tensor,
                    iters: int = 3) -> torch.Tensor:
    """Iterative refinement with compensated residuals and double-double
    solution accumulation (loopPcg.m:100-124 + quadadd.c role).  `f` is a
    chol.CholFactor or a callable b -> approximate solve."""
    solve = f if callable(f) else (lambda b: chol_solve(f, b))
    hi = solve(rhs)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        r = dd_matvec_residual(M, hi, rhs) - M @ lo
        s, e = two_sum(hi, solve(r))
        hi, lo = s, lo + e
    return hi + lo


class PcgResult(NamedTuple):
    x: torch.Tensor
    resnorm: torch.Tensor
    iters: int


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor],
        precond: Callable[[torch.Tensor], torch.Tensor],
        rhs: torch.Tensor, x0: torch.Tensor, maxiter: int = 49,
        restol: float = 5e-3, stagtol: float = 5e-14,
        abstol: float = 0.0) -> PcgResult:
    """Preconditioned CG with double-double solution accumulation and
    best-residual fallback (wrapPcg.m:94-130, loopPcg.m:126-146).  Stops
    on residual <= max(restol ||rhs||, abstol), stagnation, or maxiter
    (the host reads the stop flag once per iteration)."""
    bnorm = torch.linalg.norm(rhs)
    tol = torch.clamp_min(restol * bnorm, abstol)
    r = rhs - matvec(x0)
    p = precond(r)
    rz = r @ p
    x_hi, x_lo = x0, torch.zeros_like(x0)
    best_x, best_rn = x0, torch.linalg.norm(r)
    it, done = 0, False
    while it < maxiter and not done:
        mp = matvec(p)
        pmp = p @ mp
        alpha = rz / torch.where(pmp != 0, pmp, 1.0)
        x_hi, e = two_sum(x_hi, alpha * p)
        x_lo = x_lo + e
        r = r - alpha * mp
        z = precond(r)
        rz_new = r @ z
        beta = rz_new / torch.where(rz != 0, rz, 1.0)
        p = z + beta * p
        rn = torch.linalg.norm(r)
        better = rn < best_rn
        best_x = torch.where(better, x_hi + x_lo, best_x)
        best_rn = torch.where(better, rn, best_rn)
        done = bool((rn <= tol) | (torch.abs(rz_new) < stagtol * bnorm**2))
        rz = rz_new
        it += 1
    final_rn = torch.linalg.norm(r)
    x = torch.where(final_rn <= best_rn, x_hi + x_lo, best_x)
    return PcgResult(x=x, resnorm=torch.minimum(final_rn, best_rn), iters=it)
