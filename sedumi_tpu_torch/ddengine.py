"""Double-double Schur engine: the dd64 endgame phase's linear solver.

Counterpart of the reference's ddengine.py.  Role in the reference's
terms: the last rung of the never-fail solve chain (blkchol.c add/skip ->
PCG with quad accumulation, wrapPcg.m:94-130), carried further: the whole
Schur pipeline runs in double-double (ddlinalg: Ozaki split-GEMM
formation, dd Cholesky, dd triangular solves and one dd refinement pass),
so Newton directions stay exact to f64 up to cond(ADA) ~ 1e30.  That is
what the endgame needs once cond(ADA) ~ 1/mu^2 passes 1/eps_f64 (mu ~
1e-8): from there f64-formed directions carry O(1) defects.

Here prepare/solve run on the tensors' device in torch f64, with no host
callback; the only value that crosses to the host per prepare is the
factor's ok flag, as in ipm.DenseSchurEngine.  The LP and PSD terms are
formed in dd, the SOC term in f64 (the same formulas as
schur.build_schur): cond-critical endgames on the bundled set are PSD/LP
dominated.  COO-represented PSD buckets are densified on the device (the
dd congruence needs the full [m+1, k*d*d] block data, which the dd64
admission cost model bounds).
"""

from __future__ import annotations

import torch

from . import ddlinalg as dd
from .nt import Scaling
from .opA import CooAOp
from .structs import F64


def _dense_bucket(part: dict, meta: tuple, mp1: int) -> torch.Tensor:
    """A PSD bucket's [m+1, k*d*d] matrix, densified when it is COO."""
    rep, k, d = meta[0], meta[1], meta[2]
    if rep == "dense":
        return part["mat"]
    mat = torch.zeros(mp1, k * d * d, dtype=F64, device=part["b_val"].device)
    mat[part["b_row"], part["b_loc"]] = part["b_val"]
    return mat


def form_dd(aop: CooAOp, S: Scaling, reg: float):
    """The augmented Schur complement [A; c'] H [A; c']' as a dd pair."""
    mp1 = aop.m + 1
    dev = aop.Al.device
    Mh = torch.zeros(mp1, mp1, dtype=F64, device=dev)
    Ml = torch.zeros_like(Mh)

    def acc(Ph, Pl=None):
        nonlocal Mh, Ml
        Mh, Ml = dd.dd_add(Mh, Ml, Ph, Pl)

    if aop.Al.shape[1]:
        Wh, Wl = dd.two_prod_cols(aop.Al, S.d_l)
        acc(*dd.dd_gemm(Wh, Wl, aop.Al.T, None))
    # SOC contribution in f64 (schur.build_schur formulas)
    for aq, (cnt, d_), wb, eta2 in zip(aop.Aq, aop.q_shapes, S.q_wb,
                                       S.q_eta2):
        u = torch.einsum("mcd,cd->mc", aq.reshape(mp1, cnt, d_), wb)
        acc(2.0 * ((u * eta2[None, :]) @ u.T))
        jsign = torch.ones(d_, dtype=F64, device=dev)
        jsign[1:] = -1.0
        w = (eta2[:, None] * jsign[None, :]).reshape(-1)
        acc(-(aq * w[None, :]) @ aq.T)
    # PSD: dd congruence R' A_k R and dd Gram B B' per bucket
    for part, meta, r in zip(aop.s_parts, aop.s_meta, S.s_r):
        k, d_ = meta[1], meta[2]
        dd2 = d_ * d_
        a4 = _dense_bucket(part, meta, mp1).reshape(mp1, k, d_, d_)
        Bh = torch.empty(mp1, k * dd2, dtype=F64, device=dev)
        Bl = torch.empty_like(Bh)
        for kk in range(k):
            Ak = a4[:, kk].reshape(mp1 * d_, d_)
            Rs = dd.ozaki_split(r[kk], d_, axis=0)   # R_k split once
            Th, Tl = dd.dd_gemm(Ak, None, r[kk], None, Bs=Rs)
            # U = R' T computed as (T' R)', T' per row block
            TTh = Th.reshape(mp1, d_, d_).transpose(1, 2).reshape(-1, d_)
            TTl = Tl.reshape(mp1, d_, d_).transpose(1, 2).reshape(-1, d_)
            del Th, Tl
            Uh, Ul = dd.dd_gemm(TTh, TTl, r[kk], None, Bs=Rs)
            del TTh, TTl
            cols = slice(kk * dd2, (kk + 1) * dd2)
            Bh[:, cols] = Uh.reshape(mp1, d_, d_).transpose(1, 2) \
                .reshape(mp1, dd2)
            Bl[:, cols] = Ul.reshape(mp1, d_, d_).transpose(1, 2) \
                .reshape(mp1, dd2)
            del Uh, Ul
        del a4
        # the Gram's B' split per column is B split per row
        Bs = dd.ozaki_split(Bh, k * dd2, axis=-1)
        acc(*dd.dd_gemm(Bh, Bl, Bh.T, Bl.T, As=Bs, Bs=[s.T for s in Bs]))
        del Bs
        del Bh, Bl
    if reg != 0.0:
        sc = torch.trace(Mh) / max(mp1, 1) + 1.0
        Mh = Mh + (reg * sc) * torch.eye(mp1, dtype=F64, device=dev)
    return Mh, Ml


class DdSchurEngine:
    """The ipm.DenseSchurEngine prepare/solve contract in double-double:
    prepare forms M in dd and factors its leading m x m block by dd_chol;
    solve runs dd_chol_solve plus one dd refinement pass against the dd
    matrix (the reference's refine_iters = 1) and returns the f64 rounding
    of the dd solution."""

    def prepare(self, aop: CooAOp, S: Scaling, reg: float):
        m = aop.m
        Mh, Ml = form_dd(aop, S, reg)
        Mh_m, Ml_m = Mh[:m, :m], Ml[:m, :m]
        f = dd.dd_chol(Mh_m, Ml_m)
        return (Mh_m, Ml_m, f), Mh[:m, m], Mh[m, m], bool(f.ok)

    def solve(self, ctx, rhs: torch.Tensor) -> torch.Tensor:
        Mh, Ml, f = ctx
        xh, xl = dd.dd_chol_solve(f, rhs)
        ph, pl = dd.dd_gemv(Mh, Ml, xh, xl)
        rh, rl = dd.dd_sub(rhs, torch.zeros_like(rhs), ph, pl)
        eh, el = dd.dd_chol_solve(f, rh, rl)
        xh, xl = dd.dd_add(xh, xl, eh, el)
        return xh + xl
