"""Nesterov-Todd scaling, recomputed from (x, z) every iteration.

Counterpart of the reference's nt.py (reference analog: updtransfo.m):

* LP:   d = x/z, lam = sqrt(x z).
* SOC:  closed-form NT point w with P(w) z = x; u = sqrt(w) gives
        W = P(u) = H^{1/2} and W^{-1} = P(u^{-1}).
* PSD:  Z = Lz Lz', eigh(Lz' X Lz) = Q diag(sig^2) Q',
        R = Lz^{-T} Q diag(sig^(1/2)), Rinv = diag(sig^(-1/2)) Q' Lz',
        so R^{-1} X R^{-T} = R' Z R = diag(sig).
  Buckets of real-embedded complex-Hermitian blocks run the chain natively
  in complex arithmetic at half the order, then re-embed R, Rinv and the
  doubled spectrum (the reference's CPU path, nt.py:112-134).

Every eps-relative guard takes its eps and tiny from the operands' dtype
(f64, or f32 and complex64 in the precision ladder's f32 phases), as the
reference's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import jordan as jd
from .linalg_ops import cholesky, eigh_multi, eigvalsh_multi
from .structs import ConeVec



def _cv_dtype(cv: ConeVec) -> torch.dtype:
    return cv.l.dtype if cv.l.numel() else (
        cv.s[0].dtype if cv.s else cv.q[0].dtype)


class Scaling(NamedTuple):
    """NT scaling for the full cone product."""

    d_l: torch.Tensor                      # [nl] = x/z
    lam_l: torch.Tensor                    # [nl] = sqrt(x z)
    q_wb: tuple[torch.Tensor, ...]         # [n,d] normalized NT point
    q_eta2: tuple[torch.Tensor, ...]       # [n]   = gx/gz
    q_u: tuple[torch.Tensor, ...]          # [n,d] = sqrt(w)
    q_uinv: tuple[torch.Tensor, ...]       # [n,d] = w^{-1/2}
    q_lam: tuple[torch.Tensor, ...]        # [n,d] scaled point
    s_r: tuple[torch.Tensor, ...]          # [n,d,d]
    s_rinv: tuple[torch.Tensor, ...]       # [n,d,d]
    s_lam: tuple[torch.Tensor, ...]        # [n,d] diagonal scaled point


def _add_diag(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a + diag_embed(v) over a batch (v: [..., 1] or [..., d])."""
    d = a.shape[-1]
    return a + torch.eye(d, dtype=a.dtype, device=a.device) * v[..., None]


def _guarded_chol(a: torch.Tensor, eps: float) -> torch.Tensor:
    """Cholesky of a + 4 eps max|diag(a)| I (the reference's eps-relative
    shift that keeps endgame factorizations total; eps of a's precision)."""
    mx = torch.amax(torch.abs(torch.diagonal(a, dim1=-2, dim2=-1).real),
                    dim=-1)
    return cholesky(_add_diag(a, (4 * eps * mx)[..., None]))


def _sig_floor(sig2: torch.Tensor) -> torch.Tensor:
    fi = torch.finfo(sig2.dtype)
    return torch.maximum(
        sig2, (4 * fi.eps) ** 2 * torch.amax(sig2, dim=-1, keepdim=True)
        + fi.tiny)


def _to_c(e: torch.Tensor) -> torch.Tensor:
    d = e.shape[-1] // 2
    re = 0.5 * (e[..., :d, :d] + e[..., d:, d:])
    im = 0.5 * (e[..., d:, :d] - e[..., :d, d:])
    h = torch.complex(re, im)
    return 0.5 * (h + h.transpose(-1, -2).conj())


def _rho_j(mc: torch.Tensor) -> torch.Tensor:
    re, im = mc.real, mc.imag
    top = torch.cat([re, -im], dim=-1)
    bot = torch.cat([im, re], dim=-1)
    return torch.cat([top, bot], dim=-2)


def compute_scaling(x: ConeVec, z: ConeVec,
                    herm: tuple[bool, ...] | None = None) -> Scaling:
    """NT scaling, total on numerically interior points (every
    factorization carries an eps-relative clamp/shift)."""
    eps = torch.finfo(_cv_dtype(x)).eps

    def _posl(v):
        if not v.numel():
            return v
        return torch.maximum(v, 4 * eps * torch.max(torch.abs(v)))

    # --- LP ---
    xl, zl = _posl(x.l), _posl(z.l)
    d_l = xl / zl
    lam_l = torch.sqrt(xl * zl)

    # --- SOC ---
    q_wb, q_eta2, q_u, q_uinv, q_lam = [], [], [], [], []
    for xq, zq in zip(x.q, z.q):
        floor_x = (4 * eps) ** 2 * xq[..., 0] ** 2
        floor_z = (4 * eps) ** 2 * zq[..., 0] ** 2
        gx = torch.sqrt(torch.maximum(jd.q_tdet(xq), floor_x))
        gz = torch.sqrt(torch.maximum(jd.q_tdet(zq), floor_z))
        xb = xq / gx[..., None]
        zb = zq / gz[..., None]
        xbzb = torch.sum(xb * zb, dim=-1)
        gamma = torch.sqrt(0.5 * (1.0 + xbzb))
        wb = (xb + jd._j(zb)) / (2.0 * gamma[..., None])
        eta2 = gx / gz
        w = torch.sqrt(eta2)[..., None] * wb
        u = jd.q_sqrt(w)
        q_wb.append(wb)
        q_eta2.append(eta2)
        q_u.append(u)
        q_uinv.append(jd.q_inv(u))
        q_lam.append(jd.q_quad_rep_apply(u, zq))

    # --- PSD ---
    herm_t = tuple(herm) if herm is not None else (False,) * len(x.s)
    n_s = len(x.s)
    s_r, s_rinv, s_lam = [None] * n_s, [None] * n_s, [None] * n_s
    lz_list, m_list, ids_r = [], [], []
    lzc_list, mc_list, ids_h = [], [], []
    for bi, (xs, zs) in enumerate(zip(x.s, z.s)):
        if herm_t[bi]:
            xc, zc = _to_c(xs), _to_c(zs)
            lzc = _guarded_chol(zc, eps)
            lzc_list.append(lzc)
            mc_list.append(lzc.transpose(-1, -2).conj() @ xc @ lzc)
            ids_h.append(bi)
            continue
        lz = _guarded_chol(zs, eps)
        lz_list.append(lz)
        m_list.append(lz.transpose(-1, -2) @ xs @ lz)
        ids_r.append(bi)
    for bi, lz, (sig2, qmat) in zip(ids_r, lz_list, eigh_multi(m_list)):
        sig = torch.sqrt(_sig_floor(sig2))
        shalf = torch.sqrt(sig)
        lzt = lz.transpose(-1, -2)
        # R = Lz^{-T} Q diag(sig^{1/2}): triangular solve with Lz' (upper)
        s_r[bi] = torch.linalg.solve_triangular(
            lzt, qmat * shalf[..., None, :], upper=True)
        s_rinv[bi] = (qmat.transpose(-1, -2) / shalf[..., :, None]) @ lzt
        s_lam[bi] = sig
    for bi, lzc, (sig2, qc) in zip(ids_h, lzc_list,
                                   eigh_multi(mc_list)):
        sig = torch.sqrt(_sig_floor(sig2))
        shalf = torch.sqrt(sig)
        lzh = lzc.transpose(-1, -2).conj()
        rc = torch.linalg.solve_triangular(
            lzh, qc * shalf[..., None, :].to(qc.dtype), upper=True)
        rinvc = (qc.transpose(-1, -2).conj()
                 / shalf[..., :, None].to(qc.dtype)) @ lzh
        s_r[bi] = _rho_j(rc)
        s_rinv[bi] = _rho_j(rinvc)
        s_lam[bi] = torch.cat([sig, sig], dim=-1)

    return Scaling(
        d_l=d_l, lam_l=lam_l,
        q_wb=tuple(q_wb), q_eta2=tuple(q_eta2), q_u=tuple(q_u),
        q_uinv=tuple(q_uinv), q_lam=tuple(q_lam),
        s_r=tuple(s_r), s_rinv=tuple(s_rinv), s_lam=tuple(s_lam),
    )


# --- scaled-space transport -------------------------------------------------


def scale_x_to_v(S: Scaling, dx: ConeVec) -> ConeVec:
    """W^{-1} dx (PSD: R^{-1} dX R^{-T})."""
    return ConeVec(
        l=dx.l / torch.sqrt(S.d_l),
        q=tuple(jd.q_quad_rep_apply(ui, d) for ui, d in zip(S.q_uinv, dx.q)),
        s=tuple(jd.s_congr_t(ri, d) for ri, d in zip(S.s_rinv, dx.s)))


def scale_z_to_v(S: Scaling, dz: ConeVec) -> ConeVec:
    """W dz (PSD: R' dZ R)."""
    return ConeVec(
        l=dz.l * torch.sqrt(S.d_l),
        q=tuple(jd.q_quad_rep_apply(u, d) for u, d in zip(S.q_u, dz.q)),
        s=tuple(jd.s_congr(r, d) for r, d in zip(S.s_r, dz.s)))


def scale_v_to_x(S: Scaling, v: ConeVec) -> ConeVec:
    """W v (PSD: R V R')."""
    return ConeVec(
        l=v.l * torch.sqrt(S.d_l),
        q=tuple(jd.q_quad_rep_apply(u, d) for u, d in zip(S.q_u, v.q)),
        s=tuple(jd.s_congr_t(r, d) for r, d in zip(S.s_r, v.s)))


def H_apply(S: Scaling, u: ConeVec) -> ConeVec:
    """H u = W^2 u (reference PopK.m / two-sided psdscale)."""
    q = []
    for wb, eta2, uq in zip(S.q_wb, S.q_eta2, u.q):
        wu = torch.sum(wb * uq, dim=-1)
        q.append(eta2[..., None] * (2.0 * wb * wu[..., None] - jd._j(uq)))
    s = tuple(jd.s_congr_t(r, jd.s_congr(r, us))   # R (R' U R) R'
              for r, us in zip(S.s_r, u.s))
    return ConeVec(l=S.d_l * u.l, q=tuple(q), s=s)


def lam_sq(S: Scaling) -> ConeVec:
    """lam o lam in scaled space."""
    return ConeVec(l=S.lam_l ** 2,
                   q=tuple(jd.q_jmul(lam, lam) for lam in S.q_lam),
                   s=tuple(torch.diag_embed(sig ** 2) for sig in S.s_lam))


def lam_inv_jmul(S: Scaling, r: ConeVec) -> ConeVec:
    """Solve lam o u = r in scaled space."""
    return ConeVec(
        l=r.l / S.lam_l,
        q=tuple(jd.q_inv_jmul(lam, rq) for lam, rq in zip(S.q_lam, r.q)),
        s=tuple(jd.s_inv_jmul_diag(sig, rs) for sig, rs in zip(S.s_lam, r.s)))


def lam_as_conevec(S: Scaling) -> ConeVec:
    """The scaled point lam as a ConeVec (PSD: diagonal matrices)."""
    return ConeVec(l=S.lam_l, q=S.q_lam,
                   s=tuple(torch.diag_embed(sig) for sig in S.s_lam))


def _maxstep_psd_probes(base: ConeVec, dv: ConeVec):
    """Per-bucket probe matrices Lc^{-1} dv Lc^{-T} (maxstep.m:62-66)."""
    out = []
    for bs, ds in zip(base.s, dv.s):
        lc = _guarded_chol(bs, torch.finfo(bs.dtype).eps)
        t1 = torch.linalg.solve_triangular(lc, ds, upper=False)
        m = torch.linalg.solve_triangular(lc, t1.transpose(-1, -2),
                                          upper=False)
        out.append(0.5 * (m + m.transpose(-1, -2)))
    return out


def _psd_steps(m_list):
    out = []
    for lmin_all in (eigvalsh_multi(m_list) if m_list else []):
        lmin = torch.amin(lmin_all, dim=-1)
        big = torch.full_like(lmin, float("inf"))
        tiny = torch.finfo(lmin.dtype).tiny
        st = torch.where(lmin < 0, -1.0 / torch.clamp_max(lmin, -tiny), big)
        out.append(torch.min(st) if st.numel() else
                   torch.full((), float("inf"), dtype=st.dtype,
                              device=st.device))
    return out


def _inf(like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("inf"), dtype=like.dtype, device=like.device)


def _q_steps(bx: ConeVec, dvx: ConeVec):
    return [torch.min(jd.q_maxstep(bq, dq)) for bq, dq in zip(bx.q, dvx.q)]


def _min_all(steps, like: torch.Tensor) -> torch.Tensor:
    return torch.min(torch.stack(steps)) if steps else _inf(like)


def maxstep_pair(bx: ConeVec, dvx: ConeVec, bz: ConeVec, dvz: ConeVec):
    """sup {a : b + a dv in K} for the general interior scaled-space points
    bx and bz (maxstep.m: psdfactor + psdinvscale + minpsdeig per block),
    both sides' PSD probes in one eigvalsh call per bucket."""
    mx = _maxstep_psd_probes(bx, dvx)
    mz = _maxstep_psd_probes(bz, dvz)
    both = _psd_steps(mx + mz)
    steps_x = [jd.l_maxstep(bx.l, dvx.l)] + _q_steps(bx, dvx) \
        + both[:len(mx)]
    steps_z = [jd.l_maxstep(bz.l, dvz.l)] + _q_steps(bz, dvz) \
        + both[len(mx):]
    return _min_all(steps_x, bx.l), _min_all(steps_z, bx.l)


def maxstep_scaled(S: Scaling, dv: ConeVec) -> torch.Tensor:
    """sup {a : lam + a dv in K} in scaled space (maxstep.m)."""
    steps = [jd.l_maxstep(S.lam_l, dv.l)]
    steps += [torch.min(jd.q_maxstep(lam, dq))
              for lam, dq in zip(S.q_lam, dv.q)]
    m_list = []
    for sig, ds in zip(S.s_lam, dv.s):
        isq = 1.0 / torch.sqrt(sig)
        m_list.append(ds * isq[..., :, None] * isq[..., None, :])
    steps += _psd_steps(m_list)
    return _min_all(steps, S.lam_l)
