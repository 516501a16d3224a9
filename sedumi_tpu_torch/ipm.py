"""Interior-point core: homogeneous self-dual embedding, NT scaling and the
Sturm wide-region predictor-corrector -- one iteration as a function of
the state.

Counterpart of the reference's ipm.py (reference analog: sedumi.m:428-571
with wregion.m / sddir.m / sdfactor.m).  The reference's device-side
control flow (lax.cond at ipm.py:132, :666, :907, :1097 and the
backtracking lax.while_loop at :1177) runs here as host branches: the host
reads the gate's scalar and takes one side.  Element-wise selects
(jnp.where on tensors) stay on the device as torch.where.

Precision (reference ipm.py:314-370): make_step's `dtype` is the state's
(f64, or f32 in the ladder's f32 phase); a lower `compute_dtype` (f32 over
an f64 state) is the hybrid phase: f64 state, residuals and direction
accumulation, f32 scaling, Schur formation and solves, with defect
correction against the f64 residuals.  Every eps and tiny is its dtype's.

The embedding solved is
    A x - b tau = 0,  A'y + z - c tau = 0,  c'x - b'y + kappa = 0,
    x, z in K,  tau, kappa >= 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import jordan as jd
from . import nt
from . import wregion as wr
from .chol import LdlFactor, chol_factor, chol_solve, ldl_masked, \
    ldl_solve, refine_solve
from .cones import Layout
from .fp import resolve_dtype, torch_dtype
from .lax_eigh import coarse_sweeps_of
from .linalg_ops import cholesky, eigh_multi
from .params import CholPars, Pars
from .pcg import pcg, refine_solve_dd
from .schur import build_schur
from .structs import F64, ConeVec, cv_add, cv_cast, cv_dot, cv_eye, \
    cv_leaves, cv_map, cv_neg, cv_norm, cv_scale, cv_sub, cv_zeros


class IPMState(NamedTuple):
    x: ConeVec
    y: torch.Tensor
    z: ConeVec
    tau: torch.Tensor
    kappa: torch.Tensor


class DenseSchurEngine:
    """Dense augmented Schur complement + Cholesky + compensated
    refinement (reference ipm.py:72-189).

    prepare() forms M = [A;c'] H [A;c']' in the operator's dtype and
    factors its leading m x m block; when the Cholesky is not finite it
    falls back to the masked LDL' (kernel K3, or K3-f32 for an f32 block)
    with pars.chol's add/skip rules.  solve() refines against the dense
    matrix: two compensated refinement passes (kernel K1 or K1-f32) then
    PCG (cg.qprec=1), or plain refinement (qprec=0).

    schur_dtype (pars.schur_dtype below the state's dtype) factors in that
    lower precision and refines in full precision against ADA;
    factor_dtype (set by make_step in the hybrid phase) factors the
    f32-formed matrix in f64, Jacobi-scaled, and solves there."""

    def __init__(self, refine_iters: int = 4, qprec: int = 1,
                 schur_dtype=None, factor_dtype=None,
                 chol_pars: CholPars | None = None):
        self.refine_iters = refine_iters
        self.qprec = qprec
        self.schur_dtype = torch_dtype(schur_dtype) if schur_dtype else None
        self.factor_dtype = torch_dtype(factor_dtype) if factor_dtype \
            else None
        self.chol_pars = chol_pars if chol_pars is not None else CholPars()

    def prepare(self, aop, S: nt.Scaling, reg: float):
        m = aop.m
        Maug = build_schur(aop, S)
        ADA = Maug[:m, :m]
        sd, fd = self.schur_dtype, self.factor_dtype
        if fd is not None and fd != ADA.dtype:
            ADA = ADA.to(fd)
            f = chol_factor(ADA, reg, jacobi=True)
        elif sd is not None and sd != ADA.dtype:
            f = chol_factor(ADA.to(sd), reg)
        else:
            f = chol_factor(ADA, reg)
        fl = None
        ok = bool(f.ok)
        if not ok:
            cp = self.chol_pars
            fl = ldl_masked(ADA, canceltol=cp.canceltol, maxu=cp.maxu,
                            abstol=cp.abstol, skip_pivots=bool(cp.skip))
            ok = bool(torch.all(torch.isfinite(fl.L))
                      & torch.all(~torch.isnan(fl.d)))
        return (ADA, f, fl), Maug[:m, m], Maug[m, m], ok

    def solve(self, ctx, rhs: torch.Tensor) -> torch.Tensor:
        ADA, f, fl = ctx

        if fl is None:
            def base_solve(b):
                return chol_solve(f, b)
        else:
            fl0 = LdlFactor(L=fl.L, d=fl.d,
                            skip=torch.zeros_like(fl.skip),
                            diagadd=torch.zeros_like(fl.diagadd))

            def base_solve(b):
                return ldl_solve(fl0, b)

        if ADA.dtype != rhs.dtype:
            # hybrid: the f64 factor of the f32-formed matrix solves in f64
            # and hands back an f32 direction (the defect-correction loop
            # measures the true f64 defects)
            b64 = rhs.to(ADA.dtype)
            x = base_solve(b64)
            for _ in range(self.refine_iters):
                x = x + base_solve(b64 - ADA @ x)
            return x.to(rhs.dtype)
        if f.L.dtype != ADA.dtype:
            # low-precision factor (schur_dtype): refine in full precision
            # against ADA, only the triangular solves cast down; an f32
            # factor loses ~29 bits, each pass recovers up to ~23.  As in
            # the reference, the LDL' fallback is not used on this path.
            def solve_lo(b):
                return chol_solve(f, b.to(f.L.dtype)).to(ADA.dtype)

            x = solve_lo(rhs)
            for _ in range(max(6, self.refine_iters)):
                x = x + solve_lo(rhs - ADA @ x)
            return x
        if not self.qprec:
            return refine_solve(lambda v: ADA @ v, base_solve, rhs,
                                iters=self.refine_iters)
        # Krylov endgame recovery (wrapPcg.m:94-130 role): x0 from two
        # compensated refinement passes, then PCG polishes to stagnation
        x0 = refine_solve_dd(ADA, base_solve, rhs, iters=2)
        return pcg(lambda v: ADA @ v, base_solve, rhs, x0,
                   maxiter=12, restol=1e-16).x


class StepStats(NamedTuple):
    """Per-iteration scalars for the host loop in solver.py (0-dim tensors)."""

    mu: torch.Tensor
    alpha: torch.Tensor
    sigma: torch.Tensor
    err_p: torch.Tensor      # ||Ax - b tau|| / tau / den_p
    err_d: torch.Tensor      # ||A'y + z - c tau|| / tau / den_d
    gap_rel: torch.Tensor    # |c'x - b'y|/tau / (1+|c'x/tau|+|b'y/tau|)
    cx: torch.Tensor         # c'x (unscaled by tau)
    by: torch.Tensor         # b'y
    tau: torch.Tensor
    kappa: torch.Tensor
    chol_ok: torch.Tensor
    res_p_abs: torch.Tensor  # ||Ax - b tau||
    res_d_abs: torch.Tensor  # ||A'y + z - c tau||
    dir_defect: torch.Tensor  # ||A dx - b dtau + rp|| / (||rp|| + mu)
    wr_delta: torch.Tensor   # proximity delta of the incoming iterate
    centered: torch.Tensor   # 1.0 when the initial centering step was taken
    maxt1: torch.Tensor      # predictor boundary step from the base point
    mu_floor: torch.Tensor   # eps * (sum_i |x_i z_i| + tau kappa)/(nu+1)

    def to_host(self) -> dict:
        """All fields as Python floats, read in one device transfer."""
        vals = torch.stack([v.to(F64).reshape(()) for v in self]).cpu()
        return dict(zip(self._fields, vals.tolist()))


def cv_jmul(a: ConeVec, b: ConeVec) -> ConeVec:
    return ConeVec(
        l=a.l * b.l,
        q=tuple(jd.q_jmul(x, y) for x, y in zip(a.q, b.q)),
        s=tuple(jd.s_jmul(x, y) for x, y in zip(a.s, b.s)),
    )


def init_state(layout: Layout, aop, b, normb: float, normc: float,
               pars: Pars, device="cuda", dtype=F64) -> IPMState:
    """Identity start on the central path (sdinit.m:42-105):
    mu0 = pars.mu * sqrt((1+||b||inf)(1+||c||inf))."""
    mu0 = pars.mu * math.sqrt((1.0 + normb) * (1.0 + normc))
    root = math.sqrt(mu0)
    e = cv_eye(layout, device, dtype)
    return IPMState(x=cv_scale(e, root), y=torch.zeros(aop.m, dtype=dtype,
                                                      device=device),
                    z=cv_scale(e, root),
                    tau=torch.tensor(1.0, dtype=dtype, device=device),
                    kappa=torch.tensor(mu0, dtype=dtype, device=device))


def cast_state(state: IPMState, dtype) -> IPMState:
    """The iterate cast between precision phases (reference ipm.py:254)."""
    return cv_cast(state, dtype)


def make_recenter(layout: Layout, dtype=F64):
    """Pull an iterate strictly back into the cone interior by shifting
    x and z along e until lam_min >= 1e-2 mu / (1 + lam_max(other))
    (reference ipm.make_recenter; a no-op for safely interior iterates).
    `dtype` is the iterate's: f64, or f32 for the hybrid phase's entry."""

    def lam_range(cv: ConeVec):
        mins, maxs = [], []
        if cv.l.numel():
            mins.append(torch.min(cv.l))
            maxs.append(torch.max(cv.l))
        for lam in [jd.q_eig(xq) for xq in cv.q] + \
                [jd.s_eig(xs) for xs in cv.s]:
            mins.append(torch.min(lam))
            maxs.append(torch.max(lam))
        return torch.min(torch.stack(mins)), torch.max(torch.stack(maxs))

    def recenter(state: IPMState) -> IPMState:
        x, y, z, tau, kappa = state
        mu = (cv_dot(x, z) + tau * kappa) / (layout.nu + 1.0)
        xmin, xmax = lam_range(x)
        zmin, zmax = lam_range(z)
        rho_x = torch.clamp_min(1e-2 * mu / (1.0 + zmax) - xmin, 0.0)
        rho_z = torch.clamp_min(1e-2 * mu / (1.0 + xmax) - zmin, 0.0)
        e = cv_eye(layout, y.device, dtype)
        return IPMState(
            x=cv_add(x, cv_scale(e, rho_x)), y=y,
            z=cv_add(z, cv_scale(e, rho_z)), tau=tau,
            kappa=torch.maximum(kappa, 1e-2 * mu / (1.0 + tau)))

    return recenter


def _pos_step(val, dval):
    """sup {a : val + a dval >= 0} for scalar val > 0."""
    return torch.where(dval < 0, -val / dval,
                       torch.full_like(val, float("inf")))


def _diag_cv(vals_l, q_vecs, vals_s) -> ConeVec:
    return ConeVec(l=vals_l, q=tuple(q_vecs),
                   s=tuple(torch.diag_embed(v) for v in vals_s))


def _all_finite(tensors) -> bool:
    return bool(torch.stack([torch.all(torch.isfinite(t))
                             for t in tensors]).all())


def _strict_interior(cv: ConeVec) -> torch.Tensor:
    oks = []
    if cv.l.numel():
        oks.append(torch.all(cv.l > 0))
    for xq in cv.q:
        oks.append(torch.all(jd.q_eig(xq)[..., 0] > 0))
    for xs in cv.s:
        oks.append(torch.all(torch.isfinite(cholesky(xs))))
    return torch.stack(oks).all() if oks else \
        torch.ones((), dtype=torch.bool, device=cv.l.device)


def make_step(layout: Layout, pars: Pars, normb: float, normc: float,
              cscale: float = 1.0, dtype=None, engine=None,
              compute_dtype=None, err_dens=None):
    """Build the one-iteration step function for a fixed layout.

    The returned step(aop, b, rs, state, reg, sd_on=True, aop_lo=None) ->
    (new_state, StepStats) runs on the device of its tensors.  The solver
    runs on row-equilibrated A, b and on c/cscale; normb/normc and err_dens
    are the original-data scales, so the reported stats are in original
    units (reference ipm.make_step).

    `dtype` is the state's (default from pars.dtype: f64, or f32 for
    'float32'); `aop` carries it.  A lower `compute_dtype` makes this the
    hybrid phase (reference ipm.py:333-370): the scaling, the Schur
    formation (on `aop_lo`, the operator in the compute dtype) and the
    solves run in f32, the residuals and the direction accumulation in the
    state's f64, with at least two defect-correction passes on the primal,
    dual and gap rows; the Sturm centering and the Gondzio rounds are
    skipped, and a direction whose defect stays above 50 is not taken."""
    nu = layout.nu
    herm_flags = tuple(b.herm for b in layout.s_buckets)
    den_p, den_d = err_dens if err_dens is not None else (1.0 + normb,
                                                          1.0 + normc)
    gamma = 0.99  # step fraction to the boundary
    defect_correct = max(0, int(pars.cg.refine))
    dtype = resolve_dtype(pars.dtype) if dtype is None else torch_dtype(dtype)
    cd = torch_dtype(compute_dtype) if compute_dtype is not None else dtype
    hybrid = cd != dtype
    if hybrid:
        defect_correct = max(defect_correct, 2)
    if engine is None:
        sdt = None
        if pars.schur_dtype and torch_dtype(pars.schur_dtype) != cd:
            sdt = pars.schur_dtype
        engine = DenseSchurEngine(qprec=int(pars.cg.qprec), schur_dtype=sdt,
                                  chol_pars=pars.chol)
    if hybrid and hasattr(engine, "factor_dtype") \
            and engine.factor_dtype is None:
        # f64 factor of the f32-formed matrix (reference ipm.py:366-369)
        engine.factor_dtype = dtype
    # host decisions of the step; an engine split over a mesh makes them
    # global rank 0's, so every rank issues the same collectives
    flag = getattr(engine, "agree", bool)
    sturm = pars.alg == 2 and bool(pars.wr) and not hybrid
    use_wr = bool(pars.wr) and pars.alg != 0
    fi_cd, eps_hi = torch.finfo(cd), torch.finfo(dtype).eps
    # the PSD positivity probe runs in f32 when the compute dtype is f32
    # (reference ipm.py:1125-1136); native-f64 phases probe in f64
    probe_dt = torch.float32 if cd == torch.float32 else dtype
    eps_pr = torch.finfo(probe_dt).eps

    def lo(t):
        return cv_cast(t, cd)

    def hi(t):
        return cv_cast(t, dtype)

    def lo_safe(cv: ConeVec) -> ConeVec:
        """Cast an interior f64 iterate to the compute dtype without losing
        positivity: each block shifted by 4 eps_cd lam_max (reference
        ipm.py:379-403).  The shift perturbs only the scaling, which the
        f64 defect correction absorbs."""
        if not hybrid:
            return lo(cv)
        q = []
        for xq in cv.q:
            x32 = lo(xq)
            q.append(torch.cat([x32[..., :1] + 4 * fi_cd.eps * x32[..., :1],
                                x32[..., 1:]], dim=-1))
        s = []
        for xs in cv.s:
            x32 = lo(xs)
            mx = torch.amax(torch.abs(torch.diagonal(x32, dim1=-2, dim2=-1)),
                            dim=-1)
            s.append(nt._add_diag(x32, (4 * fi_cd.eps * mx)[..., None]))
        return ConeVec(l=lo(cv.l), q=tuple(q), s=tuple(s))

    def step(aop, b: torch.Tensor, rs: torch.Tensor, state: IPMState,
             reg: float, sd_on: bool = True, aop_lo=None):
        if aop_lo is None:
            aop_lo = aop
        m = aop.m
        dev = b.device
        x, y, z, tau, kappa = state
        zero_cv = cv_zeros(layout, dev, cd)
        e_scaled = cv_eye(layout, dev, cd)
        zero_cd = torch.zeros((), dtype=cd, device=dev)
        zero_hi = torch.zeros((), dtype=dtype, device=dev)

        # --- residuals (state dtype: the exact fixed point) --------------
        ax = aop.apply(x)
        Ax, cx = ax[:m], ax[m]
        rp = Ax - b * tau
        rd = cv_add(aop.adj_y(y, -tau), z)      # A'y + z - c tau
        by = b @ y
        rg = cx - by + kappa
        gap = cv_dot(x, z)
        mu = (gap + tau * kappa) / (nu + 1.0)

        # state-representation complementarity floor (StepStats.mu_floor)
        mf_abs = torch.abs(tau * kappa)
        for xl_, zl_ in zip(cv_leaves(x), cv_leaves(z)):
            if xl_.numel():
                mf_abs = mf_abs + torch.sum(torch.abs(xl_ * zl_))
        mu_floor = eps_hi * mf_abs / (nu + 1.0)

        # --- scaling + Schur (compute dtype; the engine sees reg rounded
        # to it, as the reference's lo(reg)) ------------------------------
        S = nt.compute_scaling(lo_safe(x), lo_safe(z), herm=herm_flags)
        ctx, ahc, chc, fac_ok = engine.prepare(
            aop_lo, S, float(torch.tensor(reg, dtype=cd)))
        tau_l, kappa_l, b_l = lo(tau), lo(kappa), lo(b)

        def solve(rhs):
            return engine.solve(ctx, rhs)

        u = solve(b_l + ahc)
        # self-dual denominator, clamped to its cancellation noise floor
        bu, au = b_l @ u, ahc @ u
        D_raw = chc + bu - au + kappa_l / tau_l
        D_floor = fi_cd.eps * (torch.abs(chc) + torch.abs(bu)
                               + torch.abs(au)) + fi_cd.tiny
        D = torch.where(torch.isfinite(D_raw) & (D_raw > D_floor), D_raw,
                        D_floor)

        def direction_raw(rp_rhs, rd_rhs: ConeVec, rg_rhs, rc: ConeVec,
                          r_tk):
            """Newton direction for general right-hand sides (sddir.m), all
            in the compute dtype:
                 A dx - b dtau = rp_rhs,  A'dy + dz - c dtau = rd_rhs,
                 c'dx - b'dy + dkappa = rg_rhs,  dx + H dz = W(lam^-1 o rc),
                 tau dkappa + kappa dtau = r_tk."""
            rcx = nt.scale_v_to_x(S, nt.lam_inv_jmul(S, rc))
            t = cv_sub(rcx, nt.H_apply(S, rd_rhs))
            att = aop_lo.apply(t)
            v = solve(rp_rhs - att[:m])
            num = -rg_rhs + r_tk / tau_l + att[m] - (b_l - ahc) @ v
            dtau = num / D
            dy = v + dtau * u
            dz = cv_sub(rd_rhs, aop_lo.adj_y(dy, -dtau))
            dx = cv_sub(rcx, nt.H_apply(S, dz))
            dkappa = (r_tk - kappa_l * dtau) / tau_l
            return dx, dy, dz, dtau, dkappa

        def direction(rc: ConeVec, r_tk, r_scale: float = 1.0):
            """Direction for r_scale times the current residuals, polished
            by monotone defect-correction passes in the state dtype (a pass
            is kept only if it reduced the measured defect: primal + gap,
            and in the hybrid phase the dual row too)."""

            def defects(dx, dy, dz, dtau, dkappa):
                dax = aop.apply(dx)
                def_p = -r_scale * rp - (dax[:m] - b * dtau)
                def_g = -r_scale * rg - (dax[m] - b @ dy + dkappa)
                nrm = torch.linalg.norm(def_p) + torch.abs(def_g)
                if not hybrid:
                    return def_p, zero_cv, def_g, nrm
                # the dual row is exact by construction only in the
                # compute dtype: A'dy + dz - c dtau + r_scale rd
                def_d = cv_neg(cv_add(cv_scale(rd, r_scale),
                                      cv_add(aop.adj_y(dy, -dtau), dz)))
                return def_p, def_d, def_g, nrm + cv_norm(def_d)

            dx, dy, dz, dtau, dkappa = hi(direction_raw(
                lo(-r_scale * rp) if r_scale else
                torch.zeros(m, dtype=cd, device=dev),
                lo(cv_scale(cv_neg(rd), r_scale)), lo(-r_scale * rg), rc,
                r_tk))
            for _ in range(defect_correct):
                def_p, def_d, def_g, nrm_old = defects(dx, dy, dz, dtau,
                                                       dkappa)
                cx_, cy_, cz_, ct_, ck_ = hi(direction_raw(
                    lo(def_p), lo(def_d), lo(def_g), zero_cv, zero_cd))
                dx2, dy2, dz2 = cv_add(dx, cx_), dy + cy_, cv_add(dz, cz_)
                dtau2, dkappa2 = dtau + ct_, dkappa + ck_
                keep = defects(dx2, dy2, dz2, dtau2, dkappa2)[3] < nrm_old

                def pick(a2, a):
                    return torch.where(keep, a2, a)

                dx, dz = cv_map(pick, dx2, dx), cv_map(pick, dz2, dz)
                dy, dtau, dkappa = pick(dy2, dy), pick(dtau2, dtau), \
                    pick(dkappa2, dkappa)
            return dx, dy, dz, dtau, dkappa

        lam2 = nt.lam_sq(S)
        lam_cv = nt.lam_as_conevec(S)
        vtk = torch.sqrt(tau_l * kappa_l)
        # centering contribution (zero unless the Sturm path fills it)
        dxc = dzc = cv_zeros(layout, dev, dtype)
        dyc = torch.zeros(m, dtype=dtype, device=dev)
        dtauc = dkappac = zero_hi
        xs_b, zs_b = lam_cv, lam_cv          # scaled-space base points
        tau_b, kappa_b = tau_l, kappa_l
        delta0, gate, maxt1 = zero_hi, False, zero_hi

        if sturm:
            # ---- Sturm wide-region iteration (wregion.m): initial
            # centering -> predictor -> 2nd-order corrector, all with one
            # NT scaling / factorization (never in the hybrid phase, so
            # the state and compute dtypes agree here) ----
            w_all = torch.cat(
                [S.lam_l ** 2]
                + [jd.q_eig(ql).reshape(-1) ** 2 for ql in S.q_lam]
                + [(sig ** 2).reshape(-1) for sig in S.s_lam]
                + [(vtk ** 2).reshape(1)])
            delta0, h0, alpha0 = wr.iswnbr(w_all, pars.theta)
            ok0 = (torch.isfinite(delta0) & torch.isfinite(h0) & (h0 > 0)
                   & torch.isfinite(alpha0) & (delta0 > 0))
            fac = torch.where(ok0, 1.0 - alpha0, 1.0)
            h_eff = torch.where(ok0, h0, 0.0)
            # projection target vTAR = (1-alpha)*max(h, lam) (wregion.m:48)
            lam_q_vals = [jd.q_eig(ql) for ql in S.q_lam]
            vt_l = fac * torch.maximum(h_eff, S.lam_l)
            vt_q_vals = [fac * torch.maximum(h_eff, lv) for lv in lam_q_vals]
            vt_s = [fac * torch.maximum(h_eff, sig) for sig in S.s_lam]
            vt_tk = fac * torch.maximum(h_eff, vtk)

            # ---- initial centering toward vTAR, residual rows zero
            # (wregion.m:50-55); dropped if it leaves the interior ----
            if flag(ok0 & (delta0 > 1e-4)):   # host gate (ipm.py:666)
                rc_c = _diag_cv(
                    2.0 * S.lam_l * (vt_l - S.lam_l),
                    [jd.q_remap(ql, 2.0 * lv * (v_ - lv))
                     for ql, lv, v_ in zip(S.q_lam, lam_q_vals, vt_q_vals)],
                    [2.0 * sig * (v_ - sig) for sig, v_ in zip(S.s_lam,
                                                              vt_s)])
                rtk_c = 2.0 * vtk * (vt_tk - vtk)
                dc = direction(rc_c, rtk_c, r_scale=0.0)
                dxc_t, dyc_t, dzc_t, dtauc_t, dkappac_t = dc
                xs_ct = cv_add(lam_cv, nt.scale_x_to_v(S, dxc_t))
                zs_ct = cv_add(lam_cv, nt.scale_z_to_v(S, dzc_t))
                tau_ct, kappa_ct = tau + dtauc_t, kappa + dkappac_t
                gate = flag(_all_finite(cv_leaves(dxc_t) + cv_leaves(dzc_t)
                                         + [dyc_t, dtauc_t, dkappac_t])
                            and bool((tau_ct > 0) & (kappa_ct > 0)
                                     & _strict_interior(xs_ct)
                                     & _strict_interior(zs_ct)))
            if gate:
                dxc, dyc, dzc, dtauc, dkappac = dc
                xs_b, zs_b, tau_b, kappa_b = xs_ct, zs_ct, tau_ct, kappa_ct
            else:
                # a rejected centering reverts the target to lam itself
                vt_l, vt_q_vals, vt_s, vt_tk = S.lam_l, lam_q_vals, \
                    list(S.s_lam), vtk
            vt_q = [jd.q_remap(ql, v_) for ql, v_ in zip(S.q_lam, vt_q_vals)]
            vtar_cv = _diag_cv(vt_l, vt_q, vt_s)

            # ---- predictor from the base point: pv = -vTAR
            # (wregion.m:73-94), full residual rows ----
            rc_p = _diag_cv(
                -S.lam_l * vt_l,
                [jd.q_remap(ql, -(lv * v_))
                 for ql, lv, v_ in zip(S.q_lam, lam_q_vals, vt_q_vals)],
                [-(sig * v_) for sig, v_ in zip(S.s_lam, vt_s)])
            dxa, dya, dza, dtaua, dkappaa = direction(rc_p, -(vtk * vt_tk))
            dxs_a = nt.scale_x_to_v(S, dxa)
            dzs_a = nt.scale_z_to_v(S, dza)
            ms_x, ms_z = nt.maxstep_pair(xs_b, dxs_a, zs_b, dzs_a)
            maxt1 = torch.minimum(
                torch.minimum(ms_x, ms_z),
                torch.minimum(_pos_step(tau_b, dtaua),
                              _pos_step(kappa_b, dkappaa)))
            maxt1 = torch.clamp(maxt1, 0.0, 1.0)
            # ---- 2nd-order corrector, alg=2 (wregion.m:104-119):
            # tTAR = 1-(1-maxt1)^3, sigma = (1-tTAR) tTAR ----
            tT = 1.0 - (1.0 - maxt1) ** 3
            sigma = (1.0 - tT) * tT
            mu_c = (cv_dot(xs_b, zs_b) + tau_b * kappa_b) / (nu + 1.0)
            dxmdz = cv_sub(dxs_a, dzs_a)
            dtk_a = (dtaua * torch.sqrt(kappa / tau)
                     - dkappaa * torch.sqrt(tau / kappa))
            gd1 = ConeVec(     # vTAR^{-1} o dxmdz (wregion.m:100-102)
                l=dxmdz.l / vt_l,
                q=tuple(jd.q_inv_jmul(vq, dq)
                        for vq, dq in zip(vt_q, dxmdz.q)),
                s=tuple(jd.s_inv_jmul_diag(vs, ds)
                        for vs, ds in zip(vt_s, dxmdz.s)))
            t2 = cv_jmul(gd1, dxmdz)
            vtar_inv = _diag_cv(1.0 / vt_l, [jd.q_inv(vq) for vq in vt_q],
                                [1.0 / vs for vs in vt_s])
            pv = cv_add(
                cv_add(cv_scale(t2, tT / 4.0),
                       cv_scale(vtar_inv, (1.0 - tT) * tT * mu_c)),
                cv_scale(vtar_cv, -(1.0 + tT / 4.0)))
            rc = cv_jmul(lam_cv, pv)
            pv_tk = ((tT / 4.0) * (dtk_a / vt_tk) * dtk_a
                     + (1.0 - tT) * tT * mu_c / vt_tk
                     - (1.0 + tT / 4.0) * vt_tk)
            r_tk = vtk * pv_tk
        else:
            # ---- Mehrotra affine predictor (the hybrid phase's path) ----
            dxa, dya, dza, dtaua, dkappaa = direction(cv_neg(lam2),
                                                      lo(-tau * kappa))
            dxs_a = nt.scale_x_to_v(S, lo(dxa))
            dzs_a = nt.scale_z_to_v(S, lo(dza))
            amax_a = torch.minimum(
                torch.minimum(nt.maxstep_scaled(S, dxs_a),
                              nt.maxstep_scaled(S, dzs_a)),
                torch.minimum(_pos_step(tau, dtaua),
                              _pos_step(kappa, dkappaa)))
            a_aff = torch.clamp_max(amax_a, 1.0)
            gap_aff = (gap + a_aff * (cv_dot(x, dza) + cv_dot(z, dxa))
                       + a_aff**2 * cv_dot(dxa, dza)
                       + (tau + a_aff * dtaua) * (kappa + a_aff * dkappaa))
            sigma = torch.clamp((gap_aff / (nu + 1.0) / mu) ** 3, 0.0, 1.0)
            sm_l = lo(sigma * mu)
            if pars.alg == 0:
                rc = cv_sub(cv_scale(e_scaled, sm_l), lam2)
                r_tk = sm_l - lo(tau * kappa)
            elif pars.alg == 1:
                # v-linearized 2nd-order corrector (wregion.m:105-110)
                t1 = lo(torch.clamp_max(amax_a, 1.0))
                dxmdz = cv_sub(dxs_a, dzs_a)
                rc = cv_add(
                    cv_scale(cv_jmul(lam_cv, cv_sub(
                        cv_scale(e_scaled, torch.sqrt(sm_l)), lam_cv)), 2.0),
                    cv_scale(cv_jmul(dxmdz, dxmdz), 0.25 * t1**2))
                vtk_hi = torch.sqrt(tau * kappa)
                dtk = (dtaua * torch.sqrt(kappa / tau)
                       - dkappaa * torch.sqrt(tau / kappa))
                r_tk = lo(2.0 * vtk_hi * (torch.sqrt(sigma * mu) - vtk_hi)) \
                    + 0.25 * t1**2 * lo(dtk)**2
            else:
                rc = cv_sub(cv_sub(cv_scale(e_scaled, sm_l), lam2),
                            cv_jmul(dxs_a, dzs_a))
                r_tk = sm_l - lo(tau * kappa + dtaua * dkappaa)

        # --- combined (corrector) direction ------------------------------
        dx, dy, dz, dtau, dkappa = direction(rc, r_tk)
        dax_full = aop.apply(dx)
        dir_defect = torch.linalg.norm(dax_full[:m] - b * dtau + rp) / (
            torch.linalg.norm(rp) + mu + 1e-30)
        # line-search base point (centered when the centering was taken)
        x_b, z_b = cv_add(x, dxc), cv_add(z, dzc)
        tau_bb, kappa_bb = tau + dtauc, kappa + dkappac
        gap_b = cv_dot(x_b, z_b)
        dxs = nt.scale_x_to_v(S, lo(dx))
        dzs = nt.scale_z_to_v(S, lo(dz))
        if sturm:
            ms_x, ms_z = nt.maxstep_pair(xs_b, dxs, zs_b, dzs)
            amax_p = torch.minimum(ms_x, _pos_step(tau_b, dtau))
            amax_d = torch.minimum(ms_z, _pos_step(kappa_b, dkappa))
        else:
            amax_p = torch.minimum(nt.maxstep_scaled(S, dxs),
                                   _pos_step(tau, dtau))
            amax_d = torch.minimum(nt.maxstep_scaled(S, dzs),
                                   _pos_step(kappa, dkappa))

        # --- Gondzio multiple centrality correctors (pars.mcc; not in the
        # hybrid phase, so the two dtypes agree here) ---------------------
        def mcc_round(dx, dy, dz, dtau, dkappa, dxs, dzs, amax_p, amax_d):
            th = torch.clamp_max(1.5 * gamma * torch.minimum(amax_p, amax_d),
                                 1.0)
            xs_t = cv_map(lambda a, d_: a + th * d_, xs_b, dxs)
            zs_t = cv_map(lambda a, d_: a + th * d_, zs_b, dzs)
            w_t = cv_jmul(xs_t, zs_t)
            wtk_t = (tau_b + th * dtau) * (kappa_b + th * dkappa)
            mu_t = (cv_dot(xs_t, zs_t) + wtk_t) / (nu + 1.0)
            blo_, bhi_ = 0.1 * mu_t, 10.0 * mu_t

            def clipd(v):
                return torch.clamp(v, blo_, bhi_) - v

            rcg_q = [jd.q_remap(wq, clipd(jd.q_eig(wq))) for wq in w_t.q]
            rcg_s = [(V * clipd(ww)[..., None, :]) @ V.transpose(-1, -2)
                     for ww, V in eigh_multi(list(w_t.s),
                                             sweeps=coarse_sweeps_of(w_t.s))]
            rc_g = ConeVec(l=clipd(w_t.l), q=tuple(rcg_q), s=tuple(rcg_s))
            dg = direction(rc_g, clipd(wtk_t), r_scale=0.0)
            dxg, dyg, dzg, dtaug, dkappag = dg
            dx2, dy2, dz2 = cv_add(dx, dxg), dy + dyg, cv_add(dz, dzg)
            dtau2, dkappa2 = dtau + dtaug, dkappa + dkappag
            dxs2 = nt.scale_x_to_v(S, dx2)
            dzs2 = nt.scale_z_to_v(S, dz2)
            ms_x2, ms_z2 = nt.maxstep_pair(xs_b, dxs2, zs_b, dzs2)
            amax_p2 = torch.minimum(ms_x2, _pos_step(tau_b, dtau2))
            amax_d2 = torch.minimum(ms_z2, _pos_step(kappa_b, dkappa2))
            better = flag(_all_finite(cv_leaves(dxg) + cv_leaves(dzg)
                                      + [dyg, dtaug, dkappag]) and bool(
                torch.minimum(amax_p2, amax_d2)
                > 1.05 * torch.minimum(amax_p, amax_d)))
            if better:
                return (dx2, dy2, dz2, dtau2, dkappa2, dxs2, dzs2,
                        amax_p2, amax_d2)
            return dx, dy, dz, dtau, dkappa, dxs, dzs, amax_p, amax_d

        carry = (dx, dy, dz, dtau, dkappa, dxs, dzs, amax_p, amax_d)
        for _ in range(0 if hybrid else max(0, int(pars.mcc))):
            # host gate (ipm.py:907): only short boundary steps get a round
            if flag(torch.minimum(carry[7], carry[8]) < 0.8):
                carry = mcc_round(*carry)
        dx, dy, dz, dtau, dkappa, dxs, dzs, amax_p, amax_d = carry
        if pars.mcc and not hybrid:
            dax_full = aop.apply(dx)   # refresh for the stepdif model

        amax_p, amax_d = amax_p.to(dtype), amax_d.to(dtype)
        amax = torch.minimum(amax_p, amax_d)
        alpha = torch.clamp_max(gamma * amax, 1.0)
        if use_wr:
            # wide-region acceptance (wregion.m:136-150) with the
            # gap-elimination step fullt (widelen.m:46-60); the trial
            # spectra in the compute dtype
            gap_tot = gap_b + tau_bb * kappa_bb
            dgap = (cv_dot(x_b, dz) + cv_dot(z_b, dx)
                    + tau_bb * dkappa + kappa_bb * dtau)
            qneg = torch.clamp_max(cv_dot(dx, dz) + dtau * dkappa, 0.0)
            fullt = torch.where(
                dgap < -1e-5 * gap_tot,
                2.0 * gap_tot / (-dgap + torch.sqrt(torch.clamp_min(
                    dgap**2 - 4.0 * gap_tot * qneg, 0.0))),
                2.0 * alpha)
            t_wr, _ = wr.widelen_batched(
                xs_b, dxs, dzs, tau_b, lo(dtau), kappa_b, lo(dkappa),
                lo(alpha), pars.theta, pars.beta, zbase=zs_b,
                fullt=lo(fullt))
            alpha = torch.minimum(alpha, t_wr)

        tp = td = alpha
        if pars.stepdif:
            tp, td = _stepdif(pars, sd_on, use_wr, alpha, amax_p, amax_d,
                              gamma, aop, b, rp, rd, dax_full, dx, dy, dz,
                              dtau, dkappa, x_b, z_b, tau_bb, kappa_bb,
                              gap_b, xs_b, zs_b, dxs, dzs, m, lo, flag)
        if hybrid:
            # never step along a direction whose defect stayed catastrophic
            # (a beyond-conditioning f32 solve): the null step lets the
            # host's stall logic escalate (reference ipm.py:1108-1116)
            bad_dir = dir_defect > 50.0
            tp = torch.where(bad_dir, 0.0, tp)
            td = torch.where(bad_dir, 0.0, td)

        # --- positivity backtracking in the state dtype (ipm.py:1177);
        # the PSD probe in probe_dt ---
        def interior(cv: ConeVec, t_, k_) -> torch.Tensor:
            oks = [t_ > 0, k_ > 0]
            if cv.l.numel():
                oks.append(torch.all(
                    cv.l > -4 * eps_hi * torch.max(torch.abs(cv.l))))
            for xq in cv.q:
                oks.append(torch.all(
                    jd.q_eig(xq)[..., 0] > -4 * eps_hi * xq[..., 0]))
            for xs in cv.s:
                x32 = xs.to(probe_dt)
                mx = torch.amax(torch.abs(torch.diagonal(x32, dim1=-2,
                                                         dim2=-1)), dim=-1)
                ch = cholesky(nt._add_diag(x32, (4 * eps_pr * mx)[..., None]))
                oks.append(torch.all(torch.isfinite(ch)))
            return torch.stack(oks).all()

        for _ in range(12):
            xc = cv_map(lambda a, d_: a + tp * d_, x_b, dx)
            zc = cv_map(lambda a, d_: a + td * d_, z_b, dz)
            # tau stays positive at BOTH rates (mu_c denominator below)
            tau_c = torch.minimum(tau_bb + tp * dtau, tau_bb + td * dtau)
            kap_c = kappa_bb + td * dkappa
            if flag(interior(xc, tau_c, kap_c) & interior(zc, tau_c, kap_c)):
                break
            tp, td = 0.6 * tp, 0.6 * td

        # differentiated-step update with homogeneous compensation
        # (wregion.m:162-196): the extended side steps to its own length,
        # the other steps to the base length scaled by mu_c
        ext_p = tp >= td
        t_ext = torch.maximum(tp, td)
        mu_c = (tau_bb + t_ext * dtau) / (tau_bb + torch.minimum(tp, td)
                                           * dtau)
        sc_z = torch.where(ext_p, mu_c, 1.0)
        sc_x = torch.where(ext_p, 1.0, mu_c)
        new = IPMState(
            x=cv_map(lambda a, d_: sc_x * (a + tp * d_), x_b, dx),
            y=sc_z * (y + dyc + td * dy),
            z=cv_map(lambda a, d_: sc_z * (a + td * d_), z_b, dz),
            tau=tau_bb + t_ext * dtau,
            kappa=sc_z * (kappa_bb + td * dkappa),
        )

        res_p = torch.linalg.norm(rp / rs)
        res_d = cv_norm(rd) * cscale
        cxs = cx / tau * cscale
        bys = by / tau * cscale
        stats = StepStats(
            mu=mu, alpha=torch.minimum(tp, td), sigma=sigma,
            err_p=res_p / tau / den_p, err_d=res_d / tau / den_d,
            gap_rel=torch.abs(cxs - bys) / (1.0 + torch.abs(cxs)
                                            + torch.abs(bys)),
            cx=cx * cscale, by=by * cscale, tau=tau, kappa=kappa,
            chol_ok=torch.tensor(float(fac_ok), dtype=F64, device=dev),
            res_p_abs=res_p, res_d_abs=res_d, dir_defect=dir_defect,
            wr_delta=delta0,
            centered=torch.tensor(float(gate), dtype=F64, device=dev),
            maxt1=maxt1, mu_floor=mu_floor,
        )
        return new, stats

    return step


def _stepdif(pars, sd_on, use_wr, alpha, amax_p, amax_d, gamma, aop, b, rp,
             rd, dax_full, dx, dy, dz, dtau, dkappa, x_b, z_b, tau_b,
             kappa_b, gap_b, xs_b, zs_b, dxs, dzs, m, lo, flag=bool):
    """Primal/dual step-length differentiation (stepdif.m:39-175 restated
    for the HSD coordinates, with the homogeneous compensation of
    wregion.m:162-168) and the trydif.m wide-region re-test, whose spectra
    run in the compute dtype (`lo` casts to it).  Returns (tp, td)."""
    dev, dt = alpha.device, alpha.dtype
    dAx = dax_full[:m] - b * dtau                                # d/dtp rp
    u1 = cv_add(aop.adj_y(dy, torch.zeros((), dtype=dt, device=dev)), dz)
    u2 = aop.adj(torch.cat([torch.zeros(m, dtype=dt, device=dev),
                            dtau.reshape(1)]))                   # c dtau
    rr = rp @ rp
    ra = rp @ dAx
    aa = dAx @ dAx
    dd = cv_dot(rd, rd)
    u12 = cv_sub(u1, u2)
    d1m2 = cv_dot(rd, u12)
    e1m2 = cv_dot(u12, u12)
    xz = gap_b
    xdz = cv_dot(x_b, dz)
    zdx = cv_dot(z_b, dx)
    dxdz = cv_dot(dx, dz)
    w1, w2 = pars.w

    tp_hi = torch.clamp_max(gamma * amax_p, 1.0)
    td_hi = torch.clamp_max(gamma * amax_d, 1.0)
    gap_eq = (xz + alpha * (zdx + xdz) + alpha**2 * dxdz
              + (tau_b + alpha * dtau) * (kappa_b + alpha * dkappa))
    gap_cap = torch.clamp_min(1.25 * gap_eq, 0.0)
    tau_a = tau_b + alpha * dtau
    tk_a = tau_a * (kappa_b + alpha * dkappa)
    rp2_aa = torch.clamp_min(rr + 2 * alpha * ra + alpha**2 * aa, 0.0)
    rd2_aa = torch.clamp_min(dd + 2 * alpha * d1m2 + alpha**2 * e1m2, 0.0)
    inf = float("inf")

    def merit_p(TP):
        # extend the primal pair (x, tau) to TP; the dual side steps alpha
        # and scales by mu = tau(TP)/tau(alpha)
        tau_t = tau_b + TP * dtau
        mu_ = tau_t / tau_a
        rp2 = torch.clamp_min(rr + 2 * TP * ra + TP**2 * aa, 0.0)
        bil = xz + TP * zdx + alpha * xdz + TP * alpha * dxdz
        gap_t = mu_ * (bil + tk_a)
        mval = (w1 * torch.sqrt(rp2) / tau_t
                + (w2 * torch.sqrt(rd2_aa) + bil + tk_a) / tau_a)
        return torch.where((gap_t <= gap_cap) & (tau_t > 0), mval, inf)

    def merit_d(TD):
        # extend the dual side (y, z, kappa) to TD; (x, tau) step alpha
        tau_t = tau_b + TD * dtau
        mu_ = tau_t / tau_a
        rd2 = torch.clamp_min(dd + 2 * TD * d1m2 + TD**2 * e1m2, 0.0)
        bil = xz + alpha * zdx + TD * xdz + alpha * TD * dxdz
        tk_t = tau_a * (kappa_b + TD * dkappa)
        gap_t = mu_ * (bil + tk_t)
        mval = (w2 * torch.sqrt(rd2) / tau_t
                + (w1 * torch.sqrt(rp2_aa) + bil + tk_t) / tau_a)
        return torch.where((gap_t <= gap_cap) & (tau_t > 0), mval, inf)

    grid = torch.as_tensor(np.linspace(0.0, 1.0, 33), dtype=dt, device=dev)

    def piece_min(fm, t_hi_):
        """1-D min over [alpha, t_hi_]: 33-point scan + parabolic polish."""
        tv = alpha + grid * (t_hi_ - alpha)
        mv = fm(tv)
        i = wr._nan_argmin(mv)
        h = (t_hi_ - alpha) / 32.0
        t0_ = tv[i]
        fm_, f0, fq_ = fm(t0_ - h), mv[i], fm(t0_ + h)
        denom = fm_ - 2.0 * f0 + fq_
        t_par = t0_ - 0.5 * h * (fq_ - fm_) / torch.where(
            torch.abs(denom) > 1e-300, denom, 1.0)
        t_par = torch.where(torch.isfinite(t_par) & (denom > 0),
                            torch.clamp(t_par, alpha, t_hi_), t0_)
        f_par = fm(t_par)
        better = f_par < f0
        return torch.where(better, t_par, t0_), torch.minimum(f_par, f0)

    use1 = amax_p >= amax_d      # extend toward the farther boundary
    t1p, f1 = piece_min(merit_p, torch.maximum(tp_hi, alpha))
    t2d, f2 = piece_min(merit_d, torch.maximum(td_hi, alpha))
    best_f = torch.where(use1, f1, f2)
    clear_win = (best_f < 0.9 * merit_p(alpha)) & (alpha > 0.01)
    tp = torch.where(clear_win & use1, t1p, alpha)
    td = torch.where(clear_win & ~use1, t2d, alpha)
    if use_wr:
        # trydif.m:40-72: keep the differentiated pair only if the
        # candidate stays in the wide region (host gate, ipm.py:1097)
        differentiated = flag(clear_win) and (pars.stepdif != 2 or sd_on)
        if differentiated:
            tp_l, td_l = lo(tp), lo(td)
            xs_try = cv_map(lambda a, d_: a + tp_l * d_, xs_b, dxs)
            zs_try = cv_map(lambda a, d_: a + td_l * d_, zs_b, dzs)
            wspec = wr.prod_spectrum(xs_try, zs_try)
            wtk = lo((tau_b + tp * dtau) * (kappa_b + td * dkappa))
            dl = wr.iswnbr(torch.cat([wspec, wtk.reshape(1)]),
                           pars.theta)[0]
            ok_dif = dl <= pars.beta
            tp = torch.where(ok_dif, tp, alpha)
            td = torch.where(ok_dif, td, alpha)
        else:
            tp, td = alpha, alpha
    if pars.stepdif == 2 and not sd_on:
        # adaptive mode (sedumi.m:434-438): equal steps until the host loop
        # turns differentiation on
        tp, td = alpha, alpha
    return tp, td
