"""Host loop: transform -> IPM iterations -> grading -> info.

Counterpart of the reference's solver.py (reference analog: sedumi.m).
route_engine picks the linear-system engine as the reference does: the
sparse tile engine (sparse_engine.TileSchurEngine) for pars.sparse=1, or
at m >= 800 when ADA is sparse; the dense Schur engine otherwise.

The precision phases (reference solver.py:399-468, 642-791), all on the
caller's device:

* 'auto'/'float64' (fp.precision_mode 'f64'): [f64], or [f64, dd64];
* 'mixed': [f32, hybrid, host64] (+ dd64): f32 iterations while they
  progress, the hybrid phase (f64 state and residuals over f32 linear
  algebra; the double-float operator df.DfAOp gives its residuals when A
  is denser than 10%), then host64, which on this card is an f64 phase on
  the same device, entered recentered (the reference's CPU-backend
  branch);
* 'float32': [f32].

Each phase's steps take the eigensolver the reference gives that phase
(phase_eigh_impl): on the card the f64 phases (f64, host64, dd64, and the
f64 recenter into host64 and dd64) take the library, as the reference's
host-CPU phases do, and everything else follows linalg_ops' dispatch,
which is the Jacobi kernels on the card.

The sparse route (TileSchurEngine) takes the same ladder: each phase's
operator is make_sparse_lq_op in the phase's dtype (f32 for the f32 phase,
f64 plus an f32 aop_lo for the hybrid phase, f64 for host64), and the
hybrid phase keeps the f64 COO operator for its residuals, not DfAOp.
dd64 (ddengine.DdSchurEngine) is admitted with the dense engine only, by
the reference's gate (m <= 1200, dd formation cost below 2.5e11) and not
in 'float32'.  A phase is left on a rejected direction, a stall, a
plateau, or the f32 phase's own probe and floor rules; the ladder's
escalation can skip the hybrid rung and discard a junk f32 trajectory.
Control scalars live on the host; each iteration is one ipm.make_step
call on the device.

A device mesh (pars.mesh_shape; mesh_plan) runs SPMD, one process per mesh
position in an initialized torch.distributed group, every rank solving the
same data: on the dense route the data axes split the Schur formation
(parallel.mesh.shard_coo_aop) and a "panels" axis factors and solves it in
panels (parallel.panels.PanelSchurEngine), with dd64 off as in the
reference; the sparse route ignores the mesh.  Under 'mixed' the mesh's
ladder is the reference's, [f32, hybrid, host64]: the f32 phase on the
panel engine in f32 (K14-f32/K15-f32 on the card), the hybrid phase with
an f64 factor of its f32-formed matrix, host64 an f64 phase on the panel
engine as the f64 mode runs it ('float32': [f32]).  After each step
(and each escalation) every rank takes global rank 0's iterate and
statistics, so the host loops branch alike and return the same result.

pars.profile times the hot phases once after the loop (profiling.py) into
info["profile"]; pars.debug checks every output leaf of each step on the
host and raises FloatingPointError naming the first non-finite one
(debug_step).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Mapping

import numpy as np
import torch

from . import fp, ipm, linalg_ops
from .cones import ConeSpec, Layout
from .ddengine import DdSchurEngine
from .df import build_df_aop
from .opA import build_coo_aop
from .params import Pars
from .parallel.mesh import Mesh, from_root, shard_coo_aop, world_size
from .parallel.panels import PanelSchurEngine
from .sparse_engine import TileSchurEngine, make_sparse_lq_op, \
    plan_sparse_lq
from .structs import cv_eye, cv_scale, from_flat, to_flat
from .userapi import eigK


@dataclasses.dataclass
class InternalResult:
    x: np.ndarray          # flat internal solution (unscaled by tau)
    y: np.ndarray
    z: np.ndarray
    tau: float
    kappa: float
    iter: int
    stop: int              # 1 converged, 0 maxiter, -1 numerical stall,
    #                        2 infeasibility branch
    err_p: float
    err_d: float
    gap_rel: float
    cx: float
    by: float
    iterlog: list[dict]
    engine: str = "dense"
    vplot: dict | None = None
    optstep: int = 0       # 1: in-loop LP finite termination fired
    profile: dict | None = None   # pars.profile's phase timings


def _log(pars: Pars, msg: str) -> None:
    if pars.fid:
        print(msg)


def _eye_flat(layout: Layout) -> np.ndarray:
    return to_flat(layout, cv_eye(layout, "cpu"))


def _residual_scales(At, b, c, layout) -> tuple[float, float]:
    """R.maxRb / R.maxRc of sdinit.m:96-105, on the internal data."""
    maxb = float(np.max(np.abs(b))) if b.size else 0.0
    maxc = float(np.max(np.abs(c))) if c.size else 0.0
    mu0 = float(np.sqrt((1.0 + maxb) * (1.0 + maxc)))
    d0 = float(np.sqrt((1.0 + maxb) / (1.0 + maxc)))
    y0 = (layout.nu + 1.0) * mu0
    e_flat = _eye_flat(layout)
    Rb = (d0 * mu0 * (At.T @ e_flat) - b) / y0
    Rc = ((mu0 / d0) * e_flat - c) / y0
    maxRb = max(1e-6, float(np.max(np.abs(Rb))) if Rb.size else 0.0)
    maxRc = max(1e-6, float(np.max(np.abs(Rc))) if Rc.size else 0.0)
    return maxRb, maxRc


def _interior_margin(layout, x_flat) -> float:
    """Smallest spectral value of a flat internal vector over all cones."""
    cv = from_flat(layout, np.asarray(x_flat, np.float64), "cpu")
    vals = [np.inf]
    l = cv.l.numpy()
    if l.size:
        vals.append(float(np.min(l)))
    for q in cv.q:
        qa = q.numpy()
        vals.append(float(np.min(
            qa[..., 0] - np.linalg.norm(qa[..., 1:], axis=-1))))
    for s in cv.s:
        vals.append(float(np.min(np.linalg.eigvalsh(s.numpy()))))
    return min(vals)


def _projected_start(At, b, layout, state):
    """Project the identity start onto {A x = b tau0}, keeping it interior
    (x0(delta) affine in delta); None when no tried step keeps margin
    >= 0.05*delta (the sdinit identity start then stands)."""
    import scipy.linalg as sla
    import scipy.sparse as sp

    m = At.shape[1]
    A = sp.csc_matrix(At).T.tocsr()
    e_flat = _eye_flat(layout)
    x_flat0 = to_flat(layout, state.x)
    delta = float(np.max(x_flat0)) if x_flat0.size else 1.0
    tau0 = float(state.tau)
    AAt = np.asarray((A @ A.T).todense())
    ridge = 1e-12 * (float(np.trace(AAt)) / max(m, 1) + 1.0)
    try:
        cho = sla.cho_factor(AAt + ridge * np.eye(m))
    except np.linalg.LinAlgError:
        return None
    xp = delta * e_flat
    xproj = xp + A.T @ sla.cho_solve(
        cho, np.asarray(b, np.float64) * tau0 - A @ xp)
    # partial projection: walk back toward the identity start until safely
    # interior
    for s_ in (1.0, 0.97, 0.95, 0.9, 0.8, 0.6, 0.4, 0.25):
        x0 = (1.0 - s_) * xp + s_ * xproj
        if _interior_margin(layout, x0) >= 0.05 * delta:
            return x0
    return None


def _check_routes(pars: Pars) -> None:
    """Raise for a precision setting neither package knows."""
    fp.precision_mode(pars.dtype)
    if pars.schur_dtype:
        fp.torch_dtype(pars.schur_dtype)


def debug_step(step):
    """pars.debug's numerical sanitizer (reference solver.py:184-215): the
    step, then its output checked on the host, leaf by leaf in the
    reference's order (x.l, y, tau, kappa, every stats field, then each
    x.q, x.s, z.q and z.s block); the first leaf that holds a non-finite
    value raises FloatingPointError naming it, instead of surfacing as an
    anonymous rejected step.  The step's values are not touched."""
    def checked(*args, **kw):
        out = step(*args, **kw)
        new_state, st = out
        leaves = [("x.l", new_state.x.l), ("y", new_state.y),
                  ("tau", new_state.tau), ("kappa", new_state.kappa)]
        leaves += [("stats." + k, getattr(st, k)) for k in st._fields]
        for fam, blocks in (("x.q", new_state.x.q), ("x.s", new_state.x.s),
                            ("z.q", new_state.z.q), ("z.s", new_state.z.s)):
            leaves += [(f"{fam}[{i}]", blk) for i, blk in enumerate(blocks)]
        # one flag a leaf, brought to the host in one transfer
        finite = torch.stack([torch.isfinite(v).all() for _, v in leaves]) \
            .cpu().tolist()
        for (name, _), ok in zip(leaves, finite):
            if not ok:
                raise FloatingPointError(
                    f"pars.debug sanitizer: non-finite values in "
                    f"'{name}' after the IPM step")
        return out
    return checked


def _clique_bound_dense(At, layout: Layout) -> bool:
    """The reference's cheap clique bound (solver.py:274-295): every PSD
    block's touching-constraint set is an ADA clique, so sum(nc_b^2)
    lower-bounds the pattern nnz; True when it exceeds 0.35 m^2."""
    m = At.shape[1]
    s_offs = layout.s_offsets()
    rows_all = At.indices
    cols_all = np.repeat(np.arange(m), np.diff(At.indptr))
    in_s = rows_all >= layout.s_start
    if not np.any(in_s):
        return False
    blk = np.searchsorted(s_offs, rows_all[in_s], side="right") - 1
    nb = max(len(layout.s), 1)
    pairs = np.unique(cols_all[in_s].astype(np.int64) * nb + blk)
    nc = np.bincount((pairs % nb).astype(int), minlength=len(layout.s))
    return float(np.sum(nc.astype(np.float64) ** 2)) > 0.35 * m * m


def route_engine(At, c_s, layout: Layout, pars: Pars):
    """The reference's linear-system routing (solver.py:266-305):
    (engine kind, sparse plan or None).  pars.sparse=1, or the automatic
    route (-1) at m >= 800, plans the sparse tile engine unless the clique
    bound proves ADA dense; the plan is kept when forced or when ADA's
    density is at most 0.35.  At, c_s: the row-equilibrated internal
    data."""
    m = At.shape[1]
    if not (pars.sparse == 1 or (pars.sparse == -1 and m >= 800)):
        return "dense", None
    if layout.s and pars.sparse != 1 and _clique_bound_dense(At, layout):
        return "dense", None
    arrays, meta = plan_sparse_lq(At, c_s, layout, pars)
    if pars.sparse == 1 or meta["ada_density"] <= 0.35:
        return "sparse", (arrays, meta)
    return "dense", None


def dd_form_cost(layout: Layout, m: int) -> float:
    """The reference's cost model of the Ozaki dd Schur formation, ~11x
    the f64 flops (reference solver.py:629-635)."""
    mp1 = m + 1
    cost = float(mp1 * mp1 * (layout.l + sum(layout.q)))
    for bkt in layout.s_buckets:
        cost += mp1 * 4.0 * bkt.count * bkt.dim**3
        cost += float(mp1) * mp1 * bkt.count * bkt.dim * bkt.dim
    return cost * 11.0


def dd64_admitted(layout: Layout, m: int, mesh: bool = False) -> bool:
    """The reference's dd64 gate (solver.py:642-644): no device mesh,
    m <= 1200 and a formation cost below 2.5e11.  It admits arch0 (~4e10)
    and control07 (~1.4e11) and excludes trto3 and OH.  (Its other term,
    a host f64 device, holds on the card.)"""
    return not mesh and m <= 1200 and dd_form_cost(layout, m) < 2.5e11


def phase_ladder(engine_kind: str, layout: Layout, m: int,
                 mode: str = "f64", mesh: bool = False) -> list[str]:
    """The phases a solve may take in precision `mode` (reference
    solver.py:438-467, 642-646): [f64], [f32] or [f32, hybrid, host64],
    with dd64 last when the dense engine is used, dd64_admitted holds (no
    mesh among its terms) and the mode is not 'f32'.  (The reference's
    host64 and dd64 need an f64 device, which the card always is.)"""
    order = {"f64": ["f64"], "f32": ["f32"],
             "mixed": ["f32", "hybrid", "host64"]}[mode]
    if engine_kind == "dense" and dd64_admitted(layout, m, mesh) \
            and mode != "f32":
        order = order + ["dd64"]
    return order


def phase_eigh_impl(phase: str, device) -> str | None:
    """The eigensolver override of a phase's steps: 'xla' (the library)
    for the f64 phases on the card, which the reference runs on its host
    CPU under impl_override('xla') (reference solver.py:389-397, 442-457,
    663-701, 763-771); None (linalg_ops' dispatch: Jacobi on the card)
    for the f32 and hybrid phases, and for every phase on the CPU, where
    the reference wraps nothing."""
    if torch.device(device).type == "cuda" \
            and phase in ("f64", "host64", "dd64"):
        return "xla"
    return None


def _phase_eigh(phase: str, device):
    """A context that applies phase_eigh_impl (an outer override stays
    in force where it gives None)."""
    impl = phase_eigh_impl(phase, device)
    return linalg_ops.impl_override(impl) if impl \
        else contextlib.nullcontext()


def mesh_plan(pars: Pars, engine_kind: str):
    """The mesh a solve builds (the reference's rule, solver.py:314-352,
    for SPMD ranks): None without pars.mesh_shape, for a one-position
    mesh, or when the process group holds fewer ranks than the mesh (the
    solve then runs unsharded, as the reference does with too few
    devices); ValueError when it holds more.  Else (shape, data_axes,
    panel_axis): a one-axis mesh is named "blocks", as the reference's
    make_mesh(n) names it.  On the dense route every axis but "panels" is
    a data axis, unless the one-axis mesh was asked for as "panels", and a
    "panels" axis in pars.mesh_shape takes PanelSchurEngine on "panels"
    (or "blocks"); the sparse route ignores the mesh ((), None).  Every
    precision mode runs on the plan (its phases: phase_ladder)."""
    shape = {str(k): int(v) for k, v in (pars.mesh_shape or {}).items()}
    n_req = math.prod(shape.values())
    if n_req <= 1:
        return None
    world = world_size()
    if world > n_req:
        raise ValueError(f"pars.mesh_shape {shape} has {n_req} positions "
                         f"and the process group {world} ranks")
    if world < n_req:
        _log(pars, f"mesh {shape} needs {n_req} ranks and the process "
                   f"group has {world}: running unsharded")
        return None
    built = shape if len(shape) > 1 else {"blocks": n_req}
    if engine_kind != "dense":
        return built, (), None
    if len(shape) > 1:
        data_axes = tuple(k for k in shape if k != "panels")
    else:
        data_axes = () if "panels" in shape else ("blocks",)
    panel_axis = None
    if "panels" in shape:
        panel_axis = "panels" if "panels" in built else "blocks"
    return built, data_axes, panel_axis


def solve_internal(At, b, c, layout: Layout, pars: Pars,
                   device="cuda") -> InternalResult:
    """Run the homogeneous self-dual IPM on a problem in internal form.

    At: (N x m) scipy sparse internal data; b: (m,); c: (N,).  f32 matrix
    products run at full f32 precision, never TF32 (the reference sets
    matmul precision 'highest', sedumi_tpu/__init__.py): the setting is
    held for the solve and restored after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return _solve_internal(At, b, c, layout, pars, device)
    finally:
        torch.set_float32_matmul_precision(prev)


def _solve_internal(At, b, c, layout: Layout, pars: Pars,
                    device) -> InternalResult:
    import scipy.sparse as sp

    m = At.shape[1]
    b = np.asarray(b, np.float64).ravel()
    c = np.asarray(c, np.float64).ravel()
    At = sp.csc_matrix(At)
    _check_routes(pars)
    # initial-residual magnitudes for the grading denominators
    # (sdinit.m:96-105, sedumi.m:678-681)
    maxRb, maxRc = _residual_scales(At, b, c, layout)
    den_p = 1.0 + (float(np.max(np.abs(b))) if m else 0.0) + 1e-3 * maxRb
    den_d = 1.0 + (float(np.max(np.abs(c))) if c.size else 0.0) \
        + 1e-3 * maxRc
    # row equilibration (exact reformulation; y_i recovers as d_i * y'_i)
    rnorm = np.sqrt(np.asarray(At.multiply(At).sum(axis=0)).ravel() + b**2)
    rowscale = np.where(rnorm > 0, 1.0 / np.maximum(rnorm, 1e-300), 1.0)
    b_orig = b
    At0 = At               # pre-equilibration data (in-loop optstep)
    At = At @ sp.diags(rowscale)
    b = b * rowscale
    # objective normalization, recovered exactly below (y, z scale)
    normb = float(np.max(np.abs(b_orig))) if m else 0.0
    normc = float(np.max(np.abs(c))) if c.size else 0.0
    cscale = 1.0 + normc
    c_s = c / cscale
    engine_kind, sp_plan = route_engine(At, c_s, layout, pars)
    mode = fp.precision_mode(pars.dtype)
    if engine_kind == "sparse":
        sp_meta = sp_plan[1]
        _log(pars, f"sparse Schur path: ADA nnz {sp_meta['ada_nnz']} "
                   f"(density {sp_meta['ada_density']:.3f}), "
                   f"{sp_meta['Kd']} dense column(s)")
    F32, F64 = torch.float32, torch.float64
    dt_hi = F32 if mode == "f32" else F64     # the state's dtype
    plan = mesh_plan(pars, engine_kind)
    mesh = Mesh(plan[0], device) if plan else None
    data_axes, panel_axis = plan[1:] if plan else ((), None)
    ops = {}

    def _op(dtype):
        """The operator in `dtype`, built once per dtype (reference
        solver.py:307-311), its formation split over the mesh's data axes
        when there are any (reference solver.py:376-386)."""
        if dtype not in ops:
            ops[dtype] = make_sparse_lq_op(*sp_plan, dtype=dtype,
                                           device=device) \
                if engine_kind == "sparse" else \
                build_coo_aop(At, c_s, layout, device=device, dtype=dtype)
            if data_axes:
                ops[dtype] = shard_coo_aop(
                    ops[dtype], mesh,
                    data_axes if len(data_axes) > 1 else data_axes[0])
                _log(pars, f"sharded operator over mesh {mesh.shape}")
        return ops[dtype]

    def _bundle(sdt, aop, engine=None, compute_dtype=None, aop_lo=None,
                recenter=False):
        """One precision phase: its step, operators and data (reference
        solver.py:399-468).  On the sparse route every phase gets its own
        TileSchurEngine, which works in the dtype of the operator and the
        scaling it is handed (in the hybrid phase the f32 aop_lo), and
        never reads pars.schur_dtype, as the reference's does not."""
        if engine_kind == "sparse":
            engine = TileSchurEngine(pars)
        elif engine is None and panel_axis:
            engine = PanelSchurEngine(
                mesh, axis=panel_axis,
                refine_iters=max(2, int(pars.cg.refine)))
        step = ipm.make_step(layout, pars, normb, normc, cscale, dtype=sdt,
                             engine=engine, compute_dtype=compute_dtype,
                             err_dens=(den_p, den_d))
        return dict(
            step=debug_step(step) if pars.debug else step,
            aop=aop, aop_lo=aop_lo,
            b=torch.as_tensor(b, dtype=sdt, device=device),
            rs=torch.as_tensor(rowscale, dtype=sdt, device=device),
            sdt=sdt, recenter=recenter)

    phase_order = phase_ladder(engine_kind, layout, m, mode,
                               mesh=mesh is not None)
    bundles: dict[str, dict] = {}
    if mode == "mixed":
        # the hybrid phase's f64-quality operator: the double-float DfAOp
        # when A itself is denser than 10% (the bucketed hi/lo pairs cost
        # O(m N)), the f64 COO operator otherwise (reference
        # solver.py:410-422)
        a_density = At.nnz / max(1, At.shape[0] * At.shape[1])
        aop64d = build_df_aop(At, c_s, layout, device=device) \
            if engine_kind == "dense" and a_density > 0.1 else _op(F64)
        bundles["f32"] = _bundle(F32, _op(F32))
        bundles["hybrid"] = _bundle(F64, aop64d, compute_dtype=F32,
                                    aop_lo=_op(F32))
    else:
        bundles[phase_order[0]] = _bundle(dt_hi, _op(dt_hi))
    cur = phase_order[0]
    normb_s = float(np.max(np.abs(b))) if m else 0.0
    normc_s = float(np.max(np.abs(c_s))) if c.size else 0.0
    state = ipm.init_state(layout, bundles[cur]["aop"], b, normb_s, normc_s,
                           pars, device=device, dtype=dt_hi)
    if mesh is not None:
        _log(pars, f"device mesh {mesh.shape}: rank {mesh.rank}, data axes "
                   f"{data_axes}, panel axis {panel_axis}")
    # --- two-sided residual-balanced start (reference solver.py:472-512):
    # scale x by d0 and z by 1/d0, d0 minimizing max(err_p0, err_d0) ---
    if m > 0:
        _xf0 = to_flat(layout, state.x)
        _zf0 = to_flat(layout, state.z)
        _ax0 = np.asarray(At.T @ _xf0).ravel() / rowscale
        _bo = b / rowscale
        _grid = np.logspace(-3, 3, 121)
        _ep = np.sqrt(np.maximum(
            _grid ** 2 * float(_ax0 @ _ax0)
            - 2.0 * _grid * float(_ax0 @ _bo) + float(_bo @ _bo),
            0.0)) / den_p
        _ed = np.sqrt(np.maximum(
            float(_zf0 @ _zf0) / _grid ** 2
            - 2.0 * float(_zf0 @ c_s) / _grid + float(c_s @ c_s),
            0.0)) * cscale / den_d
        _d0 = float(_grid[int(np.argmin(np.maximum(_ep, _ed)))])
        if abs(np.log10(_d0)) > 1.0:     # only severe imbalance
            state = state._replace(x=cv_scale(state.x, _d0),
                                   z=cv_scale(state.z, 1.0 / _d0))
            _log(pars, f"balanced start: d0={_d0:.3g} "
                       f"(err_p0 {_ep[60]:.2e} -> "
                       f"{float(np.interp(_d0, _grid, _ep)):.2e})")
    # --- projected near-feasible primal start (reference solver.py:
    # 513-537), with the dense engine only ---
    if engine_kind == "dense" and 0 < m <= 2000:
        try:   # optional start, as in the reference
            x0f = _projected_start(At, b, layout, state)
        except Exception:
            x0f = None
        if x0f is not None:
            gap0 = float(np.dot(x0f, to_flat(layout, state.z)))
            np_hi = np.float32 if dt_hi == F32 else np.float64
            state = state._replace(
                x=from_flat(layout, x0f.astype(np_hi), device, dtype=dt_hi),
                kappa=torch.tensor(max(gap0 / max(layout.nu, 1), 1e-8),
                                   dtype=dt_hi, device=device))
            _log(pars, "projected primal start: ||Ax0 - b tau0|| ~ 0")

    def _measure_resid_inf(st) -> tuple:
        """Exact inf-norm residuals of an iterate in original units."""
        xf = to_flat(layout, st.x)
        zf = to_flat(layout, st.z)
        yv = st.y.cpu().numpy()
        tauv = float(st.tau)
        rp_v = (np.asarray(At.T @ xf).ravel() - b * tauv) / rowscale
        rd_v = (np.asarray(At @ yv).ravel() + zf - c_s * tauv) * cscale
        rp_i = float(np.max(np.abs(rp_v))) if rp_v.size else 0.0
        rd_i = float(np.max(np.abs(rd_v))) if rd_v.size else 0.0
        return rp_i, rd_i

    def _arbitrate() -> None:
        """Prefer the tracked-minimum iterate over the recomputed-best when
        they disagree mildly (reference solver.py:554-573)."""
        nonlocal best_state, best_rec, best_worst
        if best_rec is None or best_worst == np.inf \
                or best_tr_rec is None or best_tr_rec is best_rec:
            return
        sc_best = (best_rec.get("prec1", np.inf)
                   + best_rec.get("prec2", np.inf))
        worst_tr = max(best_tr_rec["err_p"], best_tr_rec["err_d"],
                       best_tr_rec["gap_rel"])
        if best_tr_score < sc_best and worst_tr <= 3.0 * best_worst:
            _log(pars, f"  final pick: tracked-best iterate "
                       f"(prec {best_tr_score:.1e} < {sc_best:.1e}, "
                       f"worst {worst_tr:.1e})")
            best_state, best_rec, best_worst = \
                best_tr_state, best_tr_rec, worst_tr

    def _refine_early(st) -> float:
        """Measured r0 of the terminal-refinement candidate from an
        iterate, or inf (reference solver.py:575-591)."""
        from .refine import conic_refine

        tau_v = max(float(st.tau), 1e-300)
        x_o = to_flat(layout, st.x) / tau_v
        y_o = st.y.cpu().numpy() * rowscale * cscale / tau_v
        try:   # an optional probe never ends the solve (as the reference)
            cand = conic_refine(At0, b_orig, c, layout, x_o, y_o,
                                den_p, den_d, pars.eps, fid=0)
        except Exception:
            return np.inf
        return float(cand.r0) if cand is not None else np.inf

    state0 = state          # for discard_progress phase restarts
    it0 = 0
    if pars.resume and pars.checkpoint_path:
        import os

        if os.path.exists(pars.checkpoint_path):
            state, it0 = _load_checkpoint(pars.checkpoint_path, layout,
                                          device, dt_hi)
            _log(pars, f"resumed from {pars.checkpoint_path} at iter {it0}")
    # tracked stopping residuals (sedumi.m:545-566), seeded after resume
    if mesh is not None:
        state = from_root(mesh, state)
    rw_p, rw_d = _measure_resid_inf(state)

    # --- the phase ladder; host64 and dd64 are built at their first
    # escalation.  dd64_possible is the reference's gate (its f64-device
    # term holds here), which the f32 floor rule reads even where the
    # ladder has no dd64 ---
    dd64_possible = engine_kind == "dense" \
        and dd64_admitted(layout, m, mesh is not None)
    recenter_hi = ipm.make_recenter(layout, dt_hi)
    recenter_lo = ipm.make_recenter(layout, F32)

    def _escalate(why: str, skip_hybrid: bool = False,
                  discard_progress: bool = False) -> bool:
        """Move to the next phase; False at the ladder top (reference
        solver.py:708-791).  The iterate is cast to the state dtype,
        recentered in f32 when entering the hybrid phase and in f64 when
        entering host64 or dd64, and the tracked residuals re-synced to
        measured values.  skip_hybrid: the hybrid phase shares the f32
        formation that just failed, so jump past it.  discard_progress: the
        leaving phase's iterates are junk (bad arithmetic from its first
        steps); restart from the initial point and forget the best-iterate
        records."""
        nonlocal cur, state, phase_iters, since_best, since_best_phase, \
            stall, best_worst, best_state, best_rec, best_tr_score, \
            best_tr_state, best_tr_rec, rw_p, rw_d
        if discard_progress:
            state = ipm.cast_state(state0, dt_hi)
            best_tr_score, best_tr_state, best_tr_rec = np.inf, None, None
            best_worst, best_state, best_rec = np.inf, state, None
            _log(pars, "  discarding the unusable phase's iterates; "
                       "restarting from the initial point")
        idx = phase_order.index(cur) + 1
        if skip_hybrid and idx < len(phase_order) \
                and phase_order[idx] == "hybrid":
            idx += 1
        if idx >= len(phase_order):
            return False
        nxt = phase_order[idx]
        if nxt not in bundles:     # host64 or dd64: f64 on this device
            bundles[nxt] = _bundle(
                F64, _op(F64), recenter=True,
                engine=DdSchurEngine() if nxt == "dd64" else None)
        s = ipm.cast_state(state, dt_hi)
        if nxt == "hybrid":
            # an off-center f32 iterate would leave every widelen trial
            # outside the wide region: recenter it in f32 first
            s = ipm.cast_state(recenter_lo(ipm.cast_state(s, F32)), dt_hi)
        if bundles[nxt]["recenter"]:
            with _phase_eigh(nxt, device):
                s = recenter_hi(s)
        state = s if mesh is None else from_root(mesh, s)
        _log(pars, f"  escalating {cur} -> {nxt} ({why})")
        rw_p, rw_d = _measure_resid_inf(state)
        cur = nxt
        # fresh phase, fresh stall budgets
        phase_iters = since_best = since_best_phase = stall = 0
        return True

    # f32 stalls once `worst` nears its rounding floor; escalate a bit
    # before that (reference solver.py:793-797)
    switch_tol = 3e-4
    since_best_phase = 0
    phase_iters = 0
    mu_phase0 = np.inf

    reg = 0.0
    iterlog: list[dict] = []
    vlist: list[np.ndarray] = []
    ratelist: list[float] = []
    prev_mu = 0.0
    # adaptive step differentiation (stepdif=2): off until the trigger
    sd_on = pars.stepdif != 2
    stop = 0
    it = it0
    stall = 0
    mu_prev_it = 0.0
    optstep_tries = 0
    optstep_hit = 0
    best_state = state
    best_worst = np.inf
    best_rec = None
    since_best = 0
    best_tr_score = np.inf     # tracked prec1+prec2 minimum
    best_tr_state = None
    best_tr_rec = None
    _log(pars, " it      mu        alpha   sigma    err_p     err_d     gap")
    while it < pars.maxiter:
        t_it0 = time.time()
        tried = 0
        while True:
            bd = bundles[cur]
            st_in = ipm.cast_state(state, bd["sdt"]) \
                if bd["sdt"] != dt_hi else state
            with _phase_eigh(cur, device):
                new_state, st = bd["step"](bd["aop"], bd["b"], bd["rs"],
                                           st_in, reg, sd_on=sd_on,
                                           aop_lo=bd["aop_lo"])
            if mesh is not None:
                new_state, st = from_root(mesh, (new_state, st))
            rec = st.to_host()
            finite = np.isfinite(rec["mu"]) and bool(rec["chol_ok"]) \
                and np.isfinite(rec["alpha"])
            leaves_ok = bool(torch.isfinite(new_state.tau)
                             & torch.isfinite(new_state.kappa))
            # reject steps whose direction the solves corrupted (exact
            # Newton satisfies the primal row to roundoff); escalation
            # re-runs the same state one phase up.  (The reference also
            # treats hybrid as last when host64 is impossible; here host64
            # always is.)
            last_phase = cur == phase_order[-1]
            quality_ok = last_phase or rec["dir_defect"] < 0.1
            if finite and leaves_ok and quality_ok:
                break
            why = "bad direction" if finite and leaves_ok \
                else "non-finite step"
            _log(pars,
                 f"  step rejected ({why}): mu={rec['mu']:.1e} "
                 f"alpha={rec['alpha']:.1e} "
                 f"chol_ok={bool(rec['chol_ok'])} "
                 f"defect={rec['dir_defect']:.1e} reg={reg:.1e}")
            # the first phase's iterate is junk only when it made no real
            # progress before failing (reference solver.py:855-863)
            mu0_run = iterlog[0]["mu"] if iterlog else float("inf")
            discard = (cur == phase_order[0] and it <= 20
                       and rec["mu"] > 1e-3 * mu0_run)
            # a discard also skips the hybrid rung, which shares the f32
            # formation (reference solver.py:864-875)
            if not last_phase and _escalate(
                    f"{why} in {cur}",
                    skip_hybrid=not (finite and leaves_ok) or discard,
                    discard_progress=discard):
                continue
            tried += 1
            reg = max(reg * 100.0, 1e-14)
            if tried > 6:
                stop = -1
                break
        if stop == -1:
            break
        # `st` measures the PRE-step state: keep it for the best-iterate
        # bookkeeping
        prev_state = state
        state = ipm.cast_state(new_state, dt_hi) \
            if bundles[cur]["sdt"] != dt_hi else new_state
        rec["phase"] = cur
        rec["wall_s"] = round(time.time() - t_it0, 4)
        iterlog.append(rec)
        it += 1
        _log(
            pars,
            f"{it:3d}  {rec['mu']:9.2e}  {rec['alpha']:6.4f} "
            f"{rec['sigma']:6.4f} {rec['err_p']:9.2e} {rec['err_d']:9.2e} "
            f"{rec['gap_rel']:9.2e}  d{rec['wr_delta']:5.2f} "
            f"c{rec['centered']:.0f} t1={rec['maxt1']:5.3f}"
            f"  {rec['wall_s']:7.3f}s {cur}",
        )
        if pars.stopat == it:
            breakpoint()  # pars.stopat debug hook (sedumi.m:430-432)
        # --- in-loop LP finite termination (sedumi.m:527-536) ---
        rate_now = rec["mu"] / mu_prev_it if mu_prev_it > 0 else 1.0
        mu_prev_it = rec["mu"]
        if (pars.optstep and not layout.q and not layout.s
                and rate_now < 0.05 and optstep_tries < 3
                and rec["tau"] > 1e-6 * max(rec["kappa"], 1.0)):
            optstep_tries += 1
            from .optstep import optstep_lp

            tau_now = max(float(state.tau), 1e-300)
            x_o = to_flat(layout, state.x) / tau_now
            y_o = state.y.cpu().numpy() * rowscale * cscale / tau_now
            z_o = to_flat(layout, state.z) * cscale / tau_now
            xe, ye = optstep_lp(At0, b_orig, c, x_o, y_o, z_o, pars.eps)
            if xe is not None:
                # objective-monotonicity guard: the optimal vertex must
                # improve on both current objectives
                cx_it = rec["cx"] / max(rec["tau"], 1e-300)
                by_it = rec["by"] / max(rec["tau"], 1e-300)
                sc_obj = 1e-6 * (1.0 + abs(cx_it) + abs(by_it))
                if (float(c @ xe) > cx_it + sc_obj
                        or float(b_orig @ ye) < by_it - sc_obj):
                    xe = None
            if xe is not None:
                state = state._replace(
                    x=from_flat(layout, xe * tau_now, device, dtype=dt_hi),
                    y=torch.as_tensor(ye * tau_now / (rowscale * cscale),
                                      dtype=dt_hi, device=device))
                best_state = state
                best_rec = dict(rec)
                stop = 1
                optstep_hit = 1
                _log(pars, f"  optstep: LP optimal-face guess verified at "
                           f"iter {it} (STOP=2, sedumi.m:533)")
                break
        if not sd_on and it > 10 and rec["tau"] < 1e-3 * rec["kappa"]:
            # adaptive differentiation trigger: certificate runs only
            sd_on = True
        worst = max(rec["err_p"], rec["err_d"], rec["gap_rel"])
        phase_iters += 1
        if phase_iters == 1:
            mu_phase0 = rec["mu"]
        # f32 probe (reference solver.py:977-990): a healthy f32 phase
        # contracts mu by ~2-4x per iteration; one that has not contracted
        # it 2.5x in 4 iterations never recovers: discard and restart a
        # phase up, past the hybrid rung
        if (cur == "f32" and phase_iters == 5 and mu_phase0 > 1e-4
                and rec["mu"] > 0.4 * mu_phase0):
            if _escalate(f"f32 mu-probe: {mu_phase0:.1e} -> "
                         f"{rec['mu']:.1e} in 4 iters",
                         skip_hybrid=True, discard_progress=True):
                continue
        if cur == "f32":
            # leave f32 near its rounding floor or once it stops making
            # >= 2% relative progress (reference solver.py:991-1026); a
            # far-from-converged f32 iterate (worst > 1e-2) skips the
            # hybrid polisher, and is discarded when dd64 is admitted
            improved = worst < best_worst * (1.0 - 0.02)
            since_best_phase = 0 if improved else since_best_phase + 1
            if worst <= switch_tol or since_best_phase >= 3 or (
                    rec["alpha"] < 2e-3 and it > 3) or phase_iters >= 60:
                if _escalate(f"f32 floor at iter {it}, worst={worst:.1e}",
                             skip_hybrid=worst > 1e-2,
                             discard_progress=(worst > 1e-2
                                               and dd64_possible)):
                    since_best = 0
        elif cur == "hybrid" and (since_best >= 4 or phase_iters >= 40) \
                and best_worst > pars.eps:
            # the hybrid phase stalled above target: one chance in f64
            if _escalate(f"hybrid plateau at worst={best_worst:.1e}"):
                since_best = 0
        if pars.vplot:
            # v-plot data (sedumi.m:414,521,752-765)
            from .wregion import prod_spectrum

            wspec = prod_spectrum(state.x, state.z).cpu().numpy()
            vlist.append(np.sqrt(np.maximum(wspec, 0.0))
                         / max(np.sqrt(rec["mu"]), 1e-300))
            ratelist.append(rec["mu"] / prev_mu if prev_mu else 1.0)
            prev_mu = rec["mu"]
        if worst < best_worst:
            if worst > best_worst * (1.0 - 5e-4):
                since_best += 1      # micro-improvement
            else:
                since_best = 0
            best_worst = worst
            best_state = prev_state
            best_rec = rec
        else:
            since_best += 1
        # -- convergence --
        if worst <= pars.eps:
            stop = 1
            state = prev_state   # the state the converged record describes
            break
        # -- state-representation mu floor (ipm.StepStats.mu_floor), at
        # the ladder top only --
        if (cur == phase_order[-1] and it - it0 > 3 and best_worst < 1e-3
                and since_best >= 6
                and rec["mu"] < 30.0 * rec["mu_floor"]):
            _log(pars, f"  mu {rec['mu']:.1e} at the f64 state floor "
                       f"({rec['mu_floor']:.1e}): stopping honestly")
            stop = 1 if best_worst <= pars.eps else -1
            break
        # -- reference stop test on the tracked residuals
        # (sedumi.m:545-566): contraction by (1 - alpha(1-sigma)) plus the
        # measured direction defect --
        fk = max(0.0, 1.0 - rec["alpha"] * (1.0 - rec["sigma"]))
        defp = rec["dir_defect"] * (rec["res_p_abs"] + rec["mu"]) \
            * rec["alpha"]
        rw_p = fk * rw_p + (defp if np.isfinite(defp) else 0.0)
        rw_d = fk * rw_d
        if it % 16 == 0 and max(rw_p, rw_d) > 10.0 * pars.eps * (
                1.0 + max(normb, normc)):
            rw_p, rw_d = _measure_resid_inf(state)
        r0w = 2.0 * rw_p / (1.0 + normb) + 2.0 * rw_d / (1.0 + normc)
        tau_c = max(float(rec["tau"]), 1e-300)
        prec1 = r0w / (1.0 + tau_c)
        rgap = max(rec["cx"] - rec["by"], 0.0) / max(
            abs(rec["cx"]), abs(rec["by"]), 1e-3 * tau_c)
        prec2 = (r0w + rgap) / tau_c
        safeguard = min(pars.bigeps / 10.0, 1e4 * pars.eps)
        rec["prec1"], rec["prec2"] = prec1, prec2
        if prec1 + prec2 < best_tr_score:
            best_tr_score = prec1 + prec2
            best_tr_state = prev_state
            best_tr_rec = rec
        if prec1 < pars.eps and prec2 < pars.eps and best_worst < safeguard:
            stop = 1
            _log(pars, f"  tracked-residual stop: precision1={prec1:.1e} "
                       f"precision2={prec2:.1e} (sedumi.m:554-560)")
            break
        # -- plateau: solves at their accuracy floor (not in f32, whose
        # own rules above escalate).  Patience 18 in f64, 8 in dd64, whose
        # non-improving tail is the wander region.  The terminal
        # refinement is tried first (it may make dd64 unnecessary), then
        # the best iterate goes one rung up --
        patience = 8 if cur == "dd64" else 18
        if cur != "f32" and since_best >= patience and best_worst < 1e-5:
            if best_worst <= pars.eps:
                stop = 1
                break
            _arbitrate()
            if pars.refine and _refine_early(best_state) <= pars.eps:
                state = best_state
                stop = 1
                _log(pars, "  refine-early: terminal projection reaches "
                           "eps from the plateau iterate; skipping dd64")
                break
            if cur != phase_order[-1]:
                state = best_state
                if _escalate(f"endgame plateau at {best_worst:.1e}"):
                    continue
            stop = -1
            break
        if cur != "f32" and since_best >= 30:     # hard plateau
            if cur != phase_order[-1]:
                state = best_state
                if _escalate("hard plateau"):
                    continue
            stop = -1
            break
        # -- infeasibility: tau -> 0 while kappa stays --
        if rec["tau"] < 1e-12 * max(1.0, rec["kappa"]) or (
            rec["mu"] < 1e3 * pars.eps and rec["tau"] < 1e-6 * rec["kappa"]
        ):
            stop = 2
            break
        # -- stall: no step progress (sedumi.m:497-506); a non-final phase
        # escalates instead of giving up --
        stall = stall + 1 if (rec["alpha"] < 1e-5 and it > 5) else 0
        if stall >= 3 and not _escalate(f"stalled (alpha<1e-5 x{stall})"):
            stop = -1
            break
        if pars.checkpoint_every and pars.checkpoint_path and \
                it % pars.checkpoint_every == 0 and \
                (mesh is None or mesh.rank == 0):
            _save_checkpoint(pars.checkpoint_path, layout, state, it)

    # best-iterate fallback, except on the infeasibility path where the
    # final iterate is the Farkas ray
    tau_collapsed = float(state.tau) < 1e-8 * max(1.0, float(state.kappa))
    if stop not in (1, 2) and not tau_collapsed and not optstep_hit:
        _arbitrate()
    if stop != 2 and not tau_collapsed and best_rec is not None \
            and best_worst < np.inf:
        state = best_state
        iterlog.append(dict(best_rec))
    st_last = iterlog[-1] if iterlog else dict(
        err_p=np.inf, err_d=np.inf, gap_rel=np.inf, cx=0.0, by=0.0)
    profile = None
    if pars.profile:
        # the hot phases timed on the final iterate (reference solver.py:
        # 1250-1266): the f32 phase's bundle when there is one, else the
        # first phase's, under that phase's eigensolver.  Under a mesh the
        # bundle's operator forms its share and all-reduces, as in the
        # step, and the Cholesky is the replicated dense one, as the
        # reference's profile_iteration runs it.
        from . import profiling

        prof = "f32" if "f32" in bundles else phase_order[0]
        bd = bundles[prof]
        st_prof = ipm.cast_state(state, bd["sdt"])
        with _phase_eigh(prof, device):
            profile = profiling.profile_sparse_iteration(
                TileSchurEngine(pars), bd["aop"], st_prof, reg) \
                if engine_kind == "sparse" else \
                profiling.profile_iteration(bd["aop"], st_prof, reg)
    return InternalResult(
        x=to_flat(layout, state.x),
        y=state.y.cpu().numpy() * rowscale * cscale,
        z=to_flat(layout, state.z) * cscale,
        tau=float(state.tau),
        kappa=float(state.kappa),
        iter=it,
        stop=stop,
        err_p=float(st_last["err_p"]),
        err_d=float(st_last["err_d"]),
        gap_rel=float(st_last["gap_rel"]),
        cx=float(st_last["cx"]),
        by=float(st_last["by"]),
        iterlog=iterlog,
        engine=engine_kind,
        vplot={"v": vlist, "rate": ratelist} if pars.vplot else None,
        optstep=optstep_hit,
        profile=profile,
    )


def _save_checkpoint(path: str, layout: Layout, state, it: int) -> None:
    np.savez(path, x=to_flat(layout, state.x), y=state.y.cpu().numpy(),
             z=to_flat(layout, state.z), tau=float(state.tau),
             kappa=float(state.kappa), it=it)


def _load_checkpoint(path: str, layout: Layout, device,
                     dtype=torch.float64):
    d = np.load(path)
    state = ipm.IPMState(
        x=from_flat(layout, d["x"], device, dtype=dtype),
        y=torch.as_tensor(d["y"], dtype=dtype, device=device),
        z=from_flat(layout, d["z"], device, dtype=dtype),
        tau=torch.tensor(float(d["tau"]), dtype=dtype, device=device),
        kappa=torch.tensor(float(d["kappa"]), dtype=dtype, device=device),
    )
    return state, int(d["it"])


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sedumi_tpu_torch runs on the CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    return dev


def sedumi(
    A,
    b=None,
    c=None,
    K: "ConeSpec | Mapping[str, Any] | None" = None,
    pars: "Pars | Mapping[str, Any] | None" = None,
    device="cuda",
):
    """Solve  min c'x s.t. Ax=b, x in K  /  max b'y s.t. c - A'y in K*.

    The reference's calling convention and `info` contract (sedumi.m:
    49-163), argument sniffing included (sedumi.m:228-253).  `device`
    ('cuda' by default) is where the IPM runs; the CPU runs only when the
    caller passes device='cpu'.
    """
    import scipy.sparse as sp

    from . import transform as tf

    device = _resolve_device(device)
    A = sp.csc_matrix(A)

    def _isvec(v):
        return v is not None and not isinstance(v, (Mapping, ConeSpec)) \
            and np.asarray(v).size > 1

    def _isempty(v):
        if v is None:
            return True
        a = np.asarray(v.todense() if sp.issparse(v) else v)
        return a.size == 0 or (a.size == 1 and float(np.abs(a).max()) == 0.0)

    _CONE_KEYS = {"f", "l", "q", "r", "s", "z",
                  "scomplex", "xcomplex", "ycomplex"}

    def _is_cone(v):
        if isinstance(v, ConeSpec):
            return True
        if isinstance(v, Mapping):
            return bool(set(v) & _CONE_KEYS)
        names = getattr(getattr(v, "dtype", None), "names", None)
        return bool(names and set(names) & _CONE_KEYS)

    if b is None and (c is None or _is_cone(c)):
        raise ValueError(
            "Should have at least (A,b) or (A,c) arguments (sedumi.m:232)")
    if _is_cone(c):
        # sedumi(A, b, K) or sedumi(A, b, K, pars) (sedumi.m:240-249)
        if K is not None and pars is None:
            pars = K
        K = c
        c = None
    if c is None or _isempty(c):
        if _isvec(b) and np.asarray(b).size == max(A.shape) \
                and A.shape[0] != A.shape[1]:
            c, b = b, None
        else:
            c = None   # zeros, sized after K resolves below

    pars = Pars.make(pars)
    K = ConeSpec.make(K)
    if K.dim == 0:
        # all-LP default (sedumi.m:250-251: K.l = max(size(A)))
        n_guess = np.asarray(c).size if _isvec(c) else max(A.shape)
        K = ConeSpec(l=int(n_guess))
    if c is None or _isempty(c):
        c = np.zeros(K.dim)
    if b is None or _isempty(b):
        m_guess = A.shape[1] if A.shape[0] == K.dim else A.shape[0]
        b = np.zeros(int(m_guess))
    t0 = time.time()
    cpu0 = time.process_time()

    prob = tf.pretransfo(A, b, c, K, pars)

    # --- pre-IPM consistency checks (sedumi.m:262-305): a least-squares
    # Farkas probe, and a pivoted-QR rank probe that drops dependent rows
    drop_rows = None
    keep_rows = None
    At_i, b_i, c_i = prob.At, prob.b, prob.c
    N_i, m_i = At_i.shape
    if N_i * m_i < 100_000:
        Ad = np.asarray(At_i.todense())
        M_aug = np.vstack([Ad, b_i[None, :]])
        rhs = np.zeros(N_i + 1)
        rhs[-1] = 1.0
        yy, *_ = np.linalg.lstsq(M_aug, rhs, rcond=None)
        if abs(b_i @ yy - 1.0) < 1e-10 and \
                np.linalg.norm(Ad @ yy) < 1e-10:
            _log(pars, "pre-check: infeasibility certificate found "
                       "(no x solves Ax = b)")
            y_u = tf.posttransfo_y(prob, yy / max(b_i @ yy, 1e-300))
            x_u = np.zeros(K.dim,
                           np.complex128 if prob.complex_input else np.float64)
            t_end = time.time()
            return x_u, y_u, {
                "iter": 0, "pinf": 1, "dinf": 0, "numerr": 0, "r0": 0.0,
                "feasratio": -1.0, "lin_engine": "none",
                "timing": [t_end - t0, 0.0, 0.0],
                "wallsec": t_end - t0,
                "cpusec": time.process_time() - cpu0,
            }
        if m_i <= 1500:
            import scipy.linalg as sla

            _, R, piv = sla.qr(Ad, mode="economic", pivoting=True)
            dg = np.abs(np.diag(R))
            tol = max(N_i, m_i) * np.finfo(float).eps * (dg[0] if dg.size
                                                         else 0.0)
            rank = int(np.sum(dg > tol))
            if rank < m_i:
                keep_rows = np.sort(piv[:rank])
                drop_rows = np.sort(piv[rank:])
                coeff, *_ = np.linalg.lstsq(Ad[:, keep_rows],
                                            Ad[:, drop_rows], rcond=None)
                b_pred = b_i[keep_rows] @ coeff
                scale = 1.0 + np.max(np.abs(b_i))
                if np.max(np.abs(b_i[drop_rows] - b_pred)) > 1e-8 * scale:
                    drop_rows = keep_rows = None   # let the IPM certify
                else:
                    _log(pars, f"pre-check: dropped {drop_rows.size} "
                               "linearly dependent constraint row(s)")
                    At_i = sp.csc_matrix(At_i)[:, keep_rows]
                    b_i = b_i[keep_rows]
    t_pre = time.time()

    res = solve_internal(At_i, b_i, c_i, prob.layout, pars, device=device)
    if drop_rows is not None:
        y_full = np.zeros(m_i, res.y.dtype)
        y_full[keep_rows] = res.y
        res.y = y_full
    t_ipm = time.time()

    info: dict[str, Any] = {}
    tau, kappa = res.tau, res.kappa
    pinf, dinf, numerr, r0, x_int, y_int, is_farkas = _grade_solution(
        prob, res, pars)
    if is_farkas:
        x_u = tf.posttransfo_x(prob, x_int)
        y_u = tf.posttransfo_y(prob, y_int)
        info.update(feasratio=-1.0)
    else:
        if res.optstep:
            info["optstep"] = 1    # in-loop finite termination fired
        if pars.optstep and not res.optstep \
                and not prob.layout.q and not prob.layout.s:
            from .optstep import optstep_lp

            xe, ye = optstep_lp(prob.At, prob.b, prob.c,
                                x_int, y_int, res.z / max(tau, 1e-300),
                                pars.eps)
            if xe is not None:
                x_int, y_int = xe, ye
                info["optstep"] = 1
        x_u = tf.posttransfo_x(prob, x_int)
        y_u = tf.posttransfo_y(prob, y_int)
        info.update(feasratio=float((tau - kappa) / (tau + kappa))
                    if tau + kappa > 0 else 1.0)
    t_post = time.time()

    info.update(
        iter=res.iter,
        pinf=pinf,
        dinf=dinf,
        numerr=numerr,
        r0=r0,
        timing=[t_pre - t0, t_ipm - t_pre, t_post - t_ipm],
        wallsec=t_post - t0,
        cpusec=time.process_time() - cpu0,
    )
    if res.profile is not None:
        info["profile"] = res.profile
    info["lin_engine"] = res.engine
    phases: dict[str, dict] = {}
    for rec in res.iterlog:
        ph = rec.get("phase")
        if ph is None:
            continue
        d = phases.setdefault(ph, {"iters": 0, "wall_s": 0.0})
        d["iters"] += 1
        d["wall_s"] = round(d["wall_s"] + rec.get("wall_s", 0.0), 3)
    info["phases"] = phases
    if res.vplot is not None:
        info["vplot"] = res.vplot
    if pars.errors and not (pinf or dinf):
        info.update(dimacs_errors(A, b, c, K, x_u, y_u))
        if pars.fid:
            print("DIMACS errors: "
                  + " ".join(f"{e:8.1e}" for e in info["err"]))
    return x_u, y_u, info


def _grade_solution(prob, res: InternalResult, pars: Pars):
    """Reference-grade solution interpretation (sedumi.m:598-728), on the
    internal data: feasible quality relinf vs Farkas quality reldirinf,
    certificate normalization, and numerr against eps/bigeps, after the
    terminal conic refinement.

    Returns (pinf, dinf, numerr, r0, x_int, y_int, is_farkas)."""
    import scipy.sparse as sp

    At = sp.csc_matrix(prob.At)
    b = np.asarray(prob.b, np.float64).ravel()
    c = np.asarray(prob.c, np.float64).ravel()
    lay = prob.layout
    K_int = ConeSpec(l=lay.l, q=tuple(lay.q), s=tuple(lay.s))

    def maxeig_pos(v):
        lab = eigK(np.asarray(v).ravel(), K_int)
        return float(np.max(lab)) if lab.size else 0.0

    x = np.asarray(res.x, np.float64)
    y = np.asarray(res.y, np.float64)
    tau = float(res.tau)
    cx = float(c @ x)
    by = float(b @ y)
    Ax = At.T @ x
    Ay = At @ y
    maxb = float(np.max(np.abs(b))) if b.size else 0.0
    maxc = float(np.max(np.abs(c))) if c.size else 0.0

    pinf_n = float(np.linalg.norm(tau * b - Ax))
    dinf_n = maxeig_pos(Ay - tau * c)
    pinf = dinf = 0
    numerr = 0
    r0 = np.inf
    use_farkas = tau <= 0.0
    pdirinf = float(np.linalg.norm(Ax))
    ddirinf = maxeig_pos(Ay)
    if tau > 0:
        relinf = max(pinf_n / (1.0 + maxb), dinf_n / (1.0 + maxc)) / tau
        if relinf > pars.eps:
            reldirinf = pdirinf / (-cx) if cx < 0 else np.inf
            if by > 0:
                reldirinf = min(reldirinf, ddirinf / by)
            if reldirinf < pars.eps or relinf > max(pars.bigeps, reldirinf):
                use_farkas = True

    if not use_farkas:
        x = x / tau
        y = y / tau
        cx, by = cx / tau, by / tau
        pinf_n, dinf_n = pinf_n / tau, dinf_n / tau
        normx = float(np.linalg.norm(x))
        normy = float(np.linalg.norm(y))
        abscx = float(np.abs(c) @ np.abs(x))
        if cx <= by:
            r_gap = 0.0
        elif cx == 0.0:
            r_gap = -by / (maxb * normy + 1e-10)
        elif by == 0.0:
            r_gap = cx / (maxc * normx + 1e-10)
        else:
            r_gap = (cx - by) / (abs(by) + 1e-5 * (1.0 + abscx))
        maxRb_g, maxRc_g = _residual_scales(At, b, c, lay)
        r0 = max(r_gap, pinf_n / (1.0 + maxb + 1e-3 * maxRb_g),
                 dinf_n / (1.0 + maxc + 1e-3 * maxRc_g))
        # terminal conic refinement, kept only on a measured improvement
        if pars.refine:
            from .refine import conic_refine

            try:   # optional, as in the reference: a failure keeps x, y
                cand = conic_refine(
                    At, b, c, lay, x, y,
                    1.0 + maxb + 1e-3 * maxRb_g,
                    1.0 + maxc + 1e-3 * maxRc_g,
                    pars.eps, fid=pars.fid)
            except Exception:
                cand = None
            if cand is not None:
                x, y = cand.x, cand.y
                cx, by = float(c @ x), float(b @ y)
                r0 = min(r0, cand.r0)
        if res.stop != 1:
            if r0 > pars.bigeps:
                numerr = 2
            elif r0 > pars.eps:
                numerr = 1
        else:
            r0 = min(r0, pars.eps)
        return pinf, dinf, numerr, float(r0), x, y, False

    # Farkas interpretation (sedumi.m:694-728)
    if cx < 0 and pdirinf < -pars.bigeps * cx:
        r0 = abs(pdirinf / cx)
        dinf = 1
        x = x / (-cx)
    if by > 0 and ddirinf < pars.bigeps * by:
        r0 = min(r0, abs(ddirinf / by)) if np.isfinite(r0) \
            else abs(ddirinf / by)
        pinf = 1
        y = y / by
    if pinf + dinf == 0:
        numerr = 2
    elif res.stop == -1:
        numerr = 1 if (not np.isfinite(r0) or r0 > pars.eps) else 0
    return pinf, dinf, numerr, float(r0), x, y, True


def dimacs_errors(A, b, c, K, x, y) -> dict[str, Any]:
    """The six DIMACS error measures on the original data
    (sedumi.m:773-807, dimacserrors.m)."""
    import scipy.sparse as sp

    K = ConeSpec.make(K)
    b = np.asarray(b).ravel()
    c = np.asarray(c).ravel() if not sp.issparse(c) \
        else np.asarray(c.todense()).ravel()
    A = sp.csc_matrix(A)
    n = K.dim
    if A.shape != (b.size, n):
        A = A.T
    x = np.asarray(x).ravel()
    y = np.asarray(y).ravel()
    z = c - A.T @ y

    normb = 1.0 + np.max(np.abs(b)) if b.size else 1.0
    normc = 1.0 + np.max(np.abs(c)) if c.size else 1.0
    cx = np.real(np.vdot(c, x))
    by = np.real(np.vdot(b, y))
    denom_g = 1.0 + abs(cx) + abs(by)
    # primal residual of what was imposed: K.ycomplex rows are complex
    # equalities, every other row constrains Re(a_i^H x) only
    res = np.conj(A) @ x - b if np.iscomplexobj(x) or np.iscomplexobj(
        A.data if sp.issparse(A) else A) else A @ x - b
    if np.iscomplexobj(res):
        yc = np.zeros(b.size, bool)
        yc[[i - 1 for i in K.ycomplex]] = True
        res = np.where(yc, np.abs(res), np.abs(np.real(res)))
    err1 = np.linalg.norm(res) / normb
    lab_x = eigK(x, K)
    err2 = max(0.0, -float(np.min(lab_x)) if lab_x.size else 0.0) / normb
    err3 = 0.0  # z defined as c - A'y exactly
    lab_z = eigK(z, K)
    err4 = max(0.0, -float(np.min(lab_z)) if lab_z.size else 0.0) / normc
    err5 = (cx - by) / denom_g
    err6 = np.real(np.vdot(x, z)) / denom_g
    return {"err": [float(err1), float(err2), float(err3), float(err4),
                    float(err5), float(err6)],
            "cx": float(cx), "by": float(by)}
