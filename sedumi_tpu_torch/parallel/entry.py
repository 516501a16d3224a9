"""Entry points of the multi-device path, and the functions its ranks run.

Counterparts of the reference's __graft_entry__.py (_small_problem :19,
entry :51, dryrun_multichip :57): one IPM step of a small mixed-cone
problem, on one device or with the cone-block axis split over a mesh, the
panel engine on the same mesh, and the 2-D {"hosts": 2, "blocks": n/2}
mesh with the panels on "blocks".  dryrun_multichip and the rank_*
functions run inside an initialized process group (parallel.launch.
run_spmd hands them to its ranks; the tests and chip_smoke.py call them
so), each rank on the same data.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import ipm, kernels
from ..convert import dense_aop_from_numpy, scaling_from_numpy
from ..generators import feasible_problem
from ..opA import DenseAOp, build_dense_aop
from ..params import Pars
from ..structs import cv_cast
from ..transform import pretransfo
from . import mesh as mesh_mod
from .mesh import make_mesh, replicate, shard_aop, shard_state
from .panels import PanelSchurEngine, _dist_trisolve, dist_cholesky


def _small_problem(n_blocks_s: int = 2, n_blocks_q: int = 2, m: int = 6,
                   seed: int = 0, device="cuda"):
    """(step, (aop, b, rowscale, state, reg), (layout, pars, normb,
    normc)) of the reference's small problem: K = {l: 4, q: [3] x
    n_blocks_q, s: [4] x n_blocks_s}, feasible_problem(K, m, seed), the
    dense bucketed operator of the row-equilibrated data."""
    K = {"l": 4, "q": [3] * n_blocks_q, "s": [4] * n_blocks_s}
    At, b, c, Kspec = feasible_problem(K, m, seed=seed)
    pars = Pars(fid=0)
    prob = pretransfo(At, b, c, Kspec, pars)
    layout = prob.layout
    rnorm = np.sqrt(
        np.asarray(prob.At.multiply(prob.At).sum(axis=0)).ravel()
        + prob.b**2)
    rowscale = np.where(rnorm > 0, 1.0 / np.maximum(rnorm, 1e-300), 1.0)
    At_s = sp.csc_matrix(prob.At) @ sp.diags(rowscale)
    b_s = prob.b * rowscale
    aop = build_dense_aop(At_s, prob.c, layout, device=device)
    normb = float(np.max(np.abs(b_s)))
    normc = float(np.max(np.abs(prob.c)))
    state = ipm.init_state(layout, aop, b_s, normb, normc, pars,
                           device=device)
    step = ipm.make_step(layout, pars, normb, normc)
    args = (aop, torch.as_tensor(b_s, device=device),
            torch.as_tensor(rowscale, device=device), state, 0.0)
    return step, args, (layout, pars, normb, normc)


def entry(device="cuda"):
    """(fn, example_args): one full IPM iteration on one device."""
    step, args, _ = _small_problem(device=device)
    return step, args


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One IPM step with the cone-block axis split over an n_devices mesh
    (two, to reach the steady state), one with the panel engine on it,
    and, for an even n_devices >= 4, both on the {"hosts": 2, "blocks":
    n/2} mesh.  Every mu and alpha must be finite; returns them."""
    step, (aop, b, rs, state, reg), meta = _small_problem(
        n_blocks_s=2 * n_devices, n_blocks_q=2 * n_devices, m=8, seed=1,
        device=device)
    mesh = make_mesh(n_devices, device=device)
    aop_sh = shard_aop(aop, mesh)
    state_sh = shard_state(state, mesh)
    b_sh, rs_sh = replicate((b, rs), mesh)
    out = {}
    new_state, stats = step(aop_sh, b_sh, rs_sh, state_sh, reg)
    _, stats2 = step(aop_sh, b_sh, rs_sh, new_state, reg)
    out["blocks"] = (float(stats.mu), float(stats.alpha))
    out["blocks_step2"] = (float(stats2.mu), float(stats2.alpha))
    layout, pars, normb, normc = meta
    step_panel = ipm.make_step(layout, pars, normb, normc,
                               engine=PanelSchurEngine(mesh, bs=4))
    _, stats3 = step_panel(aop_sh, b_sh, rs_sh, state_sh, reg)
    out["panels"] = (float(stats3.mu), float(stats3.alpha))
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = make_mesh(shape={"hosts": 2, "blocks": n_devices // 2},
                          device=device)
        both = ("hosts", "blocks")
        aop_2 = shard_aop(aop, mesh2, axis=both)
        state_2 = shard_state(state, mesh2, axis=both)
        _, stats4 = step(aop_2, b_sh, rs_sh, state_2, reg)
        out["hosts_blocks"] = (float(stats4.mu), float(stats4.alpha))
        step_panel2 = ipm.make_step(
            layout, pars, normb, normc,
            engine=PanelSchurEngine(mesh2, axis="blocks", bs=4))
        _, stats5 = step_panel2(aop_2, b_sh, rs_sh, state_2, reg)
        out["hosts_panels"] = (float(stats5.mu), float(stats5.alpha))
    for key, (mu, alpha) in out.items():
        if not (np.isfinite(mu) and np.isfinite(alpha)):
            raise FloatingPointError(f"dryrun_multichip {key}: mu={mu} "
                                     f"alpha={alpha}")
    return out


# --------------------------------------------------------------------------
# rank functions (run_spmd's targets)
# --------------------------------------------------------------------------


def rank_dryrun(rank: int, n_devices: int, device="cuda") -> dict:
    return dryrun_multichip(n_devices, device=device)


def rank_sharded_step(rank: int, n_blocks: int, m: int, seed: int,
                      device="cuda") -> dict:
    """One step of _small_problem(n_blocks, n_blocks, m, seed) with the
    block axis split over the world (the reference's
    test_sharded_matches_unsharded)."""
    step, (aop, b, rs, state, reg), _ = _small_problem(
        n_blocks_s=n_blocks, n_blocks_q=n_blocks, m=m, seed=seed,
        device=device)
    mesh = make_mesh(device=device)
    new_state, stats = step(shard_aop(aop, mesh), b, rs,
                            shard_state(state, mesh), reg)
    return {"mu": float(stats.mu), "alpha": float(stats.alpha),
            "y": new_state.y}


def rank_panel_jobs(rank: int, jobs: list, device="cuda") -> list:
    """The panel routines on numpy inputs, over a one-axis world mesh
    "blocks": ("chol", M, bs) -> L; ("solve", M, b, bs) -> x from the
    factor and both substitutions; ("engine", aop arrays, scaling arrays,
    reg, rhs, bs[, dtype, factor dtype]) -> (ahc, chc, ok, x) of
    PanelSchurEngine, its operator, scaling and rhs in `dtype` (a torch
    dtype's name, float64 by default) and its factor in `factor dtype`
    (None: the formation's; the hybrid phase's f64 factor of an f32
    formation)."""
    mesh = make_mesh(device=device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    out = []
    for job in jobs:
        kind = job[0]
        if kind == "chol":
            _, M, bs = job
            out.append(dist_cholesky(t(M), mesh, "blocks", bs))
        elif kind == "solve":
            _, M, b, bs = job
            L = dist_cholesky(t(M), mesh, "blocks", bs)
            y = _dist_trisolve(L, t(b), mesh, "blocks", bs, lower=True)
            out.append(_dist_trisolve(L, y, mesh, "blocks", bs, lower=False))
        elif kind == "engine":
            _, aop_np, S_np, reg, rhs, bs, *prec = job
            dt, fdt = (getattr(torch, prec[0]),
                       prec[1] and getattr(torch, prec[1])) if prec \
                else (torch.float64, None)
            a = dense_aop_from_numpy(*aop_np, device=device)
            aop = DenseAOp(a.Al.to(dt), [v.to(dt) for v in a.Aq],
                           [v.to(dt) for v in a.As], a.q_shapes, a.s_shapes)
            S = cv_cast(scaling_from_numpy(S_np, device=device), dt)
            eng = PanelSchurEngine(mesh, bs=bs, factor_dtype=fdt)
            ctx, ahc, chc, ok = eng.prepare(aop, S, reg)
            out.append((ahc, chc, ok, eng.solve(ctx, t(rhs).to(dt))))
        else:
            raise ValueError(f"unknown panel job {kind!r}")
    return out


def rank_sedumi(rank: int, problem: tuple, pars: dict,
                device="cuda") -> dict:
    """One sedumi() solve on this rank: problem ("example", name) or
    ("feasible", K, m, seed).  Returns x, y, the solve's info fields that
    do not measure time, the iterations and wall seconds per phase, the
    wall seconds, this rank's kernel launches, and its collectives and the
    host seconds in them."""
    import sedumi_tpu_torch as st

    if problem[0] == "example":
        from ..examples import load_example

        ex = load_example(problem[1])
        At, b, c, K = ex.At, ex.b, ex.c, ex.K
    else:
        _, K, m, seed = problem
        At, b, c, _ = feasible_problem(K, m, seed=seed)
    kernels.reset_launch_counts()
    mesh_mod.COMM.update(calls=0, seconds=0.0)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.time()
    x, y, info = st.sedumi(At, b, c, K, pars, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.time() - t0
    keep = ("iter", "pinf", "dinf", "numerr", "feasratio", "r0", "err",
            "lin_engine")
    return {"x": x, "y": y,
            "info": {k: info[k] for k in keep if k in info},
            "phases": {k: v["iters"] for k, v in info["phases"].items()},
            "phase_wall": {k: v["wall_s"] for k, v in info["phases"].items()},
            "cx": float(np.real(np.vdot(c, x))),
            "by": float(np.real(np.vdot(b, y))),
            "wall": wall,
            "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
            "comm_calls": mesh_mod.COMM["calls"],
            "comm_s": mesh_mod.COMM["seconds"]}


def rank_sedumi_witness(rank: int, problem: tuple, pars: dict, plain: bool,
                        device="cuda") -> dict:
    """rank_sedumi under torch.use_deterministic_algorithms (cuBLAS with a
    fixed workspace, index_add_ without atomics), with K14/K15's plain
    versions in place of the kernels when `plain`: the card witness that
    splits the card's run-to-run noise from the kernels."""
    import os

    from . import panels

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    if plain:
        panels.panel_chol_step = panels.panel_chol_plain
        panels.trisolve_fwd_step = panels.trisolve_fwd_plain
        panels.trisolve_bwd_contrib = panels.trisolve_bwd_contrib_plain
        panels.trisolve_bwd_solve = panels.trisolve_bwd_solve_plain
    return rank_sedumi(rank, problem, pars, device=device)


def rank_batch(rank: int, calls: list, device="cuda") -> list:
    """Several rank functions of this module in one process group, in
    order: calls is a list of (name, args); each runs as
    name(rank, *args, device=device).  One spawn serves them all."""
    table = {"rank_dryrun": rank_dryrun,
             "rank_sharded_step": rank_sharded_step,
             "rank_panel_jobs": rank_panel_jobs,
             "rank_sedumi": rank_sedumi}
    return [table[name](rank, *args, device=device) for name, args in calls]
