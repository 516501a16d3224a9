"""The port's redesigned kernels beside an earlier build of the same
kernels, on one card.

    python3 parent_bench.py --parent DIR
        [--cases tiles,panels,dd,k13,gemv,schur,ldl,twins,solves,mesh]
        [--plans lp20k,sdp5k,sdp1200]
        [--problems arch0,control07] [--repeat N]

DIR holds another checkout of this repository (for example the parent
commit, unpacked with git archive).  Its sedumi_tpu_torch is loaded under
another module name (load_package), so both builds (each compiled into
its own package's _build/) run in this one process on the same inputs.
Each case times its calls in turns (earlier, this, this, earlier), back
to back between CUDA events and, where the call can be captured, as the
replay of a CUDA graph (chip_smoke.graph_ms), and reports each build's
mean and runs.  The cases (all by default):

* tiles: K8, K9 and K10 on the plans of chip_smoke.py's sparse solves
  (--plans; the tile storage A H A' at a random interior point,
  chip_smoke.tile_case) in f64 and f32: K9 at each plan's widest level
  (with its level statistics) and its graph-replay time summed over all
  levels of one factor, each level from the same storage for both builds
  and the builds within K9's bound of each other; the whole tile solve
  (K10), the builds' solutions' largest difference; and at lp20k's
  widest level K8's diagonal and off launches apart, the builds bit for
  bit equal;
* panels: K14 and K15, and their f32 builds, at the mesh path's panel
  shapes (chip_smoke.panel_case: OH's bs 128, mp 1024 and nb's bs 32,
  mp 128): K14 on column 0 and over the columns of one factor, K15's
  forward step, backward contribution and back solve, the builds within
  chip_smoke.PANEL_CASE's tolerance (and whether bit for bit) and this
  build bit for bit its emulation; and K14 over every column of one
  factor at mp 4096 and 16384 (bs 128, events; k14_at_scale) beside
  torch.linalg.cholesky_ex of the whole matrix;
* dd: on one matrix of cond 1e14 at control07's m = 666 and arch0's
  m = 174, K7 on the first panel (m x 48), a whole dd_chol, and each
  build's dd_chol_solve on its own factor, and K6 on control07's m x m
  refinement product, the builds' panels, factors, solutions and
  products bit for bit equal;
* k13: K13 with vectors at 2 x 60 in complex128 and complex64 and at one
  matrix of order 120 and 200 in complex128, beside torch.linalg.eigh,
  the builds' eigenvalues within 4 n eps ||A|| of each other;
* gemv: K1 and K1-f32 at the path's orders (chip_smoke.K1_ORDERS:
  174, 666, 948), alone and with lo (the earlier build's residual line:
  K1, M @ lo, the subtraction), beside torch.addmv and M.sum(1), the
  builds within their bounds of each other; K1 on one element beside a
  one-element fill (a launch's fixed cost); K1's eager call at 666 by
  part on the host clock (10^4 calls each: stream, function lookup,
  checks, allocation, the whole wrapper); K11's df_matvec and df_vecmat
  on socp-dense's and nb's double-float operators ([121, 400], [124,
  2379]) and at [1001, 65536], beside torch.mv on the f64 operator, the
  builds within their bounds of each other;
* schur: K2 at the dense path's COO buckets (arch0, trto3; f64 and f32)
  and the sparse engine's PSD pair values on the sdp1200 and sdp5k plans
  (the earlier build: its whole-group build, then the gather and the
  product), K4 at the dd64 path's shapes (chip_smoke.K4_SHAPES), and
  form_dd and dd_chol at control07 and arch0 with each build's K4
  launches, the builds bit for bit equal everywhere;
* ldl: K3 and K3-f32 at 3, 124, 174 and 666 (LDL_ORDERS), the builds bit
  for bit equal, events and graph replay, the m = 3 eager call on the
  host clock, and this build's other plans (LDL_SWEEP) in graph replay;
* twins: arch0 and control07, and nb+zero-row and lp900+3dense under
  'auto' and 'mixed' (K3 and K3-f32 launching), solved by each build with
  deterministic algorithms, x and y bit for bit equal;
* solves: whole solves of --problems (bundled examples) under 'auto' and
  'mixed' (a warm-up solve each first), the turns repeated --repeat
  times: each build's wall, iterations, phases with their walls, rel and
  numerr, and how often each build landed at each (phases, rel);
* mesh: chip_smoke.MESH_SOLVES (OH {"panels": 2} on 2 ranks, nb
  {"hosts": 2, "panels": 2} on 4, f64 and 'mixed') by each build in a
  process of its own (the earlier build, then this one; their ranks
  share the card under gloo): per rank the wall, the collectives and the
  bytes received in them (torch.distributed's collectives wrapped in the
  ranks, one model for both builds), their share of the wall and the
  peak of allocated device memory; then deterministically, each build's
  x and y compared bit for bit.  --repeat N runs the solves as they run
  N times, the builds' order alternating between rounds.

Prints a line per case's row, then one JSON line of all rows, the card's
name and power limit.  Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

WHO = ("earlier", "this", "this", "earlier")


def load_package(root: str, name: str):
    """Import ROOT/sedumi_tpu_torch as module `name`."""
    init = os.path.join(root, "sedumi_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def old_module(name: str):
    """The earlier build's submodule `name` (as in sedumi_tpu_torch)."""
    return importlib.import_module(f"sedumi_tpu_torch_old.{name}")


def turns(calls: dict, graph: bool = True, reps: int = 20) -> dict:
    """Event and graph-replay ms of each build's call, in turns earlier,
    this, this, earlier; the mean of each build's two runs."""
    import chip_smoke as cs

    ev = {"earlier": [], "this": []}
    gr = {"earlier": [], "this": []}
    for who in WHO:
        ev[who].append(cs.cuda_ms(calls[who], reps))
        if graph:
            gr[who].append(cs.try_graph_ms(who, calls[who]))
    out = {"event_ms": {k: sum(v) / len(v) for k, v in ev.items()},
           "event_ms_runs": ev}
    if graph:
        out["graph_ms"] = {k: None if None in v else sum(v) / len(v)
                           for k, v in gr.items()}
        out["graph_ms_runs"] = gr
    return out


def report(out: dict, key: str, row: dict) -> None:
    out[key] = row
    print(f"{key}: {json.dumps(row)}", flush=True)


# ------------------------------------------------------------------ tiles


def plan_of(make, pars):
    """The host plan route_engine makes for a problem (chip_smoke's
    solves take the same route)."""
    from sedumi_tpu_torch import solver
    from sedumi_tpu_torch.params import Pars
    from sedumi_tpu_torch.transform import pretransfo

    A, b, c, K = make(np.random.default_rng(12345))
    p = Pars.make(pars)
    pre = pretransfo(A, b, c, K, p)
    kind, plan = solver.route_engine(pre.At, pre.c, pre.layout, p)
    if kind != "sparse":
        raise RuntimeError("the problem did not take the sparse route")
    return plan


def diag_off_ms(kern, st, lv, reg, canceltol, sfx):
    """(diag ms, off ms, tiles after both) of one build's K8 launches at
    level lv; kern is that build's kernels module."""
    from chip_smoke import cuda_ms

    work = st.clone()
    rung = torch.empty(lv["dslot"].numel(), dtype=torch.int32,
                       device=st.device)
    B = st.shape[-1]

    def diag():
        work.copy_(st)
        kern.launch("tile_chol.cu", f"tile_diag{sfx}_launch",
                    work.data_ptr(), lv["dslot"].data_ptr(), rung.data_ptr(),
                    lv["dslot"].numel(), B, float(reg), float(canceltol))

    diag()
    after = work.clone()

    def off():
        work.copy_(after)
        kern.launch("tile_chol.cu", f"tile_off{sfx}_launch",
                    work.data_ptr(), lv["off_slot"].data_ptr(),
                    lv["off_dslot"].data_ptr(), lv["off_slot"].numel(), B)

    copy = cuda_ms(lambda: work.copy_(st), 20)
    off()
    return cuda_ms(diag, 20) - copy, cuda_ms(off, 20) - copy, work.clone()


def k9_levels(osc, sc, st, levels, sfx) -> dict:
    """Factor `st` in place level by level (this build's K8 and K9); before
    each level's update, time both builds' K9 from copies of the same
    storage in graph replays (in turns), and hold them within K9's bound
    of each other (chip_smoke.check_tile_kernels' bound).  Returns the
    widest level's times (events and graph replays), the summed graph
    times over the levels and the level statistics."""
    import chip_smoke as cs

    B = st.shape[-1]
    eps = float(torch.finfo(st.dtype).eps)
    tiny = float(torch.finfo(st.dtype).tiny) if sfx else 0.0
    wide = max(range(len(levels)),
               key=lambda i: (levels[i]["cols"].numel(),
                              levels[i]["pair_a"].numel()))
    total = {"earlier": 0.0, "this": 0.0}
    out = {}
    for i, lv in enumerate(levels):
        sc.tile_factor(st, lv, 0.0)
        if not lv["pair_a"].numel():
            continue
        got = {who: st.clone() for who in total}
        osc.tile_update(got["earlier"], lv)
        sc.tile_update(got["this"], lv)
        dst, ptr = lv["pair_dst"], lv["pair_ptr"]
        didx = torch.repeat_interleave(
            torch.arange(dst.numel(), device=st.device), torch.diff(ptr))
        bound = st[dst].abs().index_add_(
            0, didx, st[lv["pair_a"]].abs() @ st[lv["pair_b"]].abs().mT)
        lim = 2.0 * (B + float(torch.diff(ptr).max()) + 1.0) \
            * (eps * bound + tiny)
        if not bool(torch.all((got["this"][dst] - got["earlier"][dst]).abs()
                              <= lim)):
            cs.fail(f"K9{sfx} level {i}: the builds differ beyond its bound")
        work = {who: st.clone() for who in total}
        calls = {"earlier": lambda: osc.tile_update(work["earlier"], lv),
                 "this": lambda: sc.tile_update(work["this"], lv)}
        for who in WHO:
            total[who] += cs.graph_ms(calls[who], reps=5, replays=3) / 2
        if i == wide:
            out["k9_widest"] = turns(calls)
        sc.tile_update(st, lv)
    out["k9_levels_graph_ms"] = total
    out["k9_stats"] = cs.update_level_stats(levels, wide)
    return out


def tiles_case(old, dev, args) -> dict:
    import chip_smoke as cs
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch import sparse_chol as sc

    osc = old_module("sparse_chol")
    gen = torch.Generator().manual_seed(20261016)
    solves = {name: (make, pars) for name, make, pars, _ in cs.SPARSE_SOLVES}
    out = {}
    for name in args.plans.split(","):
        t0 = time.time()
        plan = plan_of(*solves[name])
        print(f"{name}: host plan {time.time() - t0:.1f}s", flush=True)
        for dtype in (torch.float64, torch.float32):
            sfx = "_f32" if dtype == torch.float32 else ""
            aop, st = cs.tile_case(plan, dev, np.random.default_rng(20261016),
                                   dtype)
            levels = aop.levels
            row = {}
            if name == "lp20k":
                wide = max(range(len(levels)),
                           key=lambda i: (levels[i]["cols"].numel(),
                                          levels[i]["pair_a"].numel()))
                before = st.clone()
                for lv in levels[:wide]:
                    sc.tile_factor(before, lv, 0.0)
                    sc.tile_update(before, lv)
                lv = levels[wide]
                d_old, o_old, w_old = diag_off_ms(old.kernels, before, lv,
                                                  0.0, 1e-12, sfx)
                d_new, o_new, w_new = diag_off_ms(kernels, before, lv, 0.0,
                                                  1e-12, sfx)
                row["k8_widest"] = {
                    "cols": lv["dslot"].numel(),
                    "off_tiles": lv["off_slot"].numel(),
                    "diag_ms": {"earlier": d_old, "this": d_new},
                    "off_ms": {"earlier": o_old, "this": o_new},
                    "bit_equal": cs.bit_diff(w_old, w_new)[0]}
            row.update(k9_levels(osc, sc, st, levels, sfx))
            L = st
            rhs = torch.randn(aop.meta["ntiles_n"], generator=gen,
                              dtype=torch.float64).to(dev, dtype)
            calls = {"earlier": lambda: osc.tile_solve(L, rhs, levels),
                     "this": lambda: sc.tile_solve(L, rhs, levels)}
            x_old, x_new = calls["earlier"](), calls["this"]()
            row["k10"] = turns(calls, graph=False, reps=10)
            row["k10_max_diff"] = float((x_new - x_old).abs().max())
            row["max_abs_x"] = float(x_old.abs().max())
            row["levels"] = len(levels)
            report(out, f"tiles {name}{sfx}", row)
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- panels


def panel_steps(pn, c, bs: int, mp: int) -> dict:
    """name -> a call of one build's wrapper (pn: its parallel.panels) on
    the case's inputs, as chip_smoke.check_panel_kernels times them."""
    nb = mp // bs
    nb_loc = nb // 2
    Cs, L, x, b = c["Cs"], c["L"], c["x"], c["b"]
    row = L[(nb - 1) * bs:].contiguous()
    bj = b[(nb - 1) * bs:].contiguous()
    L3 = L[nb_loc * bs:].contiguous()
    Ljj = L[:bs, :bs].contiguous()

    def factor():
        return [pn.panel_chol_step(C, j) for j, C in enumerate(Cs)]

    return {
        "k14_column0": lambda: pn.panel_chol_step(Cs[0], 0),
        "k14_factor": factor,
        "k15_fwd": lambda: pn.trisolve_fwd_step(row, x, bj, nb - 1),
        "k15_contrib": lambda: pn.trisolve_bwd_contrib(L3, x, bs, nb_loc, 0),
        "k15_bwd_solve": lambda: pn.trisolve_bwd_solve(Ljj, b[:bs], x[:bs]),
    }


def panels_case(old, dev, args) -> dict:
    import chip_smoke as cs
    from sedumi_tpu_torch.parallel import panels as pn

    old_pn = old_module("parallel.panels")
    out = {}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator().manual_seed(20261016)
        sfx = " f32" if dtype == torch.float32 else ""
        for bs, mp in cs.PANEL_SHAPES:
            c = cs.panel_case(bs, mp, gen, dev, dtype)
            if not c["emu_ok"]:
                cs.fail(f"this build differs from its emulation at bs={bs}"
                        f"{sfx}")
            calls = {"earlier": panel_steps(old_pn, c, bs, mp),
                     "this": panel_steps(pn, c, bs, mp)}
            lmax = float(c["L"].abs().max())
            xmax = float(c["x"].abs().max())
            for name in calls["this"]:
                got = {who: calls[who][name]() for who in calls}
                if name == "k14_factor":
                    got = {who: torch.stack(v) for who, v in got.items()}
                diff = float((got["this"] - got["earlier"]).abs().max())
                scale = lmax if name.startswith("k14") else xmax
                if not diff <= cs.PANEL_CASE[dtype]["tol"] * scale:
                    cs.fail(f"{name} bs={bs}{sfx}: the builds differ by "
                            f"{diff!r}")
                row = turns({who: calls[who][name] for who in calls})
                row["max_diff"], row["of"] = diff, scale
                row["same_bits"] = bool(torch.equal(got["this"],
                                                    got["earlier"]))
                report(out, f"panels{sfx} bs={bs} mp={mp} {name}", row)
    for dtype in (torch.float64, torch.float32):
        for mp in PANEL_SCALE_MP:
            report(out, f"panels{' f32' if dtype == torch.float32 else ''}"
                   f" bs=128 mp={mp} k14_factor",
                   k14_at_scale(old_pn, pn, mp, dev, dtype))
    return out


# K14 over one factor's columns at orders past one wave of its grid (bs
# 128: column j launches (nb - 1 - j) * 4 CTAs, one an SM in f64)
PANEL_SCALE_MP = (4096, 16384)


def k14_at_scale(old_pn, pn, mp: int, dev, dtype) -> dict:
    """Both builds' K14 over every block column of one [mp, mp] factor
    at bs 128 (the columns as one rank sees them: chip_smoke.panel_columns),
    events only (a column's launch costs little beside its work), whether
    the builds agree bit for bit, and one torch.linalg.cholesky_ex of the
    whole matrix beside them.  The matrix A A'/mp + I, Jacobi-scaled, is
    made on the card from a seed."""
    import chip_smoke as cs

    g = torch.Generator(device=dev).manual_seed(20261018)
    A = torch.randn(mp, mp, generator=g, device=dev, dtype=torch.float64)
    M = A @ A.T / mp + torch.eye(mp, dtype=torch.float64, device=dev)
    del A
    d = torch.sqrt(torch.diagonal(M))
    M = (M / (d[:, None] * d[None, :])).to(dtype)
    Cs, _ = cs.panel_columns(M, 128)
    calls = {who: (lambda p=p: [p.panel_chol_step(C, j)
                                for j, C in enumerate(Cs)])
             for who, p in (("earlier", old_pn), ("this", pn))}
    a, b = calls["earlier"](), calls["this"]()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    del a, b
    row = turns(calls, graph=False, reps=3)
    row["same_bits"] = same
    row["columns"] = mp // 128
    row["cholesky_ex_ms"] = cs.cuda_ms(lambda: torch.linalg.cholesky_ex(M), 3)
    return row


# --------------------------------------------------------------------- dd


def dd_case(old, dev, args) -> dict:
    import chip_smoke as cs
    from sedumi_tpu_torch import ddlinalg as dd

    odd = old_module("ddlinalg")
    gen = torch.Generator().manual_seed(20261017)
    out = {}

    def same(got):
        return all(cs.bit_diff(a, c)[0]
                   for a, c in zip(got["this"], got["earlier"]))

    for m, label in cs.DD_SOLVE_SHAPES:
        M = cs.spd_with_cond(m, 1e14, gen).to(dev)
        b = torch.randn(m, generator=gen, dtype=torch.float64).to(dev)
        Sh, Sl = M[:, :48], torch.zeros_like(M)[:, :48]
        calls = {"earlier": lambda: odd.dd_panel_chol(Sh, Sl),
                 "this": lambda: dd.dd_panel_chol(Sh, Sl)}
        got = {k: v() for k, v in calls.items()}
        if not (same({k: v[:4] for k, v in got.items()})
                and bool(got["this"][4]) == bool(got["earlier"][4])):
            cs.fail(f"the builds' dd_panel_chol differ at m={m}")
        report(out, f"K7 first panel {m} x 48 ({label})", turns(calls))
        calls = {"earlier": lambda: odd.dd_chol(M),
                 "this": lambda: dd.dd_chol(M)}
        report(out, f"dd_chol m={m} ({label})", turns(calls, reps=3))
        f, fo = dd.dd_chol(M), odd.dd_chol(M)
        if not (cs.bit_diff(f.Lh, fo.Lh)[0] and cs.bit_diff(f.Ll, fo.Ll)[0]):
            cs.fail(f"the builds' dd_chol factors differ at m={m}")
        calls = {"earlier": lambda: odd.dd_chol_solve(fo, b),
                 "this": lambda: dd.dd_chol_solve(f, b)}
        if not same({k: v() for k, v in calls.items()}):
            cs.fail(f"the builds' dd_chol_solve differ at m={m}")
        report(out, f"dd_chol_solve m={m} ({label})", turns(calls))
    m = 666
    Ah = torch.randn(m, m, generator=gen, dtype=torch.float64).to(dev)
    Al = Ah * 2.0**-54
    xh = torch.randn(m, generator=gen, dtype=torch.float64).to(dev)
    xl = xh * 2.0**-54
    calls = {"earlier": lambda: odd.dd_gemv(Ah, Al, xh, xl),
             "this": lambda: dd.dd_gemv(Ah, Al, xh, xl)}
    if not same({k: v() for k, v in calls.items()}):
        cs.fail("the builds' dd_gemv differ at m=666")
    report(out, "dd_gemv m=666", turns(calls, reps=200))
    return out


# -------------------------------------------------------------------- k13


def k13_case(old, dev, args) -> dict:
    import chip_smoke as cs
    from sedumi_tpu_torch import lax_eigh

    ole = old_module("lax_eigh")
    gen = torch.Generator().manual_seed(20261017)
    out = {}
    for k, n, dt in ((2, 60, torch.complex128), (2, 60, torch.complex64),
                     (1, 120, torch.complex128), (1, 200, torch.complex128)):
        A = cs.nt_like(k, n, dt, gen).to(dev)
        sweeps = lax_eigh._sweeps_for(n, lax_eigh._real_dtype(dt))
        calls = {"earlier": lambda: ole._jacobi(A, sweeps, True),
                 "this": lambda: lax_eigh._jacobi(A, sweeps, True)}
        got = {who: c() for who, c in calls.items()}
        eps = float(torch.finfo(lax_eigh._real_dtype(dt)).eps)
        tol = 4 * n * eps * float(got["earlier"][0].abs().max())
        diff = float((torch.sort(got["this"][0]).values
                      - torch.sort(got["earlier"][0]).values).abs().max())
        if not diff <= tol:
            cs.fail(f"K13 {k} x {n} {dt}: the builds differ by {diff!r}")
        reps = 10 if n <= 60 else 3
        row = turns(calls, graph=False, reps=reps)
        row["eigh_ms"] = cs.cuda_ms(lambda: torch.linalg.eigh(A), reps)
        row["plan"] = lax_eigh.jacobi_plan(
            n, dt, True, k, lax_eigh._sm_count(dev))
        row["max_diff"], row["tol"] = diff, tol
        report(out, f"K13 {k} x {n} {dt}", row)
    return out


# ------------------------------------------------------------------- gemv


def host_us(fn, reps: int = 10000) -> float:
    """Host microseconds a call over `reps` back-to-back calls (the queue
    of launches is drained after the clock stops)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def wrapper_parts(old, M, v, rhs, lo) -> dict:
    """K1's eager call by part, 10^4 calls each on the host clock: what
    the earlier build's wrapper did (a torch.cuda.Stream a launch, the
    library and function looked up by name, three contiguous calls,
    check_cuda, torch.empty) and what this one does (the raw stream, the
    function bound once, attribute checks, empty_like), each whole
    wrapper, the three-call residual line and torch.addmv."""
    from sedumi_tpu_torch import kernels, pcg

    ok, opcg = old.kernels, old_module("pcg")
    m = M.shape[0]
    return {"earlier": {
        "stream object": host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "library and function by name": host_us(
            lambda: getattr(ok._lib("dd_residual.cu"),
                            "dd_matvec_residual_launch")),
        "three contiguous calls": host_us(
            lambda: (M.contiguous(), v.contiguous(), rhs.contiguous())),
        "check_cuda": host_us(
            lambda: ok.check_cuda(M, v, rhs, dtype=M.dtype)),
        "torch.empty": host_us(
            lambda: torch.empty(m, dtype=M.dtype, device=M.device)),
        "wrapper": host_us(lambda: opcg.dd_matvec_residual(M, v, rhs)),
        "residual line (K1, M @ lo, subtraction)": host_us(
            lambda: opcg.dd_matvec_residual(M, v, rhs) - M @ lo)},
        "this": {
        "raw stream": host_us(kernels.raw_stream),
        "bound function": host_us(
            lambda: kernels.bound("dd_residual.cu",
                                  "dd_matvec_residual_launch")),
        "attribute checks": host_us(
            lambda: (v.dtype != M.dtype or rhs.dtype != M.dtype
                     or not v.is_cuda or not rhs.is_cuda
                     or v.shape != (m,) or rhs.shape != (m,)
                     or M.stride(1) != 1 or v.stride(0) != 1
                     or rhs.stride(0) != 1)),
        "empty_like": host_us(lambda: torch.empty_like(rhs)),
        "residual_parts": host_us(lambda: pcg.residual_parts(m, 8)),
        "wrapper": host_us(lambda: pcg.dd_matvec_residual(M, v, rhs)),
        "wrapper with lo": host_us(
            lambda: pcg.dd_matvec_residual(M, v, rhs, lo))},
        "library": {"torch.addmv": host_us(
            lambda: torch.addmv(rhs, M, v, alpha=-1.0)),
            "M @ lo": host_us(lambda: M @ lo)}}


def gemv_case(old, dev, args) -> dict:
    import chip_smoke as cs
    from sedumi_tpu_torch import df, pcg

    opcg, odf = old_module("pcg"), old_module("df")
    out = {}
    for dtype in (torch.float64, torch.float32):
        u = float(torch.finfo(dtype).eps) / 2
        for m in cs.K1_ORDERS:
            M, v, rhs, lo = cs.k1_operands(m, m, dtype, 7 * m, dev)
            S = (M.double().abs() @ v.double().abs())
            tol = (2 * m + 64) * u * u * S \
                + (m + 8) * u * (M.double().abs() @ lo.double().abs())
            for fused in (False, True):
                if fused:
                    calls = {"earlier": lambda: opcg.dd_matvec_residual(
                        M, v, rhs) - M @ lo,
                        "this": lambda: pcg.dd_matvec_residual(M, v, rhs,
                                                               lo)}
                else:
                    calls = {"earlier": lambda: opcg.dd_matvec_residual(
                        M, v, rhs),
                        "this": lambda: pcg.dd_matvec_residual(M, v, rhs)}
                got = {who: c().double() for who, c in calls.items()}
                diff = (got["this"] - got["earlier"]).abs()
                if not bool(torch.all(diff <= 2 * u * got["earlier"].abs()
                                      + tol)):
                    cs.fail(f"K1 {dtype} m={m}: the builds differ beyond "
                            f"their bounds")
                row = turns(calls, reps=1000)
                lib = lambda: torch.addmv(rhs, M, v, alpha=-1.0)
                row["addmv_ms"] = cs.cuda_ms(lib, 1000)
                row["addmv_graph_ms"] = cs.graph_ms(lib)
                # PyTorch's own row reduction over the same bytes
                row["row_sum_graph_ms"] = cs.graph_ms(lambda: M.sum(1))
                row["max_diff"] = float(diff.max())
                key = "K1" + ("-f32" if dtype == torch.float32 else "") \
                    + f" m={m}" + (" with lo (earlier: K1, M @ lo, "
                                   "subtraction)" if fused else "")
                report(out, key, row)
    # the fixed cost of a launch: K1 on one element, and a kernel that
    # does nothing (PyTorch's fill of one element)
    M, v, rhs, lo = cs.k1_operands(1, 1, torch.float64, 1, dev)
    row = turns({"earlier": lambda: opcg.dd_matvec_residual(M, v, rhs),
                 "this": lambda: pcg.dd_matvec_residual(M, v, rhs)},
                reps=1000)
    one = torch.empty(1, device=dev)
    row["fill_graph_ms"] = cs.graph_ms(lambda: one.fill_(1.0))
    report(out, "K1 m=1", row)
    M, v, rhs, lo = cs.k1_operands(666, 666, torch.float64, 1, dev)
    report(out, "K1 m=666 host us a call, by part",
           wrapper_parts(old, M, v, rhs, lo))
    pairs = cs.k11_operands(dev)
    for label, (Ah, Al) in pairs.items():
        rows, n = Ah.shape
        A64 = Ah.double() + Al.double()
        reps = 50 if rows * n > 10**7 else 1000
        for k, fn in enumerate(("df_matvec", "df_vecmat")):
            xh, xl = cs.df_vectors(n if fn == "df_matvec" else rows, k, dev)
            x64 = xh.double() + xl.double()
            if fn == "df_matvec":
                calls = {"earlier": lambda: odf.df_matvec(Ah, Al, xh, xl),
                         "this": lambda: df.df_matvec(Ah, Al, xh, xl)}
                lib = lambda: torch.mv(A64, x64)
                S = A64.abs() @ x64.abs()
                nslab, vps = df.matvec_plan(rows, n)
                chains = -(-n // 32) + 5 + 4 * -(-vps // 32) + 6 + nslab
            else:
                calls = {"earlier": lambda: odf.df_vecmat(xh, xl, Ah, Al),
                         "this": lambda: df.df_vecmat(xh, xl, Ah, Al)}
                lib = lambda: torch.mv(A64.T, x64)
                S = x64.abs() @ A64.abs()
                nslab, rps = df.vecmat_plan(rows, n)
                chains = rows + rps + nslab - 1
            # each build within (3 L + 30) 2^-48 S of the exact product,
            # L its chain (df_gemv.cu's header; a warp a row and a thread
            # a column, the earlier design: ceil(n / 32) + 5 for
            # df_matvec, the rows for df_vecmat)
            c = 3 * chains + 60
            got = {who: df.df_to64(*f()) for who, f in calls.items()}
            diff = (got["this"] - got["earlier"]).abs()
            if not bool(torch.all(diff <= c * 2.0**-48 * S)):
                cs.fail(f"K11 {fn} {label}: the builds differ beyond "
                        f"their bounds")
            row = turns(calls, reps=reps)
            row["torch.mv_ms"] = cs.cuda_ms(lib, reps)
            row["torch.mv_graph_ms"] = cs.graph_ms(lib)
            row["max_diff"], row["shape"] = float(diff.max()), [rows, n]
            report(out, f"K11 {fn} {label}", row)
        del A64
    return out


# ------------------------------------------------------------------ schur


def schur_case(old, dev, args) -> dict:
    """K2 at the dense path's COO buckets (f64 and f32) and the sparse
    engine's pair values on the SDP plans (the earlier build: whole
    groups, then the gather and the product), K4 at the dd64 path's
    shapes, and form_dd and dd_chol at control07 and arch0 with their K4
    launches: each pair of builds bit for bit equal."""
    import chip_smoke as cs
    from sedumi_tpu_torch import ddengine, kernels, schur
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import sparse_engine as se

    osc, odd, oeng = (old_module(n) for n in ("schur", "ddlinalg",
                                               "ddengine"))
    okern = old.kernels
    gen = torch.Generator().manual_seed(20261018)
    out = {}

    def same(got):
        a, b = got["this"], got["earlier"]
        a = a if isinstance(a, (tuple, list)) else (a,)
        b = b if isinstance(b, (tuple, list)) else (b,)
        return all(cs.bit_diff(x, y)[0] for x, y in zip(a, b))

    for dtype in (torch.float64, torch.float32):
        for label, aop, bi in cs.k2_buckets(dev, dtype):
            part, (rep, k, d, G, pad2, T) = aop.s_parts[bi], aop.s_meta[bi]
            mp1 = aop.m + 1
            r = (torch.randn(k, d, d, generator=gen, dtype=torch.float64)
                 / d ** 0.5 + torch.eye(d, dtype=torch.float64)).to(dtype) \
                .to(dev)
            W = schur.psd_gram(r)
            calls = {"earlier": lambda: osc._psd_contrib_coo_kernel(
                         part, k, d, G, pad2, mp1, W),
                     "this": lambda: schur._psd_contrib_coo_kernel(
                         part, k, d, G, pad2, mp1, W)}
            if not same({w: c() for w, c in calls.items()}):
                cs.fail(f"the builds' K2 differ on {label} {dtype}")
            report(out, f"K2 {label} bucket {bi} {dtype}", turns(calls))
    plans = {name: plan_of(make, pars) for name, make, pars, _ in
             cs.SPARSE_SOLVES if name in cs.K2_PAIR_PLANS}
    rng = np.random.default_rng(20261018)
    for label, (arrays, meta) in plans.items():
        bi = max(range(len(meta["s_G"])), key=lambda i: meta["s_G"][i])
        k, d = meta["s_shapes"][bi]
        for dtype in (torch.float64, torch.float32):
            a = se.make_sparse_lq_op(arrays, meta, dtype=dtype,
                                     device=dev).arrays
            W = schur.psd_gram(cs.interior_scaling(meta, dev, rng)
                               .s_r[bi]).to(dtype)
            g_args = [a[key][bi] for key in ("sg_blk", "sg_p", "sg_q",
                                             "sg_v")]
            p_args = [a[key][bi] for key in ("sp_g", "sp_loc", "sp_val")]
            G = meta["s_G"][bi]

            def earlier():
                Bg = osc.psd_outer(W, *g_args, torch.arange(G, device=dev),
                                   G)
                return Bg.reshape(G, d * d)[p_args[0], p_args[1]] \
                    * p_args[2]

            calls = {"earlier": earlier,
                     "this": lambda: schur.psd_pair_values(W, *g_args,
                                                           *p_args)}
            if not same({w: c() for w, c in calls.items()}):
                cs.fail(f"the builds' PSD pair values differ on {label}")
            report(out, f"K2 pairs {label} {dtype}", turns(calls))
    for label, R, C, ld, axis in cs.K4_SHAPES:
        X = cs.wide_matrix((R * ld,), gen).to(dev).as_strided(
            (R, C), (ld, 1) if axis == -1 else (1, ld))
        kk = C if axis == -1 else R
        calls = {"earlier": lambda: odd.ozaki_split(X, kk, axis),
                 "this": lambda: dd.ozaki_split(X, kk, axis)}
        if not same({w: c() for w, c in calls.items()}):
            cs.fail(f"the builds' K4 differ on {label}")
        report(out, f"K4 {label} {R}x{C}", turns(calls))
        del X
    for label in ("control07", "arch0"):
        aop, S = cs.dense_case(label, dev)
        m = aop.m
        runs = {}
        for who, eng, ddl, kern in (("earlier", oeng, odd, okern),
                                    ("this", ddengine, dd, kernels)):
            n0 = kern.LAUNCHES["ozaki_split"]
            Mh, Ml = eng.form_dd(aop, S, 0.0)
            n1 = kern.LAUNCHES["ozaki_split"]
            f = ddl.dd_chol(Mh[:m, :m], Ml[:m, :m])
            torch.cuda.synchronize()
            runs[who] = dict(out=(Mh, Ml, f.Lh, f.Ll, f.inv_h, f.inv_l),
                             form_dd_k4=n1 - n0,
                             dd_chol_k4=kern.LAUNCHES["ozaki_split"] - n1)
        if not same({w: r["out"] for w, r in runs.items()}):
            cs.fail(f"the builds' form_dd or dd_chol differ on {label}")
        Mh, Ml = runs["this"]["out"][:2]
        calls = {"earlier": lambda: oeng.form_dd(aop, S, 0.0),
                 "this": lambda: ddengine.form_dd(aop, S, 0.0)}
        row = turns(calls, graph=False, reps=3)
        row["k4_launches"] = {w: r["form_dd_k4"] for w, r in runs.items()}
        report(out, f"form_dd {label}", row)
        calls = {"earlier": lambda: odd.dd_chol(Mh[:m, :m], Ml[:m, :m]),
                 "this": lambda: dd.dd_chol(Mh[:m, :m], Ml[:m, :m])}
        row = turns(calls, graph=False, reps=3)
        row["k4_launches"] = {w: r["dd_chol_k4"] for w, r in runs.items()}
        report(out, f"dd_chol {label}", row)
        del runs, aop, S
        torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------------- ldl

# K3's orders: lp900+3dense's capacitance, nb+zero-row's ADA, arch0's
# Schur order and control07's (the device variant)
LDL_ORDERS = (3, 124, 174, 666)
# this build's other plans, timed beside ldl_plan's choice
LDL_SWEEP = {124: [("shared", 1, w) for w in (4, 6, 8, 12, 16)],
             174: [("shared", 1, w) for w in (4, 6, 8, 12, 16)],
             666: [("device", b, w) for b in (16, 32, 67, 132)
                   for w in (1, 2, 4, 8)]}


def k3_same(f, g) -> bool:
    """Two LdlFactors bit for bit equal (L, d, skip, diagadd)."""
    import chip_smoke as cs

    return torch.equal(f.skip, g.skip) and all(
        cs.bit_diff(a, b)[0] for a, b in ((f.L, g.L), (f.d, g.d),
                                          (f.diagadd, g.diagadd)))


def ldl_case(old, dev, args) -> dict:
    """K3 and K3-f32 of both builds at LDL_ORDERS on
    chip_smoke.indefinite_matrix (m = 3: B B' + I, the capacitance's
    kind), the builds bit for bit equal (L, d, skip, diagadd): events and
    graph replay in turns, the m = 3 eager call on the host clock
    (host_us), and this build's plan at each order beside the other plans
    of LDL_SWEEP (graph replay, bit for bit the chosen plan)."""
    import chip_smoke as cs
    from sedumi_tpu_torch import chol

    ochol = old_module("chol")
    gen = torch.Generator().manual_seed(20261018)
    out = {}
    for dtype in (torch.float64, torch.float32):
        for m in LDL_ORDERS:
            if m > 3:
                M = cs.indefinite_matrix(m, gen)
            else:
                B = torch.randn(m, m, generator=gen, dtype=torch.float64)
                M = B @ B.T + torch.eye(m, dtype=torch.float64)
            M = M.to(dtype).to(dev)
            calls = {"earlier": lambda: ochol.ldl_masked(M),
                     "this": lambda: chol.ldl_masked(M)}
            got = {w: c() for w, c in calls.items()}
            if not k3_same(got["this"], got["earlier"]):
                cs.fail(f"the builds' K3 differ at m={m} {dtype}")
            plan = chol.ldl_plan(m, dtype)
            row = turns(calls)
            row["plan"] = plan
            row["skipped"] = int(got["this"].skip.sum())
            if m == 3:
                row["host_us"] = {w: host_us(c, 2000)
                                  for w, c in calls.items()}
            graph = row["graph_ms"]["this"]
            row["us_per_column"] = None if graph is None \
                else 1e3 * graph / m
            sweep = {}
            for p in LDL_SWEEP.get(m, []):
                def call(p=p):
                    return chol._ldl_cuda(M, 1e-12, 5e5, 1e-20, True, p)
                if not k3_same(call(), got["this"]):
                    cs.fail(f"K3 plan {p} differs at m={m} {dtype}")
                sweep[":".join(map(str, p))] = cs.try_graph_ms(str(p), call)
            if sweep:
                row["sweep_graph_ms"] = sweep
            report(out, f"K3 {dtype} m={m}", row)
    return out


# ----------------------------------------------------------------- solves


def solve(pkg, name: str, pars: dict, xy: bool = False) -> dict:
    from sedumi_tpu_torch.examples import load_example

    ex = load_example(name)
    torch.cuda.synchronize()
    t0 = time.time()
    x, y, info = pkg.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0, **pars},
                            device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    cx = float(np.real(np.vdot(ex.c, x)))
    by = float(np.real(np.vdot(ex.b, y)))
    out = dict(wall_s=wall, iter=info["iter"], numerr=info["numerr"],
               rel=max(abs(cx - ex.optval), abs(by - ex.optval))
               / abs(ex.optval), phases=info["phases"])
    if xy:
        out.update(x=x, y=y)
    return out


def twin_problems() -> list:
    """(label, (A, b, c, K), pars, the K3 build it must launch or None):
    arch0 and control07 ('auto': f64, then dd64), and the solves that take
    K3: nb with a redundant zero row (its singular ADA) and the LP with
    three dense columns (its Woodbury capacitance), 'auto' (K3) and
    'mixed' (K3-f32)."""
    import chip_smoke as cs
    from sedumi_tpu_torch.examples import load_example

    out = []
    for name in ("arch0", "control07"):
        ex = load_example(name)
        out.append((name, (ex.At, ex.b, ex.c, ex.K), {"fid": 0}, None))
    nbz = cs.with_zero_row(load_example("nb"))
    make, lp_pars = next((mk, p) for n, mk, p, _ in cs.SPARSE_SOLVES
                         if n == "lp900+3dense")
    lp = make(np.random.default_rng(12345))
    for tag, pars, k3 in (("auto", {}, "ldl_masked"),
                          ("mixed", {"dtype": "mixed"}, "ldl_masked_f32")):
        out.append((f"nb+zero-row {tag}", (nbz.At, nbz.b, nbz.c, nbz.K),
                    {"fid": 0, **pars}, k3))
        out.append((f"lp900+3dense {tag}", lp, {**lp_pars, **pars}, k3))
    return out


def twins_case(old, dev, args) -> dict:
    """twin_problems by each build with deterministic algorithms (index_add_
    in order, as chip_smoke.check_dd64_twins): x and y must agree bit for
    bit, and with them the phases' iterations; the K3 solves must launch
    their K3 build in both."""
    import warnings

    import sedumi_tpu_torch as st

    import chip_smoke as cs

    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for label, prob, pars, k3 in twin_problems():
                runs = {}
                for who, pkg in (("earlier", old), ("this", st)):
                    before = dict(pkg.kernels.LAUNCHES)
                    torch.cuda.synchronize()
                    t0 = time.time()
                    x, y, info = pkg.sedumi(*prob, pars, device="cuda")
                    torch.cuda.synchronize()
                    runs[who] = dict(
                        x=x, y=y, wall_s=time.time() - t0,
                        iter=info["iter"], numerr=info["numerr"],
                        phases=info["phases"],
                        k3_launches={k: pkg.kernels.LAUNCHES[k] - before[k]
                                     for k in ("ldl_masked",
                                               "ldl_masked_f32")})
                e, t = runs["earlier"], runs["this"]
                if not (np.array_equal(e["x"], t["x"])
                        and np.array_equal(e["y"], t["y"])):
                    cs.fail(f"{label} deterministic: the builds land apart")
                if k3 and not (e["k3_launches"][k3] and
                               t["k3_launches"][k3]):
                    cs.fail(f"{label}: {k3} did not launch in both builds")
                report(out, f"{label} deterministic", {
                    who: {k: v for k, v in r.items() if k not in ("x", "y")}
                    for who, r in runs.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def solves_case(old, dev, args) -> dict:
    import sedumi_tpu_torch as st

    pkgs = {"earlier": old, "this": st}
    for who in pkgs:                       # warm-up: first-call costs
        solve(pkgs[who], "arch0", {})
    out = {}
    for name in args.problems.split(","):
        for pars in ({}, {"dtype": "mixed"}):
            runs = {"earlier": [], "this": []}
            for who in WHO * args.repeat:
                runs[who].append(solve(pkgs[who], name, pars))
            key = f"{name} {json.dumps(pars) if pars else 'auto'}"
            report(out, key, runs)
            landed = {who: {} for who in runs}
            for who, rs in runs.items():
                for r in rs:
                    at = json.dumps({p: v["iters"]
                                     for p, v in r["phases"].items()}) \
                        + f" rel {r['rel']:.4g}"
                    landed[who][at] = landed[who].get(at, 0) + 1
            report(out, f"{key} landings", landed)
    return out


# ------------------------------------------------------------------- mesh


def _count_collectives() -> dict:
    """Wraps torch.distributed's collectives in this process so that each
    call adds to the returned counts: calls, and the bytes this rank
    receives in it under parallel.mesh.COMM's model (a ring all-reduce or
    all-gather, a direct broadcast, scatter or all-to-all).  Either
    build's mesh goes through them, so both are counted alike: builds
    before row panels keep no byte count of their own (this one's,
    mesh.COMM's, is reported beside it as comm_bytes and should agree)."""
    import torch.distributed as dist

    stats = {"calls": 0, "bytes": 0}

    def n_of(group):
        return dist.get_world_size(group)

    def me(group):
        return dist.get_rank(group)

    def gsrc(src, group):
        return src if group is None else dist.get_group_rank(group, src)

    rules = {
        "all_reduce": lambda t, *a, group=None, **k:
            2 * t.nbytes * (n_of(group) - 1) / n_of(group),
        "broadcast": lambda t, src=0, group=None, **k:
            0 if me(group) == gsrc(src, group) else t.nbytes,
        "scatter": lambda t, lst=None, src=0, group=None, **k:
            0 if me(group) == gsrc(src, group) else t.nbytes,
        "all_gather_into_tensor": lambda out, t, group=None, **k:
            t.nbytes * (n_of(group) - 1),
        "all_to_all_single": lambda out, t, outs=None, ins=None,
            group=None, **k: out.nbytes - (
                outs[me(group)] * out[0].nbytes if outs
                else out.nbytes // n_of(group)),
    }
    for name, rule in rules.items():
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def counted(*a, _fn=fn, _rule=rule, **k):
            stats["calls"] += 1
            stats["bytes"] += int(_rule(*a, **k))
            return _fn(*a, **k)

        setattr(dist, name, counted)
    return stats


def mesh_rank(rank: int, calls: list, device="cuda") -> list:
    """A rank's mesh solves for the mesh case: each call (problem, pars,
    deterministic) by the build on sys.path (entry.rank_sedumi), with the
    collectives counted (_count_collectives) and the peak of allocated
    device memory over the solve; deterministic runs under
    torch.use_deterministic_algorithms, so both builds' x and y can be
    compared bit for bit."""
    import hashlib

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    stats = _count_collectives()
    from sedumi_tpu_torch.parallel import entry

    out = []
    for problem, pars, det in calls:
        torch.use_deterministic_algorithms(det, warn_only=True)
        stats.update(calls=0, bytes=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = entry.rank_sedumi(rank, tuple(problem), pars, device=device)
        torch.cuda.synchronize()
        xy = hashlib.sha1(np.ascontiguousarray(r.pop("x")).tobytes()
                          + np.ascontiguousarray(r.pop("y")).tobytes())
        r.pop("launches")
        r.update(deterministic=det, xy_sha1=xy.hexdigest(),
                 wire_calls=stats["calls"], wire_bytes=stats["bytes"],
                 peak_bytes=torch.cuda.max_memory_allocated())
        out.append(r)
    torch.use_deterministic_algorithms(False)
    return out


def mesh_solves(solves: list, dets: list) -> list:
    """Each (example, mesh shape, ranks, [pars]) of `solves` by the build
    first on sys.path, as it runs (det False) and deterministically (det
    True), for each det of `dets`, in one spawn per problem: every rank's
    mesh_rank results."""
    from sedumi_tpu_torch.parallel.launch import run_spmd

    out = []
    for name, shape, nprocs, pars_list in solves:
        calls = [(("example", name), {"fid": 0, "mesh_shape": shape, **p},
                  det) for det in dets for p in pars_list]
        out.append(run_spmd(mesh_rank, nprocs, args=(calls, "cuda"),
                            device="cuda", timeout_s=1500))
    return out


# run in a process whose sys.path holds a copy of this file and one
# build's root, so the ranks import that build's sedumi_tpu_torch (the
# parent's root holds a parent_bench.py of its own)
_MESH_CHILD = """
import json, sys
copy, root, solves = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path[:0] = [copy, root]
import parent_bench
print("MESH " + json.dumps(parent_bench.mesh_solves(
    solves, json.loads(sys.argv[4])), default=str))
"""


def mesh_case(old, dev, args) -> dict:
    """chip_smoke.MESH_SOLVES by each build, each in a process of its own
    whose sedumi_tpu_torch is that build's: per solve and rank the wall,
    iterations, collectives (the build's own count and
    _count_collectives'), the bytes received in them, the share of the
    wall in them and the peak of allocated device memory; then the same
    solves under deterministic algorithms, whose x and y must agree bit
    for bit between the builds (or the landing moved: reported).  With
    --repeat N the solves as they run come N times, the builds in turns
    (earlier first in even rounds, this first in odd ones), each round's
    walls and collective shares listed; the deterministic solves come in
    the first round only."""
    import chip_smoke as cs

    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    copy = os.path.join(here, "sedumi_tpu_torch", "_build", "mesh_case")
    os.makedirs(copy, exist_ok=True)
    shutil.copy(os.path.abspath(__file__), copy)
    solves = [(n, shape, k, list(pl)) for n, shape, k, _, pl
              in cs.MESH_SOLVES]
    roots = {"earlier": os.path.abspath(args.parent), "this": here}
    got = {"earlier": [], "this": []}
    for rnd in range(max(args.repeat, 1)):
        dets = [False, True] if rnd == 0 else [False]
        order = ("earlier", "this") if rnd % 2 == 0 else ("this", "earlier")
        for who in order:
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-c", _MESH_CHILD, copy, roots[who],
                 json.dumps(solves), json.dumps(dets)],
                capture_output=True, text=True, timeout=3000)
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("MESH ")]
            if proc.returncode or not line:
                cs.fail(f"mesh case, {who} build, round {rnd}: exit "
                        f"{proc.returncode}\n{proc.stderr[-4000:]}")
            got[who].append(json.loads(line[-1][5:]))
            print(f"mesh case, {who} build, round {rnd}: "
                  f"{time.time() - t0:.1f}s", flush=True)
    out = {}
    keep = ("iter", "numerr")
    for i, (name, shape, nprocs, pars_list) in enumerate(solves):
        for det in (False, True):
            for p, pars in enumerate(pars_list):
                k = (1 if det else 0) * len(pars_list) + p
                label = f"mesh {name} {json.dumps(shape)}" \
                    + (f" {json.dumps(pars)}" if pars else "") \
                    + (" deterministic" if det else "")
                row = {}
                for who in got:
                    ranks = [r[k] for r in got[who][0][i]]
                    row[who] = {
                        "info": {f: ranks[0]["info"][f] for f in keep},
                        "phases": ranks[0]["phases"], "cx": ranks[0]["cx"],
                        "wall_s": [r["wall"] for r in ranks],
                        "comm_calls": [r["comm_calls"] for r in ranks],
                        "wire_calls": [r["wire_calls"] for r in ranks],
                        "wire_bytes": [r["wire_bytes"] for r in ranks],
                        "comm_bytes": [r.get("comm_bytes") for r in ranks],
                        "comm_share": [r["comm_s"] / r["wall"]
                                       for r in ranks],
                        "peak_bytes": [r["peak_bytes"] for r in ranks],
                        "same_x_on_every_rank": len({r["xy_sha1"]
                                                     for r in ranks}) == 1,
                        "xy_sha1": ranks[0]["xy_sha1"]}
                    if not det:
                        rounds = [[r[k] for r in g[i]] for g in got[who]]
                        row[who]["rounds"] = [
                            {"wall_s": [r["wall"] for r in rr],
                             "iter": rr[0]["info"]["iter"],
                             "comm_share": [r["comm_s"] / r["wall"]
                                            for r in rr]}
                            for rr in rounds]
                if det:
                    row["same_bits_as_earlier"] = \
                        row["this"]["xy_sha1"] == row["earlier"]["xy_sha1"]
                report(out, label, row)
    return out


CASES = {"tiles": tiles_case, "panels": panels_case, "dd": dd_case,
         "k13": k13_case, "gemv": gemv_case, "schur": schur_case,
         "ldl": ldl_case, "twins": twins_case, "solves": solves_case,
         "mesh": mesh_case}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--plans", default="lp20k,sdp5k,sdp1200")
    ap.add_argument("--problems", default="arch0,control07")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    cases = args.cases.split(",")
    if not set(cases) <= set(CASES):
        ap.error(f"--cases: choose from {', '.join(CASES)}")
    if not torch.cuda.is_available():
        print("no CUDA device: parent_bench.py needs one card",
              file=sys.stderr)
        sys.exit(1)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "tests"))   # the emulations
    from sedumi_tpu_torch import kernels

    old = load_package(os.path.abspath(args.parent), "sedumi_tpu_torch_old")
    t0 = time.time()
    kernels.build_all()
    old.kernels.build_all()
    print(f"built both builds' kernels in {time.time() - t0:.1f}s",
          flush=True)
    dev = torch.device("cuda")
    out = {}
    for case in cases:
        out.update(CASES[case](old, dev, args))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"parent_bench": out, "card": smi}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
