"""Smoke test of sedumi_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Kernel phase: builds every CUDA kernel of the port from csrc/ (one nvcc
   per source, in parallel) and holds K1-K7, the fused dd triangular
   solve ("K6 solve"), the f32 builds of K1-K3, K11 (the double-float
   GEMV and GEMV-transpose) and the batched Jacobi eigensolvers K12 (f64,
   f32) and K13 (complex128, complex64) against their plain-PyTorch twins
   on the card at the shapes the solver gives them, with the tolerance
   stated (K1, K2, K6, K11 and the f32 K1, K2 within error bounds, K6
   also bit for bit the emulation of its lane order, tests/
   dd_emulation.py, and K1, K1-f32 and K11 bit for bit the emulation of
   theirs, tests/gemv_emulation.py, with rows off 16-byte boundaries,
   twice with the same bits; K3, K4, K5, K7, the f32 K3 and K12 bit for
   bit, K12 also in its sweep count, in each of its variants: one block, a
   cluster of 2-16 CTAs, device memory; K13 within 4 n eps ||A|| in the
   same eigenvalue slots, with its residual and orthogonality against
   the plain version's, and bit for bit its device-memory variant in w,
   V and sweeps, in each variant; the K6 solve bit for bit the
   composition of K6 and K5 launches and its emulation, and within
   1e-18 of max|z| of the plain twins' solve; K7 at cond 1e14, with a
   non-positive and with a NaN pivot and at nr == w, timed on the first
   and the last panel of m = 666 with its chain of column steps), and the
   Schur-panel kernels of the mesh path, K14 (a block column of the
   distributed Cholesky) and K15 (the distributed substitution's three
   steps), at OH's and nb's panel shapes within 1e-12 of max|L| and of
   max|x|, with a non-PD block giving NaN, and bit for bit equal to the
   emulation of their order (tests/panel_emulation.py), and so their f32
   builds K14-f32 and K15-f32 (the f32 phase under a mesh; a matrix of
   cond 1e3, within PANEL_TOL_F32 of their f32 plain versions, bit for bit
   the emulation run in float32); times each, K14
   over the columns of one factor, back to back and (K1, K1-f32, K6,
   the K6 solve, K11, K14, K15) as the replay of a captured CUDA graph,
   beside one library call for the same work (two for K15's forward
   step), and the card's least time (bound) for the work; K1 and K1-f32
   also at the path's orders 174, 666 and 948, alone, fused with the
   refinement's lo term and as the three-call line it replaces, and K11
   on socp-dense's and nb's operators and at [1001, 65536].  K2 and
   K2-f32 are timed at arch0's, trto3's and OH's COO buckets (with K2's
   least work, the needed entries, and the earlier design's whole blocks
   as bounds), K3 and K3-f32 at the path's orders 3, 124, 174 and 666
   (K3_ORDERS: its warp, shared and device variants, us a column),
   K4 at the dd64 path's shapes (K4_SHAPES), with its launches per call
   site over one control07 dd64 prepare (at most 17).  K8-K10 and their
   f32 builds follow the sparse paths (4., 5.), on their plans.
2. Dense path: sedumi_tpu_torch.sedumi() on all six bundled examples at
   full size (quantum, nb, arch0, control07, trto3, OH), plus nb with one
   redundant all-zero constraint (its Schur complement is singular, so
   every iteration takes the masked-LDL' fallback).  arch0 and control07
   must enter the dd64 phase, launch K4-K7 and the K6 solve in their
   solves and land where the K6/K5 composition landed them
   (DD64_LANDINGS, up to the f64 phase's run noise); with deterministic
   algorithms each lands bit for bit where it lands with the composition
   in place of the fused solve (check_dd64_twins).  quantum, nb, arch0 and the
   redundant-row nb must pass the reference gate (rel <= 1e-6 vs the
   published optimum, pinf = dinf = 0, numerr < 2); the others must finish
   with finite outputs, and each prints its rel, pinf, dinf, numerr and
   phases.  No Jacobi build may launch on it: the f64 phases take the
   library eigensolver, as the reference's host phases do.
3. Mixed-ladder path: pars.dtype='mixed' (f32 -> hybrid -> host64 ->
   dd64) on quantum, nb, arch0, control07, nb+zero-row, trto3, a dense
   SOCP from the reference's feasible_problem generator (the port's
   copy, sedumi_tpu_torch.generators),
   whose hybrid phase takes the double-float operator, and the
   reference's e2e ladder instance: K1-f32 must launch in every bundled
   example, K2-f32 on arch0, K3-f32 on nb+zero-row, K11 on the SOCP, and
   the f32 Jacobi K12-f32 on quantum, arch0, control07, trto3 and the
   e2e instance; no f64 or complex Jacobi build may launch.  The solves
   the reference package itself passes with 'mixed' on a CPU (quantum,
   nb, arch0, nb+zero-row: the reference gate; the SOCP and the e2e
   instance: its own test's gate against the f64 solve) are gated;
   control07 (rel 1.288e-6, numerr 1 in the reference) must land where
   it lands on the card (MIXED_LANDINGS: numerr 0, no hybrid phase) and
   trto3 must finish finite.
4. Sparse path: five problems through the sparse tile engine
   (SPARSE_SOLVES: an LP with m = 20000, SDPs with m = 5000 and m = 1200,
   an SOCP with m = 850, an LP with three dense columns).  Each must take
   the sparse engine, finish with finite outputs and launch K8-K10; the
   SDPs must launch K2 and the dense-column LP K3.  All but the SDP with
   m = 5000 are gated as the reference's tests gate them (pinf = dinf = 0,
   max(err) < 1e-7).  Each
   prints its host plan time, iterations, phases, wall time and launches.
5. Mixed sparse path: the precision ladder on the sparse engine
   (MIXED_SPARSE_SOLVES: lp20k, sdp1200, socp850 and lp900+3dense with
   pars.dtype='mixed', then socp850 with 'float32').  Each must take the
   sparse engine and the f32 phase and launch K8-f32, K9-f32 and K10-f32;
   sdp1200 must launch K2-f32 and K12-f32, lp900+3dense K3-f32.  All but
   lp20k and the 'float32' solve are gated as in 4.
   Then K2's pair entry (the sparse engine's PSD pair values, f64 and
   f32, timed) is held against its plain twin on the SDP 1200 and SDP 5k
   plans, K8-K10 on the plans the f64 solves built (LP 20k, SDP 5k,
   SDP 1200), and
   K8-f32 to K10-f32 on f32 storage of the same plans; K9 and K10 must
   repeat bit for bit, K10 take two launches a solve, and K10 is timed on
   each plan; K9's work at each plan's widest level is printed.
6. Mesh path (pars.mesh_shape, MESH_SOLVES): OH at full size with
   {"panels": 2} on two ranks and nb with {"hosts": 2, "panels": 2} on
   four, then nb on that mesh under 'mixed' (the mesh's ladder: f32,
   hybrid, host64, no dd64), all sharing this card under gloo
   (parallel.launch.run_spmd).  Every rank must return the same solution
   and launch K14 and K15, and none the dd64 kernels or K3; the 'mixed'
   solve must take the f32 phase and launch K14-f32 and K15-f32 on every
   rank; OH must land within 1e-6 (1 + |c'x|) of path 2's unsharded c'x
   with pinf = dinf = 0, numerr < 2, nb must pass the reference gate.
   Each prints its wall, iterations, phases, launches per rank and the
   collectives' share of the wall.
7. pars.profile, pars.debug and the CLI: info["profile"] of arch0 (dense,
   f64), arch0 'mixed' (the f32 bundle, its scaling on K12-f32) and
   sdp1200 (sparse), each printed on a line of its own, every key of the
   reference's set positive and finite; nb solved with and without
   pars.debug=1 under deterministic algorithms, bit for bit the same;
   then `python -m sedumi_tpu_torch` in subprocesses on examples/arch0.mat
   and on arch0 written to sparse SDPA by the port's write_sdpa, both
   exiting 0 at the reference gate and at the same c'x.
   Launch counts are zeroed just before each path (in every rank for the
   mesh path) and read just after; every kernel must have launched on the
   paths, but for the builds no card solve reaches (OFF_PATH: the f64 and
   complex Jacobi), which the kernel phase holds alone.
8. Prints the library rows (B5, B11, B9's dd_gemm, B7/B8: times and
   bounds of the routines left to the library) as one JSON line,
   {"kernels": [...]}, the card's name and power limit, and as the last
   line {"ok": true, "device": {...}}.  Any failure exits non-zero before
   the last line.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from sedumi_tpu_torch.generators import feasible_problem

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the f64
# tensor-core rate (the highest f64 rate the card has) and the f32 rate
# outside the tensor cores, which the f32 kernels use
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 67e12
PEAK_F32_PER_S = 67e12


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_F64_PER_S):
    t_b = nbytes / PEAK_BYTES_PER_S
    t_f = flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------


def check_dd_residual(dev, gen):
    """K1 at control07's Schur order m = 666, cond ~ 1e14, v = M^{-1} rhs
    so the residual is pure cancellation."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.pcg import dd_matvec_residual, \
        dd_matvec_residual_plain

    m = 666
    q, _ = torch.linalg.qr(torch.randn(m, m, generator=gen, dtype=torch.float64,
                                       device="cpu"))
    ev = torch.logspace(0, -14, m, dtype=torch.float64)
    M = ((q * ev) @ q.T).to(dev)
    M = 0.5 * (M + M.T)
    rhs = torch.randn(m, generator=gen, dtype=torch.float64).to(dev)
    v = torch.linalg.solve(M, rhs)
    n0 = kernels.LAUNCHES["dd_matvec_residual"]
    r_k = dd_matvec_residual(M, v, rhs)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["dd_matvec_residual"] != n0 + 1:
        fail("dd_matvec_residual did not launch its kernel")
    r_p = dd_matvec_residual_plain(M, v, rhs)
    eps = float(np.finfo(np.float64).eps)
    tol = 2 * eps * torch.abs(r_p) + 1e-28 * (torch.abs(M) @ torch.abs(v))
    err = torch.abs(r_k - r_p)
    print(f"K1 dd_matvec_residual m={m}: max|r|={float(r_p.abs().max()):.3e} "
          f"max err={float(err.max()):.3e} worst err/tol="
          f"{float((err / tol).max()):.3e}", flush=True)
    if not bool(torch.all(err <= tol)):
        fail("dd_matvec_residual kernel disagrees with its plain version")
    ms = cuda_ms(lambda: dd_matvec_residual(M, v, rhs), 1000)
    plain = cuda_ms(lambda: dd_matvec_residual_plain(M, v, rhs), 20)
    lib = cuda_ms(lambda: torch.addmv(rhs, M, v, alpha=-1.0), 1000)
    nbytes = 8.0 * (m * m + 3 * m)
    # per element: product + fma error term + TwoSum (6) + 2 adds
    b_ms, b_by = bound_ms(nbytes, 11.0 * m * m)
    check_k1_order(torch.float64, dev)
    return dict(name="dd_matvec_residual", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_residual.cu",
                replaces="sedumi_tpu/pcg.py:56",
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                graph_ms=graph_ms(lambda: dd_matvec_residual(M, v, rhs)),
                library_graph_ms=graph_ms(
                    lambda: torch.addmv(rhs, M, v, alpha=-1.0)),
                library="torch.addmv",
                shapes=k1_shape_times(torch.float64, dev))


# K1's orders on the path: arch0's, control07's and OH's Schur complements
K1_ORDERS = (174, 666, 948)


def same_words(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (f64 or f32)."""
    ints = torch.int64 if a.element_size() == 8 else torch.int32
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(
        a.contiguous().view(ints), b.contiguous().view(ints)))


def k1_operands(m: int, n: int, dtype, seed: int, dev, view=None):
    """(M, v, rhs, lo) from numpy's generator: M [m, n] of cond ~1e14
    (f64; ~1e6 in f32) on its square part, v = M^+ rhs (a residual of
    pure cancellation), lo a refinement correction ~u |v|.  view: None (a
    tensor of its own), "offset" (one element into a buffer, so rows start
    off 16-byte boundaries), "stride" (columns 1..n of an [m, n + 5]
    matrix)."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    A = rng.standard_normal((m, n)) * 1e-3
    A[:k, :k] = (q * np.logspace(0, -14 if dtype == torch.float64 else -6,
                                 k)) @ q.T
    rhs = rng.standard_normal(m)
    v = np.linalg.solve(A, rhs) if m == n else \
        np.linalg.lstsq(A, rhs, rcond=None)[0]
    lo = v * float(torch.finfo(dtype).eps) * rng.standard_normal(n)
    if view == "offset":
        M = torch.empty(m * n + 1, dtype=dtype, device=dev)[1:].view(m, n)
    elif view == "stride":
        M = torch.empty(m, n + 5, dtype=dtype, device=dev)[:, 1:n + 1]
    else:
        M = torch.empty(m, n, dtype=dtype, device=dev)
    M.copy_(torch.as_tensor(A, dtype=dtype))
    return (M,) + tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                        for a in (v, rhs, lo))


def k1_emulated(M, v, rhs, lo=None) -> torch.Tensor:
    """K1's result by its numpy emulation (tests/gemv_emulation.py) at
    the wrapper's parts and M's storage offset and row stride."""
    import gemv_emulation as gemu
    from sedumi_tpu_torch.pcg import residual_parts

    r = gemu.residual(M.cpu().numpy(), v.cpu().numpy(), rhs.cpu().numpy(),
                      None if lo is None else lo.cpu().numpy(),
                      residual_parts(M.shape[1], M.element_size()),
                      gemu.phase_of(M), M.stride(0))
    return torch.as_tensor(r, device=M.device)


def check_k1_order(dtype, dev) -> None:
    """K1 (or K1-f32) bit for bit its emulation at the path's orders and
    at a row stride and storage offset that put rows off 16-byte
    boundaries, with and without lo; a second call gives the same bits,
    and each call, fused or not, is one launch."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.pcg import dd_matvec_residual

    name = "dd_matvec_residual" + ("" if dtype == torch.float64 else "_f32")
    shapes = [(m, m, None) for m in (123,) + K1_ORDERS] \
        + [(123, 123, "offset"), (174, 123, "stride"), (7, 1, "offset")]
    for m, n, view in shapes:
        M, v, rhs, lo = k1_operands(m, n, dtype, m + n, dev, view)
        for low in (None, lo):
            n0 = kernels.LAUNCHES[name]
            got = dd_matvec_residual(M, v, rhs, low)
            again = dd_matvec_residual(M, v, rhs, low)
            torch.cuda.synchronize()
            if kernels.LAUNCHES[name] != n0 + 2:
                fail(f"{name}: a call was not one launch")
            if not (same_words(got, k1_emulated(M, v, rhs, low))
                    and same_words(got, again)):
                fail(f"{name} [{m}, {n}] {view} lo={low is not None}: not "
                     f"bit for bit its emulation, or two calls differ")
    print(f"{name}: bit for bit its emulation at {len(shapes)} shapes "
          f"(with and without lo, rows off 16-byte boundaries), two calls "
          f"the same bits, one launch a call", flush=True)


def k1_shape_times(dtype, dev) -> dict:
    """K1 at the path's orders, back-to-back CUDA events (the eager call
    the main path makes) and CUDA-graph replay: alone, fused with lo,
    and the three-call residual line it replaces (K1, M @ lo, the
    subtraction), beside torch.addmv, the plain version and the bound."""
    from sedumi_tpu_torch.pcg import dd_matvec_residual, \
        dd_matvec_residual_plain

    out = {}
    size = torch.finfo(dtype).bits // 8
    peak = PEAK_F64_PER_S if dtype == torch.float64 else PEAK_F32_PER_S
    for m in K1_ORDERS:
        M, v, rhs, lo = k1_operands(m, m, dtype, 7 * m, dev)
        calls = {"": lambda: dd_matvec_residual(M, v, rhs),
                 "lo_": lambda: dd_matvec_residual(M, v, rhs, lo),
                 "three_call_": lambda: dd_matvec_residual(M, v, rhs)
                 - M @ lo,
                 "library_": lambda: torch.addmv(rhs, M, v, alpha=-1.0)}
        row = {}
        for key, fn in calls.items():
            row[key + "ms"] = cuda_ms(fn, 1000)
            row[key + "graph_ms"] = graph_ms(fn)
        row["plain_ms"] = cuda_ms(
            lambda: dd_matvec_residual_plain(M, v, rhs), 5)
        row["bound_ms"], row["bound_by"] = bound_ms(
            size * (m * m + 3.0 * m), 11.0 * m * m, peak)
        row["lo_bound_ms"] = bound_ms(size * (m * m + 4.0 * m),
                                      13.0 * m * m, peak)[0]
        out[str(m)] = row
        print(f"K1 {dtype} m={m}: " + json.dumps(row), flush=True)
    return out


def dense_case(name, dev, seed=7, dtype=torch.float64):
    """(CooAOp, NT scaling at a random interior point) of a bundled
    example, as the dense engine builds them, in `dtype`."""
    from sedumi_tpu_torch import transform
    from sedumi_tpu_torch.examples import load_example
    from sedumi_tpu_torch.opA import build_coo_aop
    from sedumi_tpu_torch.params import Pars

    ex = load_example(name)
    prob = transform.pretransfo(ex.At, ex.b, ex.c, ex.K, Pars(fid=0))
    aop = build_coo_aop(prob.At, prob.c, prob.layout, device=dev,
                        dtype=dtype)
    meta = dict(nl=aop.Al.shape[1], q_shapes=aop.q_shapes,
                s_shapes=[(mt[1], mt[2]) for mt in aop.s_meta])
    S = interior_scaling(meta, dev, np.random.default_rng(seed))
    S = type(S)(*[v.to(dtype) if isinstance(v, torch.Tensor)
                  else tuple(x.to(dtype) for x in v) for v in S])
    return aop, S


def launch_key(fn, prefix: str):
    """(fn(), the kernels.VARIANT_LAUNCHES key, "name@shape" or
    "name:variant@shape", of the one launch it made)."""
    from sedumi_tpu_torch import kernels

    before = dict(kernels.VARIANT_LAUNCHES)
    out = fn()
    keys = [k for k, v in kernels.VARIANT_LAUNCHES.items()
            if k.startswith((prefix + "@", prefix + ":"))
            and v != before.get(k, 0)]
    if len(keys) != 1:
        fail(f"{prefix}: expected one launch, counted {keys}")
    return out, keys[0]


# K2 at the dense path's COO buckets (arch0: d 161, G 175, pad2 36;
# trto3: d 321, G 545, pad2 16; OH's two), and the sparse engine's pair
# values on the SDP plans of the sparse path
K2_BUCKETS = ("arch0", "trto3", "OH_2Pi_STO-6GN9r12g1T2")
K2_PAIR_PLANS = ("sdp1200", "sdp5k")


def k2_buckets(dev, dtype):
    """(label, CooAOp, bucket index) of every COO PSD bucket of
    K2_BUCKETS, built in `dtype`."""
    for label in K2_BUCKETS:
        aop, _ = dense_case(label, dev, dtype=dtype)
        bi = [i for i, mt in enumerate(aop.s_meta) if mt[0] == "coo"]
        if not bi:
            fail(f"{label} has no COO PSD bucket")
        for i in bi:
            yield label, aop, i


def k2_coo_work(part, meta, mp1, size) -> dict:
    """K2's least work on a COO bucket: the needed entries' fmas (2 sum_g
    pad2 |U_blk(g)|) and the gather's (2 T mp1) flops, beside the whole
    blocks' (2 G pad2 d^2 + 2 T mp1) of the earlier design; bytes: W, the
    group arrays, b_val and the index arrays once, and M."""
    rep, k, d, G, pad2, T = meta
    cpu = {key: v.cpu().numpy() for key, v in part.items()}
    ch = cpu["ch"]
    per_blk = np.zeros(k)
    for c in range(ch.shape[0] - 1):
        per_blk[cpu["it"][ch[c, 0], 0] // d] += ch[c + 1, 1] - ch[c, 1]
    flops = 2.0 * pad2 * float(per_blk[cpu["g_blk"]].sum()) \
        + 2.0 * T * mp1
    full = 2.0 * G * pad2 * d * d + 2.0 * T * mp1
    n_u = cpu["u_e"].size
    nbytes = size * (k * d * d + G * pad2 + T + mp1 * mp1) \
        + 8.0 * (2 * G * pad2 + mp1 + 1) \
        + 4.0 * (T + n_u + cpu["it"].size + cpu["ch"].size + mp1 * k)
    return dict(flops=flops, flops_full=full, nbytes=nbytes, n_u=n_u)


def check_psd_coo(dev, gen, dtype=torch.float64):
    """K2 (K2-f32 for dtype f32) at the dense path's COO buckets (the
    port's build_coo_aop, W = R R' from a random well-conditioned R): one
    launch a call, against the plain version (f64: within 1e-12 of
    max|M|; f32: each order is within gamma_N sum|terms| of the exact
    value, N = pad2 + Tmax + 3 with Tmax the longest row of the gather,
    so within 2 N u M_abs, M_abs the same function of |W|, |gv| and
    |b_val| in f64); times each bucket (events, graph replay) beside the
    plain version and the bound (K2's least work and the earlier design's
    whole blocks)."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.schur import _psd_contrib_coo_kernel, \
        _psd_contrib_coo_plain, psd_gram

    f32 = dtype == torch.float32
    name = "psd_contrib_coo_f32" if f32 else "psd_contrib_coo"
    size = 4.0 if f32 else 8.0
    peak = PEAK_F32_PER_S if f32 else PEAK_F64_PER_S
    shapes, worst = {}, 0.0
    for label, aop, i in k2_buckets(dev, dtype):
        part, meta = aop.s_parts[i], aop.s_meta[i]
        rep, k, d, G, pad2, T = meta
        mp1 = aop.m + 1
        r = (torch.randn(k, d, d, generator=gen, dtype=torch.float64)
             / d ** 0.5 + torch.eye(d, dtype=torch.float64)).to(dtype) \
            .to(dev)
        W = psd_gram(r)

        def call():
            return _psd_contrib_coo_kernel(part, k, d, G, pad2, mp1, W)

        n0 = kernels.LAUNCHES[name]
        M_k, key = launch_key(call, name)
        torch.cuda.synchronize()
        if kernels.LAUNCHES[name] != n0 + 1:
            fail(f"{name} launched more than once a call")
        M_p = _psd_contrib_coo_plain(part, k, d, G, pad2, mp1, W)
        err = torch.abs(M_k.double() - M_p.double())
        if f32:
            absp = {kk: (v.abs().double() if v.is_floating_point() else v)
                    for kk, v in part.items()}
            M_abs = _psd_contrib_coo_plain(absp, k, d, G, pad2, mp1,
                                           W.abs().double())
            c = 2 * (pad2 + int(torch.diff(part["b_rowptr"]).max()) + 3)
            ok = bool(torch.all(err <= c * U32 * M_abs))
            tol = f"2 N u M_abs, N={c // 2}"
        else:
            ok = float(err.max()) <= 1e-12 * float(M_p.abs().max())
            tol = "1e-12*max|M|"
        work = k2_coo_work(part, meta, mp1, size)
        row = dict(ms=cuda_ms(call, 50), graph_ms=graph_ms(call),
                   plain_ms=cuda_ms(lambda: _psd_contrib_coo_plain(
                       part, k, d, G, pad2, mp1, W), 3), key=key,
                   max_abs_err=float(err.max()), U=work["n_u"],
                   flops=work["flops"], flops_full=work["flops_full"])
        row["bound_ms"], row["bound_by"] = bound_ms(work["nbytes"],
                                                    work["flops"], peak)
        row["bound_full_ms"], row["bound_full_by"] = bound_ms(
            work["nbytes"], work["flops_full"], peak)
        desc = f"{label} bucket {i} (k={k} d={d} G={G} pad2={pad2} T={T} " \
            f"m+1={mp1})"
        print(f"K2 {name} {desc}: max|M|={float(M_p.abs().max()):.3e} max "
              f"err={float(err.max()):.3e} (tol {tol}) "
              + json.dumps(row), flush=True)
        if not ok:
            fail(f"{name} kernel disagrees with its plain version on "
                 f"{label}")
        shapes[desc] = row
        worst = max(worst, float(err.max()))
        del M_p
    first = next(iter(shapes.values()))
    return dict(name=name, route="cuda",
                source="sedumi_tpu_torch/csrc/psd_coo.cu",
                replaces="sedumi_tpu/schur.py:60", max_abs_err=worst,
                ms=first["ms"], graph_ms=first["graph_ms"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=None, shapes=shapes)


def indefinite_matrix(m: int, gen) -> torch.Tensor:
    """SPD B B' + I with two kinds of broken pivots: decoupled negative
    diagonals (cancellation add, no skip) and coupled ones (the lifted
    pivot makes |L| > maxu: skip)."""
    B = torch.randn(m, m, generator=gen, dtype=torch.float64)
    M = B @ B.T / m + torch.eye(m, dtype=torch.float64)
    for j in range(10, m, 37):      # add only
        M[j, :] = 0.0
        M[:, j] = 0.0
        M[j, j] = -1.0
    for j in range(25, m, 41):      # add, then skip
        M[j, j] = -1.0
    return M


# K3 at the path's orders: lp900+3dense's Woodbury capacitance (m = 3, the
# warp variant), nb+zero-row's singular ADA (124) and arch0's Schur order
# (174, the shared variant), control07's (666, the device variant)
K3_ORDERS = ((3, "lp900+3dense capacitance"), (124, "nb+zero-row ADA"),
             (174, "arch0's order"), (666, "control07's order"))


def check_ldl_masked(dev, gen, dtype=torch.float64):
    """K3 (K3-f32 for dtype f32) at K3_ORDERS on indefinite_matrix (m = 3:
    B B' + I, the capacitance's kind): one launch a call, L, d, skip and
    diagadd bit for bit the plain version, the order-174 matrix triggering
    both the add and the skip rule; each order timed (events, graph
    replay, us a column of the graph time) beside the plain version and
    the bound: M's lower triangle read, L, d, diagadd and skip written
    once, 3 flops a kept column's trailing entry.  The row's own numbers
    are order 174's."""
    from sedumi_tpu_torch.chol import ldl_masked, ldl_masked_plain

    f32 = dtype == torch.float32
    name = "ldl_masked_f32" if f32 else "ldl_masked"
    size = 4.0 if f32 else 8.0
    shapes = {}
    for m, label in K3_ORDERS:
        if m > 3:
            M = indefinite_matrix(m, gen)
        else:
            B = torch.randn(m, m, generator=gen, dtype=torch.float64)
            M = B @ B.T + torch.eye(m, dtype=torch.float64)
        M = M.to(dtype).to(dev)
        fk, key = launch_key(lambda: ldl_masked(M), name)
        torch.cuda.synchronize()
        fp_ = ldl_masked_plain(M)
        n_skip, n_add = int(fp_.skip.sum()), int((fp_.diagadd > 0).sum())
        same = bool(torch.equal(fk.skip, fp_.skip)) and all(
            bit_diff(a, b)[0] for a, b in ((fk.L, fp_.L), (fk.d, fp_.d),
                                           (fk.diagadd, fp_.diagadd)))
        if not same:
            fail(f"{name} disagrees with its plain version at m={m}")
        if m == 174 and not (n_skip > 0 and n_add > n_skip):
            fail("the K3 test matrix did not trigger both add and skip")
        keep = (~fp_.skip).cpu().numpy()
        flops = sum(3.0 * (m - j - 1) * (m - j) / 2 + (m - j - 1)
                    for j in range(m) if keep[j])
        row = dict(key=key, variant=key.split(":")[1].split("@")[0],
                   skipped=n_skip, added=n_add, max_abs_err=0.0,
                   ms=cuda_ms(lambda: ldl_masked(M), 20),
                   graph_ms=graph_ms(lambda: ldl_masked(M)),
                   plain_ms=cuda_ms(lambda: ldl_masked_plain(M), 2,
                                    warmup=1))
        row["us_per_column"] = 1e3 * row["graph_ms"] / m
        row["bound_ms"], row["bound_by"] = bound_ms(
            size * (m * (m + 1) / 2 + m * m + 2 * m) + m, flops,
            PEAK_F32_PER_S if f32 else PEAK_F64_PER_S)
        print(f"K3 {name} m={m} ({label}): bit for bit, "
              + json.dumps(row), flush=True)
        shapes[f"m={m} {label}"] = row
    head = shapes["m=174 arch0's order"]
    return dict(name=name, route="cuda",
                source="sedumi_tpu_torch/csrc/ldl_masked.cu",
                replaces="sedumi_tpu/chol.py:95", library_ms=None,
                shapes=shapes, **{k: head[k] for k in (
                    "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                    "bound_by")})


def wide_matrix(shape, gen) -> torch.Tensor:
    """Gaussian entries scaled over 2^-20..2^20, every 7th an exact power
    of two (frexp's f == 0.5 case), every 11th zero."""
    a = torch.randn(*shape, generator=gen, dtype=torch.float64)
    a = a * torch.exp2(torch.randint(-20, 21, shape, generator=gen)
                       .to(torch.float64))
    flat = a.view(-1)
    flat[::7] = torch.exp2(torch.randint(-20, 21, flat[::7].shape,
                                         generator=gen).to(torch.float64))
    flat[::11] = 0.0
    return a


def bit_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[bool, float]:
    """(bit-identical, max |a - b| over finite entries)."""
    ints = torch.int64 if a.element_size() == 8 else torch.int32
    same = a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(
        a.contiguous().view(ints), b.contiguous().view(ints)))
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float(torch.abs(a[fin] - b[fin]).max()) if bool(fin.any()) else 0.0
    return same, err


# K4 at the dd64 path's shapes: (label, rows, columns, row stride of the
# view, axis); control07's dd_chol updates are views of its 666 x 666
# factor (the trailing panel's rows, k = p0 = 48 and 624); R_k, split per
# column, comes as the transpose of a contiguous matrix (the NT factor's
# layout), which runs as the row split of that matrix
K4_SHAPES = (("control07 Gram B", 667, 16384, 16384, -1),
             ("control07 A_k, T'", 85376, 128, 128, -1),
             ("arch0 Gram B", 175, 25921, 25921, -1),
             ("arch0 A_k, T'", 28175, 161, 161, -1),
             ("control07 dd_chol update p0=48", 618, 48, 666, -1),
             ("control07 dd_chol update p0=624", 42, 624, 666, -1),
             ("control07 R_k", 128, 128, 128, 0))


def k4_prepare_sites(dev) -> dict:
    """K4's launches per shape over one control07 dd64 prepare (form_dd
    and dd_chol of its m x m block at a random interior point)."""
    from sedumi_tpu_torch import ddengine
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels

    aop, S = dense_case("control07", dev)
    before = dict(kernels.VARIANT_LAUNCHES)
    n0 = kernels.LAUNCHES["ozaki_split"]
    Mh, Ml = ddengine.form_dd(aop, S, 0.0)
    dd.dd_chol(Mh[:aop.m, :aop.m], Ml[:aop.m, :aop.m])
    torch.cuda.synchronize()
    sites = {k: v - before.get(k, 0)
             for k, v in kernels.VARIANT_LAUNCHES.items()
             if k.startswith("ozaki_split@") and v != before.get(k, 0)}
    total = kernels.LAUNCHES["ozaki_split"] - n0
    print(f"K4 launches over one control07 dd64 prepare: {total} "
          + json.dumps(sites), flush=True)
    if total > 17:
        fail(f"one control07 dd64 prepare launched K4 {total} times "
             f"(at most 17: each operand split once)")
    return dict(total=total, sites=sites)


def check_ozaki_split(dev, gen):
    """K4 at the dd64 path's shapes (K4_SHAPES: the Gram operands, the
    congruence inputs, dd_chol's trailing panels as views of the factor,
    an R_k per column as the path lays it out), on B's transpose (split
    per column, which runs as B's row split) and on a contiguous R_k (the
    column kernel): bit for bit against the plain version; times each
    (events, graph replay) beside its bytes bound, and counts K4's
    launches per call site over one control07 dd64 prepare."""
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels

    worst, shapes = 0.0, {}
    for label, R, C, ld, axis in K4_SHAPES:
        base = wide_matrix((R * ld,), gen).to(dev)
        X = base.as_strided((R, C), (ld, 1) if axis == -1 else (1, ld))
        k = C if axis == -1 else R
        # B' per column runs as B's row split; R_k contiguous takes the
        # column kernel
        cases = [(X, axis)] + ([(X.T, 0)] if label == "control07 Gram B"
                               else [(X.contiguous(), 0)] if axis == 0
                               else [])
        for Y, ax in cases:
            n0 = kernels.LAUNCHES["ozaki_split"]
            got, key = launch_key(lambda: dd.ozaki_split(Y, k, ax),
                                  "ozaki_split")
            torch.cuda.synchronize()
            if kernels.LAUNCHES["ozaki_split"] != n0 + 1:
                fail("ozaki_split did not launch its kernel once")
            for g, w in zip(got, dd.ozaki_split_plain(Y, k, ax)):
                same, err = bit_diff(g, w)
                worst = max(worst, err)
                if not same:
                    fail(f"ozaki_split kernel differs from its plain "
                         f"version on {label} (max err {err:.3e})")
        del got
        n = R * C
        row = dict(ms=cuda_ms(lambda: dd.ozaki_split(X, k, axis), 50),
                   graph_ms=graph_ms(lambda: dd.ozaki_split(X, k, axis)),
                   key=key)
        # read A once, write three slices; |.|, max, 2 x (add, sub, sub)
        row["bound_ms"], row["bound_by"] = bound_ms(32.0 * n, 10.0 * n)
        row["share"] = row["bound_ms"] / row["graph_ms"]
        if label == "control07 Gram B":
            row["plain_ms"] = cuda_ms(
                lambda: dd.ozaki_split_plain(X, k, axis), 10)
        print(f"K4 ozaki_split {label} ({R}x{C}, row stride {ld}, axis "
              f"{axis}): bit for bit " + json.dumps(row), flush=True)
        shapes[f"{label} {R}x{C}"] = row
        del base, X
    first = next(iter(shapes.values()))
    return dict(name="ozaki_split", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_split.cu",
                replaces="sedumi_tpu/ddlinalg.py:86",
                max_abs_err=worst, ms=first["ms"],
                graph_ms=first["graph_ms"], plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                library_ms=None, shapes=shapes,
                prepare_sites=k4_prepare_sites(dev))


def check_dd_elem(dev, gen):
    """K5's three entry points bit for bit against the plain versions:
    the accumulation (with and without the normalise) on control07's B
    shape and on arch0's congruence product (28175 x 161), dd_add and
    dd_sub at control07's Schur order (667 x 667, with and without a low
    part), two_prod by a broadcast row on B's shape."""
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels

    worst = 0.0

    def same(label, got, want):
        nonlocal worst
        for g, w in zip(got, want):
            ok, err = bit_diff(g, w)
            worst = max(worst, err)
            if not ok:
                fail(f"dd_accumulate kernel differs from its plain version "
                     f"({label}, max err {err:.3e})")

    n0 = kernels.LAUNCHES["dd_accumulate"]
    for shape in ((667, 16384), (175 * 161, 161)):
        Sh, P = wide_matrix(shape, gen).to(dev), wide_matrix(shape, gen)
        P = P.to(dev)
        Sl = Sh * 2.0**-60
        for normalize in (False, True):
            kh, kl = dd.dd_accumulate(Sh.clone(), Sl.clone(), P, normalize)
            ph, pl = dd.dd_accumulate_plain(Sh.clone(), Sl.clone(), P,
                                            normalize)
            same(f"accumulate {shape} normalize={normalize}", (kh, kl),
                 (ph, pl))
    ah, bh = (wide_matrix((667, 667), gen).to(dev) for _ in range(2))
    al, bl = ah * 2.0**-58, bh * 2.0**-57
    for lo in (bl, None):
        same("dd_add", dd.dd_add(ah, al, bh, lo),
             dd.dd_add_plain(ah, al, bh, lo))
        same("dd_sub", dd.dd_sub(ah, al, bh, lo),
             dd.dd_sub_plain(ah, al, bh, lo))
    A = wide_matrix((667, 16384), gen).to(dev)
    v = wide_matrix((16384,), gen).to(dev)
    same("two_prod_cols", dd.two_prod_cols(A, v),
         dd.two_prod_cols_plain(A, v))
    torch.cuda.synchronize()
    if kernels.LAUNCHES["dd_accumulate"] != n0 + 9:
        fail("dd_accumulate's entry points did not launch their kernels")
    print(f"K5 dd_accumulate: accumulate on 667x16384 and 28175x161, "
          f"dd_add/dd_sub on 667x667, two_prod_cols on 667x16384: bit "
          f"for bit", flush=True)
    # timed at control07's congruence product, 85376 x 128
    Sh = wide_matrix((667 * 128, 128), gen).to(dev)
    Sl, P = Sh * 2.0**-60, wide_matrix((667 * 128, 128), gen).to(dev)
    ms = cuda_ms(lambda: dd.dd_accumulate(Sh, Sl, P), 200)
    plain = cuda_ms(lambda: dd.dd_accumulate_plain(Sh, Sl, P), 20)
    n = Sh.numel()
    # read Sh, Sl, P, write Sh, Sl; TwoSum (6) + 1 add
    b_ms, b_by = bound_ms(40.0 * n, 7.0 * n)
    return dict(name="dd_accumulate", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_elem.cu",
                replaces="sedumi_tpu/ddlinalg.py:113",
                max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_dd_gemv(dev, gen):
    """K6 at m = n = 666 (the refinement's M x) and on the dd_chol_solve
    panel views (L[p0:p1, :p0] and L[p1:, p0:p1]'), against the plain
    version (the reference's Ozaki route).  The two sum in different
    orders; each is within (n + 4)^2 u^2 sum_j |A_ij| |x_j| of the exact
    product on these Gaussian inputs (K6: the compensation sum of the
    TwoSum chain is the n^2 term; the Ozaki route: its remainder slices lie
    within 4 n u of the row scale), so the tolerance is
    2 (n + 4)^2 u^2 sum_j |A_ij| |x_j|, u = 2^-53."""
    import dd_emulation as ddemu
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels

    m = 666
    u = 2.0**-53
    Ah = torch.randn(m, m, generator=gen, dtype=torch.float64).to(dev)
    Al = Ah * 2.0**-54 * torch.rand(m, m, generator=gen,
                                    dtype=torch.float64).to(dev)
    xh = torch.randn(m, generator=gen, dtype=torch.float64).to(dev)
    xl = xh * 2.0**-54 * torch.rand(m, generator=gen,
                                    dtype=torch.float64).to(dev)
    cases = [("M x", Ah, Al, xh, xl),
             ("L[48:96, :48] x", Ah[48:96, :48], Al[48:96, :48], xh[:48],
              xl[:48]),
             ("L[96:, 48:96]' x", Ah[96:, 48:96].T, Al[96:, 48:96].T,
              xh[96:], xl[96:])]
    worst_err, worst_ratio = 0.0, 0.0
    for label, A, Alo, x, xlo in cases:
        n0 = kernels.LAUNCHES["dd_gemv"]
        kh, kl = dd.dd_gemv(A, Alo, x, xlo)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["dd_gemv"] != n0 + 1:
            fail("dd_gemv did not launch its kernel")
        eh, el = ddemu.gemv(*(t.cpu().numpy() for t in (A, Alo, x, xlo)))
        if not (bit_diff(kh.cpu(), torch.as_tensor(eh))[0]
                and bit_diff(kl.cpu(), torch.as_tensor(el))[0]):
            fail(f"dd_gemv is not bit-equal to the emulation of its lane "
                 f"order on {label}")
        ph, pl = dd.dd_gemv_plain(A, Alo, x, xlo)
        n = A.shape[1]
        err = torch.abs((kh - ph) + (kl - pl))
        tol = 2.0 * (n + 4) ** 2 * u * u * (torch.abs(A) @ torch.abs(x))
        worst_err = max(worst_err, float(err.max()))
        worst_ratio = max(worst_ratio, float((err / tol).max()))
        if not bool(torch.all(err <= tol)):
            fail(f"dd_gemv kernel outside its bound on {label}")
    print(f"K6 dd_gemv m=666 and both panel orientations: bit-equal to "
          f"tests/dd_emulation.py; max err={worst_err:.3e}, worst "
          f"err/tol={worst_ratio:.3e}", flush=True)
    ms = cuda_ms(lambda: dd.dd_gemv(Ah, Al, xh, xl), 200)
    plain = cuda_ms(lambda: dd.dd_gemv_plain(Ah, Al, xh, xl), 20)
    # read Ah, Al, xh, xl, write yh, yl; ~14 flops per element
    b_ms, b_by = bound_ms(16.0 * m * m + 48.0 * m, 14.0 * m * m)
    return dict(name="dd_gemv", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_gemv.cu",
                replaces="sedumi_tpu/ddlinalg.py:130",
                max_abs_err=worst_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                graph_ms=graph_ms(lambda: dd.dd_gemv(Ah, Al, xh, xl)))


# (m, label) of check_dd_chol_solve: control07's and arch0's Schur orders
DD_SOLVE_SHAPES = ((666, "control07"), (174, "arch0"))


def plain_chol_solve(f, bh, bl):
    """dd_chol_solve_panels on the plain twins (dd_gemv_plain, the Ozaki
    route, and dd_sub_plain) on the card."""
    from sedumi_tpu_torch import ddlinalg as dd

    saved = dd.dd_gemv, dd.dd_sub
    dd.dd_gemv, dd.dd_sub = dd.dd_gemv_plain, dd.dd_sub_plain
    try:
        return dd.dd_chol_solve_panels(f, bh, bl)
    finally:
        dd.dd_gemv, dd.dd_sub = saved


def check_dd_chol_solve(dev, gen):
    """The fused dd_chol_solve (the "K6 solve" of csrc/dd_gemv.cu) at
    control07's m = 666 (14 panels, the last 42 rows wide) and arch0's
    m = 174 (4 panels, the last 30 rows), cond 1e14: one launch and no K6
    or K5 launch a solve, and z bit for bit equal to the composition of
    K6 and K5 launches (ddlinalg.dd_chol_solve_panels) and to the
    emulation of their order (tests/dd_emulation.py), with a dd
    right-hand side.  Against the plain twins' composition
    (dd_gemv_plain, dd_sub_plain: the Ozaki route, whose products round
    apart at eps^2) within 1e-18 of max|z| (the dd forward error at cond
    1e14).  Times the fused solve, the composition and the plain twins,
    back-to-back events and graph replays.  Bound: the factor's two
    triangles (h and l) read once, b and z, over the memory rate; beside
    it the chain of 2P dependent panel steps.  Returns the row at
    m = 666."""
    import dd_emulation as ddemu
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels

    row = None
    for m, label in DD_SOLVE_SHAPES:
        M = spd_with_cond(m, 1e14, gen).to(dev)
        f = dd.dd_chol(M)
        b = torch.randn(m, generator=gen, dtype=torch.float64).to(dev)
        bl = b * 2.0**-54 * torch.rand(m, generator=gen,
                                       dtype=torch.float64).to(dev)
        before = dict(kernels.LAUNCHES)
        zh, zl = dd.dd_chol_solve(f, b, bl)
        torch.cuda.synchronize()
        counts = {k: kernels.LAUNCHES[k] - before[k] for k in
                  ("dd_chol_solve", "dd_gemv", "dd_accumulate")}
        if counts != {"dd_chol_solve": 1, "dd_gemv": 0, "dd_accumulate": 0}:
            fail(f"dd_chol_solve at m={m} launched {counts}, not the one "
                 f"fused solve")
        ph, pl = dd.dd_chol_solve_panels(f, b, bl)
        eh, el = ddemu.dd_chol_solve(
            f.Lh.cpu().numpy(), f.Ll.cpu().numpy(),
            [(h.cpu().numpy(), l.cpu().numpy()) for h, l in f.inv_diag],
            f.nb, b.cpu().numpy(), bl.cpu().numpy())
        if not (bit_diff(zh, ph)[0] and bit_diff(zl, pl)[0]
                and bit_diff(zh.cpu(), torch.as_tensor(eh))[0]
                and bit_diff(zl.cpu(), torch.as_tensor(el))[0]):
            fail(f"the fused dd_chol_solve at m={m} is not bit-equal to "
                 f"the K6/K5 composition and its emulation")
        qh, ql = plain_chol_solve(f, b, bl)
        err = float(torch.abs((zh - qh) + (zl - ql)).max())
        if not err <= 1e-18 * float(torch.abs(qh).max()):
            fail(f"the fused dd_chol_solve at m={m} is {err:.3e} from the "
                 f"plain twins' solve")
        ms = cuda_ms(lambda: dd.dd_chol_solve(f, b, bl), 50)
        gms = graph_ms(lambda: dd.dd_chol_solve(f, b, bl))
        panels = cuda_ms(lambda: dd.dd_chol_solve_panels(f, b, bl), 10)
        panels_graph = graph_ms(lambda: dd.dd_chol_solve_panels(f, b, bl))
        plain = cuda_ms(lambda: plain_chol_solve(f, b, bl), 3, warmup=1)
        npan = -(-m // f.nb)
        # the triangles of L and the panels' inverses, h and l, read once;
        # b (h, l) read, z written; ~14 flops per element each way
        tri = m * (m + 1) / 2
        b_ms, b_by = bound_ms(16.0 * (tri + npan * f.nb**2) + 32.0 * m,
                              28.0 * tri)
        line = dict(m=m, problem=label, panels=npan, chain=2 * npan,
                    ms=ms, graph_ms=gms, panels_ms=panels,
                    panels_graph_ms=panels_graph, plain_ms=plain,
                    err_vs_plain=err, bound_ms=b_ms, bound_by=b_by)
        print("K6 solve " + json.dumps(line), flush=True)
        if row is None:
            row = dict(name="dd_chol_solve", route="cuda",
                       source="sedumi_tpu_torch/csrc/dd_gemv.cu",
                       replaces="sedumi_tpu/ddlinalg.py:210",
                       max_abs_err=err, ms=ms, plain_ms=plain,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       graph_ms=gms, panels_ms=panels,
                       panels_graph_ms=panels_graph)
    return row


def spd_with_cond(m: int, cond: float, gen) -> torch.Tensor:
    q, _ = torch.linalg.qr(torch.randn(m, m, generator=gen,
                                       dtype=torch.float64))
    ev = torch.logspace(0, -float(np.log10(cond)), m, dtype=torch.float64)
    M = (q * ev) @ q.T
    return 0.5 * (M + M.T)


def bits_or_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN in the same places, every other entry bit for bit."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) \
        and bit_diff(a[~nan], b[~nan])[0]


def check_dd_panel_chol(dev, gen):
    """K7 inside dd_chol against dd_chol with the plain panel, L, the
    panel inverses and ok bit for bit (NaN where the plain version has
    NaN): 666 x 666 at cond 1e14 (14 panels, the last 42 wide), with a
    forced non-positive pivot, with a NaN pivot, and 48 x 48 (one panel,
    nr == w).  Times the first panel (666 x 48) and the last (42 x 42),
    events and graph replays.  Bound: bytes, the panel's S and L (h, l)
    and the inverse once; beside it the chain: 2w dependent column steps
    (w of the factor, w of the inverse, which K7 runs a step behind the
    factor), and one factor step's cost, the last panel's graph time over
    its w."""
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels

    m = 666
    A1 = spd_with_cond(m, 1e14, gen).to(dev)
    B = torch.randn(m, m, generator=gen, dtype=torch.float64)
    A2 = (B @ B.T / m + torch.eye(m, dtype=torch.float64)).to(dev)
    A2[300, 300] = -5.0                    # pivot 300 goes negative
    A3 = A2.clone()
    A3[300, 300] = float("nan")            # pivot 300 is NaN
    A4 = spd_with_cond(48, 1e14, gen).to(dev)
    worst = 0.0
    for label, A, want_ok in (("cond 1e14", A1, True),
                              ("non-positive pivot", A2, False),
                              ("NaN pivot", A3, False),
                              ("48 x 48, nr == w", A4, True)):
        n0 = kernels.LAUNCHES["dd_panel_chol"]
        fk = dd.dd_chol(A)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["dd_panel_chol"] != n0 + -(-A.shape[0] // 48):
            fail("dd_chol did not launch the panel kernel per panel")
        kernel_panel = dd.dd_panel_chol
        dd.dd_panel_chol = dd.dd_panel_chol_plain
        try:
            fp_ = dd.dd_chol(A)
        finally:
            dd.dd_panel_chol = kernel_panel
        pairs = [(fk.Lh, fp_.Lh), (fk.Ll, fp_.Ll)] + [
            (a, b) for pk, pp in zip(fk.inv_diag, fp_.inv_diag)
            for a, b in zip(pk, pp)]
        for a, b in pairs:
            same, err = bit_diff(a, b)
            if label == "NaN pivot":
                same, err = bits_or_nan(a, b), 0.0
            worst = max(worst, err)
            if not same:
                fail(f"dd_panel_chol kernel differs from its plain version "
                     f"({label}, max err {err:.3e})")
        if bool(fk.ok) != want_ok or bool(fp_.ok) != want_ok:
            fail(f"dd_chol ok flag wrong on the {label} matrix")
    print("K7 dd_panel_chol: dd_chol of 666x666 at cond 1e14, with a "
          "forced non-positive pivot and with a NaN pivot, and of 48x48: "
          "bit for bit, ok flags right", flush=True)
    w = 48
    Sh = A1[:, :w].contiguous()
    Sl = torch.zeros_like(Sh)
    wl = m - 13 * w                         # the last panel, 42 x 42
    Th = A1[m - wl:, m - wl:].contiguous()
    Tl = torch.zeros_like(Th)
    ms = cuda_ms(lambda: dd.dd_panel_chol(Sh, Sl), 50)
    gms = graph_ms(lambda: dd.dd_panel_chol(Sh, Sl))
    last = cuda_ms(lambda: dd.dd_panel_chol(Th, Tl), 50)
    last_g = graph_ms(lambda: dd.dd_panel_chol(Th, Tl))
    plain = cuda_ms(lambda: dd.dd_panel_chol_plain(Sh, Sl), 3, warmup=1)
    # dd updates: rows r > j of column j, columns j < c < w; the inverse's
    # (w - j - 1) w; ~25 flops each (TwoProd, 3 adds, dd_sub)
    upd = sum((m - j - 1) * (w - j - 1) + (w - j - 1) * w for j in range(w))
    b_ms, b_by = bound_ms(16.0 * (2 * m * w + w * w), 25.0 * upd)
    line = dict(first_panel=[m, w], ms=ms, graph_ms=gms,
                last_panel=[wl, wl], last_ms=last, last_graph_ms=last_g,
                chain=2 * w, step_us=1e3 * last_g / wl, bound_ms=b_ms)
    print("K7 panel " + json.dumps(line), flush=True)
    return dict(name="dd_panel_chol", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_chol.cu",
                replaces="sedumi_tpu/ddlinalg.py:166",
                max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, graph_ms=gms,
                last_panel_ms=last, last_panel_graph_ms=last_g,
                chain=2 * w, step_us=line["step_us"])


# --------------------------------------------------------------------------
# the precision ladder's kernels: f32 builds of K1-K3, and K11
# --------------------------------------------------------------------------

U32 = 2.0**-24     # f32 unit roundoff
EPS64 = 2.0**-53   # f64 unit roundoff
UDF = 2.0**-48     # double-float resolution


def check_dd_residual_f32(dev, gen):
    """K1-f32 at control07's Schur order m = 666, cond ~ 1e6 (what f32
    carries), v = M^-1 rhs.  Both versions are compensated: each is within
    u |r| + c u^2 sum_j |M_ij v_j| of the exact residual (u = 2^-24), c =
    2L + 10 for the kernel (L = ceil(n/32) TwoSums per lane, 5 tree
    levels) and n + 2D + 4 for the plain pairwise tree (depth D, its e
    terms summed in any order), so the tolerance is
    2u|r| + (n + 2L + 2D + 14) u^2 sum_j |M_ij v_j|."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.pcg import dd_matvec_residual, \
        dd_matvec_residual_plain

    m = 666
    M = spd_with_cond(m, 1e6, gen).to(torch.float32).to(dev)
    rhs = torch.randn(m, generator=gen, dtype=torch.float64).to(
        torch.float32).to(dev)
    v = torch.linalg.solve(M.double(), rhs.double()).float()
    n0 = kernels.LAUNCHES["dd_matvec_residual_f32"]
    r_k = dd_matvec_residual(M, v, rhs)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["dd_matvec_residual_f32"] != n0 + 1:
        fail("dd_matvec_residual did not launch its f32 kernel")
    r_p = dd_matvec_residual_plain(M, v, rhs)
    L, D = -(-m // 32), int(np.ceil(np.log2(m)))
    c = m + 2 * L + 2 * D + 14
    S = torch.abs(M.double()) @ torch.abs(v.double())
    err = torch.abs(r_k.double() - r_p.double())
    tol = 2 * U32 * torch.abs(r_p.double()) + c * U32 * U32 * S
    print(f"K1-f32 dd_matvec_residual m={m}: max|r|="
          f"{float(r_p.abs().max()):.3e} max err={float(err.max()):.3e} "
          f"worst err/tol={float((err / tol).max()):.3e} (c={c})",
          flush=True)
    if not bool(torch.all(err <= tol)):
        fail("dd_matvec_residual f32 kernel disagrees with its plain version")
    ms = cuda_ms(lambda: dd_matvec_residual(M, v, rhs), 1000)
    plain = cuda_ms(lambda: dd_matvec_residual_plain(M, v, rhs), 20)
    lib = cuda_ms(lambda: torch.addmv(rhs, M, v, alpha=-1.0), 1000)
    b_ms, b_by = bound_ms(4.0 * (m * m + 3 * m), 11.0 * m * m,
                          PEAK_F32_PER_S)
    check_k1_order(torch.float32, dev)
    return dict(name="dd_matvec_residual_f32", route="cuda",
                source="sedumi_tpu_torch/csrc/dd_residual.cu",
                replaces="sedumi_tpu/pcg.py:56",
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                graph_ms=graph_ms(lambda: dd_matvec_residual(M, v, rhs)),
                library_graph_ms=graph_ms(
                    lambda: torch.addmv(rhs, M, v, alpha=-1.0)),
                library="torch.addmv",
                shapes=k1_shape_times(torch.float32, dev))


def check_df_gemv(dev, gen):
    """K11's two entry points against the plain versions (the reference's
    chunked pairwise tree) on nb's double-float operator (its one Lorentz
    bucket, [124, 2379]) and at a full width of [1001, 65536] (four of the
    reference's 16384-chunks).  In df arithmetic (u^2 = 2^-48) each version
    is within c u^2 S of the exact product, S = sum_j |a_j x_j|: the
    kernel with c = 3L + 30 (L terms per sequential sum: ceil(n/32) lanes'
    worth for df_matvec, the rows for df_vecmat), the reference's tree with
    c = (D + k)(D + k + 2) + 7 (depth D over k chunks).  Tolerance: the sum
    of the two.  Then the order check and the timings at the path's shapes
    (k11_operands, built once); the kernels line's times are
    [1001, 65536]'s."""
    from sedumi_tpu_torch import df, kernels

    ops = k11_operands(dev)
    worst = {"df_matvec": (0.0, 0.0), "df_vecmat": (0.0, 0.0)}
    for label in ("nb", "1001x65536"):
        Ah, Al = ops[label]
        rows, n = Ah.shape
        A64 = Ah.double() + Al.double()
        for fn in ("df_matvec", "df_vecmat"):
            length = rows if fn == "df_vecmat" else n
            x64 = torch.randn(length, generator=gen,
                              dtype=torch.float64).to(dev)
            xh, xl = df.df_split64(x64)
            x_df = xh.double() + xl.double()
            n0 = kernels.LAUNCHES[fn]
            if fn == "df_matvec":
                got = df.df_matvec(Ah, Al, xh, xl)
                want = df.df_matvec_plain(Ah, Al, xh, xl)
                S = torch.abs(A64) @ torch.abs(x_df)
                L, D, k = -(-n // 32) + 5, 14, -(-n // 16384)
            else:
                got = df.df_vecmat(xh, xl, Ah, Al)
                want = df.df_vecmat_plain(xh, xl, Ah, Al)
                S = torch.abs(x_df) @ torch.abs(A64)
                L, D, k = rows, int(np.ceil(np.log2(rows))), 1
            torch.cuda.synchronize()
            if kernels.LAUNCHES[fn] != n0 + 1:
                fail(f"{fn} did not launch its kernel")
            c = (3 * L + 30) + ((D + k) * (D + k + 2) + 7)
            err = torch.abs(df.df_to64(*got) - df.df_to64(*want))
            ratio = float((err / (c * UDF * S).clamp_min(1e-300)).max())
            worst[fn] = (max(worst[fn][0], float(err.max())),
                         max(worst[fn][1], ratio))
            print(f"K11 {fn} {label} [{rows}, {n}]: max err="
                  f"{float(err.max()):.3e} worst err/tol={ratio:.3e} "
                  f"(c={c})", flush=True)
            if not bool(torch.all(err <= c * UDF * S)):
                fail(f"{fn} kernel outside its bound on {label}")
        del A64
    check_k11_order(ops, dev)
    shapes = k11_shape_times(ops, dev)
    del ops
    torch.cuda.empty_cache()
    print("K11's kernels line: 1001x65536 (hi/lo 525 MB); library: "
          "torch.mv on the f64 operator (f64 rounding, not df)", flush=True)
    out = []
    for fn in ("df_matvec", "df_vecmat"):
        wide = shapes["1001x65536"][fn]
        out.append(dict(name=fn, route="cuda",
                        source="sedumi_tpu_torch/csrc/df_gemv.cu",
                        replaces="sedumi_tpu/df.py:"
                        + ("94" if fn == "df_matvec" else "127"),
                        max_abs_err=worst[fn][0],
                        **{k: wide[k] for k in (
                            "ms", "graph_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")},
                        shapes={k: v[fn] for k, v in shapes.items()}))
    return out


def k11_operands(dev) -> dict:
    """K11's operators, built once a run: the double-float operator's
    widest bucket of the mixed path's dense SOCP (SOCP_DENSE: its Lorentz
    bucket, [121, 400]) and of nb ([124, 2379]), and a seeded [1001,
    65536] (four of the reference's 16384-chunks, 525 MB of hi/lo)."""
    from sedumi_tpu_torch import df, transform
    from sedumi_tpu_torch.examples import load_example
    from sedumi_tpu_torch.params import Pars

    def widest(At, b, c, K):
        prob = transform.pretransfo(At, b, c, K, Pars(fid=0))
        adf = df.build_df_aop(prob.At, prob.c, prob.layout, device=dev)
        return max([adf.Al] + list(adf.Aq) + list(adf.As),
                   key=lambda p: p[0].numel())

    K, m, seed = SOCP_DENSE
    At, b, c, _ = feasible_problem(K, m, seed=seed)
    ex = load_example("nb")
    g = torch.Generator().manual_seed(20261019)
    return {"socp-dense": widest(At, b, c, K),
            "nb": widest(ex.At, ex.b, ex.c, ex.K),
            "1001x65536": df.df_split64(torch.randn(
                1001, 65536, generator=g, dtype=torch.float64).to(dev))}


def df_vectors(length: int, seed: int, dev):
    """A df vector (hi, lo) from numpy's generator."""
    from sedumi_tpu_torch import df

    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(length))
    return tuple(t.to(dev) for t in df.df_split64(x))


def df_emulated(fn: str, Ah, Al, xh, xl):
    """K11's df_matvec or df_vecmat by its numpy emulation
    (tests/gemv_emulation.py) at the wrapper's plan and A's storage offset
    and row stride, as tensors on A's device."""
    import gemv_emulation as gemu
    from sedumi_tpu_torch import df

    rows, n = Ah.shape
    args = [t.cpu().numpy() for t in (Ah, Al, xh, xl)]
    if fn == "df_matvec":
        got = gemu.df_matvec(*args, *df.matvec_plan(rows, n),
                             gemu.phase_of(Ah), Ah.stride(0))
    else:
        got = gemu.df_vecmat(args[2], args[3], args[0], args[1],
                             *df.vecmat_plan(rows, n))
    return tuple(torch.as_tensor(t, device=Ah.device) for t in got)


def df_call(fn: str, Ah, Al, xh, xl):
    from sedumi_tpu_torch import df

    return df.df_matvec(Ah, Al, xh, xl) if fn == "df_matvec" \
        else df.df_vecmat(xh, xl, Ah, Al)


def check_k11_order(pairs: dict, dev) -> None:
    """K11's two entry points bit for bit their emulation on k11_operands
    (socp-dense's [121, 400], nb's [124, 2379], [1001, 65536] with several
    slabs a row) and on nb's copied one float into a buffer (rows off
    16-byte boundaries); a second call gives the same bits."""
    cases = dict(pairs)
    Ah, Al = pairs["nb"]
    rows, n = Ah.shape
    off = [torch.empty(rows * n + 1, dtype=torch.float32,
                       device=dev)[1:].view(rows, n) for _ in range(2)]
    off[0].copy_(Ah)
    off[1].copy_(Al)
    cases["nb, offset"] = tuple(off)
    for label, (Ah, Al) in cases.items():
        rows, n = Ah.shape
        for k, fn in enumerate(("df_matvec", "df_vecmat")):
            xh, xl = df_vectors(n if fn == "df_matvec" else rows, k, dev)
            got = df_call(fn, Ah, Al, xh, xl)
            again = df_call(fn, Ah, Al, xh, xl)
            want = df_emulated(fn, Ah, Al, xh, xl)
            if not all(same_words(a, b) and same_words(a, c)
                       for a, b, c in zip(got, want, again)):
                fail(f"{fn} {label} [{rows}, {n}]: not bit for bit its "
                     f"emulation, or two calls differ")
    print("K11: df_matvec and df_vecmat bit for bit their emulation on "
          + ", ".join(cases) + "; two calls the same bits", flush=True)


def k11_shape_times(ops: dict, dev) -> dict:
    """Both entry points on k11_operands: back-to-back CUDA events and
    CUDA-graph replay, beside torch.mv on the f64 operator, the plain
    version and the bound."""
    from sedumi_tpu_torch import df

    out = {}
    for label, (Ah, Al) in ops.items():
        rows, n = Ah.shape
        A64 = Ah.double() + Al.double()
        big = rows * n > 10**7
        reps = 50 if big else 1000
        out[label] = {}
        for k, fn in enumerate(("df_matvec", "df_vecmat")):
            length = n if fn == "df_matvec" else rows
            xh, xl = df_vectors(length, 10 + k, dev)
            x64 = xh.double() + xl.double()
            A_ = A64 if fn == "df_matvec" else A64.T
            plain = df.df_matvec_plain if fn == "df_matvec" else \
                (lambda a, b, c, d: df.df_vecmat_plain(c, d, a, b))
            row = {"ms": cuda_ms(lambda: df_call(fn, Ah, Al, xh, xl), reps),
                   "graph_ms": graph_ms(lambda: df_call(fn, Ah, Al, xh,
                                                        xl)),
                   "library_ms": cuda_ms(lambda: torch.mv(A_, x64), reps),
                   "library_graph_ms": graph_ms(lambda: torch.mv(A_, x64)),
                   "plain_ms": cuda_ms(lambda: plain(Ah, Al, xh, xl),
                                       3 if big else 20, warmup=1)}
            row["bound_ms"], row["bound_by"] = bound_ms(
                8.0 * (rows * n + length) + 8.0 * (rows + n - length),
                25.0 * rows * n, PEAK_F32_PER_S)
            row["plan"] = (df.matvec_plan if fn == "df_matvec"
                           else df.vecmat_plan)(rows, n)
            out[label][fn] = row
            print(f"K11 {fn} {label} [{rows}, {n}]: " + json.dumps(row),
                  flush=True)
        del A64
    return out


# --------------------------------------------------------------------------
# the Jacobi eigensolver: K12 (real symmetric, f64 and f32 builds) and K13
# (complex Hermitian, complex128 and complex64)
# --------------------------------------------------------------------------


def nt_like(k: int, n: int, dtype, gen, cond: float = 1e4) -> torch.Tensor:
    """k symmetric (Hermitian for a complex dtype) matrices of order n with
    eigenvalues spread over `cond` in random order and sign, as the NT
    and line-search matrices of an IPM iteration are, made in f64/c128 on
    the host from `gen` and cast."""
    cplx = dtype in (torch.complex64, torch.complex128)
    g = torch.randn(k, n, n, generator=gen, dtype=torch.float64)
    if cplx:
        g = torch.complex(g, torch.randn(k, n, n, generator=gen,
                                         dtype=torch.float64))
    q, _ = torch.linalg.qr(g)
    w = torch.logspace(0, -np.log10(cond), n, dtype=torch.float64)
    w = w[torch.randperm(n, generator=gen)] * torch.where(
        torch.rand(k, n, generator=gen) < 0.3, -1.0, 1.0)
    a = (q * w[:, None, :].to(q.dtype)) @ q.transpose(-1, -2).conj()
    return (0.5 * (a + a.transpose(-1, -2).conj())).to(dtype)


# Builds that no solve on the card reaches, held by the kernel phase alone:
# the f64 Jacobi (the f64 phases take the library, as the reference's host
# phases do) and the complex Jacobi (the reference's device steps take the
# real embedding of Hermitian buckets, nt.py:112-125).
OFF_PATH = ("jacobi_eigh", "jacobi_eigh_herm", "jacobi_eigh_herm_c64")
JACOBI_NAMES = ("jacobi_eigh_f32",) + OFF_PATH


def off_norm(A, w, V):
    """||A V - V diag w||_F per matrix: the Frobenius norm of the
    off-diagonal part the sweeps left (A = V (diag w + Off) V^H)."""
    Ad = A.to(torch.complex128 if A.is_complex() else torch.float64)
    Vd = V.to(Ad.dtype)
    return torch.linalg.matrix_norm(Ad @ Vd - Vd * w.to(Ad.dtype)[:, None])


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) \
        and bool(torch.equal(a[~nan], b[~nan]))


def jacobi_compare(A, got, want, sweeps, vectors) -> dict:
    """A Jacobi kernel's result `got` against its plain version's `want`
    (each (w, V, sweeps run)) on the batch A.  Tolerance: NaN exactly
    where the plain version has NaN; the sorted eigenvalues within tol =
    4 n eps ||A||_2 + rem_k + rem_p, where rem = ||A V - V diag w||_F is
    what the sweeps left off the diagonal (by Weyl each sorted diagonal is
    within ||Off||_2 <= rem of the eigenvalues of the rotated matrix,
    itself within the backward error ~n eps ||A|| of A's; where the
    budget ends the sweeps short of convergence, two roundings leave
    different remainders; without vectors the plain version's
    with-vectors rem stands for both); with vectors ||A V - V diag w|| /
    ||A|| and ||V^H V - I|| within twice the plain version's plus
    16 n eps.  Returns ok, the slot-by-slot difference (max_abs_err),
    the sorted one, tol, bit-equality and the sweeps each ran."""
    from sedumi_tpu_torch import lax_eigh

    (w, V, nsw), (w0, V0, nsw0) = got, want
    n = A.shape[-1]
    eps = float(torch.finfo(w0.dtype).eps)
    rows = torch.isfinite(A).flatten(1).all(dim=1).nonzero().flatten()
    finite = torch.isfinite(w0)
    out = dict(
        sweeps=int(nsw.max()), sweeps_plain=int(nsw0.max()),
        bit_equal=same_bits(w, w0) and (not vectors or same_bits(V, V0)),
        max_abs_err=float(torch.abs(w - w0)[finite].max())
        if bool(finite.any()) else 0.0, sorted_err=0.0, tol=0.0)
    ok = bool(torch.equal(torch.isnan(w), torch.isnan(w0)))
    if len(rows):
        plain = lax_eigh._jacobi_herm_plain if A.is_complex() \
            else lax_eigh._jacobi_plain
        wv, Vv, _ = (w0, V0, None) if vectors else plain(A, sweeps, True)
        rem_p = float(off_norm(A[rows], wv[rows], Vv[rows]).max())
        rem_k = float(off_norm(A[rows], w[rows], V[rows]).max()) \
            if vectors else rem_p
        out["tol"] = 4 * n * eps * float(torch.abs(w0[rows]).max()) \
            + rem_k + rem_p
        out["sorted_err"] = float(torch.abs(
            torch.sort(w[rows], dim=-1).values
            - torch.sort(w0[rows], dim=-1).values).max())
        ok = ok and out["sorted_err"] <= out["tol"]
    if vectors and len(rows) == A.shape[0]:
        Ad = A.to(torch.complex128 if A.is_complex() else torch.float64)
        nrm = torch.linalg.matrix_norm(Ad)
        eye = torch.eye(n, dtype=Ad.dtype, device=A.device)
        for key, V_, w_ in (("", V, w), ("_plain", V0, w0)):
            Vd = V_.to(Ad.dtype)
            out["res" + key] = float((off_norm(A, w_, V_) / nrm).max())
            out["orth" + key] = float(torch.linalg.matrix_norm(
                Vd.transpose(-1, -2).conj() @ Vd - eye).max())
        ok = ok and out["res"] <= 2 * out["res_plain"] + 16 * n * eps \
            and out["orth"] <= 2 * out["orth_plain"] + 16 * n * eps
    out["ok"] = ok
    return out


def same_result(got, want, vectors) -> bool:
    """Two Jacobi results (w, V, sweeps run) equal: w and V bit for bit
    (NaN where the other has NaN), the same sweeps."""
    return same_bits(got[0], want[0]) \
        and (not vectors or same_bits(got[1], want[1])) \
        and bool(torch.equal(got[2], want[2]))


def jacobi_case(label, A, sweeps, vectors, time_it=True):
    """One batch through the kernel and its plain version on the card,
    held to jacobi_compare's tolerance, K12 to bit-equality with the
    plain version's sweep count and K13 to bit-equality with its
    device-memory variant (w, V and sweeps).  Each runs the dispatch's
    plan; the line names the variant and order it launched (its
    VARIANT_LAUNCHES key).
    Prints the comparison, times the kernel, the plain version and
    torch.linalg.eigh (or eigvalsh) on the same batch, and the bound."""
    from sedumi_tpu_torch import kernels, lax_eigh

    name = lax_eigh._KERNELS[A.dtype][2]
    herm = A.is_complex()
    plain = lax_eigh._jacobi_herm_plain if herm else lax_eigh._jacobi_plain

    def kernel():
        return lax_eigh._jacobi(A, sweeps, vectors)

    n0 = kernels.LAUNCHES[name]
    before = dict(lax_eigh.VARIANT_LAUNCHES)
    got = kernel()
    torch.cuda.synchronize()
    if kernels.LAUNCHES[name] != n0 + 1:
        fail(f"{name} did not launch its kernel on {label}")
    variant = [k for k, v in lax_eigh.VARIANT_LAUNCHES.items()
               if v != before.get(k, 0)]
    line = dict(case=label, kernel=name, k=A.shape[0], n=A.shape[-1],
                vectors=vectors, sweeps_budget=sweeps,
                **jacobi_compare(A, got, plain(A, sweeps, vectors), sweeps,
                                 vectors))
    line["variant"], = variant
    if not herm and (not line["bit_equal"]
                     or line["sweeps"] != line["sweeps_plain"]):
        fail(f"{name} is not bit-equal to its plain version, or ran "
             f"other sweeps, on {label}: {json.dumps(line)}")
    if herm:
        ref = lax_eigh._jacobi_cuda(A, sweeps, vectors, 0, ("device", 1))
        line["bit_equal_device"] = same_result(got, ref, vectors)
        if not line["bit_equal_device"]:
            fail(f"{name} is not bit-equal to its device-memory variant "
                 f"on {label}: {json.dumps(line)}")
    if time_it and bool(torch.isfinite(A).all()):
        k, n = A.shape[0], A.shape[-1]
        reps = max(1, min(50, int(2e8 // (k * n ** 3))))
        line["ms"] = cuda_ms(kernel, reps)
        line["plain_ms"] = cuda_ms(lambda: plain(A, sweeps, vectors), 1,
                                   warmup=0)
        lib = torch.linalg.eigh if vectors else torch.linalg.eigvalsh
        line["library_ms"] = cuda_ms(lambda: lib(A), reps)
        if herm:
            # K13's device time without the host's launches (cuSOLVER's
            # batched eigh cannot be captured: a failed capture leaves its
            # handle failing every later call)
            line["graph_ms"] = try_graph_ms(label, kernel)
        # read A once; write w (real) and V.  Flops per sweep of the
        # rotations at the padded order: 9 n^3 with vectors, 6 n^3
        # without (3 per updated element); complex 42 n^3 and 28 n^3 (14
        # real flops per complex update)
        esize = A.element_size()
        nbytes = k * n * n * esize * (2 if vectors else 1) \
            + k * n * esize // (2 if herm else 1)
        per = (42.0 if herm else 9.0) if vectors else (28.0 if herm
                                                       else 6.0)
        fp32 = A.dtype in (torch.float32, torch.complex64)
        line["bound_ms"], line["bound_by"] = bound_ms(
            nbytes, line["sweeps"] * k * per * (n + n % 2) ** 3,
            PEAK_F32_PER_S if fp32 else PEAK_F64_PER_S)
    print(f"K12/13 {json.dumps(line)}", flush=True)
    if not line["ok"]:
        fail(f"{name} disagrees with its plain version on {label}")
    return line


def plan_label(plan) -> str:
    return f"{plan[0]}{plan[1] if plan[0] == 'cluster' else ''}"


# (order, dtype, batch, vectors) of check_k12_plans: batch 1 on both
# sides of the block/cluster crossover of each dtype and at arch0's and
# trto3's orders, values only at the path's batch of two, and the batches
# at which jacobi_plan's batch rule changes its choice at 162 and 322
F32, F64 = torch.float32, torch.float64
K12_PLAN_CASES = tuple(
    [(n, F32, 1, True)
     for n in (47, 63, 79, 95, 99, 103, 107, 109, 161, 321)]
    + [(n, F64, 1, True) for n in (63, 71, 79, 87, 95, 161)]
    + [(n, F32, 2, False) for n in (95, 109, 127, 161)]
    + [(161, F32, b, True) for b in (9, 17, 34, 67)]
    + [(321, F32, b, True) for b in (9, 34)])


def check_k12_plans(dev, gen):
    """K12 at the full budget in every plan that holds the matrix (one
    block, 2-16 CTAs), at K12_PLAN_CASES: each bit-equal to the plain
    version with its sweep count, and timed (ms per call of the whole
    batch), beside the plan that lax_eigh.jacobi_plan picks and the
    fastest.  Prints one line; the times are why the plan picks what it
    does."""
    from sedumi_tpu_torch import lax_eigh

    out = []
    for n, dt, k, vec in K12_PLAN_CASES:
        A = nt_like(k, n, dt, gen).to(dev)
        m, sweeps = n + n % 2, lax_eigh._sweeps_for(n, dt)
        w0, V0, s0 = lax_eigh._jacobi_plain(A, sweeps, vec)
        reps = max(1, min(50, int(2e8 // (k * m ** 3))))
        times = {}
        plans = [("block", 1)] if lax_eigh.smem_bytes(m, dt, vec) \
            <= lax_eigh.SMEM_MAX else []
        plans += [("cluster", c) for c in lax_eigh.CLUSTER_SIZES
                  if lax_eigh.cluster_fits(m, dt, vec, c)]
        for plan in plans:
            w, V, s = lax_eigh._jacobi_cuda(A, sweeps, vec, 0, plan)
            if not (same_bits(w, w0) and (not vec or same_bits(V, V0))
                    and torch.equal(s, s0)):
                fail(f"K12 {plan} at {k} x {m} {dt} is not bit-equal to "
                     f"its plain version")
            times[plan_label(plan)] = cuda_ms(
                lambda: lax_eigh._jacobi_cuda(A, sweeps, vec, 0, plan), reps)
        chosen = lax_eigh.jacobi_plan(m, dt, vec, k, lax_eigh._sm_count(dev))
        out.append(dict(n=m, dtype=str(dt), batch=k, vectors=vec,
                        sweeps=int(s0), ms=times, plan=plan_label(chosen),
                        fastest=min(times, key=times.get)))
    print("K12 plans (bit-equal, ms): " + json.dumps(out), flush=True)


# (order, dtype, batch) of check_k13_plans, with vectors: batch 1 on
# both sides of each complex dtype's block/cluster crossover
# (lax_eigh.CLUSTER_MIN_N: 56 in complex128, 72 in complex64) and K13's
# timed case, 2 x 60, in both dtypes
C64, C128 = torch.complex64, torch.complex128
K13_PLAN_CASES = ((48, C128, 1), (56, C128, 1), (60, C128, 2),
                  (84, C128, 1), (60, C64, 1), (72, C64, 1), (60, C64, 2))


def check_k13_plans(dev, gen):
    """K13 at the full budget, with vectors, in every fused plan that holds
    the matrix (one block, 2-16 CTAs), at K13_PLAN_CASES: each bit-equal
    to its device-memory variant (w, V and sweeps) and timed (ms per call
    of the whole batch), beside torch.linalg.eigh, the plan that
    lax_eigh.jacobi_plan picks and the fastest.  Prints one line; the
    times are why CLUSTER_MIN_N is what it is for the complex dtypes."""
    from sedumi_tpu_torch import lax_eigh

    out = []
    for n, dt, k in K13_PLAN_CASES:
        A = nt_like(k, n, dt, gen).to(dev)
        sweeps = lax_eigh._sweeps_for(n, lax_eigh._real_dtype(dt))
        ref = lax_eigh._jacobi_cuda(A, sweeps, True, 0, ("device", 1))
        plans = [("block", 1)] if lax_eigh.smem_bytes(n, dt, True) \
            <= lax_eigh.SMEM_MAX else []
        plans += [("cluster", c) for c in lax_eigh.CLUSTER_SIZES
                  if lax_eigh.cluster_fits(n, dt, True, c)]
        times = {}
        for plan in plans:
            got = lax_eigh._jacobi_cuda(A, sweeps, True, 0, plan)
            if not same_result(got, ref, True):
                fail(f"K13 {plan} at {k} x {n} {dt} is not bit-equal to "
                     f"its device-memory variant")
            times[plan_label(plan)] = cuda_ms(
                lambda: lax_eigh._jacobi_cuda(A, sweeps, True, 0, plan), 10)
        chosen = lax_eigh.jacobi_plan(n, dt, True, k, lax_eigh._sm_count(dev))
        out.append(dict(n=n, dtype=str(dt), batch=k, sweeps=int(ref[2]),
                        ms=times, plan=plan_label(chosen),
                        fastest=min(times, key=times.get),
                        eigh_ms=cuda_ms(lambda: torch.linalg.eigh(A), 10)))
    print("K13 plans (bit-equal to device memory, ms): " + json.dumps(out),
          flush=True)


# K12's three rows (kernel-table name, case label): each timed at its
# case, with the launches of that case's variant over the run's paths
K12_ROWS = (("jacobi_eigh_f32 n=162", "arch0 f32 eigh"),
            ("jacobi_eigh_f32 n=322", "trto3 f32 eigh"),
            ("jacobi_eigh n=162", "arch0 f64 eigh"))


def check_jacobi(dev, gen):
    """K12 and K13 against their plain versions at the solves' shapes, K12
    bit for bit and in sweeps: arch0's PSD bucket (order 161, padded to
    162) in f32 with vectors at the full budget and without at the coarse
    budget, and in f64 with vectors (no card solve reaches the f64
    build); control07's order-128 superblock in f32; trto3's order-321
    bucket in f32 (a cluster of CTAs); order 545 in f32 with vectors at
    the coarse budget, beyond the largest cluster's capacity (the
    device-memory variant); a padded multi-bucket batch (buckets (3, 7),
    (1, 12), (2, 4) in one batch of order 12); 2500 blocks of order 4
    (sdp5k's); a batch of order 12 holding a NaN (one block) and one
    matrix of order 161 holding a NaN (a cluster of CTAs), each of which
    must come back NaN after the two unconditional sweeps; K13, each
    case also bit for bit its device-memory variant, at orders 8 and 60
    in both builds, complex128 at 120 and 200 (a cluster of CTAs) and a
    complex128 matrix of order 121 holding a NaN (a cluster).  Then
    check_k12_plans and check_k13_plans.  Returns K12's three rows
    (K12_ROWS) and K13's two (each build timed at 2 x 60), each with its
    variant's launch key under "count"."""
    from sedumi_tpu_torch import lax_eigh
    from sedumi_tpu_torch.linalg_ops import _pad_stack

    sw = lax_eigh._sweeps_for
    csw = lax_eigh.coarse_sweeps_for
    lines, worst = {}, {}

    def case(label, A, sweeps, vectors, time_it=True):
        line = jacobi_case(label, A.to(dev), sweeps, vectors, time_it)
        lines.setdefault(line["kernel"], line)
        lines[label] = line
        worst[line["kernel"]] = max(worst.get(line["kernel"], 0.0),
                                    line["max_abs_err"])
        return line

    case("arch0 f32 eigh", nt_like(1, 161, F32, gen), sw(161, F32), True)
    case("arch0 f32 eigvalsh coarse", nt_like(2, 161, F32, gen),
         csw(161, F32), False)
    case("arch0 f64 eigh", nt_like(1, 161, F64, gen), sw(161, F64), True)
    case("control07 f32 eigh", nt_like(1, 128, F32, gen), sw(128, F32), True)
    line = case("trto3 f32 eigh", nt_like(1, 321, F32, gen), sw(321, F32),
                True)
    if ":cluster" not in line["variant"]:
        fail("trto3's order-322 batch should take a cluster of CTAs")
    line = case("beyond the clusters f32 eigh coarse",
                nt_like(1, 545, F32, gen), csw(545, F32), True, time_it=False)
    if ":device@" not in line["variant"]:
        fail("order 546 with vectors should take the device-memory variant")
    mats = [nt_like(k, d, F32, gen) for k, d in ((3, 7), (1, 12), (2, 4))]
    case("padded multi-bucket f32 eigh", _pad_stack(mats)[0], sw(12, F32),
         True)
    case("2500 x 4 f32 eigh", nt_like(2500, 4, F32, gen), sw(4, F32), True)
    A = nt_like(3, 12, F32, gen)
    A[1, 2, 5] = float("nan")
    line = case("NaN batch f32", A, sw(12, F32), True, time_it=False)
    if line["sweeps"] != 2:
        fail(f"the NaN batch ran {line['sweeps']} sweeps, not 2")
    # the cluster variant's NaN: its sweep-end ratio is reduced over the
    # CTAs and its rows move by DSMEM stores
    A = nt_like(1, 161, F32, gen)
    A[0, 2, 5] = float("nan")
    line = case("NaN order 161 f32", A, sw(161, F32), True, time_it=False)
    if line["sweeps"] != 2 \
            or f":cluster{lax_eigh.MAX_CLUSTER}@" not in line["variant"]:
        fail(f"the NaN matrix of order 161 ran {line['sweeps']} sweeps "
             f"under {line['variant']}, not 2 under "
             f"{lax_eigh.MAX_CLUSTER} CTAs")
    for dt in (C128, C64):
        rdt = lax_eigh._real_dtype(dt)
        case(f"herm {dt} n=60", nt_like(2, 60, dt, gen), sw(60, rdt), True)
        case(f"herm {dt} n=8", nt_like(4, 8, dt, gen), sw(8, rdt), True)
    # complex128 at the first orders past one block: a cluster of CTAs
    for n in (120, 200):
        case(f"herm {C128} n={n}", nt_like(1, n, C128, gen), sw(n, F64),
             True)
    # K13's cluster variant on a NaN matrix: two sweeps
    A = nt_like(1, 121, C128, gen)
    A[0, 2, 5] = float("nan")
    line = case("NaN order 121 complex128", A, sw(121, F64), True,
                time_it=False)
    if line["sweeps"] != 2 or ":cluster" not in line["variant"]:
        fail(f"the complex NaN matrix ran {line['sweeps']} sweeps under "
             f"{line['variant']}, not 2 under a cluster")

    check_k12_plans(dev, gen)
    check_k13_plans(dev, gen)

    def row(name, line, replaces, src, count):
        return dict(name=name, route="cuda",
                    source=f"sedumi_tpu_torch/csrc/{src}",
                    replaces=replaces, count=count,
                    max_abs_err=worst[line["kernel"]],
                    ms=line["ms"], plain_ms=line["plain_ms"],
                    bound_ms=line["bound_ms"], bound_by=line["bound_by"],
                    library_ms=line["library_ms"],
                    **({"graph_ms": line["graph_ms"]}
                       if line.get("graph_ms") is not None else {}))

    rows = [row(name, lines[label], "sedumi_tpu/lax_eigh.py:49",
                "jacobi_eigh.cu", lines[label]["variant"])
            for name, label in K12_ROWS]
    rows += [row(name, lines[name], "sedumi_tpu/lax_eigh.py:187",
                 "jacobi_herm.cu", lines[name]["variant"])
             for name in ("jacobi_eigh_herm", "jacobi_eigh_herm_c64")]
    print("K12/K13 rows timed at: " + ", ".join(
        f"{name} {label} ({lines[label]['variant']})"
        for name, label in K12_ROWS) + ", " + ", ".join(
        f"{r['name']} {lines[r['name']]['case']} "
        f"({lines[r['name']]['variant']})" for r in rows[3:]), flush=True)
    return rows


# --------------------------------------------------------------------------
# the Schur-panel kernels of the mesh path: K14 (one block column of the
# distributed Cholesky) and K15 (the distributed substitution's steps)
# --------------------------------------------------------------------------

# (bs, mp): OH with {"panels": 2} (m = 948, n = 2: bs 128, mp 1024, nb 8)
# and nb with {"hosts": 2, "panels": 2} (m = 123: bs 32, mp 128, nb 4)
PANEL_SHAPES = ((128, 1024), (32, 128))
PANEL_TOL = 1e-12        # of max|L| (K14) and of max|x| (K15)
# K14-f32/K15-f32 against their plain versions: PANEL_TOL scaled by the
# f32/f64 epsilon ratio (the two orders round apart by ~cond(Ljj) eps)
PANEL_TOL_F32 = PANEL_TOL * 2.0**29
# per dtype: the test matrix's condition number, the tolerance against
# the plain versions (of max|L|, max|x|), against torch.linalg.cholesky
# (of max|L|) and of the solve's residual (of max|b|)
PANEL_CASE = {torch.float64: dict(cond=1e6, tol=PANEL_TOL, fac=1e-8,
                                  resid=1e-8),
              torch.float32: dict(cond=1e3, tol=PANEL_TOL_F32, fac=1e-4,
                                  resid=1e-4)}


def panel_spd(mp: int, gen, dev, dtype=torch.float64,
              cond: float = 1e6) -> torch.Tensor:
    """A Jacobi-scaled SPD matrix of the given condition number (~1e6 by
    default), as the panel engine factors (unit diagonal), in `dtype`."""
    M = spd_with_cond(mp, cond, gen)
    d = torch.sqrt(torch.diagonal(M))
    return (M / (d[:, None] * d[None, :])).to(dtype).to(dev)


def panel_columns(M: torch.Tensor, bs: int):
    """Every block column's gathered C [nb, bs, bs] (natural order) as
    dist_cholesky hands it to K14: the trailing-updated column j below
    the diagonal, the finished factor above; and L."""
    L = torch.linalg.cholesky(M).contiguous()
    mp = M.shape[0]
    nb = mp // bs
    out = []
    for j in range(nb):
        cols = slice(j * bs, (j + 1) * bs)
        S = M[:, cols] - L[:, :j * bs] @ L[cols, :j * bs].T
        S[:j * bs] = L[:j * bs, cols]
        out.append(S.reshape(nb, bs, bs).contiguous())
    return out, L


def panel_chain(L, b, bs: int, n: int, fwd, contrib, solve):
    """Both substitutions as _dist_trisolve runs them over n contiguous
    panels, in one process: fwd/contrib/solve are K15's steps (kernel or
    plain).  Returns x with L L' x = b."""
    mp = L.shape[0]
    nb = mp // bs
    nb_loc = nb // n
    x = torch.zeros(mp, dtype=L.dtype, device=L.device)
    for j in range(nb):
        x[j * bs:(j + 1) * bs] = fwd(L[j * bs:(j + 1) * bs], x,
                                     b[j * bs:(j + 1) * bs], j)
    y, x = x, torch.zeros_like(x)
    for j in range(nb - 1, -1, -1):
        c = sum(contrib(L[p * nb_loc * bs:(p + 1) * nb_loc * bs], x, bs,
                        p * nb_loc, j) for p in range(n))
        x[j * bs:(j + 1) * bs] = solve(
            L[j * bs:(j + 1) * bs, j * bs:(j + 1) * bs].contiguous(),
            y[j * bs:(j + 1) * bs], c)
    return x


def panel_case(bs: int, mp: int, gen, dev, dtype=torch.float64) -> dict:
    """K14 on every block column and a non-PD diagonal block, and K15 in
    the full two-panel substitution, against their plain versions and
    bit for bit against the emulation of their order
    (tests/panel_emulation.py), in `dtype` (the f32 builds for float32,
    on a matrix of PANEL_CASE's condition number); the errors and the
    launch deltas."""
    import panel_emulation as pe
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.parallel import panels as pn

    M = panel_spd(mp, gen, dev, dtype, PANEL_CASE[dtype]["cond"])
    Cs, L = panel_columns(M, bs)
    nb = mp // bs
    lmax = float(L.abs().max())
    n0 = dict(kernels.LAUNCHES)
    err_l = fac = 0.0
    emu_ok = True
    for j, C in enumerate(Cs):
        got = pn.panel_chol_step(C, j)
        want = pn.panel_chol_plain(C, j)
        err_l = max(err_l, float((got - want).abs().max()))
        emu_ok = emu_ok and bit_diff(got.cpu(), pe.chol_column(C.cpu(), j))[0]
        # and against the library's factor (cond 1e6: ~1e-10 apart)
        fac = max(fac, float((got[j:].reshape(-1, bs)
                              - L[j * bs:, j * bs:(j + 1) * bs])
                             .abs().max()))
    bad = Cs[nb // 2].clone()
    bad[nb // 2, 1, 1] = -1.0
    got = pn.panel_chol_step(bad, nb // 2)
    want = pn.panel_chol_plain(bad, nb // 2)
    nan_ok = bool(torch.isnan(got[nb // 2:]).all()
                  and torch.isnan(want[nb // 2:]).all()
                  and (got[:nb // 2] == 0).all())
    emu_ok = emu_ok and bit_diff(got.cpu(),
                                 pe.chol_column(bad.cpu(), nb // 2))[0]
    b = torch.randn(mp, generator=gen, dtype=torch.float64).to(dtype) \
        .to(dev)
    x_k = panel_chain(L, b, bs, 2, pn.trisolve_fwd_step,
                      pn.trisolve_bwd_contrib, pn.trisolve_bwd_solve)
    emu_ok = emu_ok and bit_diff(x_k.cpu(),
                                 pe.dist_solve(L.cpu(), b.cpu(), bs, 2))[0]
    x_p = panel_chain(L, b, bs, 2, pn.trisolve_fwd_plain,
                      pn.trisolve_bwd_contrib_plain,
                      pn.trisolve_bwd_solve_plain)
    torch.cuda.synchronize()
    resid = float((M @ x_k - b).abs().max() / b.abs().max())
    counts = {k: kernels.LAUNCHES[k] - n0[k] for k in kernels.LAUNCHES
              if kernels.LAUNCHES[k] != n0[k]}
    err_x = float((x_k - x_p).abs().max())
    return dict(err_l=err_l, rel_l=err_l / lmax, fac=fac / lmax, err_x=err_x,
                rel_x=err_x / float(x_p.abs().max()), nan_ok=nan_ok,
                emu_ok=emu_ok, resid=resid, counts=counts, M=M, L=L, Cs=Cs,
                b=b, x=x_k)


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """fn's device time a call: the replay of a captured CUDA graph of
    reps calls, timed between CUDA events, so host work (the Python
    wrappers, the launches' own overhead) is not counted."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: a call that is not stream-ordered (an earlier build's
    # cudaFuncSetAttribute before each launch) runs instead of failing
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def try_graph_ms(label: str, fn):
    """graph_ms of a call that may not be capturable (a library's), or
    None, with the reason printed."""
    try:
        return graph_ms(fn)
    except RuntimeError as exc:
        print(f"{label}: no graph replay of the library call ({exc})",
              flush=True)
        torch.cuda.synchronize()
        return None


# K14/K15's graph-replay ms before their one-launch, reciprocal-rule
# redesign (the earlier build's run on an H100 80GB HBM3 at 700 W, PERF.md
# section 6), printed beside this run's; never part of the kernels line,
# whose numbers are all measured here
PANEL_EARLIER_GRAPH_MS = {
    "dist_panel_chol": 1.09, "dist_trisolve_fwd": 0.02729,
    "dist_trisolve_bwd_contrib": 0.003974,
    "dist_trisolve_bwd_solve": 0.02878, "dist_panel_chol_f32": 0.9511,
    "dist_trisolve_fwd_f32": 0.02059,
    "dist_trisolve_bwd_contrib_f32": 0.003527,
    "dist_trisolve_bwd_solve_f32": 0.02268}


def check_panel_kernels(dev, gen, dtype=torch.float64):
    """K14 and K15 (K14-f32 and K15-f32 for float32) against their plain
    versions and, bit for bit, the emulation of their order at the mesh
    path's shapes (PANEL_SHAPES), then timed at OH's: back to back
    between CUDA events and as the replay of a captured CUDA graph, each
    beside one library call (two for the forward step) for the same
    work, in the same dtype."""
    from sedumi_tpu_torch.parallel import panels as pn

    sfx = "_f32" if dtype == torch.float32 else ""
    which = "K14-f32/K15-f32" if sfx else "K14/K15"
    tol = PANEL_CASE[dtype]
    item = torch.finfo(dtype).bits / 8
    peak = PEAK_F32_PER_S if sfx else PEAK_F64_PER_S
    cases = {}
    for bs, mp in PANEL_SHAPES:
        c = panel_case(bs, mp, gen, dev, dtype)
        nb = mp // bs
        print(f"{which} bs={bs} mp={mp}: K14 {c['rel_l']:.3e} of max|L| "
              f"from its plain version ({c['fac']:.3e} from "
              f"torch.linalg.cholesky), K15 solve {c['rel_x']:.3e} of "
              f"max|x|, residual {c['resid']:.3e}, non-PD block NaN: "
              f"{c['nan_ok']}, bit for bit the emulation: {c['emu_ok']}, "
              f"launches {c['counts']}", flush=True)
        want = {"dist_panel_chol" + sfx: nb + 1,
                "dist_trisolve_fwd" + sfx: nb,
                "dist_trisolve_bwd_contrib" + sfx: 2 * nb,
                "dist_trisolve_bwd_solve" + sfx: nb}
        if c["counts"] != want:
            fail(f"{which} launched {c['counts']}, expected {want}")
        if not (c["rel_l"] <= tol["tol"] and c["rel_x"] <= tol["tol"]
                and c["fac"] <= tol["fac"] and c["resid"] <= tol["resid"]
                and c["nan_ok"]):
            fail(f"{which} disagree with their plain versions at bs={bs}")
        if not c["emu_ok"]:
            fail(f"{which} differ from tests/panel_emulation.py at bs={bs}")
        cases[bs] = c
    # times at OH's shape: K14 over the nb columns of one factor (and on
    # column 0, the most blocks to solve), K15's forward step on the last
    # block row (the longest row product), the backward contribution of
    # panel 1 to column 0, one back solve
    bs, mp = PANEL_SHAPES[0]
    c = cases[bs]
    nb = mp // bs
    Cs, M = c["Cs"], c["M"]
    L, x, b = c["L"], c["x"], c["b"]
    row = L[(nb - 1) * bs:].contiguous()
    bj = b[(nb - 1) * bs:].contiguous()
    nb_loc = nb // 2
    L3 = L[nb_loc * bs:].contiguous()
    Ljj = L[:bs, :bs].contiguous()
    b0, c0 = b[:bs].contiguous(), x[:bs].contiguous()
    k0 = (nb - 1) * bs

    def factor(step):
        def run():
            for j, C in enumerate(Cs):
                step(C, j)
        return run

    # column j reads C[j]'s lower triangle and the nb - 1 - j blocks below
    # and writes Lcol; a Cholesky of bs^3 / 3 flops and one solve of bs^3
    # flops a block below
    col_work = [(item * ((nb - 1 - j) * bs * bs + bs * (bs + 1) / 2
                         + nb * bs * bs),
                 bs**3 / 3 + (nb - 1 - j) * float(bs)**3)
                for j in range(nb)]
    spec = [
        ("dist_panel_chol", "sedumi_tpu_torch/csrc/panel_chol.cu",
         "sedumi_tpu/parallel/panels.py:47",
         factor(pn.panel_chol_step), factor(pn.panel_chol_plain),
         "torch.linalg.cholesky_ex of the whole matrix (also its trailing "
         "updates)", lambda: torch.linalg.cholesky_ex(M),
         tuple(map(sum, zip(*col_work)))),
        ("dist_trisolve_fwd", "sedumi_tpu_torch/csrc/panel_solve.cu",
         "sedumi_tpu/parallel/panels.py:117",
         lambda: pn.trisolve_fwd_step(row, x, bj, nb - 1),
         lambda: pn.trisolve_fwd_plain(row, x, bj, nb - 1),
         "torch.addmv + torch.linalg.solve_triangular (two calls)",
         lambda: torch.linalg.solve_triangular(
             row[:, k0:], torch.addmv(bj, row[:, :k0], x[:k0],
                                      alpha=-1.0)[:, None], upper=False),
         # the row's first (nb - 1) bs + bs columns, x's first k0, b, xj
         (item * (bs * (k0 + bs) + k0 + 2 * bs), 2.0 * bs * k0 + bs * bs)),
        ("dist_trisolve_bwd_contrib", "sedumi_tpu_torch/csrc/panel_solve.cu",
         "sedumi_tpu/parallel/panels.py:117",
         lambda: pn.trisolve_bwd_contrib(L3, x, bs, nb_loc, 0),
         lambda: pn.trisolve_bwd_contrib_plain(L3, x, bs, nb_loc, 0),
         "x' L (one product)", lambda: x[nb_loc * bs:] @ L3[:, :bs],
         # the panel's column block 0 and its x segment, contrib
         (item * (nb_loc * bs * bs + nb_loc * bs + bs),
          2.0 * nb_loc * bs * bs)),
        ("dist_trisolve_bwd_solve", "sedumi_tpu_torch/csrc/panel_solve.cu",
         "sedumi_tpu/parallel/panels.py:117",
         lambda: pn.trisolve_bwd_solve(Ljj, b0, c0),
         lambda: pn.trisolve_bwd_solve_plain(Ljj, b0, c0),
         "torch.linalg.solve_triangular",
         lambda: torch.linalg.solve_triangular(Ljj.T, b0[:, None],
                                               upper=True),
         (item * (bs * bs + 3 * bs), 1.0 * bs * bs)),
    ]
    rows = []
    for name, src, rep, kern, plain, label, lib, (nbytes, flops) in spec:
        name += sfx
        ms = cuda_ms(kern, 20)
        pms = cuda_ms(plain, 5)
        lms = cuda_ms(lib, 20)
        gms = graph_ms(kern)
        lgms = try_graph_ms(name, lib)
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        key = "err_l" if name.startswith("dist_panel_chol") else "err_x"
        entry = dict(name=name, route="cuda", source=src, replaces=rep,
                     max_abs_err=max(cc[key] for cc in cases.values()),
                     ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lms, graph_ms=gms, library_graph_ms=lgms,
                     library=label)
        what = f"the {nb} columns of one factor" \
            if key == "err_l" else "one step"
        print(f"{name} bs={bs} mp={mp}, {what}: {ms:.4g} ms (graph replay "
              f"{gms:.4g}, earlier build's {PANEL_EARLIER_GRAPH_MS[name]}; "
              f"plain {pms:.4g}; {label}: {lms:.4g}, graph replay {lgms}; "
              f"bound {b_ms:.3g} by {b_by})", flush=True)
        if key == "err_l":
            def col0():
                return pn.panel_chol_step(Cs[0], 0)

            entry.update(column0_ms=cuda_ms(col0, 50),
                         column0_graph_ms=graph_ms(col0),
                         column0_bound_ms=bound_ms(*col_work[0], peak)[0])
            print(f"{name} column 0: {entry['column0_ms']:.4g} ms "
                  f"(graph replay {entry['column0_graph_ms']:.4g}; bound "
                  f"{entry['column0_bound_ms']:.3g})", flush=True)
        rows.append(entry)
    return rows


# --------------------------------------------------------------------------
# sparse-engine kernels (K8-K10, and K2's pair entry), on the plans the
# sparse path built
# --------------------------------------------------------------------------


def interior_scaling(meta, dev, rng):
    """NT scaling at a random interior point of a plan's cone layout."""
    from sedumi_tpu_torch import nt

    return nt.compute_scaling(interior_point(meta, dev, rng),
                              interior_point(meta, dev, rng))


def interior_point(meta, dev, rng):
    """A random interior point of a cone layout (meta: nl, q_shapes,
    s_shapes)."""
    from sedumi_tpu_torch.structs import ConeVec

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    def point():
        q = [np.concatenate([rng.random((c, 1)) + 2.0,
                             0.3 * rng.standard_normal((c, d - 1))], axis=1)
             for c, d in meta["q_shapes"]]
        s = []
        for k, d in meta["s_shapes"]:
            a = rng.standard_normal((k, d, d))
            s.append(a @ a.transpose(0, 2, 1) / d + 2.0 * np.eye(d))
        return ConeVec(l=t(rng.random(meta["nl"]) + 0.5),
                       q=tuple(map(t, q)), s=tuple(map(t, s)))

    return point()


def tile_case(plan, dev, rng, dtype=torch.float64):
    """(operator, tile storage of A H A') of a sparse plan at a random
    interior point, in `dtype`: the factor's input as
    TileSchurEngine.prepare assembles it."""
    from sedumi_tpu_torch import sparse_chol as sc
    from sedumi_tpu_torch import sparse_engine as se

    arrays, meta = plan
    aop = se.make_sparse_lq_op(arrays, meta, dtype=dtype, device=dev)
    S = interior_scaling(meta, dev, rng)
    S = type(S)(*[v.to(dtype) if isinstance(v, torch.Tensor)
                  else tuple(a.to(dtype) for a in v) for v in S])
    vals, _, _ = se.ada_values(aop, S)
    st = sc.assemble_tiles(meta["nslot"], meta["B"], aop.arrays["asm"], vals,
                           aop.arrays["pad_idx"])
    return aop, st


def escalation_tiles(B: int, gen, dtype=torch.float64) -> torch.Tensor:
    """Four diagonal tiles (lower triangles): SPD; indefinite by less than
    dmax + 1 (fails the lifted factor only) at pivot 3 and at pivot 70 (in
    K8's third panel); indefinite beyond it (fails both rungs)."""
    G = torch.randn(B, B, generator=gen, dtype=torch.float64)
    D = G @ G.T / B + torch.eye(B, dtype=torch.float64)
    first, late, both = D.clone(), D.clone(), D.clone()
    first[3, 3] = late[70, 70] = -0.5
    both[5, 4] = both[4, 5] = 50.0
    return torch.stack([torch.tril(a) for a in (D, first, late, both)]
                       ).to(dtype)


# K8-K10 tolerances against their plain versions, per storage dtype: the
# escalation tiles' rungs 0-1 and each level's factor (relative to the
# level's max|L|), and the solve (relative to max|x|).  f32: the plain
# versions factor with cuSOLVER and solve with cuBLAS in another order;
# on the lp20k and sdp1200 plans the kernels came within 2.3e-7 of both
# scales on an H100, and a wrong index or a lost update moves entries by
# O(1).
TILE_TOL = {torch.float64: {"esc": 1e-12, "factor": 1e-9, "solve": 1e-9},
            torch.float32: {"esc": 1e-5, "factor": 1e-5, "solve": 1e-4}}


def check_tile_kernels(plans, dev, gen, rng, reg=0.0, canceltol=1e-12,
                       dtype=torch.float64):
    """K8 and K9 level by level on the given plans (LP 20k, SDP 5k, SDP
    1200), at ADA = A H A' of a random interior point
    in `dtype` storage: each level's K8 against the plain version from the
    same storage (rungs equal, factor within TILE_TOL of the level's
    max|L|), then K9 from the same post-K8 storage (within
    2 (B + P + 1) (eps (|D| + sum_pairs |A| |B|') + tiny), P = the
    destination's pair count, eps of `dtype`, tiny the f32 underflow
    threshold in f32 and 0 in f64); K10 on the kernels' factor against the
    plain solve (within TILE_TOL of max|x|), in two launches, and bit for
    bit equal to a second call.  K8 also on four 128 x 128
    tiles built for rungs 0, 1 (at pivots 3 and 70) and 2 (the rung-2
    diagonal bit for bit in f64, within 1 ulp in f32).  Times K8 (and its
    diagonal and off parts apart) and K9 at the LP's widest level, and
    K10's whole solve on every plan.  The f32 build (K8-f32 to K10-f32)
    runs with the reference's unchanged canceltol and reg, rounded to
    f32."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch import sparse_chol as sc

    f32 = dtype == torch.float32
    sfx = "_f32" if f32 else ""
    n8, n9, n10 = ("tile_factor" + sfx, "tile_update" + sfx,
                   "tile_solve" + sfx)
    tol = TILE_TOL[dtype]
    B = 128
    st = escalation_tiles(B, gen, dtype).to(dev)
    ref = st.clone()
    lv3 = {"dslot": torch.arange(4, device=dev),
           "off_slot": torch.zeros(0, dtype=torch.int64, device=dev),
           "off_dslot": torch.zeros(0, dtype=torch.int64, device=dev)}
    rk = sc.tile_factor(st, lv3, reg, canceltol)
    rp = sc.tile_factor_plain(ref, lv3, reg, canceltol)
    err_esc = float(torch.abs(st[:3] - ref[:3]).max())
    same2, err2 = bit_diff(st[3], ref[3])
    ulp2 = float((torch.abs(st[3] - ref[3])
                  / torch.finfo(dtype).eps
                  / torch.clamp_min(torch.abs(ref[3]),
                                    torch.finfo(dtype).tiny)).max())
    print(f"K8{sfx} escalation tiles: rungs kernel {rk.tolist()} plain "
          f"{rp.tolist()}, max err rungs 0-1 {err_esc:.3e}, rung-2 tile "
          f"bit for bit {same2} (max err {err2:.3e})", flush=True)
    if rk.tolist() != [0, 1, 1, 2] or rp.tolist() != [0, 1, 1, 2]:
        fail(f"{n8}: the escalation tiles took the wrong rungs")
    if not (err_esc <= tol["esc"] * float(torch.abs(ref[:3]).max())
            and (same2 or (f32 and ulp2 <= 1.0))):
        fail(f"{n8} kernel disagrees with its plain version on the "
             "escalation tiles")

    eps = float(torch.finfo(dtype).eps)
    # f32 fill products reach the subnormal range, which the plain GEMM
    # may flush to zero: an underflow term per summand (0 in f64)
    tiny = float(torch.finfo(dtype).tiny) if f32 else 0.0
    worst = {n8: err_esc, n9: 0.0, n10: 0.0}
    timing, solves = {}, {}
    for label, plan in plans.items():
        aop, st = tile_case(plan, dev, rng, dtype)
        levels = aop.levels
        wide = max(range(len(levels)),
                   key=lambda i: (levels[i]["cols"].numel(),
                                  levels[i]["pair_a"].numel()))
        n_rung = [0, 0, 0]
        ratio9, rel8 = 0.0, 0.0
        for i, lv in enumerate(levels):
            if label == "lp20k" and i == wide:
                timing["before"] = st.clone()
            ref = st.clone()
            n0 = kernels.LAUNCHES[n8]
            rk = sc.tile_factor(st, lv, reg, canceltol)
            torch.cuda.synchronize()
            if kernels.LAUNCHES[n8] == n0:
                fail(f"{n8} did not launch its kernel")
            rp = sc.tile_factor_plain(ref, lv, reg, canceltol)
            if not torch.equal(rk, rp):
                fail(f"{n8}: rungs differ on {label} level {i}")
            for r in rk.tolist():
                n_rung[r] += 1
            slots = torch.cat([lv["dslot"], lv["off_slot"]])
            err = float(torch.abs(st[slots] - ref[slots]).max())
            worst[n8] = max(worst[n8], err)
            scale = float(torch.abs(ref[slots]).max())
            rel8 = max(rel8, err / scale)
            if not err <= tol["factor"] * scale:
                fail(f"{n8} kernel disagrees with its plain version "
                     f"on {label} level {i} (max err {err:.3e})")
            if not lv["pair_a"].numel():
                continue
            dst, ptr = lv["pair_dst"], lv["pair_ptr"]
            didx = torch.repeat_interleave(
                torch.arange(dst.numel(), device=dev), torch.diff(ptr))
            bound = torch.abs(st[dst]).index_add_(
                0, didx, torch.abs(st[lv["pair_a"]])
                @ torch.abs(st[lv["pair_b"]]).mT)
            c = 2.0 * (B + float(torch.diff(ptr).max()) + 1.0)
            ref, again = st.clone(), st.clone()
            n0 = kernels.LAUNCHES[n9]
            sc.tile_update(st, lv)
            torch.cuda.synchronize()
            if kernels.LAUNCHES[n9] != n0 + 1:
                fail(f"{n9} did not launch its kernel")
            sc.tile_update(again, lv)
            if not bit_diff(st, again)[0]:
                fail(f"{n9}: two calls on the same storage differ on "
                     f"{label} level {i}")
            sc.tile_update_plain(ref, lv)
            diff = torch.abs(st[dst] - ref[dst])
            lim = c * (eps * bound + tiny)
            worst[n9] = max(worst[n9], float(diff.max()))
            ratio9 = max(ratio9, float((diff / lim).max()))
            if not bool(torch.all(diff <= lim)):
                fail(f"{n9} kernel outside its bound on {label} level {i}")
        rhs = torch.randn(aop.meta["ntiles_n"], generator=gen,
                          dtype=torch.float64).to(dev, dtype)
        n0 = kernels.LAUNCHES[n10]
        xk = sc.tile_solve(st, rhs, levels)
        torch.cuda.synchronize()
        if kernels.LAUNCHES[n10] == n0:
            fail(f"{n10} did not launch its kernels")
        if kernels.LAUNCHES[n10] != n0 + 2:
            fail(f"{n10} took {kernels.LAUNCHES[n10] - n0} launches, not "
                 "one per pass")
        xp = sc.tile_solve_plain(st, rhs, levels)
        err = float(torch.abs(xk - xp).max())
        worst[n10] = max(worst[n10], err)
        same = bit_diff(xk, sc.tile_solve(st, rhs, levels))[0]
        print(f"K8-K10{sfx} {label}: ntc={aop.meta['ntc']} "
              f"levels={len(levels)} widest={levels[wide]['cols'].numel()} "
              f"cols, rungs {n_rung}, worst K8 err/max|L|={rel8:.3e}, worst "
              f"K9 err/bound={ratio9:.3e} (two calls bit for bit at every "
              f"level), K10 max err {err:.3e} (max|x| "
              f"{float(xp.abs().max()):.3e}), two calls bit for bit {same}",
              flush=True)
        print(f"K9{sfx} {label} levels " + json.dumps(
            update_level_stats(levels, wide)), flush=True)
        if not err <= tol["solve"] * float(torch.abs(xp).max()):
            fail(f"{n10} kernel disagrees with its plain version on "
                 f"{label}")
        if not same:
            fail(f"{n10}: two calls on the same inputs differ on {label}")
        solves[label] = k10_timing(sc, st, rhs, levels, B, f32)
        if label == "lp20k":
            timing.update(levels=levels, wide=wide, L=st, rhs=rhs)

    # --- times at the LP 20k plan: K8 and K9 at its widest level, K10's
    # whole solve; bounds in the storage dtype's bytes and at its rate
    esz = torch.finfo(dtype).bits // 8
    peak = PEAK_F32_PER_S if f32 else PEAK_F64_PER_S
    levels, lv, before = timing["levels"], timing["levels"][timing["wide"]], \
        timing["before"]
    L, rhs = timing["L"], timing["rhs"]
    work = before.clone()

    def restore():
        work.copy_(before)

    def k8():
        restore()
        sc.tile_factor(work, lv, reg, canceltol)

    def p8():
        restore()
        sc.tile_factor_plain(work, lv, reg, canceltol)

    t_copy = cuda_ms(restore, 20)
    restore()
    sc._tile_diag_kernel(work, lv, reg, canceltol)
    after_diag = work.clone()

    def k8_diag():
        restore()
        sc._tile_diag_kernel(work, lv, reg, canceltol)

    def k8_off():
        work.copy_(after_diag)
        sc._tile_off_kernel(work, lv)

    k8_parts = {"diag_ms": cuda_ms(k8_diag, 20) - t_copy,
                "off_ms": cuda_ms(k8_off, 20) - t_copy}
    D = before[lv["dslot"]]
    D = torch.tril(D) + torch.tril(D, -1).mT
    dmax = torch.abs(torch.diagonal(D, dim1=-2, dim2=-1)).amax(-1)
    Dl = D + (canceltol * dmax + 1e-300)[:, None, None] \
        * torch.eye(B, dtype=D.dtype, device=dev)
    nc, no = lv["dslot"].numel(), lv["off_slot"].numel()
    b8 = bound_ms(2.0 * esz * B * B * (nc + no),
                  nc * B**3 / 3.0 + no * B**3, peak)
    row8 = dict(name=n8, route="cuda",
                source="sedumi_tpu_torch/csrc/tile_chol.cu",
                replaces="sedumi_tpu/sparse_chol.py:469",
                max_abs_err=worst[n8],
                ms=cuda_ms(k8, 20) - t_copy, plain_ms=cuda_ms(p8, 5) - t_copy,
                bound_ms=b8[0], bound_by=b8[1],
                library_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(Dl), 20))
    np_ = lv["pair_a"].numel()
    nsrc = torch.unique(torch.cat([lv["pair_a"], lv["pair_b"]])).numel()
    b9 = bound_ms(esz * B * B * (nsrc + 2 * lv["pair_dst"].numel()),
                  2.0 * B**3 * np_, peak)
    work9 = before.clone()
    row9 = dict(name=n9, route="cuda",
                source="sedumi_tpu_torch/csrc/tile_update.cu",
                replaces="sedumi_tpu/sparse_chol.py:514",
                max_abs_err=worst[n9],
                ms=cuda_ms(lambda: sc.tile_update(work9, lv), 20),
                plain_ms=cuda_ms(lambda: sc.tile_update_plain(work9, lv), 5),
                bound_ms=b9[0], bound_by=b9[1], library_ms=None,
                graph_ms=graph_ms(lambda: sc.tile_update(work9, lv)))
    dsl = torch.cat([v["dslot"] for v in levels])
    Ld, yd = L[dsl], rhs.reshape(-1, B, 1)[:dsl.numel()].clone()
    t10 = solves["lp20k"]
    row10 = dict(name=n10, route="cuda",
                 source="sedumi_tpu_torch/csrc/tile_solve.cu",
                 replaces="sedumi_tpu/sparse_chol.py:525",
                 max_abs_err=worst[n10], ms=t10["ms"],
                 plain_ms=t10["plain_ms"], bound_ms=t10["bound_ms"],
                 bound_by=t10["bound_by"],
                 library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
                     Ld, yd, upper=False), 20))
    print(f"K8/K9{sfx} timed at the LP 20k widest level: {nc} columns, {no} "
          f"off tiles, {np_} pairs; K10{sfx} over {t10['levels']} levels, "
          f"{t10['tiles']} tiles", flush=True)
    print(json.dumps({"tile_timing" + sfx: {
        "k8_widest_lp20k": {**k8_parts, "ms": row8["ms"],
                            "library_ms": row8["library_ms"]},
        "k10_solve": solves}}), flush=True)
    return [row8, row9, row10]


def update_level_stats(levels, wide) -> dict:
    """K9's work at a plan's widest level (destinations, pairs, the most
    pairs of one destination, chunks of the work list, split
    destinations) and over all levels (pairs, the most of one level)."""
    lv = levels[wide]
    cnt = torch.diff(lv["pair_ptr"])
    return {"widest": {
        "level": wide, "destinations": lv["pair_dst"].numel(),
        "pairs": lv["pair_a"].numel(),
        "max_pairs_per_destination": int(cnt.max()) if cnt.numel() else 0,
        "chunks": lv["chunk_dst"].numel(),
        "split_destinations": int((lv["dst_part"] >= 0).sum())},
        "levels": len(levels),
        "pairs": sum(v["pair_a"].numel() for v in levels),
        "max_level_pairs": max(v["pair_a"].numel() for v in levels)}


def k10_timing(sc, L, rhs, levels, B, f32) -> dict:
    """K10's whole solve on one plan: ms, the plain solve's ms, the bound
    (each tile read once, 2 flops an entry of a diagonal tile and 4 of an
    off tile, forward and backward) and the chain of dependent steps (a
    diagonal solve per level and pass)."""
    esz = 4 if f32 else 8
    ntiles = sum(v["dslot"].numel() + v["off_slot"].numel() for v in levels)
    noff = sum(v["off_slot"].numel() for v in levels)
    b = bound_ms(esz * B * B * ntiles + 2.0 * esz * rhs.numel(),
                 2.0 * B * B * (ntiles - noff) + 4.0 * B * B * noff,
                 PEAK_F32_PER_S if f32 else PEAK_F64_PER_S)
    return {"ms": cuda_ms(lambda: sc.tile_solve(L, rhs, levels), 20),
            "plain_ms": cuda_ms(lambda: sc.tile_solve_plain(L, rhs, levels),
                                5),
            "bound_ms": b[0], "bound_by": b[1], "levels": len(levels),
            "chain": 2 * len(levels), "tiles": ntiles}


def check_library_rows(dev, gen, rng, plans):
    """Times of the routines the port leaves to the library or to plain
    torch ops, each at one main-path shape, with its bound: B5
    (chol.chol_factor + chol_solve at OH's Schur order 948), B11
    (TileSchurEngine.prepare and solve on the LP 20k plan; the bound
    counts one pass over the tile storage and the factor's flops), B9's
    library part (ddlinalg.dd_gemm of control07's PSD congruence, B
    667 x 16384 with its transpose) and B7/B8 (nt.compute_scaling,
    wregion.prod_spectrum and nt.maxstep_pair on nb's cone layout).
    Printed as one JSON line."""
    from sedumi_tpu_torch import chol, nt
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch.examples import load_example
    from sedumi_tpu_torch.params import Pars
    from sedumi_tpu_torch.sparse_engine import TileSchurEngine, \
        make_sparse_lq_op
    from sedumi_tpu_torch.transform import pretransfo
    from sedumi_tpu_torch.wregion import prod_spectrum

    rows = []
    m = 948
    M = spd_with_cond(m, 1e8, gen).to(dev)
    rhs = torch.randn(m, generator=gen, dtype=torch.float64).to(dev)
    f = chol.chol_factor(M, 0.0)
    rows.append(dict(name="B5 chol_factor + chol_solve, m=948",
                     ms=cuda_ms(lambda: chol.chol_solve(
                         chol.chol_factor(M, 0.0), rhs), 20),
                     factor_ms=cuda_ms(lambda: chol.chol_factor(M, 0.0), 20),
                     solve_ms=cuda_ms(lambda: chol.chol_solve(f, rhs), 20),
                     bound=bound_ms(8.0 * (2 * m * m + 2 * m),
                                    m**3 / 3.0 + 2.0 * m * m)))
    arrays, meta = plans["lp20k"]
    aop = make_sparse_lq_op(arrays, meta, device=dev)
    S = interior_scaling(meta, dev, rng)
    eng = TileSchurEngine(Pars.make({}))
    ctx = eng.prepare(aop, S, 0.0)[0]
    r20 = torch.randn(aop.m, generator=gen, dtype=torch.float64).to(dev)
    B = meta["B"]
    levels = aop.levels
    ntiles = sum(v["dslot"].numel() + v["off_slot"].numel() for v in levels)
    flops = sum(v["dslot"].numel() * B**3 / 3.0 + v["off_slot"].numel()
                * B**3 + 2.0 * B**3 * v["pair_a"].numel() for v in levels)
    rows.append(dict(name="B11 TileSchurEngine.prepare, lp20k",
                     ms=cuda_ms(lambda: eng.prepare(aop, S, 0.0), 5),
                     bound=bound_ms(16.0 * B * B * ntiles, flops)))
    rows.append(dict(name="B11 TileSchurEngine.solve, lp20k",
                     ms=cuda_ms(lambda: eng.solve(ctx, r20), 5),
                     bound=bound_ms(8.0 * B * B * ntiles,
                                    2.0 * B * B * ntiles)))
    Bh = torch.randn(667, 16384, generator=gen, dtype=torch.float64).to(dev)
    Bl = Bh * 2.0**-54
    nterms = 1 + len(dd._ORDER) + 2     # the slice products, 2 cross terms
    rows.append(dict(name="B9 dd_gemm B B' (control07's congruence, "
                          "667 x 16384)",
                     ms=cuda_ms(lambda: dd.dd_gemm(Bh, Bl, Bh.T, Bl.T), 5),
                     bound=bound_ms(16.0 * (667 * 16384 + 667 * 667),
                                    2.0 * nterms * 667 * 667 * 16384)))
    ex = load_example("nb")
    lay = pretransfo(ex.At, ex.b, ex.c, ex.K, Pars.make({})).layout
    cmeta = {"nl": lay.l,
             "q_shapes": [(b.count, b.dim) for b in lay.q_buckets],
             "s_shapes": [(b.count, b.dim) for b in lay.s_buckets]}
    x, z = interior_point(cmeta, dev, rng), interior_point(cmeta, dev, rng)
    dx, dz = interior_point(cmeta, dev, rng), interior_point(cmeta, dev, rng)
    Sn = nt.compute_scaling(x, z)
    lam = nt.lam_as_conevec(Sn)
    nbytes = 8.0 * 6 * (lay.l + sum(b.count * b.dim for b in lay.q_buckets)
                        + sum(b.count * b.dim**2 for b in lay.s_buckets))
    rows.append(dict(name="B7/B8 compute_scaling + prod_spectrum + "
                          "maxstep_pair, nb",
                     ms=cuda_ms(lambda: (nt.compute_scaling(x, z),
                                         prod_spectrum(x, z),
                                         nt.maxstep_pair(lam, dx, lam, dz)),
                                20),
                     bound=bound_ms(nbytes, 0.0)))
    for row in rows:
        row["bound_ms"], row["bound_by"] = row.pop("bound")
    print(json.dumps({"library_rows": rows}), flush=True)
    return rows


def check_psd_pairs(plans, dev, rng, rows):
    """K2's sparse-engine entry (one value a gathered pair) on the SDP
    plans' largest bucket, f64 and f32: against the plain version (whole
    groups, then the gather) within 2 (pad2 + 2) u of the same function
    of |W|, |gv| and |sp_val|; timed (events, graph replay) beside it and
    the bound, into the K2 and K2-f32 rows' shapes."""
    from sedumi_tpu_torch import schur
    from sedumi_tpu_torch import sparse_engine as se

    for label in K2_PAIR_PLANS:
        arrays, meta = plans[label]
        bi = max(range(len(meta["s_G"])), key=lambda i: meta["s_G"][i])
        for dtype in (torch.float64, torch.float32):
            f32 = dtype == torch.float32
            name = "psd_contrib_coo_f32" if f32 else "psd_contrib_coo"
            aop = se.make_sparse_lq_op(arrays, meta, dtype=dtype,
                                       device=dev)
            S = interior_scaling(meta, dev, rng)
            W = schur.psd_gram(S.s_r[bi]).to(dtype)
            a = aop.arrays
            args = [a[key][bi] for key in ("sg_blk", "sg_p", "sg_q",
                                           "sg_v", "sp_g", "sp_loc",
                                           "sp_val")]

            def call():
                return schur.psd_pair_values(W, *args)

            got, key = launch_key(call, name)
            want = schur.psd_pair_values_plain(W, *args)
            absa = [x.abs().double() if x.is_floating_point() else x
                    for x in args]
            vabs = schur.psd_pair_values_plain(W.abs().double(), *absa)
            G, pad2 = args[1].shape
            k, d = meta["s_shapes"][bi]
            n = got.numel()
            u = U32 if f32 else EPS64
            err = torch.abs(got.double() - want.double())
            if not bool(torch.all(err <= 2 * (pad2 + 2) * u * vabs)):
                fail(f"{name} pair values disagree with the plain version "
                     f"on {label}")
            size = 4.0 if f32 else 8.0
            row = dict(ms=cuda_ms(call, 50), graph_ms=graph_ms(call),
                       plain_ms=cuda_ms(lambda: schur.psd_pair_values_plain(
                           W, *args), 10), key=key,
                       max_abs_err=float(err.max()), pairs=n)
            row["bound_ms"], row["bound_by"] = bound_ms(
                size * (2 * n + k * d * d + G * pad2)
                + 8.0 * (2 * n + 2 * G * pad2 + G),
                2.0 * n * pad2 + n, PEAK_F32_PER_S if f32 else
                PEAK_F64_PER_S)
            desc = f"{label} pairs (bucket {bi}: k={k} d={d} G={G} " \
                f"pad2={pad2})"
            print(f"K2 {name} {desc}: " + json.dumps(row), flush=True)
            krow = next(r for r in rows if r["name"] == name)
            krow["shapes"][desc] = row
            krow["max_abs_err"] = max(krow["max_abs_err"], float(err.max()))


# --------------------------------------------------------------------------
# path phase
# --------------------------------------------------------------------------


def with_zero_row(ex):
    """ex with one all-zero constraint appended (b = 0): redundant, so the
    optimum is unchanged, but A H A' is singular."""
    import scipy.sparse as sp

    At = sp.hstack([sp.csc_matrix(ex.At),
                    sp.csc_matrix((ex.At.shape[0], 1))]).tocsc()
    return ex._replace(name=ex.name + "+zero-row", At=At,
                       b=np.concatenate([ex.b, [0.0]]))


def run_example(ex, gate: bool, pars=None):
    import sedumi_tpu_torch as st
    from sedumi_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    x, y, info = st.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0, **(pars or {})},
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    cx = float(np.real(np.vdot(ex.c, x)))
    by = float(np.real(np.vdot(ex.b, y)))
    rel = max(abs(cx - ex.optval), abs(by - ex.optval)) / abs(ex.optval)
    counts = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    counts = {k: v for k, v in counts.items() if v}
    label = ex.name + (f" {json.dumps(pars)}" if pars else "")
    print(f"{label}: iter={info['iter']} cx={cx!r} by={by!r} "
          f"rel={rel:.3e} pinf={info['pinf']} dinf={info['dinf']} "
          f"numerr={info['numerr']} wall={wall:.2f}s "
          f"phases={json.dumps(info['phases'])} launches={counts}",
          flush=True)
    finite = bool(np.all(np.isfinite(x)) and np.all(np.isfinite(y)))
    if not finite:
        fail(f"{label}: non-finite solution")
    if gate and not (rel <= 1e-6 and info["pinf"] == 0
                     and info["dinf"] == 0 and info["numerr"] < 2):
        fail(f"{label}: reference gate not met")
    return counts, dict(info, cx=cx, rel=rel)


# Where arch0 and control07 land in f64 with the K6/K5 composition
# (PERF.md section 5): rel, the iterations of each phase; pinf = dinf =
# numerr = 0.  What the fused dd_chol_solve could move is held exactly by
# check_dd64_twins; this gate on the main path's own runs allows only the
# run noise of the f64 phase, whose Schur sums (index_add_'s atomics)
# round differently from run to run.  Of 40 arch0 solves of PR 10's
# build (the K6/K5 composition) and of this one, in turns in one process
# (parent_bench.py --cases solves --problems arch0 --repeat 5), each
# build landed once at dd64 7 and rel 3.18e-7, the others at f64 44 /
# dd64 3 and rel 2.349e-7 to 2.376e-7; chip_smoke.py's own runs once at
# f64 45 / dd64 7 and rel 4.823e-7 (2.03x; PERF.md section 6, NVIDIA H100
# 80GB HBM3, 700 W).  So: f64 iterations within 1 of these, dd64 within
# 4, rel within 2.5x.
DD64_LANDINGS = {"arch0": (2.375e-07, {"f64": 44, "dd64": 3}),
                 "control07": (1.285e-06, {"f64": 30, "dd64": 11})}
DD64_SLACK = {"f64": 1, "dd64": 4}
# Where control07 lands with 'mixed': with K1-f32's earlier order (a warp
# a row, lanes strided over the columns) at f32 17 / host64 30 / dd64 11,
# rel 1.285e-6, numerr 0, in every paired solve.  K1-f32's order picks
# the f32 phase's exit: other thread counts end it at f32 12-15 and take
# a hybrid phase to numerr 1 (PERF.md section 6).  This gate holds the
# main path to the first landing: the same phases, f32 within 2
# iterations, host64 within 1, dd64 within 4.
MIXED_LANDINGS = {"control07": (1.285e-06, {"f32": 17, "host64": 30,
                                            "dd64": 11})}
MIXED_SLACK = {"f32": 2, "host64": 1, "dd64": 4}


def check_landing(label, info, rel0, phases0, slack):
    """`label` landed at rel <= 2.5 rel0, pinf = dinf = numerr = 0, with
    the phases of `phases0`, each within its `slack` of iterations."""
    iters = {k: v["iters"] for k, v in info["phases"].items()}
    rel = info["rel"]
    if not (rel <= 2.5 * rel0 and info["pinf"] == 0 and info["dinf"] == 0
            and info["numerr"] == 0 and iters.keys() == phases0.keys()
            and all(abs(iters[k] - v) <= slack[k]
                    for k, v in phases0.items())):
        fail(f"{label} landed at rel={rel:.3e} numerr={info['numerr']} "
             f"with {iters}, not near rel={rel0:.3e} with {phases0}")


def check_dd64_landing(name, counts, info, dd_kernels):
    """`name` entered dd64, launched every dd64 kernel (the fused solve
    among them) and landed as in DD64_LANDINGS."""
    if "dd64" not in info["phases"]:
        fail(f"{name} never entered the dd64 phase")
    if any(counts.get(k, 0) == 0 for k in dd_kernels):
        fail(f"{name}: a dd64 kernel never ran in its solve")
    check_landing(name, info, *DD64_LANDINGS[name], DD64_SLACK)


def check_dd64_twins(names):
    """The fused dd_chol_solve moves no landing.  With deterministic
    algorithms (index_add_ in order, as tests/test_torch_cuda.py::
    test_arch0_witness runs), each of `names` is solved as the main path
    solves it and again with ddlinalg.dd_chol_solve_panels, the K6/K5
    composition, in place of the fused solve: x and y must agree bit for
    bit, and with them the phases' iterations and rel.  Prints a line per
    problem (iterations, rel, each run's wall)."""
    import sedumi_tpu_torch as st
    from sedumi_tpu_torch import ddlinalg as dd
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.examples import load_example

    fused = dd.dd_chol_solve
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name in names:
                ex = load_example(name)
                runs = {}
                for who, solve in (("fused", fused),
                                   ("panels", dd.dd_chol_solve_panels)):
                    dd.dd_chol_solve = solve
                    n0 = kernels.LAUNCHES["dd_chol_solve"]
                    torch.cuda.synchronize()
                    t0 = time.time()
                    x, y, info = st.sedumi(ex.At, ex.b, ex.c, ex.K,
                                           {"fid": 0}, device="cuda")
                    torch.cuda.synchronize()
                    cx = float(np.real(np.vdot(ex.c, x)))
                    by = float(np.real(np.vdot(ex.b, y)))
                    runs[who] = dict(
                        x=x, y=y, wall_s=time.time() - t0,
                        launches=kernels.LAUNCHES["dd_chol_solve"] - n0,
                        iters={k: v["iters"]
                               for k, v in info["phases"].items()},
                        rel=max(abs(cx - ex.optval), abs(by - ex.optval))
                        / abs(ex.optval))
                f, p = runs["fused"], runs["panels"]
                print(f"{name} deterministic: " + json.dumps(
                    {who: {k: v for k, v in r.items() if k not in ("x", "y")}
                     for who, r in runs.items()}), flush=True)
                if f["launches"] == 0 or p["launches"] != 0 \
                        or "dd64" not in f["iters"]:
                    fail(f"{name} deterministic: the fused solve ran "
                         f"{f['launches']} / {p['launches']} times, or "
                         f"dd64 was never entered")
                if not (np.array_equal(f["x"], p["x"])
                        and np.array_equal(f["y"], p["y"])
                        and f["iters"] == p["iters"]
                        and f["rel"] == p["rel"]):
                    fail(f"{name} deterministic: the fused solve landed at "
                         f"{f['iters']} rel={f['rel']!r}, the composition "
                         f"at {p['iters']} rel={p['rel']!r}")
    finally:
        dd.dd_chol_solve = fused
        torch.use_deterministic_algorithms(False)


# The mixed-ladder path's dense SOCP: eight Lorentz cones of order 50 and
# m = 120 (nb's scale), A 80% dense.  Of the bundled examples none takes
# the double-float operator in the reference's ladder: nb, whose A is
# dense, rejects an f32 direction before real progress, so its f32
# iterates are discarded and the hybrid rung skipped (reference
# solver.py:855-875), and the others' A are under 2% dense.  This instance
# enters the hybrid phase in the reference and in the port on a CPU; where
# the f32 phase ends moves with the f32 summation order (reference: f32 7,
# a rejected hybrid step, host64 9; port: f32 5, hybrid 2, host64 7).
SOCP_DENSE = ({"q": [50] * 8}, 120, 7)
# The reference's e2e ladder instance (tests/test_hybrid.py and the port's
# tests/test_torch_precision.py): LP, two Lorentz cones and PSD blocks of
# orders 8 and 6, which the data layer packs into one superblock of order
# 64, m = 30.  The reference lands it with 'mixed' on a CPU at c'x
# 300.4585009045144 (f32 5, host64 9, dd64 2; numerr 0).
E2E_LADDER = ({"l": 8, "q": [5, 4], "s": [8, 6]}, 30, 11)


def run_mixed_generated(label, problem):
    """A generated problem with pars.dtype='mixed' against its f64 solve:
    the gate of the reference's test_mixed_ladder_with_df_operator_e2e
    (pinf = dinf = 0, numerr = 0, c'x within 1e-6 (1 + |c'x|))."""
    import sedumi_tpu_torch as st
    from sedumi_tpu_torch import kernels

    K, m, seed = problem
    At, b, c, _ = feasible_problem(K, m, seed=seed)
    x64, _, _ = st.sedumi(At, b, c, K, {"fid": 0}, device="cuda")
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    x, y, info = st.sedumi(At, b, c, K, {"fid": 0, "dtype": "mixed"},
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    cx64, cx = float(c @ x64), float(c @ x)
    rel = abs(cx - cx64) / (1.0 + abs(cx64))
    print(f"{label} {{\"dtype\": \"mixed\"}}: "
          f"iter={info['iter']} cx={cx!r} cx_f64={cx64!r} rel={rel:.3e} "
          f"pinf={info['pinf']} dinf={info['dinf']} "
          f"numerr={info['numerr']} wall={wall:.2f}s "
          f"phases={json.dumps(info['phases'])} "
          f"launches={ {k: v for k, v in counts.items() if v} }", flush=True)
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        fail(f"{label}: non-finite solution")
    if not (info["pinf"] == 0 and info["dinf"] == 0 and info["numerr"] == 0
            and rel <= 1e-6):
        fail(f"{label}: the reference test's gate not met")
    return counts


# The sparse problems: copies of the generators of
# tests/test_sparse_engine.py (which imports the reference package), each
# drawn from a fresh numpy.random.default_rng(12345) as tests/conftest.py
# seeds them.


def random_sparse_lp(m, n_extra, rng, density=3, dense_cols=0):
    """Feasible sparse LP: n = m + n_extra variables, ~density nonzeros per
    column, dense_cols columns hitting half the constraints."""
    import scipy.sparse as sp

    n = m + n_extra
    perm = rng.permutation(m)
    rows, cols, vals = [perm], [np.arange(m)], [rng.random(m) + 0.5]
    for j in range(m, n):
        k = rng.integers(1, density + 1)
        rows.append(rng.choice(m, size=k, replace=False))
        cols.append(np.full(k, j))
        vals.append(rng.standard_normal(k))
    for j in range(dense_cols):
        r = rng.choice(m, size=m // 2, replace=False)
        rows.append(r)
        cols.append(np.full(r.size, j + m))
        vals.append(rng.standard_normal(r.size) * 0.3)
    A = sp.csc_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(m, n))
    x0 = rng.random(n) + 0.5
    b = A @ x0
    y0 = rng.standard_normal(m) * 0.1
    c = A.T @ y0 + rng.random(n) + 0.5
    return A, b, c, {"l": n}


def random_sparse_sdp(m, nb, d, rng, touch=2):
    """Feasible sparse SDP: nb PSD blocks of order d, each constraint
    touching `touch` blocks with a few symmetric entries."""
    import scipy.sparse as sp

    rows, cols, vals = [], [], []
    for i in range(m):
        for bk in rng.choice(nb, size=touch, replace=False):
            p = int(rng.integers(0, d))
            q = int(rng.integers(0, d))
            v = float(rng.standard_normal())
            base = bk * d * d
            ent = {(p, q): 0.5 * v, (q, p): 0.5 * v} if p != q \
                else {(p, p): v}
            dg = int(rng.integers(0, d))
            ent[(dg, dg)] = ent.get((dg, dg), 0.0) + float(
                rng.standard_normal())
            for (a, bq), vv in ent.items():
                rows.append(i)
                cols.append(base + a * d + bq)
                vals.append(vv)
    A = sp.csc_matrix((vals, (rows, cols)), shape=(m, nb * d * d))
    b = A @ np.tile(np.eye(d).ravel(), nb)
    c = A.T @ (rng.standard_normal(m) * 0.1) \
        + np.tile((np.eye(d) * 1.5).ravel(), nb)
    return A, b, c, {"s": [d] * nb}


def sparse_socp(rng, m=850, ncones=60):
    """test_sparse_socp_with_cones's problem: a sparse LP plus `ncones`
    Lorentz cones of dimension 3, each touching 3 random constraints."""
    import scipy.sparse as sp

    A, _, _, _ = random_sparse_lp(m, 100, rng)
    n = A.shape[1]
    qdims = [3] * ncones
    rows, cols, vals = [], [], []
    off = 0
    for d in qdims:
        r = rng.choice(m, size=3, replace=False)
        for j in range(d):
            rows.append(r)
            cols.append(np.full(r.size, n + off + j))
            vals.append(rng.standard_normal(r.size) * 0.2)
        off += d
    Aq = sp.lil_matrix(sp.csc_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m, n + sum(qdims))))
    Aq[:, :n] = A
    Aq = sp.csc_matrix(Aq)
    xq, zq = np.zeros(sum(qdims)), np.zeros(sum(qdims))
    o = 0
    for d in qdims:
        xq[o] = 2.0
        xq[o + 1:o + d] = rng.standard_normal(d - 1) * 0.3
        o += d
    bq = Aq @ np.concatenate([rng.random(n) + 0.5, xq])
    o = 0
    for d in qdims:
        zq[o] = 1.5
        zq[o + 1:o + d] = rng.standard_normal(d - 1) * 0.2
        o += d
    cq = Aq.T @ (rng.standard_normal(m) * 0.1) + np.concatenate(
        [rng.random(n) + 0.5, zq])
    return Aq, bq, cq, {"l": n, "q": qdims}


# (name, generator, pars, gated): the problems of the reference's tests
# for the sparse path (tests/test_sparse_engine.py), all but the last on
# the automatic route.  The SDP runs at both of the reference's sizes.
# lp20k and sdp5k run without the terminal conic refinement (refine.py,
# host numpy with dense m x m face Grams), which would put this script
# past its time limit: at m = 5000 it took 660 s of a 764 s solve on the
# card's host, and with it lp20k had not returned after 1700 s there.
# Without it sdp5k's endgame lands at the gate (max(err) 3.2e-8 and
# 9.5e-8 in two card runs), so it runs ungated, as trto3 and OH do on the
# dense path, and the reference's gate holds on sdp1200.
SPARSE_SOLVES = [
    ("lp20k", lambda rng: random_sparse_lp(20000, 4000, rng),
     {"fid": 0, "optstep": 0, "refine": 0}, True),
    ("sdp5k", lambda rng: random_sparse_sdp(5000, 2500, 4, rng),
     {"fid": 0, "optstep": 0, "refine": 0}, False),
    ("sdp1200", lambda rng: random_sparse_sdp(1200, 600, 4, rng),
     {"fid": 0, "optstep": 0}, True),
    ("socp850", sparse_socp, {"fid": 0, "optstep": 0}, True),
    ("lp900+3dense", lambda rng: random_sparse_lp(900, 200, rng,
                                                  dense_cols=3),
     {"fid": 0, "sparse": 1, "optstep": 0}, True),
]


# The precision ladder on the sparse engine: the same problems and pars
# with pars.dtype='mixed' ([f32, hybrid, host64]; K8-f32 to K10-f32 in the
# f32 and hybrid phases), gated as in f64 but lp20k, whose f64 gate holds
# without the refinement in f64 only; sdp5k is left out (its host plan
# alone takes ~30 s).  Then socp850 with 'float32', ungated: f32 alone
# cannot reach 1e-7.
MIXED_SPARSE_SOLVES = [
    (name + " mixed", make, {**pars, "dtype": "mixed"}, name != "lp20k")
    for name, make, pars, _ in SPARSE_SOLVES if name != "sdp5k"] + [
    ("socp850 float32", sparse_socp,
     {"fid": 0, "optstep": 0, "dtype": "float32"}, False)]
TILE_F64 = ("tile_factor", "tile_update", "tile_solve")
TILE_F32 = ("tile_factor_f32", "tile_update_f32", "tile_solve_f32")


def run_sparse(name, make, pars, gate, plans, tiles=TILE_F64):
    """One sparse solve on the card.  The solver's route_engine is wrapped
    to time the host plan and keep it (for the kernel checks).  Every solve
    must take the sparse engine, finish with finite outputs and launch the
    tile kernels `tiles`; a gated one must also meet the reference's
    gate."""
    import sedumi_tpu_torch as st
    from sedumi_tpu_torch import kernels, solver

    A, b, c, K = make(np.random.default_rng(12345))
    route = solver.route_engine
    planned = {}

    def timed_route(*args):
        t = time.time()
        kind, plan = route(*args)
        planned.update(sec=time.time() - t, plan=plan)
        return kind, plan

    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    solver.route_engine = timed_route
    try:
        x, y, info = st.sedumi(A, b, c, K, pars, device="cuda")
    finally:
        solver.route_engine = route
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    meta = planned["plan"][1] if planned.get("plan") else {}
    res = float(np.linalg.norm(A @ x - b) / (1.0 + np.abs(b).max()))
    print(f"{name}: m={A.shape[0]} n={A.shape[1]} "
          f"engine={info['lin_engine']} plan={planned.get('sec', 0.0):.2f}s "
          f"(ntc={meta.get('ntc')} levels={meta.get('nlev')} "
          f"Kd={meta.get('Kd')} ADA density={meta.get('ada_density', 0):.4f}) "
          f"iter={info['iter']} cx={float(c @ x)!r} "
          f"max(err)={max(info['err']):.3e} |Ax-b|={res:.3e} "
          f"pinf={info['pinf']} dinf={info['dinf']} numerr={info['numerr']} "
          f"wall={wall:.2f}s phases={json.dumps(info['phases'])} "
          f"launches={counts}", flush=True)
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        fail(f"{name}: non-finite solution")
    if info["lin_engine"] != "sparse":
        fail(f"{name}: the sparse engine was not taken")
    if gate and not (info["pinf"] == 0 and info["dinf"] == 0
                     and max(info["err"]) < 1e-7):
        fail(f"{name}: the reference's sparse-path gate not met")
    if any(counts[k] == 0 for k in tiles):
        fail(f"{name}: a tile-Cholesky kernel never ran in its solve")
    plans[name] = planned["plan"]
    return counts, info


# The mesh path (pars.mesh_shape), SPMD on one card: run_spmd spawns one
# process per mesh position, all on cuda:0 under gloo (NCCL refuses two
# ranks on one card).  OH at full size with {"panels": 2} (bs 128, mp
# 1024) and nb with {"hosts": 2, "panels": 2} (formation split over
# "hosts", panels of bs 32 on "panels"), then nb on that mesh under
# 'mixed': the mesh's ladder [f32, hybrid, host64] (no dd64), its f32
# phase on K14-f32/K15-f32.
# (example, mesh shape, ranks, gate, the pars of each solve of the spawn):
# OH is held to the unsharded solve's c'x, nb to the published optimum
MESH_SOLVES = [("OH_2Pi_STO-6GN9r12g1T2", {"panels": 2}, 2, "unsharded",
                ({},)),
               ("nb", {"hosts": 2, "panels": 2}, 4, "published",
                ({}, {"dtype": "mixed"}))]
PANEL_KERNELS = ("dist_panel_chol", "dist_trisolve_fwd",
                 "dist_trisolve_bwd_contrib", "dist_trisolve_bwd_solve")
PANEL_KERNELS_F32 = tuple(k + "_f32" for k in PANEL_KERNELS)
OFF_MESH = ("ldl_masked", "ozaki_split", "dd_accumulate", "dd_gemv",
            "dd_chol_solve", "dd_panel_chol")


def run_mesh(name, shape, nprocs, cx_unsharded=None, pars_list=({},)):
    """Mesh solves of `name` on nprocs ranks of this card, one for each
    entry of pars_list, in one spawn (entry.rank_batch; each solve's
    launch counts are zeroed in every rank just before it).  In each,
    every rank must return the same x and launch K14 and K15; none may
    launch the dd64 kernels or K3 (dd64 is off under a mesh, and the
    panel engine has no LDL' fallback).  Under 'mixed' every rank must
    also take the f32 phase and launch K14-f32 and K15-f32, and no phase
    may be dd64.  OH is held to the unsharded solve's c'x within 1e-6
    (1 + |c'x|) with pinf = dinf = 0, numerr < 2; nb to the reference
    gate.  Prints, per rank, the wall, the collectives, their share of
    the wall and the bytes received in them (parallel.mesh.COMM), and the
    peak of allocated device memory over the solve.  Returns the launches
    summed over the ranks and the solves."""
    from sedumi_tpu_torch.examples import load_example
    from sedumi_tpu_torch.parallel import entry
    from sedumi_tpu_torch.parallel.launch import run_spmd

    ex = load_example(name)
    t0 = time.time()
    calls = [("rank_sedumi", (("example", name),
                              {"fid": 0, "mesh_shape": shape, **pars}))
             for pars in pars_list]
    batch = run_spmd(entry.rank_batch, nprocs, args=(calls, "cuda"),
                     device="cuda", timeout_s=600)
    spawn_wall = time.time() - t0
    total = {}
    for i, pars in enumerate(pars_list):
        res = [b[i] for b in batch]
        label = f"{name} {json.dumps(shape)}" \
            + (f" {json.dumps(pars)}" if pars else "")
        r0 = res[0]
        info = r0["info"]
        rel = max(abs(r0["cx"] - ex.optval), abs(r0["by"] - ex.optval)) \
            / abs(ex.optval)
        for r in res:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        share = [r["comm_s"] / r["wall"] for r in res]
        print(f"{label} on {nprocs} ranks: "
              f"iter={info['iter']} cx={r0['cx']!r} rel={rel:.3e} "
              f"pinf={info['pinf']} dinf={info['dinf']} "
              f"numerr={info['numerr']} wall={r0['wall']:.2f}s "
              f"(the spawn's {len(pars_list)} solve(s), spawn to results "
              f"{spawn_wall:.2f}s) phases="
              f"{json.dumps(r0['phases'])} phase walls per rank "
              f"{[r['phase_wall'] for r in res]} collectives per rank "
              f"{[r['comm_calls'] for r in res]}, share of the wall "
              f"{[round(s, 4) for s in share]}, bytes received in them "
              f"per rank {[r['comm_bytes'] for r in res]}, peak allocated "
              f"device memory per rank {[r['peak_bytes'] for r in res]} "
              f"launches per rank {[r['launches'] for r in res]}",
              flush=True)
        if not all(np.array_equal(r["x"], r0["x"]) and
                   np.array_equal(r["y"], r0["y"]) for r in res):
            fail(f"{label}: the ranks returned different solutions")
        if not (np.all(np.isfinite(r0["x"]))
                and np.all(np.isfinite(r0["y"]))):
            fail(f"{label}: non-finite solution on the mesh")
        for r in res:
            if any(r["launches"].get(k, 0) == 0 for k in PANEL_KERNELS):
                fail(f"{label}: K14/K15 did not launch on every rank")
            if any(r["launches"].get(k, 0) for k in OFF_MESH):
                fail(f"{label}: dd64 or K3 launched under a mesh")
            if pars.get("dtype") == "mixed" and (
                    any(r["launches"].get(k, 0) == 0
                        for k in PANEL_KERNELS_F32)
                    or "f32" not in r["phases"] or "dd64" in r["phases"]):
                fail(f"{label}: no f32 phase on K14-f32/K15-f32 on every "
                     f"rank, or a dd64 phase under a mesh")
        ok = info["pinf"] == 0 and info["dinf"] == 0 and info["numerr"] < 2
        if cx_unsharded is not None:
            ok = ok and abs(r0["cx"] - cx_unsharded) \
                <= 1e-6 * (1.0 + abs(cx_unsharded))
        else:
            ok = ok and rel <= 1e-6
        if not ok:
            fail(f"{label}: the mesh path's gate not met")
    return total


# pars.profile: the keys info["profile"] carries for each engine (the
# reference's profiling.profile_iteration / profile_sparse_iteration)
PROFILE_KEYS = {"dense": ("nt_scaling_ms", "schur_ms", "chol_ms",
                          "schur_tflops", "chol_tflops", "schur_flop_count",
                          "chol_flop_count"),
                "sparse": ("nt_scaling_ms", "prepare_ms", "solve_ms")}


def run_profile(label, At, b, c, K, pars, engine) -> dict:
    """One solve with pars.profile=1 on the card: its info["profile"]
    printed on a line of its own, every key of the engine's set present
    with a positive, finite value."""
    import sedumi_tpu_torch as st

    torch.cuda.synchronize()
    t0 = time.time()
    _, _, info = st.sedumi(At, b, c, K, {"fid": 0, "profile": 1, **pars},
                           device="cuda")
    torch.cuda.synchronize()
    prof = info.get("profile")
    print(f"profile {label}: {json.dumps(prof)} (engine "
          f"{info['lin_engine']}, phases "
          f"{json.dumps({k: v['iters'] for k, v in info['phases'].items()})}"
          f", wall {time.time() - t0:.2f}s)", flush=True)
    if info["lin_engine"] != engine or prof is None \
            or set(prof) != set(PROFILE_KEYS[engine]):
        fail(f"profile {label}: engine {info['lin_engine']}, keys "
             f"{sorted(prof or {})}, expected {engine}'s "
             f"{sorted(PROFILE_KEYS[engine])}")
    bad = [k for k, v in prof.items()
           if not (np.isfinite(v) and v > 0)]
    if bad:
        fail(f"profile {label}: not positive and finite: {bad}")
    return prof


def check_debug_twins(name: str) -> None:
    """pars.debug changes no value: with deterministic algorithms (as
    check_dd64_twins runs them) `name` is solved without and with
    pars.debug=1, and x, y and the phases must agree bit for bit."""
    import sedumi_tpu_torch as st
    from sedumi_tpu_torch.examples import load_example

    ex = load_example(name)
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for debug in (0, 1):
                torch.cuda.synchronize()
                t0 = time.time()
                x, y, info = st.sedumi(ex.At, ex.b, ex.c, ex.K,
                                       {"fid": 0, "debug": debug},
                                       device="cuda")
                torch.cuda.synchronize()
                runs[debug] = dict(x=x, y=y, wall_s=time.time() - t0,
                                   iters={k: v["iters"] for k, v
                                          in info["phases"].items()},
                                   numerr=info["numerr"])
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"{name} pars.debug twins (deterministic): " + json.dumps(
        {f"debug={d}": {k: v for k, v in r.items() if k not in ("x", "y")}
         for d, r in runs.items()}), flush=True)
    a, b = runs[0], runs[1]
    if not (np.array_equal(a["x"], b["x"]) and np.array_equal(a["y"], b["y"])
            and a["iters"] == b["iters"]):
        fail(f"{name}: pars.debug=1 changed the solve")


def run_cli(runs: list, here: str) -> list:
    """python -m sedumi_tpu_torch once for each argument list of `runs`,
    in subprocesses on the card started together (the checkout's root as
    their working directory): each must exit 0 with the JSON summary as
    its last line.  Returns the summaries, in order."""
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-m", "sedumi_tpu_torch",
                               *args], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=here)
             for args in runs]
    out = []
    try:
        for args, proc in zip(runs, procs):
            out.append(_cli_summary(args, proc, t0))
    finally:   # a failed run leaves no process behind
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _cli_summary(args: list, proc, t0: float) -> dict:
    """The JSON summary of one CLI subprocess of run_cli: exit code 0 and
    the reference CLI's keys, or the script fails."""
    stdout, stderr = proc.communicate(timeout=600)
    lines = stdout.strip().splitlines()
    print(f"python -m sedumi_tpu_torch {' '.join(args)}: exit "
          f"{proc.returncode} {time.time() - t0:.1f}s after the start, "
          f"last line {lines[-1] if lines else None}", flush=True)
    if proc.returncode != 0:
        fail(f"the CLI on {args} exited {proc.returncode}:\n"
             f"{stderr[-4000:]}")
    try:
        summary = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"the CLI on {args} printed no JSON summary last")
    if set(summary) != {"cx", "by", "iter", "pinf", "dinf", "numerr", "err",
                        "wallsec"}:
        fail(f"the CLI's JSON keys {sorted(summary)} are not the "
             f"reference CLI's")
    return summary


def check_cli(here: str) -> None:
    """The CLI on the card: arch0.mat, and arch0 (K.l + K.s) written to
    sparse SDPA by the port's write_sdpa and solved from the .dat-s.
    Both must pass the reference gate (rel <= 1e-6 of the published
    optimum on c'x and b'y, pinf = dinf = 0, numerr < 2) and land at the
    same c'x to the gate's resolution (2e-6 relative): write_sdpa writes
    F0 = -c, and read_sdpa reads c = -F0, so the two problems have one
    objective."""
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.examples import load_example
    from sedumi_tpu_torch.io_sdpa import write_sdpa

    ex = load_example("arch0")
    dat = kernels.BUILD_DIR / "arch0.dat-s"
    write_sdpa(str(dat), ex.At, ex.b, ex.c, ex.K)
    got = {}
    paths = {"arch0.mat": os.path.join("examples", "arch0.mat"),
             "arch0.dat-s": str(dat)}
    summaries = run_cli([[path, "--json"] for path in paths.values()], here)
    for label, r in zip(paths, summaries):
        rel = max(abs(r["cx"] - ex.optval), abs(r["by"] - ex.optval)) \
            / abs(ex.optval)
        print(f"CLI {label}: cx={r['cx']!r} by={r['by']!r} rel={rel:.3e} "
              f"iter={r['iter']} pinf={r['pinf']} dinf={r['dinf']} "
              f"numerr={r['numerr']} wallsec={r['wallsec']:.2f}", flush=True)
        if not (rel <= 1e-6 and r["pinf"] == 0 and r["dinf"] == 0
                and r["numerr"] < 2):
            fail(f"CLI {label}: reference gate not met")
        got[label] = r["cx"]
    a, b = got["arch0.mat"], got["arch0.dat-s"]
    if abs(a - b) > 2e-6 * abs(a):
        fail(f"the CLI landed arch0.mat at c'x={a!r} and its SDPA copy at "
             f"{b!r}")


def add_counts(total: dict) -> None:
    """Adds this path's launches (kernels.LAUNCHES, and K12's per variant,
    kernels.VARIANT_LAUNCHES) into `total`."""
    from sedumi_tpu_torch import kernels

    for counts in (kernels.LAUNCHES, kernels.VARIANT_LAUNCHES):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        sys.exit(1)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "tests"))   # panel_emulation
    from sedumi_tpu_torch import kernels
    from sedumi_tpu_torch.examples import load_example

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    times = kernels.build_all()
    print(f"built kernels in {time.time() - t0:.1f}s: "
          + ", ".join(f"{s} {t:.1f}s" for s, t in times.items()), flush=True)

    # f32 matrix products must run at full f32, never TF32
    print(f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}",
          flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmul is on: the f32 phases need full f32 products")

    gen = torch.Generator().manual_seed(20261016)
    rows = [check_dd_residual(dev, gen), check_psd_coo(dev, gen),
            check_ldl_masked(dev, gen), check_ozaki_split(dev, gen),
            check_dd_elem(dev, gen), check_dd_gemv(dev, gen),
            check_dd_chol_solve(dev, gen),
            check_dd_panel_chol(dev, gen), check_dd_residual_f32(dev, gen),
            check_psd_coo(dev, gen, torch.float32),
            check_ldl_masked(dev, gen, torch.float32)]
    rows += check_df_gemv(dev, gen)
    rows += check_jacobi(dev, gen)
    rows += check_panel_kernels(dev, gen)
    # K14-f32/K15-f32 on a generator of their own: the checks after them
    # draw what they drew before these builds existed
    rows += check_panel_kernels(dev, torch.Generator().manual_seed(20261018),
                                torch.float32)
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    plan = [("quantum", True), ("nb", True), ("arch0", True),
            ("control07", False), ("trto3", False),
            ("OH_2Pi_STO-6GN9r12g1T2", False)]
    dd_kernels = ("ozaki_split", "dd_accumulate", "dd_gemv", "dd_panel_chol",
                  "dd_chol_solve")
    landed = {}
    for name, gate in plan:
        counts, info = run_example(load_example(name), gate)
        landed[name] = info["cx"]
        if counts.get("dd_matvec_residual", 0) == 0:
            fail(f"{name}: the compensated-residual kernel never ran")
        if name == "arch0" and counts.get("psd_contrib_coo", 0) == 0:
            fail("arch0: the sparse PSD Schur kernel never ran")
        if name in DD64_LANDINGS:
            check_dd64_landing(name, counts, info, dd_kernels)
    counts, _ = run_example(with_zero_row(load_example("nb")), True)
    if counts.get("ldl_masked", 0) == 0:
        fail("nb+zero-row: the masked-LDL' fallback never ran")
    # launches per kernel build, and K12's per variant, over the paths
    total = {}
    add_counts(total)
    # the f64 phases take the library eigensolver, as the reference's
    # host phases do
    if any(total[k] for k in JACOBI_NAMES):
        fail("a Jacobi kernel launched on the dense f64 path")
    check_dd64_twins(DD64_LANDINGS)
    torch.cuda.empty_cache()

    # the mixed precision ladder, its counts zeroed just before and read
    # just after.  Gated where the reference package meets the gate with
    # 'mixed' on a CPU: quantum (f32 5, host64 64; rel 1.54e-9), nb (f32
    # 8, host64 16; rel 9.17e-8), arch0 (f32 13, host64 44, dd64 8; rel
    # 4.85e-7), nb+zero-row (as nb).  control07 (f32 15, hybrid 5, host64
    # 12, dd64 11) lands at rel 1.288e-6, numerr 1 there; here it is held
    # to its landing on the card (MIXED_LANDINGS).  trto3 is ungated, as
    # in f64.  The f32 and hybrid phases take the
    # Jacobi kernel K12-f32 (quantum's Hermitian bucket on its real
    # embedding); host64 and dd64 the library, and no f64 or complex
    # Jacobi build launches.
    kernels.reset_launch_counts()
    mixed = {"dtype": "mixed"}
    t_mixed = time.time()
    for name, gate in (("quantum", True), ("nb", True), ("arch0", True),
                       ("control07", False), ("nb+zero-row", True),
                       ("trto3", False)):
        ex = with_zero_row(load_example("nb")) if name == "nb+zero-row" \
            else load_example(name)
        counts, info = run_example(ex, gate, mixed)
        if name in MIXED_LANDINGS:
            check_landing(name + " 'mixed'", info, *MIXED_LANDINGS[name],
                          MIXED_SLACK)
        if "f32" not in info["phases"] \
                or counts.get("dd_matvec_residual_f32", 0) == 0:
            fail(f"{name}: the f32 phase or its K1-f32 residual never ran")
        if name == "arch0" and counts.get("psd_contrib_coo_f32", 0) == 0:
            fail("arch0: K2-f32 never formed the f32 Schur complement")
        if name == "nb+zero-row" and counts.get("ldl_masked_f32", 0) == 0:
            fail("nb+zero-row: the f32 masked-LDL' fallback never ran")
        if name in ("quantum", "arch0", "control07", "trto3") \
                and counts.get("jacobi_eigh_f32", 0) == 0:
            fail(f"{name}: the f32 Jacobi kernel never ran")
    counts = run_mixed_generated("socp-dense (q 8x50, m=120)", SOCP_DENSE)
    if counts["df_matvec"] == 0 or counts["df_vecmat"] == 0:
        fail("socp-dense: the double-float operator (K11) never ran")
    counts = run_mixed_generated("e2e ladder (l 8, q 5+4, s 8+6, m=30)",
                                 E2E_LADDER)
    if counts.get("jacobi_eigh_f32", 0) == 0:
        fail("e2e ladder: the f32 Jacobi kernel never ran")
    print(f"mixed-ladder path: {time.time() - t_mixed:.1f}s", flush=True)
    if any(kernels.LAUNCHES[k] for k in OFF_PATH):
        fail("an f64 or complex Jacobi build launched on the mixed path")
    add_counts(total)
    torch.cuda.empty_cache()

    # the sparse path, its counts zeroed just before and read just after
    kernels.reset_launch_counts()
    plans = {}
    for name, make, pars, gate in SPARSE_SOLVES:
        counts, _ = run_sparse(name, make, pars, gate, plans)
        if name.startswith("sdp") and counts["psd_contrib_coo"] == 0:
            fail(f"{name}: K2 never built the PSD groups in its solve")
        if name == "lp900+3dense" and counts["ldl_masked"] == 0:
            fail("lp900+3dense: K3 never factored the Woodbury capacitance")
        torch.cuda.empty_cache()
    if any(kernels.LAUNCHES[k] for k in JACOBI_NAMES):
        fail("a Jacobi kernel launched on the sparse f64 path")
    add_counts(total)

    # the mixed/f32 ladder on the sparse engine, its counts zeroed just
    # before and read just after: every solve takes K8-f32 to K10-f32 on
    # the sparse engine; sdp1200's f32 phase builds its PSD groups with
    # K2-f32 and scales its blocks with K12-f32, lp900+3dense factors its
    # capacitance with K3-f32
    kernels.reset_launch_counts()
    t_ms = time.time()
    for name, make, pars, gate in MIXED_SPARSE_SOLVES:
        counts, info = run_sparse(name, make, pars, gate, {}, TILE_F32)
        if "f32" not in info["phases"]:
            fail(f"{name}: the f32 phase never ran")
        if name.startswith("sdp") and (counts["psd_contrib_coo_f32"] == 0
                                       or counts["jacobi_eigh_f32"] == 0):
            fail(f"{name}: K2-f32 or K12-f32 never ran in its f32 phase")
        if name.startswith("lp900") and counts["ldl_masked_f32"] == 0:
            fail(f"{name}: K3-f32 never factored the capacitance")
        torch.cuda.empty_cache()
    print(f"mixed sparse path: {time.time() - t_ms:.1f}s", flush=True)
    if any(kernels.LAUNCHES[k] for k in OFF_PATH):
        fail("an f64 or complex Jacobi build launched on the mixed sparse "
             "path")
    add_counts(total)

    # the mesh path (pars.mesh_shape), its counts zeroed in every rank
    # just before its solve and read just after; this process launches
    # nothing meanwhile
    kernels.reset_launch_counts()
    t_mesh = time.time()
    for name, shape, nprocs, gate, pars_list in MESH_SOLVES:
        counts = run_mesh(name, shape, nprocs,
                          landed[name] if gate == "unsharded" else None,
                          pars_list)
        for k, v in counts.items():
            total[k] += v
    print(f"mesh path: {time.time() - t_mesh:.1f}s", flush=True)
    if any(kernels.LAUNCHES.values()):
        fail("the parent process launched a kernel during the mesh path")

    # pars.profile and pars.debug, their counts zeroed just before and read
    # just after: profiles of arch0 (dense, f64), arch0 'mixed' (the f32
    # bundle: its scaling runs K12-f32) and sdp1200 (sparse; without the
    # host refinement, which the profile does not time), then nb solved
    # with and without the sanitizer
    kernels.reset_launch_counts()
    t_pd = time.time()
    arch0 = load_example("arch0")
    sdp1200 = random_sparse_sdp(1200, 600, 4, np.random.default_rng(12345))
    run_profile("arch0", arch0.At, arch0.b, arch0.c, arch0.K, {}, "dense")
    run_profile("arch0 'mixed'", arch0.At, arch0.b, arch0.c, arch0.K,
                {"dtype": "mixed"}, "dense")
    run_profile("sdp1200", *sdp1200, {"optstep": 0, "refine": 0}, "sparse")
    if kernels.LAUNCHES["jacobi_eigh_f32"] == 0:
        fail("profile arch0 'mixed': the f32 scaling never ran K12-f32")
    check_debug_twins("nb")
    print(f"profile and debug: {time.time() - t_pd:.1f}s", flush=True)
    if any(kernels.LAUNCHES[k] for k in OFF_PATH):
        fail("an f64 or complex Jacobi build launched on the profile or "
             "debug solves")
    add_counts(total)
    torch.cuda.empty_cache()

    # the CLI, in subprocesses of its own (their launches are theirs)
    t_cli = time.time()
    check_cli(here)
    print(f"CLI: {time.time() - t_cli:.1f}s", flush=True)

    # the sparse engine's kernels at the plans' shapes
    rng = np.random.default_rng(20261016)
    check_psd_pairs(plans, dev, rng, rows)
    tile_plans = {k: plans[k] for k in ("lp20k", "sdp5k", "sdp1200")}
    rows += check_tile_kernels(tile_plans, dev, gen, rng)
    rows += check_tile_kernels(tile_plans, dev, gen, rng,
                               dtype=torch.float32)
    check_library_rows(dev, gen, rng, plans)
    print("K3, K12 and K13 launches per variant over the paths: "
          + json.dumps({k: v for k, v in total.items() if ":" in k}),
          flush=True)
    for row in rows:
        count = row.pop("count", row["name"])
        row["launches"] = total.get(count, 0)
        if row["name"].startswith(("psd_contrib_coo", "ldl_masked",
                                   "ozaki_split")):
            for shape in row["shapes"].values():   # launches per shape
                shape["launches"] = total.get(shape["key"], 0)
        if row["launches"] == 0 and count.split(":")[0] not in OFF_PATH:
            fail(f"kernel {row['name']} ({count}) never launched on the "
                 f"path")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # and, where a check gives them, its graph-replay and column-0 times
    extra = ("graph_ms", "library_graph_ms", "library", "column0_ms",
             "column0_graph_ms", "column0_bound_ms", "panels_ms",
             "panels_graph_ms", "shapes", "prepare_sites")
    print(json.dumps({"kernels": [
        {k: row[k] for k in keys + extra if k in keys or k in row}
        for row in rows]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
