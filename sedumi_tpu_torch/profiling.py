"""Per-phase device timers and analytic flop counts for the hot path.

The port's counterpart of sedumi_tpu/profiling.py (reference analog: the
Pre/IPM/Post timings of sedumi.m:218-219).  With pars.profile=1 the solver
times the per-iteration hot phases once more on its final iterate: the NT
scaling (its batched eigh included), the Schur formation and the Cholesky
factorization (dense engine), or the tile engine's prepare and one
direction solve (sparse engine), and converts the Schur and Cholesky work
into TFLOP/s against analytic flop counts.  Each phase is called once to
warm up, then timed over three calls with time.perf_counter around a
fence: torch.cuda.synchronize on the card (every queued kernel finished),
nothing on the CPU, where a call returns finished.  The solve's own steps
are not touched.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from . import nt
from .chol import chol_factor
from .opA import CooAOp, DenseAOp
from .schur import build_schur


def _fence(device: torch.device) -> None:
    """Wait for the work queued on the card; nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device: torch.device, fn, repeats: int = 3):
    """(the last call's output, ms a call): one warm-up call, then
    `repeats` calls between fences."""
    out = fn()
    _fence(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    _fence(device)
    return out, (time.perf_counter() - t0) / repeats * 1e3


def schur_flops(aop) -> float:
    """Analytic flop count of one augmented-Schur formation M=[A;c']H[A;c']'.

    Dense LP/SOC GEMMs + per-PSD-bucket cost of the representation actually
    used (dense congruence+BB' vs sparse outer-product formation).  An
    operator split over a device mesh (parallel.mesh.ShardedAOp) counts as
    the whole operator it splits."""
    aop = getattr(aop, "full", aop)
    mp1 = aop.m + 1
    fl = 0.0
    if aop.Al.shape[1]:
        fl += 2.0 * mp1 * mp1 * aop.Al.shape[1]
    for (c, d) in aop.q_shapes:
        fl += 2.0 * mp1 * c * d          # u = <Aq, wb>
        fl += 2.0 * mp1 * mp1 * c        # rank-1 GEMM
        fl += 2.0 * mp1 * mp1 * c * d    # J-part GEMM
    if isinstance(aop, CooAOp):
        for rep, k, d, G, pad2, T in aop.s_meta:
            if rep == "coo":
                fl += 2.0 * G * pad2 * d * d + 2.0 * T * mp1
            else:
                fl += 4.0 * mp1 * k * d**3 + 2.0 * mp1 * mp1 * k * d * d
    elif isinstance(aop, DenseAOp):
        for (k, d) in aop.s_shapes:
            fl += 4.0 * mp1 * k * d**3 + 2.0 * mp1 * mp1 * k * d * d
    return fl


def chol_flops(m: int) -> float:
    """Dense Cholesky of the m x m Schur complement."""
    return m**3 / 3.0


def eigh_flops(layout) -> float:
    """Batched symmetric eigendecomposition cost of one NT scaling
    (~9 n^3 per dense eigh with eigenvectors, standard LAPACK estimate)."""
    fl = 0.0
    for b in layout.s_buckets:
        fl += 9.0 * b.count * b.dim**3
        fl += 2.0 * b.count * b.dim**3   # Cholesky of Z + congruences
    return fl


def profile_iteration(aop, state, reg) -> dict[str, Any]:
    """Measure the hot phases on the current iterate (device-fenced).

    Returns a dict with per-phase milliseconds and achieved TFLOP/s for the
    Schur formation and Cholesky factorization."""
    m = aop.m
    dev = state.tau.device
    S, t_scal = _timed(dev, lambda: nt.compute_scaling(state.x, state.z))
    M, t_schur = _timed(dev, lambda: build_schur(aop, S))
    _, t_chol = _timed(dev, lambda: chol_factor(M[:m, :m], float(reg)))

    fl_schur = schur_flops(aop)
    fl_chol = chol_flops(m)
    return {
        "nt_scaling_ms": round(t_scal, 3),
        "schur_ms": round(t_schur, 3),
        "chol_ms": round(t_chol, 3),
        "schur_tflops": round(fl_schur / (t_schur * 1e-3) / 1e12, 4),
        "chol_tflops": round(fl_chol / (t_chol * 1e-3) / 1e12, 4),
        "schur_flop_count": fl_schur,
        "chol_flop_count": fl_chol,
    }


def bench_large_block(d: int = 1024, k: int = 1, m: int = 512,
                      dtype=torch.float32, repeats: int = 3,
                      device="cuda") -> dict[str, Any]:
    """Synthetic large-block Schur + Cholesky throughput probe.

    One congruence+BB' Schur formation over a [m+1, k, d, d] constraint
    bucket and one dense Cholesky of the m x m result (plus m I), with
    data from a seeded numpy generator.  Returns achieved TFLOP/s against
    analytic flop counts."""
    import numpy as np

    from .schur import _psd_contrib

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    mp1 = m + 1
    as_ = torch.as_tensor(rng.normal(size=(mp1, k * d * d)), dtype=dtype,
                          device=dev)
    r = torch.as_tensor(np.eye(d)[None] + 0.1 * rng.normal(size=(k, d, d)),
                        dtype=dtype, device=dev)
    eye_m = float(m) * torch.eye(m, dtype=dtype, device=dev)

    M, t_schur = _timed(dev, lambda: _psd_contrib(as_, k, d, r), repeats)
    _, t_chol = _timed(dev, lambda: chol_factor(M[:m, :m] + eye_m, 0.0),
                       repeats)
    fl_schur = 4.0 * mp1 * k * float(d) ** 3 + 2.0 * mp1 * mp1 * k * d * d
    fl_chol = chol_flops(m)
    return {
        "d": d, "k": k, "m": m, "dtype": str(dtype).replace("torch.", ""),
        "schur_ms": round(t_schur, 3),
        "chol_ms": round(t_chol, 3),
        "schur_tflops": round(fl_schur / (t_schur * 1e-3) / 1e12, 2),
        "chol_tflops": round(fl_chol / (t_chol * 1e-3) / 1e12, 2),
    }


def profile_sparse_iteration(engine, aop, state, reg) -> dict[str, Any]:
    """Per-phase device timing for the tile-supernodal sparse engine
    (sparse_engine.TileSchurEngine): NT scaling, prepare (sparse ADA
    assembly + level-scheduled tile factorization + dense-column Woodbury),
    and one direction solve (tile triangular solves + PCG refinement).
    Complements profile_iteration (dense engine); same pars.profile=1
    contract.  As the reference does, prepare is timed alone and prepare
    plus solve together, and solve_ms is the difference."""
    dev = state.tau.device
    S, t_scal = _timed(dev, lambda: nt.compute_scaling(state.x, state.z))
    _, t_prep = _timed(dev, lambda: engine.prepare(aop, S, float(reg)))
    rhs = torch.ones(aop.m, dtype=state.tau.dtype, device=dev)

    def prep_solve():
        ctx, *_ = engine.prepare(aop, S, float(reg))
        return engine.solve(ctx, rhs)

    _, t_both = _timed(dev, prep_solve)
    return {
        "nt_scaling_ms": round(t_scal, 3),
        "prepare_ms": round(t_prep, 3),    # ADA assembly + tile factor
        "solve_ms": round(max(t_both - t_prep, 0.0), 3),  # tri solves + PCG
    }
