"""Solver parameters.

Typed equivalent of the reference's ``pars`` struct with identical field
names and defaults (reference: checkpars.m:40-193), so that existing SeDuMi
call sites translate directly.  Unknown keys are rejected loudly instead of
being silently ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass
class CholPars:
    """Cholesky robustness controls (reference: checkpars.m:145-168).

    skip      -- 1: skip unstable pivots (repaired by PCG), 0: keep them.
    abstol    -- absolute pivot floor.
    canceltol -- relative cancellation tolerance: a computed pivot smaller
                 than canceltol * (accumulated magnitude) is considered
                 cancelled and gets a diagonal add (blkchol.c:176-184).
    maxu      -- max allowed |L(i,j)| growth before a pivot is skipped.
    maxuden   -- like maxu for the dense-column product-form factors.
    """

    skip: int = 1
    abstol: float = 1e-20
    canceltol: float = 1e-12
    maxu: float = 5e5
    maxuden: float = 5e2


@dataclass
class CgPars:
    """Preconditioned-conjugate-gradient controls (checkpars.m:170-193).

    qprec   -- 1: accumulate the CG solution in double-double (compensated)
               arithmetic (reference: loopPcg.m:100-108 + quadadd.c).
    restol  -- relative residual tolerance for accepting a CG refinement.
    stagtol -- stagnation tolerance.
    maxiter -- max CG iterations per solve.
    refine  -- number of refinement restarts.
    """

    qprec: int = 1
    restol: float = 5e-3
    stagtol: float = 5e-14
    maxiter: int = 49
    refine: int = 1


@dataclass
class Pars:
    """All solver parameters; field names/defaults mirror checkpars.m.

    Algorithm selection (checkpars.m:40-75):
      alg     -- 0: no corrector; 1: v-linearized corrector; 2: xz-corrector
                 (Mehrotra-style second order, default).
      beta    -- wide-region neighborhood parameter in [0.1, 0.9].
      theta   -- wide-region parameter in [0.01, 1.0] (1.0 when alg=0).
      stepdif -- primal/dual step-length differentiation: 0 off, 1 on,
                 2 adaptive (default).
      w       -- weights (len 2) for primal vs dual merit in step diff.

    Preprocessing:
      free    -- free variables: 0 split into x+ - x-, 1 embed in a Lorentz
                 cone (default; pretransfo.m:339-387).
      sdp     -- enable SDP preprocessing (diag-block detection).

    Initialization:
      mu      -- initial centrality scale factor (sdinit.m:42-105).

    Stopping / reporting:
      fid     -- 0: silent; nonzero: print progress (my_fprintf.m).
      eps     -- accuracy target (default 1e-8).
      bigeps  -- degraded-accuracy threshold separating numerr=1 from 2.
      maxiter -- IPM iteration cap (default 150).

    Diagnostics: vplot, stopat (callback hook at given iterations),
      errors (compute/print DIMACS errors), prep (print preprocessing info).

    Dense columns: denq (quantile), denf (multiplier) — getdense.m:41-99.

    TPU-specific extensions (no reference analog):
      dtype        -- numeric dtype of the IPM core ("auto"/"float64"/
                      "float32"); "auto" picks the widest dtype the backend
                      actually computes at (fp.backend_has_f64).
      schur_dtype  -- dtype used to *form/factor* the Schur complement; if
                      lower precision than `dtype`, the factor acts as a PCG
                      preconditioner and solves are refined matrix-free in
                      `dtype` (TPU mixed-precision path).
      mesh_shape   -- optional dict axis->size for multi-chip sharding.
      checkpoint_every / checkpoint_path -- iterate snapshotting.
    """

    alg: int = 2
    beta: float = 0.5
    theta: float = 0.25
    stepdif: int = 2
    w: tuple[float, float] = (1.0, 1.0)
    free: int = 1
    sdp: int = 1
    mu: float = 1.0
    fid: int = 1
    eps: float = 1e-8
    bigeps: float = 1e-3
    maxiter: int = 150
    vplot: int = 0
    stopat: int = -1
    errors: int = 1
    prep: int = 1
    denq: float = 0.75
    denf: float = 10.0
    sparse: int = -1      # linear-system backend routing: -1 auto (sparse
    #                       tile Cholesky for large-m LP/SOC with sparse ADA,
    #                       dense otherwise; symbchol.m:71-78 crossover role),
    #                       0 force dense, 1 force sparse
    wr: int = 1           # 1 (default, matching the reference's wide-region
                          # method): Sturm-Zhang neighborhood acceptance
                          # (widelen/iswnbr) + trydif re-test.  0: plain
                          # fraction-to-boundary — cheaper per iteration but
                          # measurably insufficient on hard instances
                          # (trto3: stalls at rel ~3e-6/3e-4; passes 1e-6
                          # objective parity with wr=1)
    # numtol/bignumtol/numlvl are accepted for pars compatibility; they are
    # vestigial IN THE REFERENCE ITSELF: defined with defaults at
    # checkpars.m:135-142 but consumed by no other reference file (verified
    # by grep over the reference .m sources) — so there is no behavior to mirror.
    numtol: float = 5e-7
    bignumtol: float = 0.9
    numlvl: int = 0
    chol: CholPars = field(default_factory=CholPars)
    cg: CgPars = field(default_factory=CgPars)
    # --- TPU-native extensions ---
    dtype: str = "auto"   # 'auto': f64 where the backend really computes
    #                       f64 (CPU), else f32 (TPU); 'mixed' forces the
    #                       f32 -> hybrid(double-float) -> host-f64 phase
    #                       ladder on any backend — see fp.precision_mode
    schur_dtype: str | None = None
    optstep: int = 1      # pure-LP Mehrotra-Ye finite-termination projection
    refine: int = 1       # terminal conic refinement: optimal-face
    #                       projection (optstep.m:42-138 generalized from LP
    #                       to the full l/q/s family, refine.conic_refine).
    #                       Kept only when it verifiably improves the
    #                       measured solution grade r0.  0 disables.
    pack_dim: int = 128   # pack PSD blocks of order < pack_dim into
    #                       block-diagonal superblocks of order <= pack_dim
    #                       (exact reformulation; 0 disables — cones.pack_plan)
    pack_round: int = 64  # round superblock orders up to this multiple with
    #                       barrier padding (collapses compiled-kernel count;
    #                       0 disables — transform.pretransfo)
    mcc: int = 2          # Gondzio multiple-centrality-corrector rounds per
    #                       iteration (new vs the reference; Gondzio '96
    #                       lifted to the Jordan frame).  Each round reuses
    #                       the iteration's factorization to project
    #                       complementarity OUTLIER pairs back toward mu —
    #                       the observed mid-phase pattern on control07 is a
    #                       tightly centered bulk with one pair crashing to
    #                       0.02 mu, each crash costing a centering
    #                       iteration.  0 disables.
    mesh_shape: Mapping[str, int] | None = None
    checkpoint_every: int = 0
    checkpoint_path: str | None = None
    resume: int = 0       # 1: resume from checkpoint_path if it exists
    profile: int = 0      # 1: measure per-phase device timings + TFLOP/s
    #                       (profiling.profile_iteration) into info['profile']
    debug: int = 0        # 1: numerical sanitizer — every IPM step's
    #                       outputs are leaf-checked on the host and the
    #                       FIRST non-finite leaf raises by NAME instead
    #                       of entering the recovery ladder; debugging only

    def __post_init__(self) -> None:
        if isinstance(self.chol, Mapping):
            self.chol = CholPars(**dict(self.chol))
        if isinstance(self.cg, Mapping):
            self.cg = CgPars(**dict(self.cg))
        if self.alg not in (0, 1, 2):
            self.alg = 2
        self.beta = min(0.9, max(0.1, self.beta))
        if self.alg == 0:
            # Pure centering follows the central path exactly (theta=1).
            self.theta = 1.0
        self.theta = min(1.0, max(0.01, self.theta))
        w = tuple(float(max(wi, 1e-8)) for wi in self.w)
        if len(w) != 2:
            w = (1.0, 1.0)
        self.w = w
        if self.mu <= 0:
            self.mu = 1.0

    @classmethod
    def make(cls, pars: "Pars | Mapping[str, Any] | None") -> "Pars":
        """Build a Pars from None, an existing Pars, or a dict.

        Dicts may use nested dicts for 'chol'/'cg' (reference-style
        ``pars.chol.maxu`` etc.).
        """
        if pars is None:
            return cls()
        if isinstance(pars, cls):
            return pars
        d = dict(pars)
        if "chol" in d and isinstance(d["chol"], Mapping):
            d["chol"] = CholPars(**dict(d["chol"]))
        if "cg" in d and isinstance(d["cg"], Mapping):
            d["cg"] = CgPars(**dict(d["cg"]))
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - valid
        if unknown:
            raise ValueError(f"unknown pars fields: {sorted(unknown)}")
        return cls(**d)
