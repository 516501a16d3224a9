"""Precision regime of the port.

The H100 (like the CPU) computes f64 natively, so 'auto' runs the solver
in the f64 mode that the reference runs on a CPU, with its dd64 endgame
rung (solver.py).  The reference's precision ladder runs when the caller
asks for it:

* 'mixed'   -- f32 iterations while they progress, then the hybrid phase
               (f64 state and residuals, f32 linear algebra), then host64
               (f64 on the same device) and dd64 (solver.py);
* 'float32' -- f32 only, with compensated refinement.

The Veltkamp splitting constant of the error-free TwoProd (pcg.two_prod,
which ddlinalg and df share) is 2^ceil(p/2) + 1 for the mantissa width p
of the dtype the operation rounds to.
"""

from __future__ import annotations

import numpy as np
import torch

_SPLIT_F32 = 4097.0          # 2^12 + 1, p = 24
_SPLIT_F64 = 134217729.0     # 2^27 + 1, p = 53


def backend_has_f64() -> bool:
    """True: the card and the CPU both compute f64 products at f64
    precision, so the reference's probe (which exists for TPU plugins
    that round f64 to f32) has nothing to find here."""
    return True


def torch_dtype(name) -> torch.dtype:
    """'float32'/'float64' (or a numpy/torch dtype) as a torch dtype; the
    solver computes in no other."""
    if isinstance(name, torch.dtype):
        return name
    dt = np.dtype(name)
    if dt not in (np.float32, np.float64):
        raise ValueError(f"dtype {name!r}: the solver computes in float32 "
                         "or float64")
    return torch.float32 if dt == np.float32 else torch.float64


def resolve_dtype(requested: str | None) -> torch.dtype:
    """Pars.dtype ('auto'/'float32'/'float64') as the IPM's base dtype."""
    if requested in (None, "auto"):
        return torch.float64
    return torch_dtype(requested)


def precision_mode(requested: str | None = "auto") -> str:
    """The precision regime the solver runs in (reference fp.py:68-86):
    'auto' and 'float64' give 'f64' (native f64 here), 'mixed' the full
    ladder, any other float dtype ('float32') 'f32'."""
    if requested == "mixed":
        return "mixed"
    if requested in (None, "auto"):
        return "f64"
    return "f64" if np.dtype(requested) == np.float64 else "f32"


def split_const(dtype=torch.float64) -> float:
    """Veltkamp constant of the precision `dtype` rounds to."""
    return _SPLIT_F32 if torch_dtype(dtype) == torch.float32 else _SPLIT_F64


def eps_for(dtype) -> float:
    """Unit roundoff of the arithmetic that runs on `dtype`."""
    return float(torch.finfo(torch_dtype(dtype)).eps)
