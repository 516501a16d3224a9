"""sedumi_tpu_torch -- the symmetric-cone interior-point solver of sedumi_tpu
in PyTorch, for one NVIDIA H100.

`sedumi(A, b, c, K, pars, device="cuda")` keeps the reference package's
calling convention, pars names/defaults and info fields.  It runs the f64
precision mode with the dense Schur engine on the card, and the
double-double dd64 endgame phase where the reference admits it; the
compensated Schur-solve residual, the sparse PSD Schur formation, the
masked LDL' fallback and dd64's Ozaki split, dd accumulation, dd
matrix-vector product and dd panel Cholesky are hand-written CUDA kernels
(csrc/, built at first use by kernels.build_all), everything else is
PyTorch on library kernels.  The
CPU runs only when the caller passes device="cpu" (the tests do), with the
kernels' plain-PyTorch twins.

Importing the package has no side effects: no device, compiler or file
is touched.
"""

from __future__ import annotations

from .cones import ConeSpec
from .params import Pars
from .solver import sedumi
from .userapi import cellK, eigK, eyeK, mat, vec

__version__ = "0.1.0"

__all__ = ["sedumi", "Pars", "ConeSpec", "eigK", "eyeK", "cellK", "mat",
           "vec"]
