"""sedumi_tpu_torch -- the symmetric-cone interior-point solver of sedumi_tpu
in PyTorch, for one NVIDIA H100.

`sedumi(A, b, c, K, pars, device="cuda")` keeps the reference package's
calling convention, pars names/defaults and info fields.  On the card it
runs the f64 precision mode ('auto') with the reference's [f64, dd64]
ladder, the mixed precision ladder (pars.dtype='mixed': f32 -> hybrid ->
host64 -> dd64) and the f32-only mode ('float32'), with the dense Schur
engine or, for large sparse problems, the sparse tile engine.  The
hand-written CUDA kernels (csrc/, built at first use by
kernels.build_all) are the compensated Schur-solve residual, the sparse
PSD Schur formation and the masked LDL' fallback (f64 and f32), dd64's
Ozaki split, dd accumulation, dd matrix-vector product and dd panel
Cholesky, the tile-supernodal Cholesky factor, update and solve, the
double-float operator products of the hybrid phase, and the batched
Jacobi eigensolvers (real and complex Hermitian), which every phase but
the f64 ones takes on the card, as the reference does on its
accelerator; everything else is PyTorch on library kernels.  The CPU
runs only when the caller passes device="cpu" (the tests do), with the
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
