"""Dense symmetric linear algebra on library kernels (cuSOLVER on the card,
LAPACK on the CPU).

The reference dispatches eigh to a batched Jacobi solver (lax_eigh.py)
only because XLA:TPU compiles eigh slowly; on the CPU it takes LAPACK, so
the port's library eigh is that same path.  Eigenvalues come back in
ascending order.  Like jax.numpy.linalg, every routine symmetrizes its
input first ((A + A^H)/2), and a batch entry that cannot be factored
(cholesky: not positive definite; eigh: not finite) comes back NaN-filled
instead of raising.
"""

from __future__ import annotations

import torch


def _sym(A: torch.Tensor) -> torch.Tensor:
    return 0.5 * (A + A.transpose(-1, -2).conj())


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN-filled for batch entries that are not
    numerically positive definite."""
    L, info = torch.linalg.cholesky_ex(_sym(A))
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def _finite_or_eye(A: torch.Tensor):
    """(ok [...], A with its non-finite batch entries replaced by I)."""
    ok = torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return ok, torch.where(ok[..., None, None], A, eye)


def eigh(A: torch.Tensor):
    """(w, V) batched, ascending w."""
    ok, A = _finite_or_eye(_sym(A))
    w, V = torch.linalg.eigh(A)
    nan = float("nan")
    return (torch.where(ok[..., None], w, nan),
            torch.where(ok[..., None, None], V, nan))


def eigvalsh(A: torch.Tensor) -> torch.Tensor:
    ok, A = _finite_or_eye(_sym(A))
    return torch.where(ok[..., None], torch.linalg.eigvalsh(A), float("nan"))


def eigh_multi(mats):
    """eigh over a list of per-bucket [k_i, d_i, d_i] batches (real
    symmetric or complex Hermitian)."""
    return [eigh(a) for a in mats]


def eigvalsh_multi(mats):
    """eigvalsh over a list of per-bucket batches."""
    return [eigvalsh(a) for a in mats]
