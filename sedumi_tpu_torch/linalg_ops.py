"""Dense symmetric linear algebra, and the eigensolver dispatch.

Counterpart of the reference's linalg_ops.py.  The reference takes the
batched Jacobi solver (lax_eigh.py) for every eigh/eigvalsh on its
accelerator and LAPACK on a CPU; the port does the same with the tensors'
device: Jacobi (kernels K12/K13) on the card, the library (LAPACK on the
CPU; cuSOLVER on the card when asked) elsewhere.  impl_override('jacobi'
| 'xla') wins over that, then SEDUMI_TPU_EIGH=jacobi|xla (the reference's
variable and values; 'xla' is the library path).  The solver wraps the
phases that the reference sends to its host CPU (solver.phase_eigh_impl).

* Jacobi output is UNSORTED unless sort=True, and `sweeps` caps its
  budget (the coarse line-search spectra); the library path ignores both
  and returns ascending eigenvalues.
* The *_multi functions run several buckets as one Jacobi batch, each
  padded to the largest order with a unit diagonal (_pad_stack).  The
  Jacobi's early exit takes its max over the whole batch, so the padding
  moves the sweep count as in the reference.
* Like jax.numpy.linalg, the library routines symmetrize their input
  ((A + A^H)/2) and give NaN-filled entries for a batch entry that cannot
  be factored (cholesky: not positive definite; eigh: not finite) instead
  of raising; the Jacobi takes the matrix as given (as the reference's
  does) and returns NaN for a non-finite one.
* eigvalsh's `lead` leading dimensions are independent problems, as
  under the reference's jax.vmap (wregion.widelen_batched's trial
  steps): each converges with its own early exit.
"""

from __future__ import annotations

import contextlib
import os

import torch

from .lax_eigh import jacobi_eigh, jacobi_eigh_herm, jacobi_eigvalsh

# the eigensolver forced by impl_override ('jacobi' | 'xla' | None)
_FORCE_IMPL: str | None = None


@contextlib.contextmanager
def impl_override(impl: str | None):
    """Force the eigh implementation ('jacobi' | 'xla' | None) inside."""
    global _FORCE_IMPL
    prev = _FORCE_IMPL
    _FORCE_IMPL = impl
    try:
        yield
    finally:
        _FORCE_IMPL = prev


def _use_jacobi(device) -> bool:
    """The Jacobi solver or the library for tensors on `device`: the
    override, then SEDUMI_TPU_EIGH, then Jacobi iff on the card."""
    if _FORCE_IMPL == "jacobi":
        return True
    if _FORCE_IMPL == "xla":
        return False
    impl = os.environ.get("SEDUMI_TPU_EIGH", "auto")
    if impl == "jacobi":
        return True
    if impl == "xla":
        return False
    return torch.device(device).type == "cuda"


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


def _library_eigh(A: torch.Tensor):
    ok, A = _finite_or_eye(_sym(A))
    w, V = torch.linalg.eigh(A)
    nan = float("nan")
    return (torch.where(ok[..., None], w, nan),
            torch.where(ok[..., None, None], V, nan))


def eigh(A: torch.Tensor, sort: bool = False, sweeps: int | None = None):
    """(w, V) batched for real symmetric A (complex Hermitian batches go
    through eigh_herm_multi); the order of w is unspecified unless
    sort=True."""
    if _use_jacobi(A.device):
        return jacobi_eigh(A, sweeps=sweeps, sort=sort)
    return _library_eigh(A)


def eigvalsh(A: torch.Tensor, sort: bool = False, sweeps: int | None = None,
             lead: int = 0) -> torch.Tensor:
    if _use_jacobi(A.device):
        return jacobi_eigvalsh(A, sweeps=sweeps, sort=sort, lead=lead)
    ok, A = _finite_or_eye(_sym(A))
    return torch.where(ok[..., None], torch.linalg.eigvalsh(A), float("nan"))


def _pad_stack(mats):
    """Stack [..., k_i, d_i, d_i] batches into one [..., sum k_i, dmax,
    dmax] batch, each block padded with a decoupled unit diagonal (the
    Jacobi rotations never mix it in, so the leading d_i x d_i corner of
    the result is the unpadded answer)."""
    dmax = max(a.shape[-1] for a in mats)
    padded = []
    for a in mats:
        d = a.shape[-1]
        if d < dmax:
            p = torch.zeros(a.shape[:-2] + (dmax, dmax), dtype=a.dtype,
                            device=a.device)
            p[..., :d, :d] = a
            idx = torch.arange(d, dmax, device=a.device)
            p[..., idx, idx] = 1.0
            a = p
        padded.append(a)
    return torch.cat(padded, dim=-3), dmax


def _split(mats, w, V=None):
    """The per-bucket corners of a padded batch's results."""
    out, off = [], 0
    for a in mats:
        k, d = a.shape[-3], a.shape[-1]
        wi = w[..., off:off + k, :d]
        out.append(wi if V is None else (wi, V[..., off:off + k, :d, :d]))
        off += k
    return out


def eigh_multi(mats, sweeps: int | None = None):
    """eigh over a list of per-bucket [k_i, d_i, d_i] batches: one padded
    Jacobi batch (its cost is the largest order's rounds, not the sum),
    or the library per bucket.  Eigenvalues unsorted."""
    if len(mats) <= 1 or not _use_jacobi(mats[0].device):
        return [eigh(a, sweeps=sweeps) for a in mats]
    A, _ = _pad_stack(mats)
    w, V = jacobi_eigh(A, sweeps=sweeps, sort=False)
    return _split(mats, w, V)


def eigh_herm_multi(mats, sweeps: int | None = None):
    """eigh_multi for complex Hermitian batches (the native complex path:
    K13 under Jacobi, the library otherwise)."""
    if not mats or not _use_jacobi(mats[0].device):
        return [_library_eigh(a) for a in mats]
    if len(mats) == 1:
        return [jacobi_eigh_herm(mats[0], sweeps=sweeps)]
    A, _ = _pad_stack(mats)
    return _split(mats, *jacobi_eigh_herm(A, sweeps=sweeps))


def eigvalsh_multi(mats, sweeps: int | None = None, lead: int = 0):
    """eigh_multi without vectors; a list of [k_i, d_i] batches."""
    if len(mats) <= 1 or not _use_jacobi(mats[0].device):
        return [eigvalsh(a, sweeps=sweeps, lead=lead) for a in mats]
    A, _ = _pad_stack(mats)
    return _split(mats, jacobi_eigvalsh(A, sweeps=sweeps, sort=False,
                                        lead=lead))
