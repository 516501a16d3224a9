"""Batched symmetric and Hermitian eigensolvers: round-robin cyclic Jacobi.

Counterpart of the reference's lax_eigh.py, which the reference runs for
every eigh/eigvalsh on its accelerator (linalg_ops._use_jacobi).  The
algorithm is the reference's, round for round: two-sided Jacobi with the
round-robin ("tournament") parallel ordering, so each round rotates n/2
disjoint pivot pairs at once and n-1 rounds visit every pair once (one
sweep).  The rotation J(p, q) with G[pp] = G[qq] = c, G[pq] = s,
G[qp] = -s annihilates A[p, q] by the stable half-angle formulas
(A <- G' A G); V accumulates the rotations, A_orig = V diag(w) V'.

* The sweep budget is fixed (_sweeps_for; coarse_sweeps_for for the
  line-search spectra), and the loop stops early once the off-diagonal
  norm relative to the diagonal's, its max over the batch, falls below
  8 eps sqrt(n): the first two sweeps always run, a NaN norm ends it.
* An odd order is padded with a decoupled unit diagonal entry.
* The eigenvalues come back UNSORTED unless sort=True.
* `lead` leading batch dimensions converge independently, each with its
  own early exit: the reference runs its line search's trial spectra
  under jax.vmap, whose batched while_loop stops each trial on its own.

jacobi_eigh/jacobi_eigvalsh (kernel K12, csrc/jacobi_eigh.cu, f64 and f32
builds) and jacobi_eigh_herm (kernel K13, csrc/jacobi_herm.cu, complex128
and complex64) launch the kernels on CUDA tensors and raise if they
cannot; on CPU tensors they run the plain-PyTorch versions below.  Both
run one of three variants (csrc/jacobi_fused.cuh, csrc/jacobi_common.cuh),
which jacobi_plan picks from the order, the dtype and the batch: one
block per matrix, a thread-block cluster per matrix, or (beyond the
largest cluster's capacity) device memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import kernels
from .fp import eps_for, torch_dtype

F32, F64 = torch.float32, torch.float64
C64, C128 = torch.complex64, torch.complex128

# the dynamic shared memory one block may use on an H100 (227 KB)
SMEM_MAX = 232448
# an H100 SXM's streaming multiprocessors: the plan's default card
NUM_SMS = 132


def _round_robin_schedule(n: int) -> np.ndarray:
    """[n-1, n/2, 2] pivot pairs (p<q), round-robin tournament (n even)."""
    assert n % 2 == 0
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = [
            (min(players[i], players[n - 1 - i]),
             max(players[i], players[n - 1 - i]))
            for i in range(n // 2)
        ]
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, np.int32)


def closed_form_schedule(n: int) -> np.ndarray:
    """_round_robin_schedule(n) from its closed form, as K12's kernels
    compute it: in round r, slot 0 holds player 0 and slot s >= 1 player
    (s - 1 - r) mod (n - 1) + 1 (the tail turns right by one a round);
    pair k is slots k and n-1-k."""
    assert n % 2 == 0
    m = n - 1
    r = np.arange(m)[:, None]
    k = np.arange(n // 2)[None, :]

    def player(s):
        return np.where(s == 0, 0, (s - 1 - r + m) % m + 1)

    a, b = player(k), player(n - 1 - k)
    return np.stack([np.minimum(a, b), np.maximum(a, b)], -1).astype(
        np.int32)


def _sweeps_for(n: int, dtype=None) -> int:
    """Sweep budget for convergence to the dtype's roundoff floor (f32
    converges ~2 sweeps earlier; reference lax_eigh.py:167-183)."""
    f32 = dtype is not None and torch_dtype(dtype) == F32
    if n <= 16:
        return 6 if f32 else 8
    if n <= 64:
        return 8 if f32 else 10
    if n <= 256:
        return 10 if f32 else 12
    return 12 if f32 else 14


def coarse_sweeps_for(n: int, dtype=None) -> int:
    """Line-search-grade budget (~1e-3 relative spectra): the wide-region
    proximity tests, the maxstep boundary estimates and the Gondzio clip
    need ~3 digits (reference lax_eigh.py:295-305)."""
    return max(3, _sweeps_for(n, dtype) - 4)


def coarse_sweeps_of(mats) -> int | None:
    """The coarse budget of one padded batch of the [k_i, d_i, d_i]
    matrices `mats` (their largest order), None for no matrices."""
    if not mats:
        return None
    return coarse_sweeps_for(max(m.shape[-1] for m in mats), mats[0].dtype)


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return F32 if dtype in (F32, C64) else F64


def _pad_odd(A: torch.Tensor) -> torch.Tensor:
    """A copy of A, padded to even order with a decoupled unit diagonal
    entry (rotations with a zero off-diagonal are the identity)."""
    n0 = A.shape[-1]
    if n0 % 2 == 0:
        return A.clone()
    P = torch.zeros(A.shape[:-2] + (n0 + 1, n0 + 1), dtype=A.dtype,
                    device=A.device)
    P[..., :n0, :n0] = A
    P[..., n0, n0] = 1.0
    return P


def _off_ratio(A: torch.Tensor, lead: int) -> torch.Tensor:
    """||offdiag(A)|| / max(||diag(A)||, 1e-30) per batch entry, its max
    over the batch axes after the first `lead` (NaN propagates).  The
    diagonal is zeroed before the sum: sum(A^2) - sum(d^2) cancels."""
    d = torch.diagonal(A, dim1=-2, dim2=-1).real
    dn = torch.sqrt(torch.sum(d * d, dim=-1))
    n = A.shape[-1]
    idx = torch.arange(n, device=A.device)
    Ao = A.clone()
    Ao[..., idx, idx] = 0.0
    sq = Ao * Ao if not Ao.is_complex() else torch.abs(Ao) ** 2
    off = torch.sqrt(torch.sum(sq, dim=(-2, -1)))
    r = off / torch.clamp_min(dn, 1e-30)
    return torch.amax(r.reshape(r.shape[:lead] + (-1,)), dim=-1)


def _angle(app, aqq, mag, ueps: float):
    """(small, c, s) of the rotations annihilating the pivots `mag` (the
    real apq, or |apq| for a Hermitian pivot): the reference's formulas,
    with |theta| clamped at 1/eps and t = 1 when theta == 0."""
    small = torch.abs(mag) <= 0.25 * ueps * (torch.abs(app) + torch.abs(aqq))
    theta = (aqq - app) / (2.0 * mag.masked_fill(small, 1.0))
    theta_c = torch.clamp(theta, -1.0 / ueps, 1.0 / ueps)
    t = torch.sign(theta_c) / (torch.abs(theta_c)
                               + torch.sqrt(1.0 + theta_c * theta_c))
    t = t.masked_fill(theta == 0.0, 1.0)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    return small, c.masked_fill(small, 1.0), s.masked_fill(small, 0.0)


def _sweep_loop(AV: torch.Tensor, n: int, sweeps: int, lead: int,
                ueps: float, angle_fn) -> torch.Tensor:
    """The reference's sweeps, in place on AV = [A; V] ([..., 2n, n], or
    A alone [..., n, n]): each round rotates the rows p, q of A by (cb,
    sp, sq) -> (cb A_p - sp A_q, sq A_p + cb A_q), then the columns of A
    and V by (cT, sTp, sTq), from angle_fn(A, p, q).  Sweep i runs iff
    i < sweeps and (i < 2 or the off-norm ratio > 8 eps sqrt(n)), per
    group of the `lead` dimensions (the reference's while_loop; under its
    vmap a finished group keeps its values).  Returns the sweeps run per
    group."""
    thresh = 8.0 * ueps * float(np.sqrt(n))
    h = n // 2
    sched = torch.as_tensor(_round_robin_schedule(n), dtype=torch.long,
                            device=AV.device)
    pq = torch.cat([sched[:, :, 0], sched[:, :, 1]], dim=1)  # [n-1, n]
    A = AV[..., :n, :]
    lead_shape = AV.shape[:lead]
    active = torch.ones(lead_shape, dtype=torch.bool, device=AV.device)
    nsw = torch.zeros(lead_shape, dtype=torch.int32, device=AV.device)
    for i in range(sweeps):
        if i >= 2:
            active = active & (_off_ratio(A, lead) > thresh)
            if not bool(torch.any(active)):
                break
        old = AV.clone() if lead else None
        for r in range(n - 1):
            idx = pq[r]
            cb, sp, sq, cT, sTp, sTq = angle_fn(A, idx[:h], idx[h:])
            R = A.index_select(-2, idx)
            rp, rq = R[..., :h, :], R[..., h:, :]
            A.index_copy_(-2, idx, torch.cat([cb * rp - sp * rq,
                                              sq * rp + cb * rq], dim=-2))
            C = AV.index_select(-1, idx)
            cp, cq = C[..., :h], C[..., h:]
            AV.index_copy_(-1, idx, torch.cat([cT * cp - sTp * cq,
                                               sTq * cp + cT * cq], dim=-1))
        if lead:
            keep = ~active.reshape(lead_shape + (1,) * (AV.ndim - lead))
            AV.copy_(torch.where(keep, old, AV))
        nsw += active.to(torch.int32)
    return nsw


def _start(A: torch.Tensor, with_vectors: bool):
    """[A; I] (or A) padded to even order, the sweeps' working copy."""
    A = _pad_odd(A)
    if not with_vectors:
        return A
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.cat([A, eye], dim=-2)


def _real_rotations(ueps: float):
    """_sweep_loop's angle_fn for real symmetric A: the rotations of the
    pairs (p, q) as the row factors (c, s, s) and column factors."""

    def angle_fn(A, p, q):
        diag = torch.diagonal(A, dim1=-2, dim2=-1)
        _, c, s = _angle(diag[..., p], diag[..., q], A[..., p, q], ueps)
        cb, sb = c[..., :, None], s[..., :, None]
        cT, sT = c[..., None, :], s[..., None, :]
        return cb, sb, sb, cT, sT, sT

    return angle_fn


def _jacobi_plain(A: torch.Tensor, sweeps: int, with_vectors: bool,
                  lead: int = 0):
    """Plain-PyTorch K12: (w unsorted, V or None, sweeps run per group)
    for real symmetric A [..., n, n] (reference lax_eigh.py:49-165)."""
    n0 = A.shape[-1]
    AV = _start(A, with_vectors)
    n = AV.shape[-1]
    ueps = eps_for(A.dtype)
    nsw = _sweep_loop(AV, n, sweeps, lead, ueps, _real_rotations(ueps))
    w = torch.diagonal(AV[..., :n, :], dim1=-2, dim2=-1)[..., :n0]
    return w, (AV[..., n:, :][..., :n0, :n0] if with_vectors else None), nsw


def _jacobi_herm_plain(A: torch.Tensor, sweeps: int, with_vectors: bool,
                       lead: int = 0):
    """Plain-PyTorch K13: (w real unsorted, V or None, sweeps run) for
    complex Hermitian A [..., n, n] (reference lax_eigh.py:187-283).  The
    rotation is the real one with the pivot's phase u = a_pq/|a_pq| folded
    into the sine: G = [[c, s u], [-s conj(u), c]], A <- G^H A G."""
    n0 = A.shape[-1]
    AV = _start(A, with_vectors)
    n = AV.shape[-1]
    ueps = eps_for(_real_dtype(A.dtype))

    def angle_fn(A, p, q):
        diag = torch.diagonal(A, dim1=-2, dim2=-1).real
        apq = A[..., p, q]
        mag = torch.abs(apq)
        small, c, s = _angle(diag[..., p], diag[..., q], mag, ueps)
        m1 = mag.masked_fill(small, 1.0)
        # the phase e^{i phi}: a division of each part by the real |apq|
        u = torch.complex(apq.real / m1, apq.imag / m1).masked_fill(small, 1.0)
        cc = c.to(A.dtype)
        su = s.to(A.dtype) * u
        cb, sb = cc[..., :, None], su[..., :, None]
        cT, sT = cc[..., None, :], su[..., None, :]
        return cb, sb, torch.conj(sb), cT, torch.conj(sT), sT

    nsw = _sweep_loop(AV, n, sweeps, lead, ueps, angle_fn)
    w = torch.diagonal(AV[..., :n, :], dim1=-2, dim2=-1).real[..., :n0]
    return w, (AV[..., n:, :][..., :n0, :n0] if with_vectors else None), nsw


# --------------------------------------------------------------------------
# kernels K12 / K13 on the card
# --------------------------------------------------------------------------

# (dtype) -> (source, C launch function, LAUNCHES key)
_KERNELS = {
    F64: ("jacobi_eigh.cu", "jacobi_eigh_f64_launch", "jacobi_eigh"),
    F32: ("jacobi_eigh.cu", "jacobi_eigh_f32_launch", "jacobi_eigh_f32"),
    C128: ("jacobi_herm.cu", "jacobi_herm_c128_launch", "jacobi_eigh_herm"),
    C64: ("jacobi_herm.cu", "jacobi_herm_c64_launch",
          "jacobi_eigh_herm_c64"),
}
_SCHED: dict = {}
# K12's and K13's launches per variant and order, beside
# kernels.LAUNCHES' per build, e.g. "jacobi_eigh_f32:cluster16@322";
# cleared with it by kernels.reset_launch_counts
VARIANT_LAUNCHES = kernels.VARIANT_LAUNCHES


def variant_key(name: str, variant: str, cluster: int, n: int) -> str:
    """VARIANT_LAUNCHES' key of one K12/K13 build, plan and (even)
    order."""
    return f"{name}:{variant}{cluster if variant == 'cluster' else ''}@{n}"


def _schedule(n: int, device) -> torch.Tensor:
    """The round-robin table as int32 on the card, uploaded once per n."""
    key = (n, str(device))
    if key not in _SCHED:
        _SCHED[key] = torch.as_tensor(_round_robin_schedule(n),
                                      dtype=torch.int32, device=device)
    return _SCHED[key]


def smem_bytes(n: int, dtype: torch.dtype, with_vectors: bool) -> int:
    """Dynamic shared memory of one block holding a whole matrix of even
    order n (the block variant, csrc/jacobi_fused.cuh block_smem): A (and
    V) with rows padded to n + 1, the round's rotations (max(n/2, 32) of
    two elements each, which the final reduction's 64 reals reuse) and
    its pivot pairs (n/2 ints).  At most SMEM_MAX with vectors up to order
    168 in f32, 118 in f64 and complex64, 84 in complex128."""
    esize = torch.empty((), dtype=dtype).element_size()
    mats = (2 if with_vectors else 1) * n * (n + 1) * esize
    return mats + max(n, 64) * esize + 2 * n


# the variants, numbered as csrc/jacobi_fused.cuh numbers them
VARIANTS = ("device", "block", "cluster")
# cluster sizes; above 8 CTAs the kernel sets the non-portable attribute
CLUSTER_SIZES = (2, 4, 8, 16)
MAX_CLUSTER = CLUSTER_SIZES[-1]
# measured on the card (chip_smoke.check_k12_plans, PERF.md section 6):
# by dtype, the order from which 16 CTAs beat one block on a matrix alone
# (f32 from 100, f64 from 80; complex64 from 72, complex128 from 56:
# chip_smoke.check_k13_plans); and where one block holds the matrix, the
# fewest CTAs that beat it (2 CTAs trail one block at every order and
# batch measured)
CLUSTER_MIN_N = {F32: 100, F64: 80, C64: 72, C128: 56}
CLUSTER_MIN_CTAS = 4


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def cluster_smem_bytes(n: int, dtype: torch.dtype, with_vectors: bool,
                       cluster: int) -> int:
    """Dynamic shared memory of one CTA of the cluster variant at even
    order n (csrc/jacobi_fused.cuh ClusterLayout), each part on 16 bytes:
    the rows of its at most P = ceil(n/2 / C) pairs twice (read one copy,
    write the other) and its at most S = ceil(n / C) rows of V, padded to
    n + 1; the rotations of two rounds (2 max(n, 64) elements); a pointer
    per own row (2 P) and an int per own pair (P); 2 MAX_CLUSTER partial
    sums."""
    esize = torch.empty((), dtype=dtype).element_size()
    h = n // 2
    P, S = -(-h // cluster), -(-n // cluster)
    o = _up16((4 * P + (S if with_vectors else 0)) * (n + 1) * esize)
    o = _up16(o + 2 * max(n, 64) * esize)
    o = _up16(o + 16 * P)
    o = _up16(o + 4 * P)
    return o + 2 * MAX_CLUSTER * esize


def cluster_fits(n: int, dtype: torch.dtype, with_vectors: bool,
                 cluster: int) -> bool:
    """Whether C CTAs hold a matrix of even order n: each owns at least
    one pair, within SMEM_MAX."""
    return (cluster <= n // 2
            and cluster_smem_bytes(n, dtype, with_vectors, cluster)
            <= SMEM_MAX)


def jacobi_plan(n: int, dtype: torch.dtype, with_vectors: bool, batch: int,
                sms: int = NUM_SMS) -> tuple[str, int]:
    """(variant, cluster size) of K12 or K13 for a batch of `batch`
    matrices of even order n and the given dtype.

    * Where no cluster holds the matrix (order 2, where a second CTA
      would own no pair; beyond MAX_CLUSTER CTAs' capacity): one block
      if it does, else the device-memory variant.
    * Otherwise the fewest CTAs that hold the matrix, doubled (up to
      MAX_CLUSTER) while batch x C still fits the card's SMs.
    * But one block where it holds the matrix and the order is below
      CLUSTER_MIN_N, or the cluster would have fewer than
      CLUSTER_MIN_CTAS CTAs or need more CTAs than the card has SMs.
    """
    if n < 2 or n % 2:
        raise ValueError(f"Jacobi plan: order {n} is not even")
    fits = [c for c in CLUSTER_SIZES
            if cluster_fits(n, dtype, with_vectors, c)]
    block = smem_bytes(n, dtype, with_vectors) <= SMEM_MAX
    if not fits:
        return ("block", 1) if block else ("device", 1)
    if block and n < CLUSTER_MIN_N[dtype]:
        return "block", 1
    c = fits[0]
    while (c < MAX_CLUSTER and 2 * c * batch <= sms
           and cluster_fits(n, dtype, with_vectors, 2 * c)):
        c *= 2
    if block and (c < CLUSTER_MIN_CTAS or c * batch > sms):
        return "block", 1
    return "cluster", c


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _jacobi_cuda(A: torch.Tensor, sweeps: int, with_vectors: bool,
                 lead: int = 0, plan: tuple[str, int] | None = None):
    """K12/K13 on the card: (w, V or None, sweeps run per group).  One
    launch per sweep; the early exit is a per-group flag on the card, so
    the host never synchronises.  Runs `plan` (default jacobi_plan's
    choice for this batch on this card); a variant the card refuses
    raises."""
    if A.dtype not in _KERNELS:
        raise ValueError(f"Jacobi kernel: dtype {A.dtype} is not built")
    src, fn, name = _KERNELS[A.dtype]
    n0 = A.shape[-1]
    P = _pad_odd(A)
    n = P.shape[-1]
    lead_shape = tuple(P.shape[:lead])
    groups = math.prod(lead_shape)
    batch = math.prod(P.shape[:-2])
    work = P.reshape(batch, n, n).contiguous()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(
        batch, n, n).contiguous() if with_vectors else work
    ratio = torch.empty(batch, dtype=_real_dtype(A.dtype), device=A.device)
    done = torch.zeros(max(groups, 1), dtype=torch.int32, device=A.device)
    nsw = torch.zeros_like(done)
    kernels.check_cuda(work, V)
    eps = eps_for(_real_dtype(A.dtype))
    if batch:
        variant, cluster = plan or jacobi_plan(n, A.dtype, with_vectors,
                                               batch, _sm_count(A.device))
        # only the device-memory variant reads the table
        sched = _schedule(n, A.device).data_ptr() if variant == "device" \
            else None
        kernels.launch(src, fn, work.data_ptr(), V.data_ptr(), sched,
                       ratio.data_ptr(), done.data_ptr(), nsw.data_ptr(),
                       batch, groups, n, sweeps, int(with_vectors), eps,
                       VARIANTS.index(variant), cluster)
        kernels.LAUNCHES[name] += 1
        key = variant_key(name, variant, cluster, n)
        VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1
    work = work.reshape(P.shape)
    w = torch.diagonal(work, dim1=-2, dim2=-1)[..., :n0]
    if A.is_complex():
        w = w.real
    Vo = V.reshape(P.shape)[..., :n0, :n0] if with_vectors else None
    return w.contiguous(), Vo, nsw[:groups].reshape(lead_shape)


def _jacobi(A: torch.Tensor, sweeps: int, with_vectors: bool,
            lead: int = 0):
    """K12 (real A) or K13 (complex A): the kernel on a CUDA tensor, the
    plain version on the CPU."""
    if A.is_cuda:
        return _jacobi_cuda(A, sweeps, with_vectors, lead)
    plain = _jacobi_herm_plain if A.is_complex() else _jacobi_plain
    return plain(A, sweeps, with_vectors, lead)


def _sorted(w, V):
    order = torch.argsort(w, dim=-1)
    w = torch.take_along_dim(w, order, dim=-1)
    if V is not None:
        V = torch.take_along_dim(V, order[..., None, :], dim=-1)
    return w, V


def jacobi_eigh_herm(A: torch.Tensor, sweeps: int | None = None):
    """(w, V) for batched complex Hermitian A; w real, V unitary,
    A = V diag(w) V^H.  Eigenvalue order unspecified."""
    n = A.shape[-1]
    w, V, _ = _jacobi(A, sweeps or _sweeps_for(n, _real_dtype(A.dtype)), True)
    return w, V


def jacobi_eigh(A: torch.Tensor, sweeps: int | None = None,
                sort: bool = True):
    """(w, V) with A = V diag(w) V'; w ascending iff sort (default)."""
    n = A.shape[-1]
    w, V, _ = _jacobi(A, sweeps or _sweeps_for(n, A.dtype), True)
    return _sorted(w, V) if sort else (w, V)


def jacobi_eigvalsh(A: torch.Tensor, sweeps: int | None = None,
                    sort: bool = True, lead: int = 0) -> torch.Tensor:
    n = A.shape[-1]
    w, _, _ = _jacobi(A, sweeps or _sweeps_for(n, A.dtype), False, lead)
    return torch.sort(w, dim=-1).values if sort else w
