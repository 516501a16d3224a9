"""Bucketed cone vectors as torch tensors, and flat <-> bucket conversion.

An element of K = R+^l x Q^q1..qk x S+^s1..sr is a :class:`ConeVec`: one
[nl] tensor for the LP part, one [count, dim] tensor per Lorentz bucket and
one [count, dim, dim] tensor per PSD bucket (the bucket layout of
cones.Layout).  All tensors share one device and one dtype: float64, or
float32 in the precision ladder's f32 phase.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .cones import Layout

F64 = torch.float64


class ConeVec(NamedTuple):
    """l: [nl];  q: per q-bucket [count, dim];  s: per s-bucket
    [count, dim, dim] symmetric blocks."""

    l: torch.Tensor
    q: tuple[torch.Tensor, ...]
    s: tuple[torch.Tensor, ...]


def cv_map(fn: Callable, *cvs: ConeVec) -> ConeVec:
    """Apply fn leafwise over one or more ConeVecs of the same layout."""
    return ConeVec(
        l=fn(*(c.l for c in cvs)),
        q=tuple(fn(*xs) for xs in zip(*(c.q for c in cvs))),
        s=tuple(fn(*xs) for xs in zip(*(c.s for c in cvs))),
    )


def cv_leaves(a: ConeVec) -> list[torch.Tensor]:
    return [a.l, *a.q, *a.s]


def cv_zeros(layout: Layout, device, dtype=F64) -> ConeVec:
    return ConeVec(
        l=torch.zeros(layout.l, dtype=dtype, device=device),
        q=tuple(torch.zeros(b.count, b.dim, dtype=dtype, device=device)
                for b in layout.q_buckets),
        s=tuple(torch.zeros(b.count, b.dim, b.dim, dtype=dtype,
                            device=device)
                for b in layout.s_buckets),
    )


def cv_eye(layout: Layout, device, dtype=F64) -> ConeVec:
    """Identity element of K (reference: eyeK.m)."""
    q = []
    for b in layout.q_buckets:
        e = torch.zeros(b.count, b.dim, dtype=dtype, device=device)
        e[:, 0] = 1.0
        q.append(e)
    s = tuple(torch.eye(b.dim, dtype=dtype, device=device)
              .expand(b.count, b.dim, b.dim).clone()
              for b in layout.s_buckets)
    return ConeVec(l=torch.ones(layout.l, dtype=dtype, device=device),
                   q=tuple(q), s=s)


def cv_cast(a, dtype):
    """A tensor, ConeVec or (nested) tuple of them cast to `dtype` (the
    reference's cast between precision phases); other values pass."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    if isinstance(a, tuple):
        return type(a)(*(cv_cast(v, dtype) for v in a)) \
            if hasattr(a, "_fields") else tuple(cv_cast(v, dtype)
                                                for v in a)
    return a


def cv_dot(a: ConeVec, b: ConeVec) -> torch.Tensor:
    """<a, b> over the whole cone space (tr(AB) for symmetric blocks)."""
    parts = [torch.sum(x * y) for x, y in zip(cv_leaves(a), cv_leaves(b))]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def cv_add(a: ConeVec, b: ConeVec) -> ConeVec:
    return cv_map(torch.add, a, b)


def cv_sub(a: ConeVec, b: ConeVec) -> ConeVec:
    return cv_map(torch.sub, a, b)


def cv_scale(a: ConeVec, alpha) -> ConeVec:
    return cv_map(lambda x: alpha * x, a)


def cv_neg(a: ConeVec) -> ConeVec:
    return cv_map(torch.neg, a)


def cv_norm(a: ConeVec) -> torch.Tensor:
    return torch.sqrt(cv_dot(a, a))


# ---------------------------------------------------------------------------
# Host-side flat <-> bucket conversion.  The flat internal layout is
# [lp | q blocks in order | vec(S blocks)].
# ---------------------------------------------------------------------------


def _q_indices(layout: Layout) -> list[np.ndarray]:
    offs = layout.q_offsets()
    out = []
    for b in layout.q_buckets:
        idx = np.stack([offs[i] + np.arange(b.dim) for i in b.block_ids]) \
            if b.count else np.zeros((0, b.dim), np.int64)
        out.append(idx.astype(np.int64))
    return out


def _s_indices(layout: Layout) -> list[np.ndarray]:
    offs = layout.s_offsets()
    out = []
    for b in layout.s_buckets:
        idx = np.stack(
            [offs[i] + np.arange(b.dim * b.dim).reshape(b.dim, b.dim)
             for i in b.block_ids]
        ) if b.count else np.zeros((0, b.dim, b.dim), np.int64)
        out.append(idx.astype(np.int64))
    return out


def from_flat(layout: Layout, x: np.ndarray, device,
              symmetrize: bool = True, dtype=F64) -> ConeVec:
    """Split a flat internal vector into bucketed form on `device`.

    PSD blocks are symmetrized ((X+X')/2, reference: vecsym.c) unless
    disabled."""
    x = np.asarray(x, dtype=np.float64).ravel()
    ql = [x[idx] for idx in _q_indices(layout)]
    sl = []
    for idx in _s_indices(layout):
        blk = x[idx]
        if symmetrize:
            blk = 0.5 * (blk + np.swapaxes(blk, -1, -2))
        sl.append(blk)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return ConeVec(l=put(x[: layout.l]), q=tuple(put(v) for v in ql),
                   s=tuple(put(v) for v in sl))


def to_flat(layout: Layout, v: ConeVec) -> np.ndarray:
    """Assemble the flat internal vector (numpy, host) from bucketed form."""
    x = np.zeros(layout.N, dtype=np.float64)
    x[: layout.l] = v.l.detach().cpu().numpy()
    for idx, arr in zip(_q_indices(layout), v.q):
        x[idx.ravel()] = arr.detach().cpu().numpy().ravel()
    for idx, arr in zip(_s_indices(layout), v.s):
        x[idx.ravel()] = arr.detach().cpu().numpy().ravel()
    return x
