"""Double-float (two-f32) compensated operator products.

Counterpart of the reference's df.py.  A double-float number is an
unevaluated sum hi + lo of two f32 (combined resolution ~2^-48); products
A[i, :] . x take error-free f32 TwoProd and compensated TwoSum sums, so no
f32 rounding enters beyond the df resolution.  The reference built this
because its accelerator has no f64: :class:`DfAOp` gives the hybrid phase
(ipm.make_step with compute_dtype=f32) f64-quality residuals of a dense
operator at f32 bandwidth.  The port keeps the reference's phase
semantics, so the hybrid phase of the precision ladder (solver.py) takes
DfAOp on the same operators the reference does (A denser than 10%).

:func:`df_matvec` and :func:`df_vecmat` are kernel K11: on CUDA tensors
they launch csrc/df_gemv.cu (and raise if they cannot); on CPU tensors
they run :func:`df_matvec_plain` / :func:`df_vecmat_plain`, the
reference's chunked pairwise-tree arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .cones import Layout
from .opA import build_dense_aop
from .pcg import two_prod, two_sum   # f32 inputs split with 4097
from .structs import F64, ConeVec

F32 = torch.float32

__all__ = ["two_sum", "two_prod", "df_split64", "df_to64", "df_matvec",
           "df_vecmat", "df_matvec_plain", "df_vecmat_plain", "DfAOp",
           "build_df_aop"]


def df_split64(a: torch.Tensor):
    """f64 -> (hi, lo) f32 pair with hi = f32(a), lo = f32(a - hi)."""
    a = a.to(F64)
    hi = a.to(F32)
    return hi, (a - hi.to(F64)).to(F32)


def df_to64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return hi.to(F64) + lo.to(F64)


def _df_reduce_last(hi: torch.Tensor, lo: torch.Tensor):
    """Compensated pairwise-tree reduction of df values over the last axis:
    TwoSum on the hi parts per level, the exact sum errors carried into lo
    in plain f32 (reference df.py:74-91)."""
    while hi.shape[-1] > 1:
        if hi.shape[-1] % 2:
            hi = torch.nn.functional.pad(hi, (0, 1))
            lo = torch.nn.functional.pad(lo, (0, 1))
        s, e = two_sum(hi[..., 0::2], hi[..., 1::2])
        hi, lo = s, lo[..., 0::2] + lo[..., 1::2] + e
    return hi[..., 0], lo[..., 0]


def _prod_terms(Ah, Al, xh, xl):
    """Per-element (p, c): p + e = Ah xh exactly, c = e + Ah xl + Al xh."""
    p, e = two_prod(Ah, xh)
    return p, e + Ah * xl + Al * xh


def df_matvec_plain(Ah, Al, xh, xl, chunk: int = 16384):
    """y = A x in df: [m, n] @ [n] -> [m] (hi, lo), over n-chunks of
    `chunk`, each reduced by the pairwise tree and folded into the running
    sum with TwoSum (reference df.py:94-124).  The reference zero-pads the
    last chunk to full width; the tree pairs the real terms the same way
    either way and adds exact zeros, so the unpadded chunk gives the same
    bits."""
    m, n = Ah.shape
    hi = torch.zeros(m, dtype=F32, device=Ah.device)
    lo = torch.zeros_like(hi)
    for st in range(0, n, chunk):
        sl = slice(st, st + chunk)
        p, c = _prod_terms(Ah[:, sl], Al[:, sl], xh[None, sl], xl[None, sl])
        sh, slo = _df_reduce_last(p, c)
        s, e2 = two_sum(hi, sh)
        hi, lo = s, lo + slo + e2
    return hi, lo


def df_vecmat_plain(xh, xl, Ah, Al, chunk: int = 16384):
    """y = x A in df: [m] @ [m, n] -> [n] (hi, lo); the tree runs over the
    m rows, n in chunks (reference df.py:127-158)."""
    outs = [_df_reduce_last(*(t.T for t in _prod_terms(
        Ah[:, st:st + chunk], Al[:, st:st + chunk], xh[:, None],
        xl[:, None]))) for st in range(0, Ah.shape[1], chunk)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _launch(fn: str, a, b, c, d, rows: int, n: int):
    args = [t.contiguous() for t in (a, b, c, d)]
    kernels.check_cuda(*args, dtype=F32)
    out = [torch.empty(rows if fn == "df_matvec" else n, dtype=F32,
                       device=a.device) for _ in range(2)]
    kernels.launch("df_gemv.cu", fn + "_launch",
                   *(t.data_ptr() for t in args + out), rows, n)
    kernels.LAUNCHES[fn] += 1
    return out[0], out[1]


def df_matvec(Ah, Al, xh, xl):
    """y = A x in df (kernel K11's df_matvec on the card)."""
    if not Ah.is_cuda:
        return df_matvec_plain(Ah, Al, xh, xl)
    rows, n = Ah.shape
    if Al.shape != Ah.shape or xh.shape != (n,) or xl.shape != (n,):
        raise ValueError(f"df_matvec: A {tuple(Ah.shape)}/{tuple(Al.shape)}"
                         f", x {tuple(xh.shape)}/{tuple(xl.shape)}")
    return _launch("df_matvec", Ah, Al, xh, xl, rows, n)


def df_vecmat(xh, xl, Ah, Al):
    """y = x A in df (kernel K11's df_vecmat on the card)."""
    if not Ah.is_cuda:
        return df_vecmat_plain(xh, xl, Ah, Al)
    rows, n = Ah.shape
    if Al.shape != Ah.shape or xh.shape != (rows,) or xl.shape != (rows,):
        raise ValueError(f"df_vecmat: A {tuple(Ah.shape)}/{tuple(Al.shape)}"
                         f", x {tuple(xh.shape)}/{tuple(xl.shape)}")
    return _launch("df_vecmat", xh, xl, Ah, Al, rows, n)


class DfAOp:
    """Double-float view of the bucketed operator [A; c'] (the layout of
    opA.DenseAOp, each bucket as an (hi, lo) f32 pair) with the
    apply/adj/adj_y contract, f64 in and f64 out (reference df.py:161)."""

    def __init__(self, Al, Aq, As, q_shapes, s_shapes):
        self.Al = Al
        self.Aq = tuple(Aq)
        self.As = tuple(As)
        self.q_shapes = tuple(tuple(s) for s in q_shapes)
        self.s_shapes = tuple(tuple(s) for s in s_shapes)

    @property
    def m(self) -> int:
        return self.Al[0].shape[0] - 1

    def _flat_parts(self, x: ConeVec):
        parts = [(self.Al, x.l)] if self.Al[0].shape[1] else []
        parts += [(aq, xq.reshape(-1)) for aq, xq in zip(self.Aq, x.q)]
        parts += [(as_, xs.reshape(-1)) for as_, xs in zip(self.As, x.s)]
        return parts

    def apply(self, x: ConeVec) -> torch.Tensor:
        """[A x; c'x] in f64 through df products."""
        hi = torch.zeros(self.m + 1, dtype=F32, device=self.Al[0].device)
        lo = torch.zeros_like(hi)
        for (Ah, Al_), xv in self._flat_parts(x):
            ph, pl = df_matvec(Ah, Al_, *df_split64(xv))
            s, e = two_sum(hi, ph)
            hi, lo = s, lo + pl + e
        return df_to64(hi, lo)

    def adj(self, w: torch.Tensor) -> ConeVec:
        """A'w + c w[m] in f64."""
        wh, wl = df_split64(w)

        def vm(pair):
            return df_to64(*df_vecmat(wh, wl, pair[0], pair[1]))

        l = vm(self.Al) if self.Al[0].shape[1] else \
            torch.zeros(0, dtype=F64, device=w.device)
        q = tuple(vm(aq).reshape(c, d)
                  for aq, (c, d) in zip(self.Aq, self.q_shapes))
        s = tuple(vm(as_).reshape(c, d, d)
                  for as_, (c, d) in zip(self.As, self.s_shapes))
        return ConeVec(l=l, q=q, s=s)

    def adj_y(self, y: torch.Tensor, minus_tau: torch.Tensor) -> ConeVec:
        """A'y - c tau (the dual-residual combination)."""
        return self.adj(torch.cat([y, minus_tau.reshape(1)]))


def build_df_aop(At, c: np.ndarray, layout: Layout, device="cuda") -> DfAOp:
    """The df operator from f64 host data: the dense bucketed layout
    (opA.build_dense_aop ordering), each bucket split into (hi, lo) f32
    pairs on the host (reference df.py:236-254)."""
    a64 = build_dense_aop(At, c, layout, device="numpy")

    def split_put(a):
        hi = np.asarray(a, np.float32)
        lo = np.asarray(a - hi, np.float32)
        return tuple(torch.as_tensor(v, device=device) for v in (hi, lo))

    return DfAOp(split_put(a64.Al), [split_put(a) for a in a64.Aq],
                 [split_put(a) for a in a64.As], a64.q_shapes, a64.s_shapes)
