"""Double-double dense linear algebra on the device, by error-free splits.

Counterpart of the reference's ddlinalg.py (reference analog: quadadd.c,
compensated arithmetic lifted from dot products to matrix algebra).  A dd
value is a pair (h, l) of f64 tensors standing for h + l (~1e-32
relative).  The IPM endgame's accuracy wall is cond(ADA) ~ 1/mu^2 against
f64's eps: past cond * eps ~ 1 neither the f64 factorization nor its
refinement contracts, and dd arithmetic moves that wall to cond ~ 1e30.

A dd GEMM follows Ozaki, Ogita, Oishi and Rump (Numer. Algorithms 2012):
each f64 operand splits into 3 slices of t bits along the accumulation
dimension k, t = floor((53 - ceil(log2 k)) / 2), so a slice product and
its internal sums are exact in f64 in any summation order (cuBLAS DGEMM on
the card, torch.matmul here); 9 slice products and 2 cross terms
accumulate with TwoSum.  Everything runs in torch f64 on the tensors'
device; the reference ran it as host numpy inside jax.pure_callback.  The
element operations keep the reference's association everywhere.

Kernels (csrc/, built at first use).  Each wrapper launches its kernel on
a CUDA tensor, or raises; only a CPU tensor takes the plain-PyTorch twin:

  K4 ozaki_split                     csrc/dd_split.cu
  K5 dd_accumulate, dd_add / dd_sub,
     two_prod_cols                   csrc/dd_elem.cu
  K6 dd_gemv                         csrc/dd_gemv.cu (twin: the Ozaki route)
  K6 solve: dd_chol_solve            csrc/dd_gemv.cu (twin: the panel
                                     composition, dd_chol_solve_panels)
  K7 dd_panel_chol                   csrc/dd_chol.cu

dd_accumulate updates its first two arguments in place (the reference's
arrays are rebound instead); nothing else here mutates an argument.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .pcg import two_prod, two_sum

_F64 = torch.float64


# ------------------------------------------------------------ element ops
# two_sum and two_prod (Dekker) are pcg's: the same operations as the
# reference's ddlinalg.py:31-47


def dd_normalize(h, l):
    return two_sum(h, l)


def dd_add_plain(ah, al, bh, bl=None):
    if bl is None:
        bl = torch.zeros_like(bh)
    sh, se = two_sum(ah, bh)
    return dd_normalize(sh, se + al + bl)


def dd_sub_plain(ah, al, bh, bl=None):
    if bl is None:
        bl = torch.zeros_like(bh)
    return dd_add_plain(ah, al, -bh, -bl)


def dd_mul(ah, al, bh, bl):
    ph, pe = two_prod(ah, bh)
    return dd_normalize(ph, pe + ah * bl + al * bh)


def dd_div(ah, al, bh, bl):
    q1 = ah / bh
    # r = a - q1 * b in dd
    ph, pl = dd_mul(q1, torch.zeros_like(q1), bh, bl)
    rh, rl = dd_sub_plain(ah, al, ph, pl)
    q2 = (rh + rl) / bh
    return dd_normalize(q1, q2)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  torch's CPU sqrt can miss by an ulp
    (sqrt(512.0)); numpy's, CUDA's and the kernels' are IEEE-exact."""
    if x.device.type == "cpu":
        return torch.as_tensor(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def dd_sqrt(ah, al):
    s = _sqrt(torch.clamp_min(ah, 0.0))
    # one dd Newton step: s + (a - s^2) / (2 s)
    ph, pl = two_prod(s, s)
    rh, rl = dd_sub_plain(ah, al, ph, pl)
    e = (rh + rl) / torch.clamp_min(2.0 * s, 1e-300)
    return dd_normalize(s, e)


# -------------------------------------------------------------- K5 wrappers


def _check_same(*ts: torch.Tensor) -> None:
    shape = ts[0].shape
    if any(t.shape != shape for t in ts):
        raise ValueError("dd element kernels need equal shapes, got "
                         + ", ".join(str(tuple(t.shape)) for t in ts))
    kernels.check_cuda(*ts, dtype=_F64)


def dd_accumulate_plain(Sh, Sl, P, normalize: bool = False):
    s, e = two_sum(Sh, P)
    l = Sl + e
    if normalize:
        s, l = dd_normalize(s, l)
    Sh.copy_(s)
    Sl.copy_(l)
    return Sh, Sl


def dd_accumulate(Sh, Sl, P, normalize: bool = False):
    """In place: (Sh, Sl) <- (TwoSum(Sh, P), Sl + its error); with
    normalize, then (Sh, Sl) <- TwoSum(Sh, Sl).  Kernel K5 on the card."""
    if not Sh.is_cuda:
        return dd_accumulate_plain(Sh, Sl, P, normalize)
    P = P.contiguous()
    _check_same(Sh, Sl, P)
    kernels.launch("dd_elem.cu", "dd_accumulate_launch", Sh.data_ptr(),
                   Sl.data_ptr(), P.data_ptr(), Sh.numel(), int(normalize))
    kernels.LAUNCHES["dd_accumulate"] += 1
    return Sh, Sl


def _dd_add_kernel(ah, al, bh, bl, negate: bool):
    ah, al, bh = ah.contiguous(), al.contiguous(), bh.contiguous()
    if bl is not None:
        bl = bl.contiguous()
        _check_same(ah, al, bh, bl)
    else:
        _check_same(ah, al, bh)
    oh, ol = torch.empty_like(ah), torch.empty_like(ah)
    kernels.launch("dd_elem.cu", "dd_add_launch", ah.data_ptr(),
                   al.data_ptr(), bh.data_ptr(),
                   None if bl is None else bl.data_ptr(), int(negate),
                   oh.data_ptr(), ol.data_ptr(), ah.numel())
    kernels.LAUNCHES["dd_accumulate"] += 1
    return oh, ol


def dd_add(ah, al, bh, bl=None):
    """(ah + al) + (bh + bl) in dd, normalised; bl None means 0.  Kernel
    K5 on the card."""
    if not ah.is_cuda:
        return dd_add_plain(ah, al, bh, bl)
    return _dd_add_kernel(ah, al, bh, bl, negate=False)


def dd_sub(ah, al, bh, bl=None):
    """(ah + al) - (bh + bl) in dd (dd_add of the negation).  Kernel K5 on
    the card."""
    if not ah.is_cuda:
        return dd_sub_plain(ah, al, bh, bl)
    return _dd_add_kernel(ah, al, bh, bl, negate=True)


def two_prod_cols_plain(A, v):
    return two_prod(A, v[None, :])


def two_prod_cols(A, v):
    """Exact products A_ij v_j = P_ij + E_ij.  Kernel K5 on the card
    (TwoProd by fma, the same (P, E) as Dekker's split)."""
    if not A.is_cuda:
        return two_prod_cols_plain(A, v)
    A, v = A.contiguous(), v.contiguous()
    kernels.check_cuda(A, v, dtype=_F64)
    if A.dim() != 2 or v.shape != (A.shape[1],):
        raise ValueError(f"two_prod_cols: A {tuple(A.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    P, E = torch.empty_like(A), torch.empty_like(A)
    kernels.launch("dd_elem.cu", "two_prod_cols_launch", A.data_ptr(),
                   v.data_ptr(), A.shape[1], P.data_ptr(), E.data_ptr(),
                   A.numel())
    kernels.LAUNCHES["dd_accumulate"] += 1
    return P, E


# ------------------------------------------------------------------ K4 split


def split_bits(k: int) -> int:
    """t = floor((53 - ceil(log2 k)) / 2), at least 1 (k >= 2 assumed)."""
    return max(1, (53 - max((max(k, 2) - 1).bit_length(), 1)) // 2)


def _pow2(E: torch.Tensor) -> torch.Tensor:
    """Exactly 2.0**E for an int64 tensor E, built from the exponent bits
    (inf above the range, subnormal or 0 below it, as ldexp)."""
    E1 = E.clamp(-1022, 1023)
    E2 = (E - E1).clamp(-1022, 1023)
    return ((E1 + 1023) << 52).view(_F64) * ((E2 + 1023) << 52).view(_F64)


def _sigma(mu: torch.Tensor, t: int) -> torch.Tensor:
    """2^(ceil(log2 mu) + 53 - t); mu <= 0, NaN or inf count as 1.  The
    exponent comes from frexp (exact), not from log2."""
    ok = torch.isfinite(mu) & (mu > 0)
    mant, e = torch.frexp(torch.where(ok, mu, 1.0))
    expo = torch.where(mant == 0.5, e - 1, e).to(torch.int64)
    return _pow2(expo + (53 - t))


def ozaki_split_plain(A: torch.Tensor, k: int, axis: int):
    """Error-free split of A into 3 slices of t bits each along the
    accumulation dimension of length k, scaled per row (axis=-1) or per
    column (axis=0).  For finite A it equals the reference's slices bit
    for bit; a non-finite line max counts as 1 here, where the
    reference's shift is undefined."""
    t = split_bits(k)
    slices = []
    R = A.clone()
    for _ in range(2):
        mu = torch.amax(torch.abs(R), dim=axis, keepdim=True)
        sigma = _sigma(mu, t)
        S = (R + sigma) - sigma
        slices.append(S)
        R = R - S
    slices.append(R)
    return slices


def _unit_col_stride(A: torch.Tensor):
    """(X, flipped): X is A, or A.T when flipped, with unit column stride
    and row stride >= its width; a copy when neither view has it."""
    if A.stride(1) == 1 and A.stride(0) >= max(A.shape[1], 1):
        return A, False
    if A.stride(0) == 1 and A.stride(1) >= max(A.shape[0], 1):
        return A.T, True
    return A.contiguous(), False


def ozaki_split(A: torch.Tensor, k: int, axis: int):
    """ozaki_split_plain; kernel K4 on the card.  A transposed view runs
    as the split of its transpose along the other axis, without a copy."""
    if not A.is_cuda:
        return ozaki_split_plain(A, k, axis)
    if A.dim() != 2:
        raise ValueError(f"ozaki_split takes a matrix, got {A.dim()}-d")
    row_scaled = axis % 2 == 1
    X, flipped = _unit_col_stride(A)
    if flipped:
        row_scaled = not row_scaled
    kernels.check_cuda(X, dtype=_F64, contiguous=False)
    R, C = X.shape
    S = [torch.empty(R, C, dtype=_F64, device=X.device) for _ in range(3)]
    kernels.launch("dd_split.cu", "ozaki_split_launch", X.data_ptr(),
                   X.stride(0), R, C, int(row_scaled), split_bits(k),
                   *(s.data_ptr() for s in S))
    kernels.count("ozaki_split",
                  f"{R}x{C} {'rows' if row_scaled else 'cols'}")
    return [s.T for s in S] if flipped else S


# -------------------------------------------------------------- dd GEMM/GEMV

# the 8 slice products after S0 S0', largest first
_ORDER = ((0, 1), (1, 0), (0, 2), (1, 1), (2, 0), (1, 2), (2, 1), (2, 2))


def dd_gemm(Ah, Al, Bh, Bl, As=None, Bs=None):
    """(Ah + Al) @ (Bh + Bl) in double-double: exact slice products plus
    the cross terms Ah Bl and Al Bh.  Ah: (m, k), Bh: (k, n); Al / Bl may
    be None (pure f64 operands).  As / Bs, when given, are the slices of
    Ah (per row) and Bh (per column) with this k, split once by the caller
    for several products: a line's slices depend only on the line and k,
    so passing them changes no bit."""
    k = Ah.shape[-1]
    if As is None:
        As = ozaki_split(Ah, k, axis=-1)
    if Bs is None:
        Bs = ozaki_split(Bh, k, axis=0 if Bh.dim() == 2 else -1)
    Sh = As[0] @ Bs[0]
    Sl = torch.zeros_like(Sh)
    terms = [(As[i], Bs[j]) for i, j in _ORDER]
    if Bl is not None:
        terms.append((Ah, Bl))
    if Al is not None:
        terms.append((Al, Bh))
    P = torch.empty_like(Sh)
    for n, (a, b) in enumerate(terms):
        torch.matmul(a, b, out=P)
        dd_accumulate(Sh, Sl, P, normalize=n == len(terms) - 1)
    return Sh, Sl


def dd_gemv_plain(Ah, Al, xh, xl):
    """Matrix-vector product in dd, as the reference: dd_gemm on a column."""
    yh, yl = dd_gemm(Ah, Al, xh[:, None], xl[:, None])
    return yh[:, 0], yl[:, 0]


def dd_gemv(Ah, Al, xh, xl):
    """(Ah + Al)(xh + xl) in dd.  Kernel K6 on the card, which reads A
    through its strides (row-sliced panels and transposed views run
    without a copy); its summation order differs from the twin's, within
    c eps^2 sum_j |A_ij x_j|."""
    if not Ah.is_cuda:
        return dd_gemv_plain(Ah, Al, xh, xl)
    if Al.stride() != Ah.stride():
        Ah, Al = Ah.contiguous(), Al.contiguous()
    xh, xl = xh.contiguous(), xl.contiguous()
    m, n = Ah.shape
    if Al.shape != Ah.shape or xh.shape != (n,) or xl.shape != (n,):
        raise ValueError(f"dd_gemv: A {tuple(Ah.shape)}, x "
                         f"{tuple(xh.shape)} do not match")
    kernels.check_cuda(Ah, Al, dtype=_F64, contiguous=False)
    kernels.check_cuda(xh, xl, dtype=_F64)
    yh = torch.empty(m, dtype=_F64, device=Ah.device)
    yl = torch.empty_like(yh)
    kernels.launch("dd_gemv.cu", "dd_gemv_launch", Ah.data_ptr(),
                   Al.data_ptr(), Ah.stride(0), Ah.stride(1), xh.data_ptr(),
                   xl.data_ptr(), m, n, yh.data_ptr(), yl.data_ptr())
    kernels.LAUNCHES["dd_gemv"] += 1
    return yh, yl


# --------------------------------------------------------------- Cholesky


class DdCholFactor(NamedTuple):
    """Double-double Cholesky L L' = A, with the dd inverses of the
    diagonal panels (panel k's w x w inverse, rows of inv(L_kk), in the
    top left corner of inv_h[k] + inv_l[k], [P, nb, nb]) and ok = no pivot
    was replaced (a 0-dim bool tensor)."""

    Lh: torch.Tensor
    Ll: torch.Tensor
    inv_h: torch.Tensor
    inv_l: torch.Tensor
    nb: int
    ok: torch.Tensor

    @property
    def inv_diag(self) -> list:
        """(inv_h, inv_l) of each panel, its w x w corner."""
        m = self.Lh.shape[0]
        return [(self.inv_h[k, :w, :w], self.inv_l[k, :w, :w])
                for k, w in enumerate(min(self.nb, m - p0)
                                      for p0 in range(0, m, self.nb))]


def dd_panel_chol_plain(Sh, Sl):
    """One panel S [nr, w] (nr >= w) of the dd Cholesky after its trailing
    update: returns (Lh, Ll) [nr, w] (zero above the diagonal), the dd
    inverse (Ih, Il) of the w x w diagonal factor, and ok (the reference's
    dd_chol column loop and panel inverse, ddlinalg.py:166-206)."""
    Sh, Sl = Sh.clone(), Sl.clone()
    nr, w = Sh.shape
    Lh, Ll = torch.zeros_like(Sh), torch.zeros_like(Sh)
    ok = torch.ones((), dtype=torch.bool, device=Sh.device)
    for j in range(w):
        dh, dl = Sh[j, j], Sl[j, j]
        # not (dh > 0): Python's max(abs(dh), 1e-300) keeps a NaN
        bad = ~(dh > 0)
        v = torch.abs(dh)
        v = torch.where(1e-300 > v, 1e-300, v)
        dh, dl = torch.where(bad, v, dh), torch.where(bad, 0.0, dl)
        ok = ok & ~bad
        sh_, sl_ = dd_sqrt(dh, dl)
        ch, cl = dd_div(Sh[j:, j], Sl[j:, j], sh_, sl_)
        Lh[j:, j], Ll[j:, j] = ch, cl
        if j + 1 < w:
            # S[:, j+1:w] -= outer(col, col[1:..]) in dd
            ph, pe = two_prod(ch[1:, None], ch[None, 1:w - j])
            pl = pe + ch[1:, None] * cl[None, 1:w - j] \
                + cl[1:, None] * ch[None, 1:w - j]
            Sh2, Sl2 = dd_sub_plain(Sh[j + 1:, j + 1:w], Sl[j + 1:, j + 1:w],
                                    ph, pl)
            Sh[j + 1:, j + 1:w], Sl[j + 1:, j + 1:w] = Sh2, Sl2
    Ih, Il = torch.zeros(w, w, dtype=_F64, device=Sh.device), \
        torch.zeros(w, w, dtype=_F64, device=Sh.device)
    Eh = torch.eye(w, dtype=_F64, device=Sh.device)
    El = torch.zeros_like(Eh)
    for j in range(w):
        qh, ql = dd_div(Eh[j], El[j], Lh[j, j], Ll[j, j])
        Ih[j], Il[j] = qh, ql
        if j + 1 < w:
            lh, ll = Lh[j + 1:w, j], Ll[j + 1:w, j]
            ph, pe = two_prod(lh[:, None], qh[None, :])
            pl = pe + lh[:, None] * ql[None, :] + ll[:, None] * qh[None, :]
            Eh2, El2 = dd_sub_plain(Eh[j + 1:], El[j + 1:], ph, pl)
            Eh[j + 1:], El[j + 1:] = Eh2, El2
    return Lh, Ll, Ih, Il, ok


def dd_panel_chol(Sh, Sl):
    """dd_panel_chol_plain; kernel K7 on the card (bit for bit)."""
    if not Sh.is_cuda:
        return dd_panel_chol_plain(Sh, Sl)
    nr, w = Sh.shape
    if Sl.shape != Sh.shape or not 0 < w <= 64 or nr < w:
        raise ValueError(f"dd_panel_chol needs an [nr, w] panel with "
                         f"nr >= w and w <= 64, got {tuple(Sh.shape)}")
    # the kernel reads S through its row stride (a column panel of A runs
    # without a copy) and writes every element of L, I and ok
    if Sh.stride() != Sl.stride() or Sh.stride(1) != 1 \
            or Sh.stride(0) < w:
        Sh, Sl = Sh.contiguous(), Sl.contiguous()
    kernels.check_cuda(Sh, Sl, dtype=_F64, contiguous=False)
    Lh = torch.empty(nr, w, dtype=_F64, device=Sh.device)
    Ll = torch.empty_like(Lh)
    Ih = torch.empty(w, w, dtype=_F64, device=Sh.device)
    Il = torch.empty_like(Ih)
    ok = torch.empty(1, dtype=torch.int32, device=Sh.device)
    kernels.launch("dd_chol.cu", "dd_panel_chol_launch", Sh.data_ptr(),
                   Sl.data_ptr(), Sh.stride(0), nr, w, Lh.data_ptr(),
                   Ll.data_ptr(), Ih.data_ptr(), Il.data_ptr(), ok.data_ptr())
    kernels.LAUNCHES["dd_panel_chol"] += 1
    return Lh, Ll, Ih, Il, ok[0] == 1


def dd_chol(Ah: torch.Tensor, Al: torch.Tensor | None = None,
            nb: int = 48) -> DdCholFactor:
    """Left-looking blocked dd Cholesky of an SPD matrix given as a dd
    pair: the trailing update of each panel is dd_gemm + dd_sub, the
    panel itself and its diagonal inverse are dd_panel_chol."""
    m = Ah.shape[0]
    if Al is None:
        Al = torch.zeros_like(Ah)
    Lh = torch.zeros(m, m, dtype=_F64, device=Ah.device)
    Ll = torch.zeros_like(Lh)
    inv_h = torch.zeros(-(-m // nb), nb, nb, dtype=_F64, device=Ah.device)
    inv_l = torch.zeros_like(inv_h)
    ok = torch.ones((), dtype=torch.bool, device=Ah.device)
    for k, p0 in enumerate(range(0, m, nb)):
        p1 = min(p0 + nb, m)
        Sh, Sl = Ah[p0:, p0:p1], Al[p0:, p0:p1]
        if p0:
            # the B operand's lines are A's first p1 - p0 rows, same k
            As = ozaki_split(Lh[p0:, :p0], p0, axis=-1)
            Uh, Ul = dd_gemm(Lh[p0:, :p0], Ll[p0:, :p0],
                             Lh[p0:p1, :p0].T, Ll[p0:p1, :p0].T, As=As,
                             Bs=[s[:p1 - p0].T for s in As])
            Sh, Sl = dd_sub(Sh, Sl, Uh, Ul)
        Ph, Pl, Ih, Il, okp = dd_panel_chol(Sh, Sl)
        Lh[p0:, p0:p1], Ll[p0:, p0:p1] = Ph, Pl
        inv_h[k, :p1 - p0, :p1 - p0], inv_l[k, :p1 - p0, :p1 - p0] = Ih, Il
        ok = ok & okp
    return DdCholFactor(Lh, Ll, inv_h, inv_l, nb, ok)


def dd_chol_solve_panels(f: DdCholFactor, bh: torch.Tensor,
                         bl: torch.Tensor | None = None):
    """Solve L L' x = b in dd, blockwise: dd_gemv on the panels and on the
    diagonal inverses, dd_sub between (K6 and K5 launches on the card).
    dd_chol_solve's route on the CPU; on the card the fused solve's twin,
    which it equals bit for bit."""
    m = f.Lh.shape[0]
    nb = f.nb
    if bl is None:
        bl = torch.zeros_like(bh)
    inv = f.inv_diag
    xh, xl = torch.zeros_like(bh), torch.zeros_like(bh)
    # forward: L y = b
    for p0 in range(0, m, nb):
        p1 = min(p0 + nb, m)
        rh, rl = bh[p0:p1], bl[p0:p1]
        if p0:
            uh, ul = dd_gemv(f.Lh[p0:p1, :p0], f.Ll[p0:p1, :p0],
                             xh[:p0], xl[:p0])
            rh, rl = dd_sub(rh, rl, uh, ul)
        Ih, Il = inv[p0 // nb]
        xh[p0:p1], xl[p0:p1] = dd_gemv(Ih, Il, rh, rl)
    # backward: L' z = y
    zh, zl = torch.zeros_like(bh), torch.zeros_like(bh)
    for p0 in reversed(range(0, m, nb)):
        p1 = min(p0 + nb, m)
        rh, rl = xh[p0:p1], xl[p0:p1]
        if p1 < m:
            uh, ul = dd_gemv(f.Lh[p1:, p0:p1].T, f.Ll[p1:, p0:p1].T,
                             zh[p1:], zl[p1:])
            rh, rl = dd_sub(rh, rl, uh, ul)
        Ih, Il = inv[p0 // nb]
        zh[p0:p1], zl[p0:p1] = dd_gemv(Ih.T, Il.T, rh, rl)
    return zh, zl


def dd_chol_solve(f: DdCholFactor, bh: torch.Tensor,
                  bl: torch.Tensor | None = None):
    """Solve L L' x = b in dd (bl None means 0).  On the card one launch
    of the fused solve (csrc/dd_gemv.cu, a cluster of 16 CTAs), bit for
    bit dd_chol_solve_panels; an order whose solution copies do not fit
    the CTAs' shared memory (m > 5472 at nb = 48) raises.  On the CPU
    dd_chol_solve_panels."""
    if not bh.is_cuda:
        return dd_chol_solve_panels(f, bh, bl)
    m = f.Lh.shape[0]
    bh = bh.contiguous()
    if bl is not None:
        bl = bl.contiguous()
        kernels.check_cuda(bl, dtype=_F64)
    kernels.check_cuda(bh, f.Lh, f.Ll, f.inv_h, f.inv_l, dtype=_F64)
    if bh.shape != (m,) or (bl is not None and bl.shape != (m,)) \
            or f.Ll.shape != (m, m) or f.inv_h.shape[1:] != (f.nb, f.nb):
        raise ValueError(f"dd_chol_solve: L {tuple(f.Lh.shape)}, b "
                         f"{tuple(bh.shape)} do not match")
    zh, zl = torch.empty_like(bh), torch.empty_like(bh)
    kernels.launch("dd_gemv.cu", "dd_chol_solve_launch", f.Lh.data_ptr(),
                   f.Ll.data_ptr(), f.Lh.stride(0), f.inv_h.data_ptr(),
                   f.inv_l.data_ptr(), bh.data_ptr(),
                   None if bl is None else bl.data_ptr(), m, f.nb,
                   zh.data_ptr(), zl.data_ptr())
    kernels.LAUNCHES["dd_chol_solve"] += 1
    return zh, zl
