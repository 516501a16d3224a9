"""Schur-complement formation M = [A; c'] H [A; c']'.

Counterpart of the reference's schur.py (reference analog: getada1-3.c +
spscale.c).  Per cone family:

  LP:   M += (Al * d) @ Al'                                  (library GEMM)
  SOC:  M += 2 U diag(eta2) U' - (Aq * eta2 * jsign) @ Aq'   (library GEMM)
  PSD, 'dense' bucket:  B[m,k] = R_k' A[m,k] R_k;  M += B B' (library bmm)
  PSD, 'coo' bucket:    kernel K2, _psd_contrib_coo

Everything runs in the operator's dtype: f64, or f32 in the precision
ladder's f32 and hybrid phases (K2-f32 on the card).  K2's first half, psd_outer, also builds the sparse engine's per-group
B~ (sparse_engine.TileSchurEngine).

The augmented row m carries c, so M holds ADA, A H c and c' H c.
"""

from __future__ import annotations

import torch

from . import kernels
from .nt import Scaling
from .opA import CooAOp


def build_schur(aop: CooAOp, S: Scaling) -> torch.Tensor:
    """The (m+1) x (m+1) augmented Schur complement."""
    mp1 = aop.m + 1
    M = torch.zeros(mp1, mp1, dtype=aop.Al.dtype, device=aop.Al.device)

    if aop.Al.shape[1]:
        M = M + (aop.Al * S.d_l[None, :]) @ aop.Al.T

    for aq, (c, d), wb, eta2 in zip(aop.Aq, aop.q_shapes, S.q_wb, S.q_eta2):
        u = torch.einsum("mcd,cd->mc", aq.reshape(mp1, c, d), wb)
        M = M + 2.0 * ((u * eta2[None, :]) @ u.T)
        jsign = torch.ones(d, dtype=aq.dtype, device=aq.device)
        jsign[1:] = -1.0
        w = (eta2[:, None] * jsign[None, :]).reshape(-1)   # [c*d]
        M = M - (aq * w[None, :]) @ aq.T

    for part, (rep, k, d, G, pad2, T), r in zip(aop.s_parts, aop.s_meta,
                                                S.s_r):
        if rep == "dense":
            M = M + _psd_contrib(part["mat"], k, d, r)
        elif T:
            M = M + _psd_contrib_coo(part, k, d, G, pad2, mp1, r)
    return M


def _psd_contrib(as_: torch.Tensor, k: int, d: int, r: torch.Tensor,
                 chunk: int = 128) -> torch.Tensor:
    """B B' with B[m, kdd] = vec(R_k' A[m,k] R_k), the congruence in
    m-chunks so the [m+1, k, d, d] temporaries never exist whole.
    as_ is flat [m+1, k*d*d]."""
    mp1 = as_.shape[0]
    kdd = k * d * d
    rt = r.transpose(-1, -2)
    bf = torch.empty(mp1, kdd, dtype=as_.dtype, device=as_.device)
    for st in range(0, mp1, chunk):
        a4 = as_[st:st + chunk].reshape(-1, k, d, d)
        bf[st:st + chunk] = (rt @ (a4 @ r)).reshape(-1, kdd)
    return bf @ bf.T


def psd_gram(r: torch.Tensor) -> torch.Tensor:
    """W = R R' per block (the NT metric, H = W (.) W), library bmm."""
    return r @ r.transpose(-1, -2)


def psd_outer_plain(W: torch.Tensor, g_blk: torch.Tensor, gp: torch.Tensor,
                    gq: torch.Tensor, gv: torch.Tensor, g_slot: torch.Tensor,
                    nout: int, chunk_elems: float = 6e7) -> torch.Tensor:
    """B~[g_slot[g]] = sum_t gv_t W[:, p_t] W[q_t, :] for every (row,
    block) group g, into [nout, d, d] zeros (plain PyTorch, in group
    chunks so the [g, pad2, d] temporaries stay bounded)."""
    G, pad2 = gp.shape
    d = W.shape[-1]
    btf = torch.zeros(nout, d, d, dtype=W.dtype, device=W.device)
    gchunk = max(1, int(chunk_elems // max(pad2 * d, 1)))
    for st in range(0, G, gchunk):
        en = min(st + gchunk, G)
        blk = g_blk[st:en]
        wp = W[blk[:, None], :, gp[st:en]] * gv[st:en, :, None]
        wq = W[blk[:, None], gq[st:en], :]
        btf[g_slot[st:en]] = torch.einsum("gtd,gte->gde", wp, wq)
    return btf


def _psd_outer_kernel(W: torch.Tensor, g_blk: torch.Tensor, gp: torch.Tensor,
                      gq: torch.Tensor, gv: torch.Tensor, g_slot: torch.Tensor,
                      nout: int) -> torch.Tensor:
    """The same function on the card: csrc/psd_coo.cu (a), f64 or f32."""
    W = W.contiguous()
    if W.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"psd_outer takes f32 or f64, got {W.dtype}")
    kernels.check_cuda(W, gv, dtype=W.dtype)
    kernels.check_cuda(g_blk, gp, gq, g_slot, dtype=torch.int64)
    G, pad2 = gp.shape
    d = W.shape[-1]
    btf = torch.zeros(nout, d, d, dtype=W.dtype, device=W.device)
    suffix = "_f32" if W.dtype == torch.float32 else ""   # K2-f32
    kernels.launch("psd_coo.cu", f"psd_coo_outer{suffix}_launch",
                   W.data_ptr(), g_slot.data_ptr(), g_blk.data_ptr(),
                   gp.data_ptr(), gq.data_ptr(), gv.data_ptr(),
                   btf.data_ptr(), G, pad2, d)
    kernels.LAUNCHES["psd_contrib_coo" + suffix] += 1
    return btf


def psd_outer(W: torch.Tensor, g_blk: torch.Tensor, gp: torch.Tensor,
              gq: torch.Tensor, gv: torch.Tensor, g_slot: torch.Tensor,
              nout: int) -> torch.Tensor:
    """Per-group scaled operators B~ (kernel K2 (a) on the card); see
    psd_outer_plain."""
    if W.is_cuda:
        return _psd_outer_kernel(W, g_blk, gp, gq, gv, g_slot, nout)
    return psd_outer_plain(W, g_blk, gp, gq, gv, g_slot, nout)


def _psd_contrib_coo_plain(part: dict, k: int, d: int, G: int, pad2: int,
                           mp1: int, W: torch.Tensor) -> torch.Tensor:
    """Sparse PSD Schur contribution from W = R R' (plain PyTorch):
      B~[row*k + blk] = sum_t gv_t W[:, p_t] W[q_t, :]   per group,
      M[i, j] = sum_{t in row i} b_val_t B~[j][b_loc_t]."""
    btf = psd_outer_plain(W, part["g_blk"], part["gp"], part["gq"],
                          part["gv"], part["g_slot"], mp1 * k)
    tmp = btf.reshape(mp1, k * d * d)[:, part["b_loc"]] \
        * part["b_val"][None, :]                                # [mp1, T]
    return torch.zeros(mp1, mp1, dtype=W.dtype, device=W.device) \
        .index_add_(0, part["b_row"], tmp.T)


def _psd_contrib_coo_kernel(part: dict, k: int, d: int, G: int, pad2: int,
                            mp1: int, W: torch.Tensor) -> torch.Tensor:
    """The same function on the card: csrc/psd_coo.cu (a) builds B~ group
    by group, (b) gathers M row by row."""
    kernels.check_cuda(part["b_val"], dtype=W.dtype)
    kernels.check_cuda(part["b_rowptr"], part["b_loc"], dtype=torch.int64)
    btf = _psd_outer_kernel(W, part["g_blk"], part["gp"], part["gq"],
                            part["gv"], part["g_slot"], mp1 * k)
    M = torch.empty(mp1, mp1, dtype=W.dtype, device=W.device)
    suffix = "_f32" if W.dtype == torch.float32 else ""
    kernels.launch("psd_coo.cu", f"psd_coo_gather{suffix}_launch",
                   btf.data_ptr(),
                   part["b_rowptr"].data_ptr(), part["b_loc"].data_ptr(),
                   part["b_val"].data_ptr(), M.data_ptr(), mp1, k * d * d)
    return M


def _psd_contrib_coo(part: dict, k: int, d: int, G: int, pad2: int,
                     mp1: int, r: torch.Tensor) -> torch.Tensor:
    """Sparse PSD Schur contribution (reference: getada3.c + spscale.c),
    M[i, j] = <A_i, W A_j W>; kernel K2 on the card."""
    W = psd_gram(r)
    if W.is_cuda:
        return _psd_contrib_coo_kernel(part, k, d, G, pad2, mp1, W)
    return _psd_contrib_coo_plain(part, k, d, G, pad2, mp1, W)
