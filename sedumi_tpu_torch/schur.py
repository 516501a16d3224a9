"""Schur-complement formation M = [A; c'] H [A; c']'.

Counterpart of the reference's schur.py (reference analog: getada1-3.c +
spscale.c).  Per cone family:

  LP:   M += (Al * d) @ Al'                                  (library GEMM)
  SOC:  M += 2 U diag(eta2) U' - (Aq * eta2 * jsign) @ Aq'   (library GEMM)
  PSD, 'dense' bucket:  B[m,k] = R_k' A[m,k] R_k;  M += B B' (library bmm)
  PSD, 'coo' bucket:    kernel K2, _psd_contrib_coo

Everything runs in the operator's dtype: f64, or f32 in the precision
ladder's f32 and hybrid phases (K2-f32 on the card).  K2's pair entry,
psd_pair_values, forms the sparse engine's PSD pair values
(sparse_engine.ada_values).

The augmented row m carries c, so M holds ADA, A H c and c' H c.
"""

from __future__ import annotations

import torch

from . import kernels
from .nt import Scaling
from .opA import DenseAOp


def build_schur(aop, S: Scaling) -> torch.Tensor:
    """The (m+1) x (m+1) augmented Schur complement of a CooAOp or a
    DenseAOp.  An operator split over a device mesh
    (parallel.mesh.ShardedAOp) forms its own: partial sums all-reduced
    over the mesh's data axes."""
    if hasattr(aop, "schur"):
        return aop.schur(S)
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

    if isinstance(aop, DenseAOp):
        for as_, (k, d), r in zip(aop.As, aop.s_shapes, S.s_r):
            M = M + _psd_contrib(as_, k, d, r)
        return M
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


def _suffix(dtype) -> str:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"kernel K2 takes f32 or f64, got {dtype}")
    return "_f32" if dtype == torch.float32 else ""   # K2-f32


def psd_pair_values_plain(W: torch.Tensor, g_blk: torch.Tensor,
                          gp: torch.Tensor, gq: torch.Tensor,
                          gv: torch.Tensor, sp_g: torch.Tensor,
                          sp_loc: torch.Tensor,
                          sp_val: torch.Tensor) -> torch.Tensor:
    """B~_g at the sparse engine's pair entries (group sp_g, flat location
    sp_loc in d x d) times sp_val (plain PyTorch: the groups' whole blocks,
    then the gather)."""
    G = gp.shape[0]
    d = W.shape[-1]
    Bg = psd_outer_plain(W, g_blk, gp, gq, gv,
                         torch.arange(G, device=W.device), G)
    return Bg.reshape(G, d * d)[sp_g, sp_loc] * sp_val


def _psd_pair_values_kernel(W, g_blk, gp, gq, gv, sp_g, sp_loc, sp_val):
    """The same function on the card: csrc/psd_coo.cu psd_pair, one
    thread a pair, f64 or f32."""
    W = W.contiguous()
    suffix = _suffix(W.dtype)
    kernels.check_cuda(W, gv, sp_val, dtype=W.dtype)
    kernels.check_cuda(g_blk, gp, gq, sp_g, sp_loc, dtype=torch.int64)
    out = torch.empty_like(sp_val)
    kernels.launch("psd_coo.cu", f"psd_pair{suffix}_launch", W.data_ptr(),
                   g_blk.data_ptr(), gp.data_ptr(), gq.data_ptr(),
                   gv.data_ptr(), sp_g.data_ptr(), sp_loc.data_ptr(),
                   sp_val.data_ptr(), out.data_ptr(), out.numel(),
                   gp.shape[1], W.shape[-1])
    kernels.count("psd_contrib_coo" + suffix,
                  f"pairs {out.numel()} d {W.shape[-1]} pad2 {gp.shape[1]}")
    return out


def psd_pair_values(W, g_blk, gp, gq, gv, sp_g, sp_loc, sp_val):
    """The sparse engine's PSD pair values (kernel K2 on the card, one
    value a pair, written straight into the vector the segment sum
    takes); see psd_pair_values_plain."""
    if W.is_cuda:
        return _psd_pair_values_kernel(W, g_blk, gp, gq, gv, sp_g, sp_loc,
                                       sp_val)
    return psd_pair_values_plain(W, g_blk, gp, gq, gv, sp_g, sp_loc, sp_val)


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


# K2's staging limit (csrc/psd_coo.cu STAGE): a chunk's rows a and a row
# of W must fit beside each other
_MAX_D = 3072


def _psd_contrib_coo_kernel(part: dict, k: int, d: int, G: int, pad2: int,
                            mp1: int, W: torch.Tensor) -> torch.Tensor:
    """The same function on the card: csrc/psd_coo.cu psd_schur, one
    launch, B~ formed only at the needed entries (opA.needed_entries)."""
    W = W.contiguous()
    suffix = _suffix(W.dtype)
    if "b_uidx" not in part:
        raise ValueError("kernel K2 needs the part's needed-entry arrays "
                         "(opA.needed_entries)")
    if d > _MAX_D:
        raise ValueError(f"kernel K2 stages blocks of order <= {_MAX_D}, "
                         f"got {d}")
    kernels.check_cuda(W, part["gv"], part["b_val"], dtype=W.dtype)
    kernels.check_cuda(part["gp"], part["gq"], part["b_rowptr"],
                       dtype=torch.int64)
    ne = [part[key] for key in ("g_of", "u_e", "it", "ch", "b_uidx")]
    kernels.check_cuda(*ne, dtype=torch.int32)
    M = torch.empty(mp1, mp1, dtype=W.dtype, device=W.device)
    kernels.launch("psd_coo.cu", f"psd_schur{suffix}_launch", W.data_ptr(),
                   part["g_of"].data_ptr(), part["gp"].data_ptr(),
                   part["gq"].data_ptr(), part["gv"].data_ptr(),
                   part["u_e"].data_ptr(), part["it"].data_ptr(),
                   part["ch"].data_ptr(), part["ch"].shape[0] - 1,
                   part["b_rowptr"].data_ptr(), part["b_uidx"].data_ptr(),
                   part["b_val"].data_ptr(), M.data_ptr(), mp1, k, d, pad2)
    kernels.count("psd_contrib_coo" + suffix,
                  f"mp1 {mp1} d {d} G {G} pad2 {pad2} "
                  f"U {part['u_e'].numel()}")
    return M


def _psd_contrib_coo(part: dict, k: int, d: int, G: int, pad2: int,
                     mp1: int, r: torch.Tensor) -> torch.Tensor:
    """Sparse PSD Schur contribution (reference: getada3.c + spscale.c),
    M[i, j] = <A_i, W A_j W>; kernel K2 on the card."""
    W = psd_gram(r)
    if W.is_cuda:
        return _psd_contrib_coo_kernel(part, k, d, G, pad2, mp1, W)
    return _psd_contrib_coo_plain(part, k, d, G, pad2, mp1, W)
