"""The constraint operator [A; c'] in bucketed form, as torch tensors.

Row convention (as in the reference package): rows 0..m-1 are the
constraints, row m is the objective c, so one product gives A x and c'x,
and the adjoint of w = [y; t] is A'y + c t.

:class:`CooAOp` keeps the LP/Lorentz parts dense ([m+1, nl] and
[m+1, count*d]) and each PSD bucket either 'dense' (flat [m+1, k*d*d])
or 'coo': sorted triplets b_row/b_loc/b_val for apply/adjoint and the
Schur gather, plus per-(row, block) padded groups g_row/g_blk/gp/gq/gv
and their output slots g_slot = g_row*k + g_blk for the scaled-operator
build (schur._psd_contrib_coo).  build_coo_aop
picks the representation per bucket by the reference's flop model,
gemm_discount=3.0 included, so the dense/coo choice is the reference's.
(The reference's DenseAOp is the all-'dense' special case; the port's
solver never builds it.)
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .cones import Layout
from .structs import F64, ConeVec


def _put(a, device, dtype=F64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


class CooAOp:
    """Sparsity-aware bucketed operator for [A; c'] (see module doc).

    s_parts[i] is a dict of tensors for PSD bucket i; s_meta[i] is
    (rep, k, d, G, pad2, T)."""

    def __init__(self, Al, Aq, s_parts, q_shapes, s_meta):
        self.Al = Al
        self.Aq = tuple(Aq)
        self.s_parts = tuple(s_parts)
        self.q_shapes = tuple(tuple(s) for s in q_shapes)
        self.s_meta = tuple(s_meta)

    @property
    def m(self) -> int:
        return self.Al.shape[0] - 1

    def apply(self, x: ConeVec) -> torch.Tensor:
        """[A x ; c'x] -- shape [m+1]."""
        mp1 = self.m + 1
        out = self.Al @ x.l if self.Al.shape[1] else \
            torch.zeros(mp1, dtype=F64, device=self.Al.device)
        for aq, xq in zip(self.Aq, x.q):
            out = out + aq @ xq.reshape(-1)
        for part, (rep, k, d, G, pad2, T), xs in zip(
                self.s_parts, self.s_meta, x.s):
            if rep == "dense":
                out = out + part["mat"] @ xs.reshape(-1)
            else:
                contrib = part["b_val"] * xs.reshape(-1)[part["b_loc"]]
                out = out + torch.zeros(mp1, dtype=F64, device=out.device) \
                    .index_add_(0, part["b_row"], contrib)
        return out

    def adj(self, w: torch.Tensor) -> ConeVec:
        """w = [y; t] -> A'y + c t."""
        l = self.Al.T @ w
        q = tuple((w @ aq).reshape(c, d)
                  for aq, (c, d) in zip(self.Aq, self.q_shapes))
        s = []
        for part, (rep, k, d, G, pad2, T) in zip(self.s_parts, self.s_meta):
            if rep == "dense":
                s.append((w @ part["mat"]).reshape(k, d, d))
            else:
                vw = part["b_val"] * w[part["b_row"]]
                flat = torch.zeros(k * d * d, dtype=F64, device=w.device) \
                    .index_add_(0, part["b_loc"], vw)
                s.append(flat.reshape(k, d, d))
        return ConeVec(l=l, q=tuple(q), s=tuple(s))

    def adj_y(self, y: torch.Tensor, minus_tau: torch.Tensor) -> ConeVec:
        return self.adj(torch.cat([y, minus_tau.reshape(1)]))


def coo_arrays(At: sp.spmatrix, c: np.ndarray, layout: Layout,
               gemm_discount: float = 3.0):
    """Host (numpy) half of build_coo_aop: the dense LP/Lorentz matrices
    and, per PSD bucket, the chosen representation with its arrays.

    Returns (Al, Aq list, q_shapes, s_parts list of dicts of ndarrays,
    s_meta list)."""
    N, m = At.shape
    if N != layout.N:
        raise ValueError(f"At has {N} rows, layout expects {layout.N}")
    mp1 = m + 1
    aug = sp.hstack(
        [sp.csc_matrix(At),
         sp.csc_matrix(np.asarray(c, np.float64).reshape(-1, 1))]
    ).T.tocsr()          # [m+1, N]: rows = constraints, last row = c

    nl = layout.l
    Al = np.asarray(aug[:, :nl].todense(), np.float64) if nl \
        else np.zeros((mp1, 0), np.float64)
    Aq, q_shapes = [], []
    q_offs = layout.q_offsets()
    for b in layout.q_buckets:
        cols = np.concatenate([q_offs[i] + np.arange(b.dim)
                               for i in b.block_ids]) \
            if b.count else np.zeros(0, np.int64)
        Aq.append(np.asarray(aug[:, cols].todense(), np.float64))
        q_shapes.append((b.count, b.dim))

    s_offs = layout.s_offsets()
    s_parts, s_meta = [], []
    for b in layout.s_buckets:
        k, d = b.count, b.dim
        cols = np.concatenate([s_offs[i] + np.arange(d * d)
                               for i in b.block_ids]) \
            if k else np.zeros(0, np.int64)
        sub = aug[:, cols].tocoo()  # cols now in bucket-local flat order
        # symmetrize per block: X -> (X + X')/2 in the d x d coordinates
        loc = sub.col.astype(np.int64)
        blk = loc // (d * d)
        p = (loc % (d * d)) // d
        qq = loc % d
        rows2 = np.concatenate([sub.row, sub.row])
        blk2 = np.concatenate([blk, blk])
        p2 = np.concatenate([p, qq])
        q2 = np.concatenate([qq, p])
        v2 = np.concatenate([sub.data, sub.data]) * 0.5
        M2 = sp.coo_matrix((v2, (rows2, blk2 * d * d + p2 * d + q2)),
                           shape=(mp1, k * d * d)).tocsr()
        M2.sum_duplicates()
        sub = M2.tocoo()
        b_row = sub.row.astype(np.int64)
        b_loc = sub.col.astype(np.int64)
        b_val = sub.data.astype(np.float64)
        T = b_row.size

        # group by (row, block): padded arrays for the scaled-operator build
        blk_of = b_loc // (d * d)
        keys = b_row * max(k, 1) + blk_of
        order = np.argsort(keys, kind="stable")
        kr, kb = b_row[order], blk_of[order]
        uk, start = np.unique(keys[order], return_index=True)
        counts = np.diff(np.concatenate([start, [T]]))
        G = uk.size
        pad2 = int(counts.max()) if G else 1
        # flop model (per iteration): sparse = outer-product GEMMs + gather;
        # dense = chunked congruence + B B' GEMM (schur._psd_contrib)
        sparse_cost = G * pad2 * d * d * 2 + T * mp1
        dense_cost = mp1 * 4 * k * d**3 + mp1 * mp1 * k * d * d
        rep = "coo" if sparse_cost * gemm_discount < dense_cost else "dense"
        if rep == "dense" or T == 0:
            mat = np.zeros((mp1, k * d * d), np.float64)
            mat[b_row, b_loc] = b_val
            s_parts.append({"mat": mat})
            s_meta.append(("dense", k, d, 0, 0, int(T)))
            continue
        gp = np.zeros((G, pad2), np.int64)
        gq = np.zeros((G, pad2), np.int64)
        gv = np.zeros((G, pad2), np.float64)
        pos_in_group = np.arange(T) - np.repeat(start, counts)
        gidx = np.repeat(np.arange(G), counts)
        loc_o = b_loc[order]
        gp[gidx, pos_in_group] = (loc_o % (d * d)) // d
        gq[gidx, pos_in_group] = loc_o % d
        gv[gidx, pos_in_group] = b_val[order]
        s_parts.append({
            "b_row": b_row, "b_loc": b_loc, "b_val": b_val,
            # CSR row pointers of the sorted b_row (the Schur gather kernel)
            "b_rowptr": np.searchsorted(b_row, np.arange(mp1 + 1)),
            "g_row": kr[start], "g_blk": kb[start],
            # B~ output slot of each group (schur.psd_outer)
            "g_slot": kr[start] * k + kb[start],
            "gp": gp, "gq": gq, "gv": gv,
        })
        s_meta.append(("coo", k, d, int(G), int(pad2), int(T)))
    return Al, Aq, q_shapes, s_parts, s_meta


def _part_to_torch(part: dict, device) -> dict:
    return {key: _put(a, device,
                      F64 if a.dtype == np.float64 else torch.int64)
            for key, a in part.items()}


def build_coo_aop(At: sp.spmatrix, c: np.ndarray, layout: Layout,
                  device="cuda", gemm_discount: float = 3.0) -> CooAOp:
    """Build the sparsity-aware operator on `device` from sparse internal
    data (reference opA.build_coo_aop, same representation choice)."""
    Al, Aq, q_shapes, s_parts, s_meta = coo_arrays(At, c, layout,
                                                   gemm_discount)
    return CooAOp(Al=_put(Al, device), Aq=[_put(a, device) for a in Aq],
                  s_parts=[_part_to_torch(p, device) for p in s_parts],
                  q_shapes=q_shapes, s_meta=s_meta)
