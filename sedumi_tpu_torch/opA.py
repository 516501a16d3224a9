"""The constraint operator [A; c'] in bucketed form, as torch tensors.

Row convention (as in the reference package): rows 0..m-1 are the
constraints, row m is the objective c, so one product gives A x and c'x,
and the adjoint of w = [y; t] is A'y + c t.

:class:`CooAOp` keeps the LP/Lorentz parts dense ([m+1, nl] and
[m+1, count*d]) and each PSD bucket either 'dense' (flat [m+1, k*d*d])
or 'coo': sorted triplets b_row/b_loc/b_val for apply/adjoint and the
Schur gather, plus per-(row, block) padded groups g_row/g_blk/gp/gq/gv
and their output slots g_slot = g_row*k + g_blk, plus the needed-entry
arrays of kernel K2 (needed_entries: the distinct locations U of b_loc,
cut into items and chunks, and each nonzero's index into U) for the Schur
formation (schur._psd_contrib_coo).  build_coo_aop
picks the representation per bucket by the reference's flop model,
gemm_discount=3.0 included, so the dense/coo choice is the reference's.
It builds the operator in f64, or in f32 for the precision ladder's f32
and hybrid phases.

:class:`DenseAOp` is the all-dense bucketed layout (flat [m+1, k*d*d]
PSD buckets); build_dense_aop(device="numpy") gives its host arrays, from
which df.build_df_aop splits the double-float operator.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .cones import Layout
from .structs import F64, ConeVec


def _put(a, device, dtype=F64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


class DenseAOp:
    """Dense bucketed operator for [A; c'] (reference opA.py:39-87): Al
    [m+1, nl], Aq per q-bucket [m+1, count*d], As per s-bucket
    [m+1, count*d*d] (symmetrized blocks)."""

    def __init__(self, Al, Aq, As, q_shapes, s_shapes):
        self.Al = Al
        self.Aq = tuple(Aq)
        self.As = tuple(As)
        self.q_shapes = tuple(tuple(s) for s in q_shapes)
        self.s_shapes = tuple(tuple(s) for s in s_shapes)

    @property
    def m(self) -> int:
        return self.Al.shape[0] - 1

    def apply(self, x: ConeVec) -> torch.Tensor:
        """[A x ; c'x] -- shape [m+1]."""
        out = self.Al @ x.l if self.Al.shape[1] else \
            torch.zeros(self.m + 1, dtype=self.Al.dtype, device=x.l.device)
        for a, xv in zip(self.Aq + self.As, x.q + x.s):
            out = out + a @ xv.reshape(-1)
        return out

    def adj(self, w: torch.Tensor) -> ConeVec:
        """w = [y; t] -> A'y + c t."""
        return ConeVec(
            l=self.Al.T @ w,
            q=tuple((w @ aq).reshape(c, d)
                    for aq, (c, d) in zip(self.Aq, self.q_shapes)),
            s=tuple((w @ as_).reshape(c, d, d)
                    for as_, (c, d) in zip(self.As, self.s_shapes)))

    def adj_y(self, y: torch.Tensor, minus_tau: torch.Tensor) -> ConeVec:
        return self.adj(torch.cat([y, minus_tau.reshape(1)]))


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
            torch.zeros(mp1, dtype=self.Al.dtype, device=self.Al.device)
        for aq, xq in zip(self.Aq, x.q):
            out = out + aq @ xq.reshape(-1)
        for part, (rep, k, d, G, pad2, T), xs in zip(
                self.s_parts, self.s_meta, x.s):
            if rep == "dense":
                out = out + part["mat"] @ xs.reshape(-1)
            else:
                contrib = part["b_val"] * xs.reshape(-1)[part["b_loc"]]
                out = out + torch.zeros(mp1, dtype=out.dtype,
                                        device=out.device) \
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
                flat = torch.zeros(k * d * d, dtype=w.dtype,
                                   device=w.device) \
                    .index_add_(0, part["b_loc"], vw)
                s.append(flat.reshape(k, d, d))
        return ConeVec(l=l, q=tuple(q), s=tuple(s))

    def adj_y(self, y: torch.Tensor, minus_tau: torch.Tensor) -> ConeVec:
        return self.adj(torch.cat([y, minus_tau.reshape(1)]))


# K2's work units (csrc/psd_coo.cu R and UC): a chunk is a range of at
# most CHUNK_ENTRIES entries of U in one block, an item a row's segment of
# at most ITEM_ENTRIES entries inside one chunk
ITEM_ENTRIES = 4
CHUNK_ENTRIES = 4096


def _rotations(es: np.ndarray, itemsize: int) -> np.ndarray:
    """Per item (a row of es: its columns, -1 past its entries) the
    rotation of its slots that a greedy pass picks so that, slot by slot,
    the shared-memory loads of W[q_t, e] over a group of threads (a
    half-warp for 8-byte values, a warp for 4-byte ones) fall on distinct
    banks (16 of 8 bytes or 32 of 4); the items run 32 to a warp from the
    chunk's start.  A padded slot loads column 0."""
    n_i, R = es.shape
    nbank = 128 // itemsize
    group = 16 if itemsize == 8 else 32
    rot = np.zeros(n_i, np.int64)
    for g0 in range(0, n_i, group):
        load = [{} for _ in range(R)]        # slot -> bank -> addresses
        for x in range(g0, min(g0 + group, n_i)):
            row = [int(e) if e >= 0 else 0 for e in es[x]]
            best = None
            for k in range(R):
                cost = 0
                for r in range(R):
                    addr = row[(r + k) % R]
                    seen = load[r].get(addr % nbank, ())
                    cost += 0 if addr in seen else len(seen)
                if best is None or cost < best[0]:
                    best = (cost, k)
            rot[x] = best[1]
            for r in range(R):
                addr = row[(r + best[1]) % R]
                load[r].setdefault(addr % nbank, set()).add(addr)
    return rot


def needed_entries(b_row, b_loc, g_slot, mp1: int, k: int, d: int,
                   itemsize: int = 8) -> dict:
    """The locations K2 forms, as int32 arrays (keys added to a COO part):

      u_e    [nU]       column e of each distinct location U (sorted b_loc)
      it     [nI, 3]    items: blk * d + a, first entry (index into U),
                        entries n + 16 * rotation (slot r takes the
                        item's entry (r + rotation) % ITEM_ENTRIES)
      ch     [nC+1, 4]  chunks: first item, first entry, rows a_lo, a_hi
                        (the last row: nI, nU, 0, 0)
      b_uidx [T]        each nonzero's index into U (ascending in each row)
      g_of   [mp1*k]    the group of (row, blk), or -1

    A chunk takes whole rows a of one block while they fit (a longer row
    is cut).  Its items run by (segment, row): the threads of a warp take
    neighbouring rows' same segment, whose columns lie close together in
    a banded pattern; each item's slots are rotated so that a warp's loads
    of one slot rarely share a bank (_rotations; itemsize: the value type's
    bytes).  b_row must ascend and b_loc ascend within each row
    (coo_arrays' order)."""
    b_row = np.asarray(b_row, np.int64)
    b_loc = np.asarray(b_loc, np.int64)
    R = ITEM_ENTRIES
    dd = d * d
    U = np.unique(b_loc)
    b_uidx = np.searchsorted(U, b_loc)
    same_row = b_row[1:] == b_row[:-1]
    if np.any(b_row[1:] < b_row[:-1]) or np.any(
            same_row & (b_uidx[1:] <= b_uidx[:-1])):
        raise ValueError("needed_entries: b_row must ascend and b_loc "
                         "ascend within each row")
    ab = (U // dd) * d + (U % dd) // d
    starts = np.flatnonzero(np.r_[True, ab[1:] != ab[:-1]])
    ends = np.r_[starts[1:], U.size]
    bounds = [0]
    for s0, s1 in zip(starts, ends):      # the rows of U, in order
        b0 = bounds[-1]
        if s0 > b0 and (ab[s0] // d != ab[b0] // d
                        or s1 - b0 > CHUNK_ENTRIES):
            bounds.append(int(s0))
        while s1 - bounds[-1] > CHUNK_ENTRIES:
            bounds.append(bounds[-1] + CHUNK_ENTRIES)
    bounds.append(U.size)
    items, chunks = [], []
    for u0, u1 in zip(bounds[:-1], bounds[1:]):
        abc = ab[u0:u1]
        first = np.r_[True, abc[1:] != abc[:-1]]
        pos = np.arange(abc.size) - np.flatnonzero(first)[np.cumsum(first)
                                                          - 1]
        seg = pos // R
        order = np.lexsort((abc, seg))          # by segment, then row
        key = seg[order] * (k * d) + abc[order]
        head = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        n = np.diff(np.r_[head, order.size])
        ua = u0 + order[head]
        es = np.where(np.arange(R) < n[:, None],
                      U[np.minimum(ua[:, None] + np.arange(R), U.size - 1)]
                      % d, -1)
        chunks.append((sum(len(x) for x in items), u0, abc[0] % d,
                       abc[-1] % d))
        items.append(np.stack([abc[order][head], ua,
                               n + 16 * _rotations(es, itemsize)], axis=1))
    n_items = sum(len(x) for x in items)
    chunks.append((n_items, U.size, 0, 0))
    g_of = np.full(mp1 * k, -1, np.int64)
    g_of[np.asarray(g_slot, np.int64)] = np.arange(len(g_slot))
    i32 = np.int32
    return {"u_e": (U % d).astype(i32),
            "it": (np.concatenate(items) if items
                   else np.zeros((0, 3))).astype(i32),
            "ch": np.asarray(chunks, i32).reshape(-1, 4),
            "b_uidx": b_uidx.astype(i32), "g_of": g_of.astype(i32)}


def coo_arrays(At: sp.spmatrix, c: np.ndarray, layout: Layout,
               gemm_discount: float = 3.0, dtype=np.float64):
    """Host (numpy) half of build_coo_aop: the dense LP/Lorentz matrices
    and, per PSD bucket, the chosen representation with its arrays, the
    values in `dtype` (rounded as the reference rounds them: c to dtype
    first, the symmetrized values after their f64 sums).

    Returns (Al, Aq list, q_shapes, s_parts list of dicts of ndarrays,
    s_meta list)."""
    N, m = At.shape
    if N != layout.N:
        raise ValueError(f"At has {N} rows, layout expects {layout.N}")
    mp1 = m + 1
    aug = sp.hstack(
        [sp.csc_matrix(At),
         sp.csc_matrix(np.asarray(c, dtype).reshape(-1, 1))]
    ).T.tocsr()          # [m+1, N]: rows = constraints, last row = c

    nl = layout.l
    Al = np.asarray(aug[:, :nl].todense(), dtype) if nl \
        else np.zeros((mp1, 0), dtype)
    Aq, q_shapes = [], []
    q_offs = layout.q_offsets()
    for b in layout.q_buckets:
        cols = np.concatenate([q_offs[i] + np.arange(b.dim)
                               for i in b.block_ids]) \
            if b.count else np.zeros(0, np.int64)
        Aq.append(np.asarray(aug[:, cols].todense(), dtype))
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
        b_val = sub.data.astype(dtype)
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
            mat = np.zeros((mp1, k * d * d), dtype)
            mat[b_row, b_loc] = b_val
            s_parts.append({"mat": mat})
            s_meta.append(("dense", k, d, 0, 0, int(T)))
            continue
        gp = np.zeros((G, pad2), np.int64)
        gq = np.zeros((G, pad2), np.int64)
        gv = np.zeros((G, pad2), dtype)
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
            # B~ output slot of each group (schur.psd_outer_plain)
            "g_slot": kr[start] * k + kb[start],
            "gp": gp, "gq": gq, "gv": gv,
        })
        s_parts[-1].update(needed_entries(b_row, b_loc, s_parts[-1]["g_slot"],
                                          mp1, k, d,
                                          np.dtype(dtype).itemsize))
        s_meta.append(("coo", k, d, int(G), int(pad2), int(T)))
    return Al, Aq, q_shapes, s_parts, s_meta


def _part_to_torch(part: dict, device, dtype=F64) -> dict:
    """Floats in `dtype`; K2's needed-entry arrays stay int32, the other
    indices int64."""
    return {key: _put(a, device, dtype if a.dtype.kind == "f"
                      else torch.int32 if a.dtype == np.int32
                      else torch.int64)
            for key, a in part.items()}


def build_coo_aop(At: sp.spmatrix, c: np.ndarray, layout: Layout,
                  device="cuda", gemm_discount: float = 3.0,
                  dtype=torch.float64) -> CooAOp:
    """Build the sparsity-aware operator on `device` from sparse internal
    data (reference opA.build_coo_aop, same representation choice), in
    f64 or f32."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    Al, Aq, q_shapes, s_parts, s_meta = coo_arrays(At, c, layout,
                                                   gemm_discount, np_dt)
    return CooAOp(Al=_put(Al, device, dtype),
                  Aq=[_put(a, device, dtype) for a in Aq],
                  s_parts=[_part_to_torch(p, device, dtype)
                           for p in s_parts],
                  q_shapes=q_shapes, s_meta=s_meta)


def build_dense_aop(At: sp.spmatrix, c: np.ndarray, layout: Layout,
                    device="cuda", dtype=np.float64) -> DenseAOp:
    """The dense bucketed [A; c'] from sparse internal data: one O(nnz)
    scatter per bucket (reference opA.py:281-364).  device="numpy" keeps
    host ndarrays (df.build_df_aop splits them); any other device gives a
    DenseAOp of tensors there."""
    N, m = At.shape
    if N != layout.N:
        raise ValueError(f"At has {N} rows, layout expects {layout.N}")
    aug = sp.hstack(
        [sp.csc_matrix(At),
         sp.csc_matrix(np.asarray(c, dtype).reshape(-1, 1))]).tocoo()
    nz_row = aug.row.astype(np.int64)
    nz_col = aug.col.astype(np.int64)
    nz_val = aug.data.astype(dtype)

    row_bucket = np.full(N, -1, np.int64)   # which bucket a flat row is in
    row_pos = np.zeros(N, np.int64)         # its flat position there
    Al = np.zeros((m + 1, layout.l), dtype)
    if layout.l:
        row_bucket[: layout.l] = -2  # LP marker
        row_pos[: layout.l] = np.arange(layout.l)
    q_offs = layout.q_offsets()
    for bi, b in enumerate(layout.q_buckets):
        rows = np.concatenate([q_offs[i] + np.arange(b.dim)
                               for i in b.block_ids]) \
            if b.count else np.zeros(0, np.int64)
        row_bucket[rows] = bi
        row_pos[rows] = np.arange(rows.size)
    s_offs = layout.s_offsets()
    nq = len(layout.q_buckets)
    for bi, b in enumerate(layout.s_buckets):
        rows = np.concatenate([s_offs[i] + np.arange(b.dim * b.dim)
                               for i in b.block_ids]) \
            if b.count else np.zeros(0, np.int64)
        row_bucket[rows] = nq + bi
        row_pos[rows] = np.arange(rows.size)

    rb = row_bucket[nz_row]
    rp = row_pos[nz_row]
    if layout.l:
        sel = rb == -2
        Al[nz_col[sel], rp[sel]] = nz_val[sel]
    Aq, q_shapes = [], []
    for bi, b in enumerate(layout.q_buckets):
        blk = np.zeros((m + 1, b.count * b.dim), dtype)
        sel = rb == bi
        blk[nz_col[sel], rp[sel]] = nz_val[sel]
        Aq.append(blk)
        q_shapes.append((b.count, b.dim))
    As, s_shapes = [], []
    for bi, b in enumerate(layout.s_buckets):
        blk = np.zeros((m + 1, b.count * b.dim * b.dim), dtype)
        sel = rb == nq + bi
        blk[nz_col[sel], rp[sel]] = nz_val[sel]
        t = blk.reshape(m + 1, b.count, b.dim, b.dim)
        for k in range(b.count):  # symmetrize per block (bounded memory)
            tk = t[:, k]
            t[:, k] = 0.5 * (tk + np.swapaxes(tk, -1, -2))
        As.append(blk)
        s_shapes.append((b.count, b.dim))
    if device != "numpy":
        tdt = F64 if np.dtype(dtype) == np.float64 else torch.float32
        Al = _put(Al, device, tdt)
        Aq = [_put(a, device, tdt) for a in Aq]
        As = [_put(a, device, tdt) for a in As]
    return DenseAOp(Al=Al, Aq=Aq, As=As, q_shapes=q_shapes,
                    s_shapes=s_shapes)
