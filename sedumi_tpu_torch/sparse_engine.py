"""Large-m sparse Schur path: sparse ADA + tile Cholesky + Woodbury + PCG.

Counterpart of the reference's sparse_engine.py (reference analog:
getsymbada.m, symbchol.m, getada1/2/3.c, blkchol.c, getdense.m,
deninfac.m/dpr1fact.c, wrapPcg.m/loopPcg.m):

* :func:`plan_sparse_lq` -- the host symbolic phase, copied from the
  reference so its arrays compare one for one: the getdense quantile rule
  with the m/2 abandonment, the clique ADA pattern, the tile plan, the
  pair triples, the Lorentz rank-1 maps, the PSD pair gathers and the
  dense-column (Woodbury) bundle.
* :class:`SparseLqOp` -- the operator [A; c'] as COO triplets (apply /
  adj / adj_y by library ``index_add_``) plus the plan's device arrays.
* :class:`TileSchurEngine` -- prepare(): ADA values by ``index_add_``
  segment sums of pair triples and rank-1 terms, the PSD term through
  kernel K2's pair values (schur.psd_pair_values), tile assembly, the
  level-scheduled tile factor (K8, K9), the dense columns' capacitance
  factored by K3 (chol.ldl_masked, pars.chol.maxuden); solve(): the
  Woodbury direct solve (K10 per tile solve) as the preconditioner of PCG
  against the matrix-free A H A'.

Everything runs in the operator's dtype: f64, or f32 in the precision
ladder's f32 and hybrid phases (make_sparse_lq_op(dtype=float32)), where
the group build, the capacitance factor and the tile kernels take their
f32 builds (K2-f32, K3-f32, K8-f32 to K10-f32) and PCG runs in f32 with
the reference's tolerances.  Only the factor's ok flag crosses to the host
in prepare().
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from . import fp, nt, schur, sparse_chol
from .chol import LdlFactor, ldl_masked, ldl_solve
from .cones import Layout
from .params import Pars
from .pcg import pcg
from .structs import ConeVec


class SparseLqOp:
    """The sparse operator and the per-iteration plan, as tensors.

    Doubles as the `aop` of ipm.make_step (apply/adj/adj_y/m) and as the
    data of TileSchurEngine.prepare.  Index arrays are int64; static shape
    information lives in `meta`; `levels` holds the tile factor's per-level
    maps (sparse_chol.levels_to)."""

    # augmented [A; c'] COO (a_*), ADA pair triples (pr_*), Lorentz rank-1
    # maps (u_*, p2_*), dense columns (ud_*, udu_*), tile assembly (asm,
    # pad_idx), permutation (perm, iperm)
    ARRAY_FIELDS = (
        "a_row", "a_col", "a_val",
        "pr_dst", "pr_w", "pr_prod",
        "u_pos", "u_wb", "u_val",
        "p2_dst", "p2_a", "p2_b", "p2_c",
        "ud_base", "ud_w",
        "udu_row", "udu_col", "udu_wb", "udu_val",
        "ud_r1c",
        "asm", "pad_idx",
        "perm", "iperm",
    )
    # per PSD bucket: groups for the B~ build (sg_*), pair gathers (sp_*)
    TUPLE_FIELDS = ("sg_blk", "sg_p", "sg_q", "sg_v",
                    "sp_dst", "sp_g", "sp_loc", "sp_val")

    def __init__(self, arrays: dict, meta: dict, levels: tuple):
        self.arrays = dict(arrays)
        self.meta = dict(meta)
        self.levels = levels

    @property
    def m(self) -> int:
        return self.meta["m"]

    def _flatten_cv(self, x: ConeVec) -> torch.Tensor:
        parts = ([x.l] + [a.reshape(-1) for a in x.q]
                 + [a.reshape(-1) for a in x.s])
        return torch.cat(parts)

    def _unflatten_cv(self, flat: torch.Tensor) -> ConeVec:
        nl = self.meta["nl"]
        off = nl
        q = []
        for (c, d) in self.meta["q_shapes"]:
            q.append(flat[off:off + c * d].reshape(c, d))
            off += c * d
        s = []
        for (k, d) in self.meta["s_shapes"]:
            s.append(flat[off:off + k * d * d].reshape(k, d, d))
            off += k * d * d
        return ConeVec(l=flat[:nl], q=tuple(q), s=tuple(s))

    def apply(self, x: ConeVec) -> torch.Tensor:
        """[A x; c'x] -- shape [m+1]."""
        a = self.arrays
        xf = self._flatten_cv(x)
        out = torch.zeros(self.m + 1, dtype=xf.dtype, device=xf.device)
        return out.index_add_(0, a["a_row"], a["a_val"] * xf[a["a_col"]])

    def adj(self, w: torch.Tensor) -> ConeVec:
        """w = [y; t] -> A'y + c t."""
        a = self.arrays
        flat = torch.zeros(self.meta["nflat"], dtype=w.dtype,
                           device=w.device)
        flat.index_add_(0, a["a_col"], a["a_val"] * w[a["a_row"]])
        return self._unflatten_cv(flat)

    def adj_y(self, y: torch.Tensor, minus_tau: torch.Tensor) -> ConeVec:
        return self.adj(torch.cat([y, minus_tau.reshape(1)]))


def _segsum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device) \
        .index_add_(0, idx, vals)


def ada_values(aop: SparseLqOp, S: nt.Scaling):
    """(vals, w, eta2_flat): the lower-triangle values of the sparse part
    of A H A' in the plan's nz order (the dense columns are left to the
    Woodbury term), the per-iteration weights w (d_l, then -eta2 * jsign
    per Lorentz cone) and the cones' eta2, flattened."""
    meta = aop.meta
    nnz_l = meta["nnz_l"]
    arr = aop.arrays
    dtype, dev = arr["a_val"].dtype, arr["a_val"].device
    wparts = [S.d_l]
    for eta2, (c, d) in zip(S.q_eta2, meta["q_shapes"]):
        jsign = torch.ones(d, dtype=dtype, device=dev)
        jsign[1:] = -1.0
        wparts.append((-eta2[:, None] * jsign[None, :]).reshape(-1))
    w = torch.cat(wparts)

    # pair triples and Lorentz rank-1 terms (library index_add_)
    vals = _segsum(arr["pr_prod"] * w[arr["pr_w"]], arr["pr_dst"], nnz_l)
    eta2_flat = torch.cat(S.q_eta2) if S.q_eta2 else \
        torch.zeros(0, dtype=dtype, device=dev)
    if meta["n_uflat"]:
        wb_flat = torch.cat([a.reshape(-1) for a in S.q_wb])
        u = _segsum(arr["u_val"] * wb_flat[arr["u_wb"]], arr["u_pos"],
                    meta["n_uflat"])
        vals = vals + _segsum(
            2.0 * eta2_flat[arr["p2_c"]] * u[arr["p2_a"]] * u[arr["p2_b"]],
            arr["p2_dst"], nnz_l)

    # PSD term: (W A_g W)[loc] sp_val per gathered pair, B~_g = W A_g W
    # of the pair's (constraint, block) group formed at that entry only
    # (kernel K2's pair entry), then the per-pair segment sum
    for bi in range(len(meta["s_shapes"])):
        if not meta["s_G"][bi]:
            continue
        W = schur.psd_gram(S.s_r[bi])
        pv = schur.psd_pair_values(
            W, arr["sg_blk"][bi], arr["sg_p"][bi], arr["sg_q"][bi],
            arr["sg_v"][bi], arr["sp_g"][bi], arr["sp_loc"][bi],
            arr["sp_val"][bi])
        vals = vals + _segsum(pv, arr["sp_dst"][bi], nnz_l)
    return vals, w, eta2_flat


class TileCtx(NamedTuple):
    aop: SparseLqOp
    L: torch.Tensor         # tile factor storage
    Ud: torch.Tensor        # [m, Kd] dense columns
    sd: torch.Tensor        # [Kd] their signed weights
    Z: torch.Tensor         # [m, Kd] = F^{-1} Ud
    fC: LdlFactor | None    # LDL' of the capacitance (skip/diagadd zeroed)
    S: nt.Scaling           # NT scaling (for the exact matvec)


class TileSchurEngine:
    """prepare/solve backend over SparseLqOp (plugs into ipm.make_step)."""

    def __init__(self, pars: Pars):
        self.pars = pars

    def prepare(self, aop: SparseLqOp, S: nt.Scaling, reg: float):
        meta = aop.meta
        m = meta["m"]
        arr = aop.arrays
        dtype, dev = arr["a_val"].dtype, arr["a_val"].device
        vals, w, eta2_flat = ada_values(aop, S)

        # --- assemble + level-scheduled tile factor (K8, K9) ---------------
        storage = sparse_chol.assemble_tiles(meta["nslot"], meta["B"],
                                             arr["asm"], vals, arr["pad_idx"])
        L = sparse_chol.factor_tiles(storage, aop.levels, reg,
                                     canceltol=self.pars.chol.canceltol)
        ok = torch.all(torch.isfinite(L))

        # --- dense columns: Woodbury capacitance, factored by K3 -----------
        Kd = meta["Kd"]
        Ud = arr["ud_base"]
        sd = torch.zeros(0, dtype=dtype, device=dev)
        fC = None
        Z = Ud
        if Kd:
            if meta["n_udu"]:
                wb_flat = torch.cat([a.reshape(-1) for a in S.q_wb])
                Ud = Ud.index_put((arr["udu_row"], arr["udu_col"]),
                                  arr["udu_val"] * wb_flat[arr["udu_wb"]],
                                  accumulate=True)
            if eta2_flat.numel():
                sd = torch.where(
                    arr["ud_r1c"] >= 0,
                    2.0 * eta2_flat[torch.clamp_min(arr["ud_r1c"], 0)],
                    w[arr["ud_w"]])
            else:
                sd = w[arr["ud_w"]]
            Z = torch.stack([_fsolve(aop, L, Ud[:, j]) for j in range(Kd)],
                            dim=1)
            C = torch.diag(1.0 / sd) + Ud.T @ Z
            cp = self.pars.chol
            f = ldl_masked(C, canceltol=cp.canceltol, maxu=cp.maxuden,
                           abstol=cp.abstol, skip_pivots=bool(cp.skip))
            ok = ok & torch.all(torch.isfinite(f.L))
            fC = LdlFactor(L=f.L, d=f.d, skip=torch.zeros_like(f.skip),
                           diagadd=torch.zeros_like(f.diagadd))

        # --- augmented column: ahc = A H c, chc = c' H c --------------------
        e_m = torch.zeros(m + 1, dtype=dtype, device=dev)
        e_m[m] = 1.0
        hc = nt.H_apply(S, aop.adj(e_m))
        af = aop.apply(hc)
        ctx = TileCtx(aop=aop, L=L, Ud=Ud, sd=sd, Z=Z, fC=fC, S=S)
        return ctx, af[:m], af[m], bool(ok)

    @staticmethod
    def _direct(ctx: TileCtx, rhs: torch.Tensor) -> torch.Tensor:
        x0 = _fsolve(ctx.aop, ctx.L, rhs)
        if ctx.fC is not None:
            x0 = x0 - ctx.Z @ ldl_solve(ctx.fC, ctx.Ud.T @ x0)
        return x0

    def solve(self, ctx: TileCtx, rhs: torch.Tensor) -> torch.Tensor:
        aop = ctx.aop
        m = aop.m
        zero = torch.zeros(1, dtype=rhs.dtype, device=rhs.device)

        def matvec(v):
            return aop.apply(nt.H_apply(ctx.S, aop.adj(torch.cat([v, zero]))))[:m]

        S = ctx.S
        # pars.cg.restol is absolute in the reference's semantics
        # (wrapPcg.m:46), scaled by mu = mean(lam^2) of the NT point, with
        # a relative floor of 1e-9 ||rhs||
        lam2 = (S.lam_l @ S.lam_l + sum(torch.sum(q * q) for q in S.q_lam)
                + sum(torch.sum(sg * sg) for sg in S.s_lam))
        nspec = (S.lam_l.numel() + sum(q.numel() for q in S.q_lam)
                 + sum(sg.numel() for sg in S.s_lam))
        mu = lam2 / max(nspec, 1)
        cg = self.pars.cg
        return pcg(matvec, lambda r: self._direct(ctx, r), rhs,
                   self._direct(ctx, rhs), maxiter=int(cg.maxiter),
                   restol=1e-9, abstol=float(cg.restol) * mu,
                   stagtol=float(cg.stagtol)).x


def _fsolve(aop: SparseLqOp, L: torch.Tensor, b_m: torch.Tensor):
    """F^{-1} b through the tile factor, in the original row order."""
    arr = aop.arrays
    m = aop.m
    bp = torch.zeros(aop.meta["ntiles_n"], dtype=b_m.dtype,
                     device=b_m.device)
    bp[:m] = b_m[arr["perm"]]
    x = sparse_chol.tile_solve(L, bp, aop.levels)
    return x[:m][arr["iperm"]]


def plan_sparse_lq(At: sp.spmatrix, c: np.ndarray, layout: Layout,
                   pars: Pars, B: int = 128) -> tuple[dict, dict]:
    """Host symbolic phase: ONE pass producing all static plan arrays.

    Returns (arrays, meta) in numpy; instantiate per dtype/device with
    make_sparse_lq_op.  Reference analogs: getsymbada.m (pattern),
    getdense.m (dense columns), symbchol.m (ordering + symbolic factor),
    and the value-gather maps replacing getada1/2.c's runtime loops.
    """
    N, m = At.shape
    assert N == layout.N
    aug0 = sp.hstack([sp.csc_matrix(At),
                      sp.csc_matrix(np.asarray(c, np.float64).reshape(-1, 1))]
                     ).T.tocsc()          # [m+1, N] csc: fast column access
    nl = layout.l
    nq = int(sum(layout.q))
    q_shapes = tuple((b.count, b.dim) for b in layout.q_buckets)
    s_shapes = tuple((b.count, b.dim) for b in layout.s_buckets)
    q_offs = layout.q_offsets()           # flat start of each layout block
    # PSD columns: reorder to bucket-local flat and symmetrize per block
    # (X -> (X+X')/2 in the d x d coordinates, the vecsym.c role) so the
    # operator's adjoint lands symmetric s blocks and Schur pair products
    # see both triangles.
    s_offs = layout.s_offsets()
    aug_parts = [aug0[:, :nl + nq]]
    for b in layout.s_buckets:
        k, d = b.count, b.dim
        cols = (np.concatenate([s_offs[i] + np.arange(d * d)
                                for i in b.block_ids])
                if k else np.zeros(0, np.int64))
        sub = aug0[:, cols].tocoo()
        loc = sub.col.astype(np.int64)
        blk = loc // (d * d)
        p = (loc % (d * d)) // d
        qq = loc % d
        M2 = sp.coo_matrix(
            (np.concatenate([sub.data, sub.data]) * 0.5,
             (np.concatenate([sub.row, sub.row]),
              np.concatenate([blk, blk]) * d * d
              + np.concatenate([p, qq]) * d + np.concatenate([qq, p]))),
            shape=(m + 1, k * d * d)).tocsr()
        M2.sum_duplicates()
        aug_parts.append(M2)
    aug = sp.hstack(aug_parts).tocsc() if len(aug_parts) > 1 else aug0

    def col_support(j):
        sl = slice(aug.indptr[j], aug.indptr[j + 1])
        rows = aug.indices[sl]
        vals = aug.data[sl]
        keep = rows < m                   # the c row never enters ADA
        return rows[keep].astype(np.int64), vals[keep]

    # --- group structure: LP cols, then cones bucket-major -----------------
    # weight slots: [0, nl) LP; [nl, nl+sum(c*d)) Lorentz J-part (bucket
    # major, cone major, component minor) — must match prepare()'s concat.
    wq_off = [nl]
    r1_off = [0]
    for (cnt, d) in q_shapes:
        wq_off.append(wq_off[-1] + cnt * d)
        r1_off.append(r1_off[-1] + cnt)

    lp_groups = []                        # (wslot, rows, vals)
    for k in range(nl):
        rows, vals = col_support(k)
        if rows.size:
            lp_groups.append((k, rows, vals))

    cone_groups = []   # (flat_cone, wslots[d], col_ids[d], union_rows, ...)
    for bi, b in enumerate(layout.q_buckets):
        d = b.dim
        for ci, blk in enumerate(b.block_ids):
            base = int(q_offs[blk])
            cols = [col_support(base + j) for j in range(d)]
            union = np.unique(np.concatenate([r for r, _ in cols])) \
                if any(r.size for r, _ in cols) else np.zeros(0, np.int64)
            if union.size == 0:
                continue
            cone_groups.append(dict(
                flat_cone=r1_off[bi] + ci,
                wslot0=wq_off[bi] + ci * d,
                wb0=wq_off[bi] - nl + ci * d,   # wb_flat offset
                base_col=base, d=d, cols=cols, union=union,
            ))

    # --- PSD incidences: (constraint, block) groups per bucket -------------
    # Reference analog: findblks.c (which PSD blocks each constraint
    # touches) + incorder.c's grouping; pattern-wise every block's touching
    # set is a clique in ADA (getsymbada.m:41-60 behavior), since
    # <A_i, W A_j W> is generically nonzero whenever i and j share a block.
    s_host = []
    s_col0 = nl + nq
    for bi, b in enumerate(layout.s_buckets):
        k, d = b.count, b.dim
        ncols = k * d * d
        sub = aug[:, s_col0:s_col0 + ncols].tocoo()
        s_col0 += ncols
        keep = sub.row < m                # the c row never enters ADA
        rows_s = sub.row[keep].astype(np.int64)
        loc_s = sub.col[keep].astype(np.int64)
        val_s = sub.data[keep]
        blk = loc_s // (d * d)
        pq = loc_s % (d * d)
        keys = rows_s * k + blk
        order = np.argsort(keys, kind="stable")
        rows_o, blk_o = rows_s[order], blk[order]
        pq_o, val_o = pq[order], val_s[order]
        T = rows_o.size
        uk, start = (np.unique(keys[order], return_index=True)
                     if T else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
        counts_g = np.diff(np.concatenate([start, [T]]))
        G = uk.size
        pad2 = int(counts_g.max()) if G else 1
        gp_a = np.zeros((G, pad2), np.int32)
        gq_a = np.zeros((G, pad2), np.int32)
        gv_a = np.zeros((G, pad2), np.float64)
        if G:
            gidx = np.repeat(np.arange(G), counts_g)
            posg = np.arange(T) - np.repeat(start, counts_g)
            gp_a[gidx, posg] = (pq_o // d).astype(np.int32)
            gq_a[gidx, posg] = (pq_o % d).astype(np.int32)
            gv_a[gidx, posg] = val_o
        s_host.append(dict(
            k=k, d=d, G=int(G), pad2=pad2,
            g_row=rows_o[start], g_blk=blk_o[start].astype(np.int32),
            gp=gp_a, gq=gq_a, gv=gv_a,
            counts=counts_g, start=start, pq=pq_o, val=val_o))

    # --- dense-column detection (getdense.m:41-99 quantile rule) -----------
    counts = np.array([r.size for _, r, _ in lp_groups]
                      + [g["union"].size for g in cone_groups], np.int64)
    dense_lp: set[int] = set()
    dense_cone: set[int] = set()
    if counts.size and pars.denf > 0:
        dq = np.quantile(counts, min(max(pars.denq, 0.0), 1.0))
        thr = pars.denf * max(dq, 2.0)
        dense_ids = np.nonzero(counts > thr)[0]
        # the reference abandons when more than m/2 columns are dense
        ncols_dense = 0
        for gi in dense_ids:
            ncols_dense += 1 if gi < len(lp_groups) \
                else 1 + cone_groups[gi - len(lp_groups)]["d"]
        if ncols_dense <= m / 2:
            for gi in dense_ids:
                if gi < len(lp_groups):
                    dense_lp.add(gi)
                else:
                    dense_cone.add(gi - len(lp_groups))

    # --- symbolic ADA pattern over sparse groups ----------------------------
    rows_inc, cols_inc = [], []
    gid = 0
    for gi, (_, rows, _) in enumerate(lp_groups):
        if gi in dense_lp:
            continue
        rows_inc.append(rows)
        cols_inc.append(np.full(rows.size, gid))
        gid += 1
    for ci_, g in enumerate(cone_groups):
        if ci_ in dense_cone:
            continue
        rows_inc.append(g["union"])
        cols_inc.append(np.full(g["union"].size, gid))
        gid += 1
    for bh in s_host:
        # every PSD block's touching-constraint set is one pattern clique
        for bk in np.unique(bh["g_blk"]):
            members = bh["g_row"][bh["g_blk"] == bk]
            rows_inc.append(members)
            cols_inc.append(np.full(members.size, gid))
            gid += 1
    if rows_inc:
        inc = sp.csr_matrix(
            (np.ones(sum(r.size for r in rows_inc), np.int8),
             (np.concatenate(rows_inc), np.concatenate(cols_inc))),
            shape=(m, gid))
        pattern = (inc @ inc.T).tocoo()
        pattern = sp.coo_matrix(
            (np.ones(pattern.nnz, np.int8), (pattern.row, pattern.col)),
            shape=(m, m))
    else:
        pattern = sp.coo_matrix((m, m))
    pattern = (pattern + sp.eye(m, format="coo", dtype=np.int8)).tocsc()
    pattern.data[:] = 1

    # --- tile plan + lower-triangle nz numbering ----------------------------
    plan = sparse_chol.plan_tiles(pattern, B=B)
    iperm0 = np.empty(m, np.int64)
    iperm0[plan.perm] = np.arange(m)
    pat_l = sp.tril(pattern).tocoo()
    nz_i = pat_l.row.astype(np.int64)
    nz_j = pat_l.col.astype(np.int64)
    nnz_l = nz_i.size
    nzid = {(int(i), int(j)): t for t, (i, j) in enumerate(zip(nz_i, nz_j))}

    pi, pj = iperm0[nz_i], iperm0[nz_j]
    r = np.maximum(pi, pj)
    cc = np.minimum(pi, pj)
    slot = np.asarray([plan.slot_of[(int(a) // B, int(b) // B)]
                       for a, b in zip(r, cc)], np.int64)
    asm = slot * (B * B) + (r % B) * B + (cc % B)
    pad_idx = plan.pad_idx

    # --- pair triples --------------------------------------------------------
    pr_dst, pr_w, pr_prod = [], [], []

    def add_pairs(rows, vals, wslot):
        s = rows.size
        ia, ib = np.triu_indices(s)       # a <= b; rows sorted asc -> i>=j
        pr_dst.append(np.asarray(
            [nzid[(int(rows[b]), int(rows[a]))] for a, b in zip(ia, ib)],
            np.int64))
        pr_w.append(np.full(ia.size, wslot, np.int64))
        pr_prod.append(vals[ia] * vals[ib])

    for gi, (k, rows, vals) in enumerate(lp_groups):
        if gi not in dense_lp:
            add_pairs(rows, vals, k)

    u_pos, u_wb, u_val = [], [], []
    p2_dst, p2_a, p2_b, p2_c = [], [], [], []
    uoff = 0
    for ci_, g in enumerate(cone_groups):
        if ci_ in dense_cone:
            continue
        union = g["union"]
        pos_of = {int(rr): t for t, rr in enumerate(union)}
        for j, (rows, vals) in enumerate(g["cols"]):
            if rows.size:
                add_pairs(rows, vals, g["wslot0"] + j)
                u_pos.append(np.asarray([uoff + pos_of[int(rr)] for rr in rows],
                                        np.int64))
                u_wb.append(np.full(rows.size, g["wb0"] + j, np.int64))
                u_val.append(vals)
        s = union.size
        ia, ib = np.triu_indices(s)
        p2_dst.append(np.asarray(
            [nzid[(int(union[b]), int(union[a]))] for a, b in zip(ia, ib)],
            np.int64))
        p2_a.append(uoff + ia)
        p2_b.append(uoff + ib)
        p2_c.append(np.full(ia.size, g["flat_cone"], np.int64))
        uoff += s

    # --- PSD pair gathers ----------------------------------------------------
    # For each lower nz (i,j) and shared block: gather the SMALLER side's
    # entries against the other side's scaled operator B~ (both orders give
    # <A_i, W A_j W>; picking the sparser gather side halves the work —
    # the sortnnz.c economics).
    def cat(parts, dt):
        return (np.concatenate(parts).astype(dt) if parts
                else np.zeros(0, dt))

    sg_blk_b, sg_p_b, sg_q_b, sg_v_b = [], [], [], []
    sp_dst_b, sp_g_b, sp_loc_b, sp_val_b = [], [], [], []
    for bh in s_host:
        dsts, ggs, lls, vvs = [], [], [], []
        gb = bh["g_blk"]
        gr = bh["g_row"]
        cnt = bh["counts"]
        st_ = bh["start"]
        for bk in np.unique(gb):
            gis = np.nonzero(gb == bk)[0]
            for ai in range(gis.size):
                for bj in range(ai, gis.size):
                    g1, g2 = int(gis[ai]), int(gis[bj])
                    r1, r2 = int(gr[g1]), int(gr[g2])
                    gat, oth = (g1, g2) if cnt[g1] <= cnt[g2] else (g2, g1)
                    sl = slice(int(st_[gat]), int(st_[gat] + cnt[gat]))
                    n_t = int(cnt[gat])
                    dsts.append(np.full(
                        n_t, nzid[(max(r1, r2), min(r1, r2))], np.int64))
                    ggs.append(np.full(n_t, oth, np.int64))
                    lls.append(bh["pq"][sl])
                    vvs.append(bh["val"][sl])
        sg_blk_b.append(bh["g_blk"])
        sg_p_b.append(bh["gp"])
        sg_q_b.append(bh["gq"])
        sg_v_b.append(bh["gv"])
        sp_dst_b.append(cat(dsts, np.int32))
        sp_g_b.append(cat(ggs, np.int32))
        sp_loc_b.append(cat(lls, np.int32))
        sp_val_b.append(cat(vvs, np.float64))

    # --- dense columns -> Woodbury bundle -----------------------------------
    ud_cols = []       # (static base values over rows<m, wslot, r1c, udu?)
    udu = []           # (row, colidx, wb_slot, val) for per-iteration u cols
    for gi in sorted(dense_lp):
        k, rows, vals = lp_groups[gi]
        base = np.zeros(m)
        base[rows] = vals
        ud_cols.append((base, k, -1))
    for ci_ in sorted(dense_cone):
        g = cone_groups[ci_]
        for j, (rows, vals) in enumerate(g["cols"]):
            base = np.zeros(m)
            base[rows] = vals
            ud_cols.append((base, g["wslot0"] + j, -1))
        ucol_idx = len(ud_cols)
        for j, (rows, vals) in enumerate(g["cols"]):
            for rr, vv in zip(rows, vals):
                udu.append((int(rr), ucol_idx, g["wb0"] + j, float(vv)))
        ud_cols.append((np.zeros(m), 0, g["flat_cone"]))

    aug_coo = aug.tocoo()
    order = np.argsort(aug_coo.row, kind="stable")
    arrays = dict(
        a_row=aug_coo.row[order].astype(np.int32),
        a_col=aug_coo.col[order].astype(np.int32),
        a_val=aug_coo.data[order].astype(np.float64),
        pr_dst=cat(pr_dst, np.int32), pr_w=cat(pr_w, np.int32),
        pr_prod=cat(pr_prod, np.float64),
        u_pos=cat(u_pos, np.int32), u_wb=cat(u_wb, np.int32),
        u_val=cat(u_val, np.float64),
        p2_dst=cat(p2_dst, np.int32), p2_a=cat(p2_a, np.int32),
        p2_b=cat(p2_b, np.int32), p2_c=cat(p2_c, np.int32),
        ud_base=(np.stack([b for b, _, _ in ud_cols], axis=1)
                 if ud_cols else np.zeros((m, 0))),
        ud_w=np.asarray([w_ for _, w_, _ in ud_cols], np.int32),
        ud_r1c=np.asarray([r1 for _, _, r1 in ud_cols], np.int32),
        udu_row=np.asarray([t[0] for t in udu], np.int32),
        udu_col=np.asarray([t[1] for t in udu], np.int32),
        udu_wb=np.asarray([t[2] for t in udu], np.int32),
        udu_val=np.asarray([t[3] for t in udu], np.float64),
        asm=asm, pad_idx=pad_idx,
        dslot=np.asarray(plan.dslot), oslot=np.asarray(plan.oslot),
        omask=np.asarray(plan.omask), pa=np.asarray(plan.pa),
        pb=np.asarray(plan.pb), pdst=np.asarray(plan.pdst),
        pmask=np.asarray(plan.pmask), orow=np.asarray(plan.orow),
        lv_cols=np.asarray(plan.lv_cols), lv_cmask=np.asarray(plan.lv_cmask),
        perm=plan.perm.astype(np.int32), iperm=iperm0.astype(np.int32),
        sg_blk=tuple(sg_blk_b), sg_p=tuple(sg_p_b), sg_q=tuple(sg_q_b),
        sg_v=tuple(sg_v_b),
        sp_dst=tuple(sp_dst_b), sp_g=tuple(sp_g_b), sp_loc=tuple(sp_loc_b),
        sp_val=tuple(sp_val_b),
        # the port's exact per-level maps (sparse_chol.level_maps)
        levels=plan.levels,
    )
    meta = dict(
        m=m, nl=nl,
        nflat=nl + int(sum(layout.q)) + int(sum(
            k_ * d_ * d_ for (k_, d_) in s_shapes)),
        q_shapes=q_shapes, s_shapes=s_shapes,
        s_G=tuple(bh["G"] for bh in s_host),
        nnz_l=int(nnz_l), n_uflat=int(uoff), Kd=len(ud_cols),
        n_udu=len(udu), B=B, ntc=plan.ntc, nslot=plan.nslot,
        ntiles_n=plan.n, npad=int(plan.n - m), nlev=plan.nlev,
        lv_lists=plan.lv_lists,
        ada_nnz=int(pattern.nnz), ada_density=float(pattern.nnz) / max(m * m, 1),
        psd_pair_entries=int(sum(a.size for a in sp_val_b)),
    )
    return arrays, meta


def make_sparse_lq_op(arrays: dict, meta: dict, dtype=torch.float64,
                      device="cuda") -> SparseLqOp:
    """Put a host plan's arrays on `device`: the float fields in `dtype`
    (f64, or f32 for the precision ladder's f32 and hybrid phases; the
    reference's make_sparse_lq_op), indices as int64, the tile factor's
    per-level maps with them."""
    float_fields = {"a_val", "pr_prod", "u_val", "ud_base", "udu_val",
                    "sg_v", "sp_val"}
    fdt = fp.torch_dtype(dtype)

    def put(key, a):
        dt = fdt if key in float_fields else torch.int64
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    out = {k: put(k, arrays[k]) for k in SparseLqOp.ARRAY_FIELDS}
    for k in SparseLqOp.TUPLE_FIELDS:
        out[k] = tuple(put(k, a) for a in arrays[k])
    return SparseLqOp(out, meta,
                      sparse_chol.levels_to(arrays["levels"], device))
