"""Tile-supernodal sparse Cholesky, planned on the host, run per level.

Counterpart of the reference's sparse_chol.py (reference analog: ordmmd.c,
symfct.c, cholsplit.c, blkchol.c/blkchol2.c, fwblkslv.c/bwblkslv.c).  The
factor is stored as dense B x B tiles of the AMD-permuted matrix,
[nslot, B, B] with a trailing trash slot, exactly as the reference stores
it; :func:`plan_tiles` is the reference's host planner, copied, so its
arrays compare one for one.

The reference keeps three device schedules (sequential, padded per-level
fori_loop, unrolled with exact shapes) because an XLA trace has to bound
its size.  Here a host loop over the levels runs one schedule, the exact
per-level one: :func:`level_maps` turns the padded plan arrays into each
level's lists of columns, valid off tiles, valid update pairs grouped by
destination (CSR) and off tiles grouped by destination row (CSR).
Within a level every column is independent: a column reads tiles written
by its descendants and writes tiles of its ancestors.

Kernels, each with its plain-PyTorch twin (CPU tensors, and the card's
comparisons):

* K8 :func:`tile_factor` -- lifted Cholesky of the level's diagonal tiles
  with the reference's two escalation rungs, then X = T L_D^-T for its off
  tiles, both blocked in panels of 32 (csrc/tile_chol.cu; two launches
  per level);
* K9 :func:`tile_update` -- st[dst] -= st[a] st[b]' over the level's
  update pairs (csrc/tile_update.cu);
* K10 :func:`tile_solve` -- L L' x = b, each pass one persistent kernel
  that walks the levels of :func:`flatten_levels`' arrays
  (csrc/tile_solve.cu; two launches per solve).

Each works in the storage's dtype: f64, or f32 in the precision ladder's
f32 and hybrid phases, where the wrappers launch the f32 builds (K8-f32,
K9-f32, K10-f32, counted apart as tile_*_f32).  As in the reference's f32
trace, reg and canceltol (pars.chol.canceltol, unchanged in every dtype)
are rounded to the storage dtype, so in f32 the lift's + 1e-300 adds 0.
On a CUDA tensor each wrapper launches its kernel or raises.  The factor
updates the storage in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from . import kernels, native


class TilePlan(NamedTuple):
    """Static host-side factorization plan (numpy; the reference's fields
    plus the exact per-level maps)."""

    n: int                 # padded matrix order (multiple of B)
    B: int                 # tile size
    perm: np.ndarray       # AMD permutation, length n_orig (new->old)
    ntc: int               # number of tile columns
    nslot: int             # number of stored tiles (last slot = trash)
    # per tile-column arrays (padded; pad targets point at the trash slot)
    dslot: np.ndarray      # [ntc + 1] slot of the diagonal tile
    oslot: np.ndarray      # [ntc + 1, maxo] slots of off-diagonal tiles
    omask: np.ndarray      # [ntc + 1, maxo] validity
    pa: np.ndarray         # [ntc + 1, maxp] update source A (in column j)
    pb: np.ndarray         # [ntc + 1, maxp] update source B (in column j)
    pdst: np.ndarray       # [ntc + 1, maxp] update destination slot
    pmask: np.ndarray      # [ntc + 1, maxp]
    orow: np.ndarray       # [ntc + 1, maxo] row-tile index of each off tile
    asm_dst: np.ndarray    # [nnz_lower] flat index into [nslot*B*B]
    asm_key: np.ndarray    # [nnz_lower] row * n + col of each asm_dst entry
    pad_idx: np.ndarray    # flat index of the padded tail's diagonal
    slot_of: dict          # (rowtile, coltile) -> slot
    nlev: int = 0
    lv_cols: np.ndarray | None = None   # [nlev, maxc] column ids (pad=ntc)
    lv_cmask: np.ndarray | None = None  # [nlev, maxc] validity
    # ((col ids...), maxo_level, maxp_level) per level
    lv_lists: tuple = ()
    levels: tuple = ()     # level_maps(...): one dict per level


def plan_tiles(pattern: sp.spmatrix, B: int = 128,
               order: np.ndarray | None = None) -> TilePlan:
    """Build the static tile plan for the symmetric pattern `pattern`.

    Host pipeline: AMD ordering (native.sed_amd) -> elimination tree ->
    tile-level symbolic fill -> schedule arrays (reference
    sparse_chol.plan_tiles, copied) -> per-level maps.
    """
    n0 = pattern.shape[0]
    perm = native.amd_order(pattern) if order is None else np.asarray(order)
    P = sp.csc_matrix(pattern)[perm][:, perm]
    n = ((n0 + B - 1) // B) * B
    ntc = n // B

    # tile-level quotient pattern of P (+identity padding)
    coo = P.tocoo()
    rt = coo.row // B
    ct = coo.col // B
    Q = sp.csc_matrix(
        (np.ones(rt.size + ntc), (np.concatenate([rt, np.arange(ntc)]),
                                  np.concatenate([ct, np.arange(ntc)]))),
        shape=(ntc, ntc),
    )
    # symbolic fill at tile level
    parent = native.etree(Q)
    Lpat = native.symbolic_pattern(Q, parent)  # lower incl diag

    # slot numbering: column-major over tile columns
    lp = Lpat.tocsc()
    slot_of: dict[tuple[int, int], int] = {}
    s = 0
    for j in range(ntc):
        for p in range(lp.indptr[j], lp.indptr[j + 1]):
            i = int(lp.indices[p])
            slot_of[(i, j)] = s
            s += 1
    nslot = s + 1  # + trash
    trash = s

    cols_rows = [
        [int(lp.indices[p]) for p in range(lp.indptr[j], lp.indptr[j + 1])]
        for j in range(ntc)
    ]
    maxo = max((len(r) - 1 for r in cols_rows), default=0)
    maxo = max(maxo, 1)
    maxp = 1
    for rows in cols_rows:
        k = len(rows) - 1
        maxp = max(maxp, k * (k + 1) // 2)

    dslot = np.full(ntc, trash, np.int32)
    oslot = np.full((ntc, maxo), trash, np.int32)
    omask = np.zeros((ntc, maxo), bool)
    orow = np.zeros((ntc, maxo), np.int32)
    pa = np.full((ntc, maxp), trash, np.int32)
    pb = np.full((ntc, maxp), trash, np.int32)
    pdst = np.full((ntc, maxp), trash, np.int32)
    pmask = np.zeros((ntc, maxp), bool)

    for j in range(ntc):
        rows = cols_rows[j]
        assert rows and rows[0] == j, (j, rows[:3])
        dslot[j] = slot_of[(j, j)]
        off = rows[1:]
        for t, i in enumerate(off):
            oslot[j, t] = slot_of[(i, j)]
            omask[j, t] = True
            orow[j, t] = i
        # update pairs: for i >= k (both in off), tile (i,k) in column k
        t = 0
        for ki, k in enumerate(off):
            for i in off[ki:]:
                pa[j, t] = slot_of[(i, j)]
                pb[j, t] = slot_of[(k, j)]
                pdst[j, t] = slot_of.get((i, k), trash)
                pmask[j, t] = (i, k) in slot_of
                t += 1

    # level schedule: batch independent tile-columns per etree level.  A
    # padding row (column id = ntc) is appended to every per-column array:
    # its diagonal tile is the trash slot, its off/update entries masked.
    lev = native.levels(parent)
    nlev = int(lev.max()) + 1 if ntc else 0
    bylev = [np.nonzero(lev == l)[0] for l in range(nlev)]
    noff = [len(r) - 1 for r in cols_rows]
    npair = [k * (k + 1) // 2 for k in noff]
    lv_lists = tuple(
        (tuple(int(j) for j in g),
         max((noff[j] for j in g), default=0),
         max((npair[j] for j in g), default=0))
        for g in bylev)
    maxc = max((g.size for g in bylev), default=1)
    lv_cols = np.full((max(nlev, 1), maxc), ntc, np.int32)
    lv_cmask = np.zeros((max(nlev, 1), maxc), bool)
    for l, g in enumerate(bylev):
        lv_cols[l, : g.size] = g
        lv_cmask[l, : g.size] = True
    dslot = np.concatenate([dslot, [trash]]).astype(np.int32)
    oslot = np.vstack([oslot, np.full((1, maxo), trash, np.int32)])
    omask = np.vstack([omask, np.zeros((1, maxo), bool)])
    orow = np.vstack([orow, np.zeros((1, maxo), np.int32)])
    pa = np.vstack([pa, np.full((1, maxp), trash, np.int32)])
    pb = np.vstack([pb, np.full((1, maxp), trash, np.int32)])
    pdst = np.vstack([pdst, np.full((1, maxp), trash, np.int32)])
    pmask = np.vstack([pmask, np.zeros((1, maxp), bool)])

    # assembly map for the lower triangle of the permuted matrix
    mask_low = coo.row >= coo.col
    ri, ci = coo.row[mask_low], coo.col[mask_low]
    st = np.asarray([slot_of[(int(r) // B, int(c) // B)]
                     for r, c in zip(ri, ci)], np.int64)
    asm_dst = st * (B * B) + (ri % B).astype(np.int64) * B + (ci % B)
    pad = np.arange(n0, n, dtype=np.int64)
    pad_idx = (dslot[pad // B].astype(np.int64) * (B * B)
               + (pad % B) * B + (pad % B))

    return TilePlan(
        n=n, B=B, perm=perm, ntc=ntc, nslot=nslot, dslot=dslot,
        oslot=oslot, omask=omask, pa=pa, pb=pb, pdst=pdst, pmask=pmask,
        orow=orow, asm_dst=asm_dst,
        asm_key=ri.astype(np.int64) * n + ci, pad_idx=pad_idx,
        slot_of=slot_of, nlev=nlev,
        lv_cols=lv_cols, lv_cmask=lv_cmask, lv_lists=lv_lists,
        levels=level_maps(dslot, oslot, omask, pa, pb, pdst, pmask, orow,
                          lv_lists))


def _csr(keys: np.ndarray):
    """(stable order, unique keys, row pointer) grouping `keys`."""
    order = np.argsort(keys, kind="stable")
    uniq, counts = np.unique(keys[order], return_counts=True)
    return order, uniq, np.concatenate([[0], np.cumsum(counts)])


def level_maps(dslot, oslot, omask, pa, pb, pdst, pmask, orow,
               lv_lists) -> tuple:
    """Exact per-level maps from the padded plan arrays (int64 numpy, one
    dict per level, plan order kept inside every group):

      cols, dslot          the level's columns and their diagonal slots;
      off_ptr              CSR by column (position in cols) of its valid
                           off tiles off_slot / off_row, with off_dslot the
                           owner's diagonal slot, off_col the owner column
                           and off_cidx its position in cols;
      pair_dst, pair_ptr   the valid update pairs (pair_a, pair_b) grouped
                           by destination slot;
      chunk_ptr, ...       K9's work list over those pairs (update_chunks);
      fs_row, fs_ptr       the off tiles (fs_slot, fs_col) grouped by
                           destination row tile, for the forward solve.
    """
    out = []
    for cols_t, _, _ in lv_lists:
        cols = np.asarray(cols_t, np.int64)
        om = np.asarray(omask)[cols]
        noff = om.sum(axis=1)
        off_col = np.repeat(cols, noff)
        off_slot = np.asarray(oslot, np.int64)[cols][om]
        off_row = np.asarray(orow, np.int64)[cols][om]
        pm = np.asarray(pmask)[cols]
        a = np.asarray(pa, np.int64)[cols][pm]
        b = np.asarray(pb, np.int64)[cols][pm]
        dst = np.asarray(pdst, np.int64)[cols][pm]
        porder, pair_dst, pair_ptr = _csr(dst)
        forder, fs_row, fs_ptr = _csr(off_row)
        out.append(dict(
            cols=cols, dslot=np.asarray(dslot, np.int64)[cols],
            off_ptr=np.concatenate([[0], np.cumsum(noff)]).astype(np.int64),
            off_slot=off_slot, off_row=off_row,
            off_dslot=np.asarray(dslot, np.int64)[off_col],
            off_col=off_col,
            off_cidx=np.repeat(np.arange(cols.size), noff),
            pair_dst=pair_dst, pair_ptr=pair_ptr.astype(np.int64),
            pair_a=a[porder], pair_b=b[porder],
            **update_chunks(pair_ptr),
            fs_row=fs_row, fs_ptr=fs_ptr.astype(np.int64),
            fs_slot=off_slot[forder], fs_col=off_col[forder]))
    return tuple(out)


def update_chunks(pair_ptr) -> dict:
    """K9's work list for one level, from its pairs' CSR by destination:
    each destination's pairs cut, in plan order, into chunks of at most
    ceil(pairs / destinations) pairs (int64 numpy).

      chunk_ptr            [nchunk + 1] each chunk's pairs, consecutive
                           ranges covering [0, pairs) in order;
      chunk_dst            [nchunk] its destination (position in pair_dst);
      dst_chunk            [ndst + 1] each destination's chunks (a CSR);
      dst_part             [ndst] the scratch slot of a split destination's
                           first chunk (its chunks' slots follow in chunk
                           order), -1 for a destination of one chunk;
      part_chunk           [nsplit] the chunk of each scratch slot: the
                           order in which a split destination's sums add.
    """
    ptr = np.asarray(pair_ptr, np.int64)
    cnt = np.diff(ptr)
    nd = cnt.size
    per = max(1, -(-int(ptr[-1] - ptr[0]) // max(nd, 1)))
    nch = -(-cnt // per)
    dst_chunk = np.concatenate([[0], np.cumsum(nch)]).astype(np.int64)
    chunk_dst = np.repeat(np.arange(nd, dtype=np.int64), nch)
    k = np.arange(chunk_dst.size, dtype=np.int64) - dst_chunk[chunk_dst]
    chunk_ptr = np.concatenate([ptr[chunk_dst] + k * per,
                                ptr[-1:]]).astype(np.int64)
    split = nch > 1
    slot = np.concatenate([[0], np.cumsum(np.where(split, nch, 0))])
    dst_part = np.where(split, slot[:-1], -1).astype(np.int64)
    part_chunk = np.nonzero(split[chunk_dst])[0].astype(np.int64)
    return dict(chunk_ptr=chunk_ptr, chunk_dst=chunk_dst,
                dst_chunk=dst_chunk, dst_part=dst_part,
                part_chunk=part_chunk)


# K9's sub-tiles per destination: 64 x 64 blocks of a tile of order <= 128
UPDATE_MAX_SUB = 4

# K10's flattened level arrays (flatten_levels), all int64
FLAT_KEYS = ("lev_cols", "cols", "dslot", "col_off", "lev_off", "off_slot",
             "off_row", "lev_fs", "fs_row", "fs_ptr", "fs_slot", "fs_col")


def flatten_levels(levels) -> dict:
    """K10's arrays, built once per plan from level_maps' numpy maps: every
    level's lists concatenated in level order, with per-level offsets.

      lev_cols             [nlev + 1] offsets into cols / dslot;
      col_off              [ncols + 1] each column's off tiles, a CSR into
                           off_slot / off_row (the level's off_ptr, shifted);
      lev_off              [nlev + 1] offsets into off_slot / off_row;
      lev_fs               [nlev + 1] offsets into fs_row;
      fs_ptr               [nrows + 1] each destination row's off tiles, a
                           CSR into fs_slot / fs_col (the level's fs_ptr,
                           shifted).

    Raises if a level's maps do not fit together."""
    def offsets(sizes):
        return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    def cat(key):
        return np.concatenate([np.zeros(0, np.int64)] + [
            np.asarray(lv[key], np.int64) for lv in levels])

    ncol = [len(lv["cols"]) for lv in levels]
    noff = [len(lv["off_slot"]) for lv in levels]
    lev_off = offsets(noff)
    col_off, fs_ptr = [np.zeros(1, np.int64)], [np.zeros(1, np.int64)]
    for lv, n, o, base in zip(levels, ncol, noff, lev_off):
        optr = np.asarray(lv["off_ptr"], np.int64)
        fptr = np.asarray(lv["fs_ptr"], np.int64)
        if (optr.size != n + 1 or optr[0] != 0 or optr[-1] != o
                or fptr.size != len(lv["fs_row"]) + 1 or fptr[0] != 0
                or fptr[-1] != o or np.any(np.diff(optr) < 0)
                or np.any(np.diff(fptr) < 0) or len(lv["dslot"]) != n
                or len(lv["fs_slot"]) != o or len(lv["off_row"]) != o):
            raise ValueError("level maps do not fit together")
        col_off.append(optr[1:] + base)
        fs_ptr.append(fptr[1:] + base)
    return dict(lev_cols=offsets(ncol), cols=cat("cols"), dslot=cat("dslot"),
                col_off=np.concatenate(col_off), lev_off=lev_off,
                off_slot=cat("off_slot"), off_row=cat("off_row"),
                lev_fs=offsets([len(lv["fs_row"]) for lv in levels]),
                fs_row=cat("fs_row"), fs_ptr=np.concatenate(fs_ptr),
                fs_slot=cat("fs_slot"), fs_col=cat("fs_col"))


class LevelMaps(tuple):
    """levels_to's result: one dict of tensors per level, and in `flat`
    K10's flattened arrays for the same plan (flatten_levels) with `bar`,
    the grid barrier's two counters."""


def levels_to(levels, device) -> LevelMaps:
    """The per-level maps as int64 tensors on `device`, with K9's tickets
    (`upd_ticket`, int32 zeros, UPDATE_MAX_SUB a destination) and K10's
    flattened arrays, checked for the kernels once here."""
    out = LevelMaps({k: torch.as_tensor(np.ascontiguousarray(v),
                                        dtype=torch.int64, device=device)
                     for k, v in lv.items()} for lv in levels)
    for lv in out:
        lv["upd_ticket"] = torch.zeros(
            UPDATE_MAX_SUB * lv["pair_dst"].numel(), dtype=torch.int32,
            device=device)
    flat = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
            for k, v in flatten_levels(levels).items()}
    flat["bar"] = torch.zeros(2, dtype=torch.int32, device=device)
    if flat["bar"].is_cuda:
        kernels.check_cuda(*(flat[k] for k in FLAT_KEYS), dtype=torch.int64)
    out.flat = flat
    return out


def assemble_tiles(nslot: int, B: int, asm_dst: torch.Tensor,
                   vals_lower: torch.Tensor,
                   pad_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter the lower-triangle nz values into tile storage [nslot, B, B];
    pad_idx (the padded tail's diagonal) gets 1.0."""
    flat = torch.zeros(nslot * B * B, dtype=vals_lower.dtype,
                       device=vals_lower.device)
    flat.index_add_(0, asm_dst, vals_lower)
    if pad_idx is not None and pad_idx.numel():
        flat.index_add_(0, pad_idx, torch.ones(pad_idx.numel(),
                                               dtype=flat.dtype,
                                               device=flat.device))
    return flat.reshape(nslot, B, B)


# ---------------------------------------------------------------- K8


def tile_factor_plain(st: torch.Tensor, lv: dict, reg: float,
                      canceltol: float = 1e-12) -> torch.Tensor:
    """Factor one level's diagonal tiles and solve its off tiles, in place
    (plain PyTorch; the reference's factor_tiles_ur :489-513).  Returns the
    rung each diagonal tile took: 0 lifted Cholesky, 1 with +(dmax+1) I,
    2 the diagonal last resort."""
    B = st.shape[-1]
    dsl = lv["dslot"]
    D = st[dsl]
    D = torch.tril(D) + torch.tril(D, -1).mT
    diag = torch.diagonal(D, dim1=-2, dim2=-1)
    dmax = torch.amax(torch.abs(diag), dim=-1)
    lift = torch.maximum(torch.full_like(dmax, float(reg)),
                         canceltol * dmax) + 1e-300
    eye = torch.eye(B, dtype=st.dtype, device=st.device)
    Dl = D + lift[:, None, None] * eye
    LD, info = torch.linalg.cholesky_ex(Dl)
    bad1 = (info != 0) | torch.isnan(LD).any(dim=(-2, -1))
    rung = torch.zeros(dsl.numel(), dtype=torch.int32, device=st.device)
    if bool(bad1.any()):
        idx = torch.nonzero(bad1)[:, 0]
        up = (dmax[idx] + 1.0)[:, None, None]
        L2, info2 = torch.linalg.cholesky_ex(Dl[idx] + up * eye)
        bad2 = (info2 != 0) | torch.isnan(L2).any(dim=(-2, -1))
        Ldiag = torch.sqrt(torch.abs(torch.diagonal(Dl[idx], dim1=-2,
                                                    dim2=-1))
                           + (dmax[idx] + 1.0)[:, None])[..., None] * eye
        LD[idx] = torch.where(bad2[:, None, None], Ldiag, L2)
        rung[idx] = 1 + bad2.to(torch.int32)
    st[dsl] = LD
    if lv["off_slot"].numel():
        T = st[lv["off_slot"]]
        X = torch.linalg.solve_triangular(st[lv["off_dslot"]].mT, T,
                                          upper=True, left=False)
        st[lv["off_slot"]] = X
    return rung


def _suffix(st: torch.Tensor) -> str:
    """The kernels' name suffix for the storage dtype: '' (f64) or '_f32';
    raises for any other dtype."""
    if st.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"tile kernels take f32 or f64, got {st.dtype}")
    return "_f32" if st.dtype == torch.float32 else ""


def _tile_diag_kernel(st: torch.Tensor, lv: dict, reg: float,
                      canceltol: float) -> torch.Tensor:
    """K8's diagonal part: the level's diagonal tiles and their rungs."""
    sfx = _suffix(st)
    kernels.check_cuda(st)
    kernels.check_cuda(lv["dslot"], dtype=torch.int64)
    nc = lv["dslot"].numel()
    rung = torch.empty(nc, dtype=torch.int32, device=st.device)
    kernels.launch("tile_chol.cu", f"tile_diag{sfx}_launch", st.data_ptr(),
                   lv["dslot"].data_ptr(), rung.data_ptr(), nc, st.shape[-1],
                   float(reg), float(canceltol))
    kernels.LAUNCHES["tile_factor" + sfx] += 1
    return rung


def _tile_off_kernel(st: torch.Tensor, lv: dict) -> None:
    """K8's off part: X = T L_D^-T for the level's off tiles."""
    sfx = _suffix(st)
    kernels.check_cuda(st)
    kernels.check_cuda(lv["off_slot"], lv["off_dslot"], dtype=torch.int64)
    kernels.launch("tile_chol.cu", f"tile_off{sfx}_launch", st.data_ptr(),
                   lv["off_slot"].data_ptr(), lv["off_dslot"].data_ptr(),
                   lv["off_slot"].numel(), st.shape[-1])
    kernels.LAUNCHES["tile_factor" + sfx] += 1


def _tile_factor_kernel(st: torch.Tensor, lv: dict, reg: float,
                        canceltol: float) -> torch.Tensor:
    rung = _tile_diag_kernel(st, lv, reg, canceltol)
    if lv["off_slot"].numel():
        _tile_off_kernel(st, lv)
    return rung


def tile_factor(st: torch.Tensor, lv: dict, reg: float,
                canceltol: float = 1e-12) -> torch.Tensor:
    """One level's diagonal and off tiles (kernel K8 on the card, K8-f32
    on f32 storage); see tile_factor_plain."""
    if st.is_cuda:
        return _tile_factor_kernel(st, lv, reg, canceltol)
    return tile_factor_plain(st, lv, reg, canceltol)


# ---------------------------------------------------------------- K9


def tile_update_plain(st: torch.Tensor, lv: dict) -> None:
    """st[dst] -= st[a] st[b]' over one level's update pairs, in place
    (plain PyTorch; the reference's factor_tiles_ur :514-521)."""
    U = st[lv["pair_a"]] @ st[lv["pair_b"]].mT
    dst = torch.repeat_interleave(lv["pair_dst"], torch.diff(lv["pair_ptr"]))
    st.index_add_(0, dst, U, alpha=-1.0)


_UPDATE_KEYS = ("pair_dst", "pair_a", "pair_b", "chunk_ptr", "chunk_dst",
                "dst_chunk", "dst_part")


def _tile_update_kernel(st: torch.Tensor, lv: dict) -> None:
    """K9 over the level's work list (update_chunks, with levels_to's
    tickets); tiles of order above 128 or levels without the list raise."""
    sfx = _suffix(st)
    B = st.shape[-1]
    nsub = (-(-B // 64)) ** 2
    if nsub > UPDATE_MAX_SUB:
        raise ValueError(f"K9 takes tiles of order at most 128, got {B}")
    if "upd_ticket" not in lv or lv["upd_ticket"].numel() \
            < UPDATE_MAX_SUB * lv["pair_dst"].numel():
        raise ValueError("K9 takes the levels of levels_to")
    kernels.check_cuda(st)
    kernels.check_cuda(*(lv[k] for k in _UPDATE_KEYS), dtype=torch.int64)
    kernels.check_cuda(lv["upd_ticket"], dtype=torch.int32)
    nsplit = lv["part_chunk"].numel()
    part = torch.empty(nsplit * nsub * 64 * 64, dtype=st.dtype,
                       device=st.device) if nsplit else None
    kernels.launch("tile_update.cu", f"tile_update{sfx}_launch",
                   st.data_ptr(), *(lv[k].data_ptr() for k in _UPDATE_KEYS),
                   lv["upd_ticket"].data_ptr(),
                   None if part is None else part.data_ptr(),
                   lv["chunk_dst"].numel(), B)
    kernels.LAUNCHES["tile_update" + sfx] += 1


def tile_update(st: torch.Tensor, lv: dict) -> None:
    """One level's trailing update (kernel K9 on the card, K9-f32 on f32
    storage)."""
    if not lv["pair_a"].numel():
        return
    if st.is_cuda:
        _tile_update_kernel(st, lv)
    else:
        tile_update_plain(st, lv)


def factor_tiles(storage: torch.Tensor, levels, reg: float,
                 canceltol: float = 1e-12) -> torch.Tensor:
    """Level-scheduled right-looking tile Cholesky over `levels`
    (levels_to of level_maps), in place; returns the storage, now L."""
    for lv in levels:
        tile_factor(storage, lv, reg, canceltol)
        tile_update(storage, lv)
    return storage


# ---------------------------------------------------------------- K10


def tile_solve_plain(L: torch.Tensor, rhs: torch.Tensor,
                     levels) -> torch.Tensor:
    """Solve L L' x = rhs level by level (plain PyTorch; the reference's
    solve_tiles_ur).  rhs: [ntc * B] (padded)."""
    B = L.shape[-1]
    y = rhs.reshape(-1, B).clone()
    for lv in levels:
        cols = lv["cols"]
        y[cols] = torch.linalg.solve_triangular(
            L[lv["dslot"]], y[cols][..., None], upper=False)[..., 0]
        if lv["off_slot"].numel():
            contrib = torch.einsum("oab,ob->oa", L[lv["off_slot"]],
                                   y[lv["off_col"]])
            y.index_add_(0, lv["off_row"], contrib, alpha=-1.0)
    for lv in reversed(levels):
        cols = lv["cols"]
        yc = y[cols]
        if lv["off_slot"].numel():
            corr = torch.einsum("oab,oa->ob", L[lv["off_slot"]],
                                y[lv["off_row"]])
            yc = yc - torch.zeros_like(yc).index_add_(0, lv["off_cidx"],
                                                      corr)
        y[cols] = torch.linalg.solve_triangular(
            L[lv["dslot"]].mT, yc[..., None], upper=True)[..., 0]
    return y.reshape(-1)


def _tile_solve_kernel(L: torch.Tensor, rhs: torch.Tensor, levels,
                       grid: int = 0) -> torch.Tensor:
    """K10: the forward and the backward pass, one cooperative launch each
    on `grid` blocks (0: one per SM); a grid the card cannot hold resident
    raises."""
    sfx = _suffix(L)
    kernels.check_cuda(L, rhs, dtype=L.dtype)
    fl = getattr(levels, "flat", None)
    if fl is None or fl["cols"].device != L.device:
        raise ValueError("K10 takes the levels of levels_to on L's device")
    B = L.shape[-1]
    nlev = fl["lev_cols"].numel() - 1
    name = "tile_solve" + sfx
    y = rhs.reshape(-1, B).clone()
    part = torch.empty(max(fl["off_slot"].numel(), 1), B, dtype=L.dtype,
                       device=L.device)
    ptr = {k: fl[k].data_ptr() for k in (*FLAT_KEYS, "bar")}
    kernels.launch("tile_solve.cu", f"tile_solve_fwd{sfx}_launch",
                   L.data_ptr(), y.data_ptr(), ptr["lev_cols"], ptr["cols"],
                   ptr["dslot"], ptr["lev_fs"], ptr["fs_row"], ptr["fs_ptr"],
                   ptr["fs_slot"], ptr["fs_col"], ptr["bar"], nlev, B, grid)
    kernels.LAUNCHES[name] += 1
    kernels.launch("tile_solve.cu", f"tile_solve_bwd{sfx}_launch",
                   L.data_ptr(), y.data_ptr(), part.data_ptr(),
                   ptr["lev_cols"], ptr["cols"], ptr["dslot"],
                   ptr["col_off"], ptr["lev_off"], ptr["off_slot"],
                   ptr["off_row"], ptr["bar"], nlev, B, grid)
    kernels.LAUNCHES[name] += 1
    return y.reshape(-1)


def tile_solve(L: torch.Tensor, rhs: torch.Tensor, levels) -> torch.Tensor:
    """L L' x = rhs with the tile factor (kernel K10 on the card, K10-f32
    for an f32 factor); see tile_solve_plain."""
    if L.is_cuda:
        return _tile_solve_kernel(L, rhs, levels)
    return tile_solve_plain(L, rhs, levels)


class SparseCholesky:
    """Host-facing wrapper: plan once, factor/solve many times (reference
    sparse_chol.SparseCholesky; symbchol.m + blkchol/fw/bwblkslv roles).
    `factor(M)` takes the sparse SPD matrix with the planned pattern;
    `solve(L, b)` returns M^{-1} b (approximately, when diag-adds fired)."""

    def __init__(self, pattern: sp.spmatrix, B: int = 128, device="cuda"):
        self.plan = plan_tiles(pattern, B=B)
        self.device = torch.device(device)
        self.levels = levels_to(self.plan.levels, self.device)
        p = self.plan.perm
        self._n0 = pattern.shape[0]
        self._iperm = np.empty_like(p)
        self._iperm[p] = np.arange(p.size)
        self._key_order = np.argsort(self.plan.asm_key)

    def storage(self, M: sp.spmatrix) -> torch.Tensor:
        """Tile storage of M, which has the planned pattern (its nonzeros
        may come in another order), identity on the padded tail."""
        pl = self.plan
        Mp = sp.csc_matrix(M)[pl.perm][:, pl.perm].tocoo()
        mask = Mp.row >= Mp.col
        key = Mp.row[mask].astype(np.int64) * pl.n + Mp.col[mask]
        keys = pl.asm_key[self._key_order]
        pos = np.minimum(np.searchsorted(keys, key), max(keys.size - 1, 0))
        if not np.array_equal(keys[pos], key):
            raise ValueError("M has nonzeros outside the planned pattern")
        dst = pl.asm_dst[self._key_order[pos]]

        def put(a, dt=torch.int64):
            return torch.as_tensor(a, dtype=dt, device=self.device)

        return assemble_tiles(pl.nslot, pl.B, put(dst),
                              put(Mp.data[mask], torch.float64),
                              put(pl.pad_idx))

    def factor(self, M: sp.spmatrix, reg: float = 0.0) -> torch.Tensor:
        return factor_tiles(self.storage(M), self.levels, reg)

    def solve(self, L: torch.Tensor, b) -> np.ndarray:
        b = torch.as_tensor(np.asarray(b, np.float64), device=self.device)
        return self.solve_device(L, b).cpu().numpy()

    def solve_device(self, L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        pl = self.plan
        perm = torch.as_tensor(pl.perm, device=b.device)
        bp = torch.zeros(pl.n, dtype=b.dtype, device=b.device)
        bp[: self._n0] = b[perm]
        x = tile_solve(L, bp, self.levels)
        return x[: self._n0][torch.as_tensor(self._iperm, device=b.device)]
