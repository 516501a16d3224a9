"""Problem canonicalization: user (A,b,c,K) -> internal real (At,b,c,Layout).

Reference analog: pretransfo.m / posttransfo.m.  Same spirit — build one
sparse linear map from user variables to internal variables and transform
the data once on the host — but a different (and TPU-simpler) canonical
form:

Step A ("realify", pretransfo.m:254-320 analog): eliminate all complex
  data/variables.
  * Constraint rows listed in K.ycomplex are complex equalities: the row
    keeps its real part and an extra row enforcing the imaginary part is
    appended (y recovery: y_i = y_re + 1j*y_im).
  * Complex scalar variables (K.xcomplex, among f/q/r) expand to (re, im)
    pairs inside the same cone (norms are preserved).
  * Complex-Hermitian PSD blocks (K.scomplex) are *real-embedded*:
    X (n x n Hermitian, PSD) <-> rho(X) = [[Re X, -Im X], [Im X, Re X]]
    (2n x 2n symmetric, PSD).  Data matrices map to rho(Herm(M))/2 for the
    real part and rho(Herm(iM))/2 for the imaginary part, which preserves
    all inner products: tr((rho(H)/2)' rho(X)) = Re tr(H^H X).  Unlike the
    reference (which keeps interleaved complex storage, psdeig.m:64-67),
    this keeps the whole device pipeline real — the J-invariance averaging
    argument guarantees the optimal values coincide.
  Inner-product convention: <a, x> = a^H x, matching MATLAB's A'*x with
  complex data (sedumi.m:773-807 computes errors with ctranspose).

Step B (real canonicalization, pretransfo.m:334-522 analog): one sparse
  matrix T (N_int x n1) with x1 = T' x_int, At_int = T At1, c_int = T c1:
  * diagonal SDP blocks -> LP variables (pretransfo.m:231-247);
  * rotated cones -> Lorentz by the orthogonal rotation
    (y1,y2) = ((x1+x2)/sqrt2, (x1-x2)/sqrt2) (pretransfo.m:408-432);
  * free variables: split x=u-v into the LP part (pars.free=0) or embed as
    the tail of a fresh Lorentz cone with a zero-cost head variable
    (pars.free=1, the default; pretransfo.m:339-387);
  * final internal ordering [ l | q ... | s ... ].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import scipy.sparse as sp

from .cones import ConeSpec, Layout, pack_plan
from .params import Pars


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _herm(M: np.ndarray) -> np.ndarray:
    return 0.5 * (M + M.conj().T)


def _rho(M: np.ndarray) -> np.ndarray:
    """Real embedding of a complex (Hermitian) matrix."""
    re, im = np.real(M), np.imag(M)
    return np.block([[re, -im], [im, re]])


def _sym_vec_csc(A: sp.spmatrix, n: int) -> sp.csc_matrix:
    """Symmetrize every column of A (n^2 x m), viewed as col-major n x n."""
    idx = np.arange(n * n).reshape(n, n, order="F")
    perm = idx.T.reshape(-1, order="F")  # vec(M') index map
    A = sp.csc_matrix(A)
    return sp.csc_matrix(0.5 * (A + A[perm, :]))


@dataclass
class Problem:
    """Canonicalized problem + everything needed to map solutions back."""

    At: sp.csc_matrix        # N_int x m_int
    b: np.ndarray            # m_int
    c: np.ndarray            # N_int
    layout: Layout
    K_orig: ConeSpec
    m_orig: int
    T: sp.csc_matrix         # N_int x n1
    # de-realify metadata
    n_user: int
    re_idx: np.ndarray       # n_user -> index into x1 (or -1/-2)
    im_idx: np.ndarray       # n_user -> index into x1 (or -1)
    herm_blocks: list[tuple[int, int, int]] = field(default_factory=list)
    # (user_offset, n, x1_offset) per Hermitian block
    ycomplex: tuple[int, ...] = ()
    complex_input: bool = False
    prep_notes: list[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Step A: realify
# ---------------------------------------------------------------------------


def _realify(At, b, c, K: ConeSpec):
    """Returns (At1 (n1 x m1), b1, c1, K1, re_idx, im_idx, herm_blocks)."""
    n_user = K.dim
    m = b.size
    At = sp.csc_matrix(At)
    assert At.shape == (n_user, m), (At.shape, n_user, m)
    ycomplex = sorted(set(int(i) for i in K.ycomplex))
    complex_any = (
        np.iscomplexobj(At.data) or np.iscomplexobj(c) or np.iscomplexobj(b)
        or K.scomplex or K.xcomplex or ycomplex
    )
    if not complex_any:
        re_idx = np.arange(n_user, dtype=np.int64)
        im_idx = np.full(n_user, -1, np.int64)
        K1 = ConeSpec(f=K.f, l=K.l, q=K.q, r=K.r, s=K.s)
        return (At, np.real(b).astype(np.float64), np.real(c).astype(np.float64),
                K1, re_idx, im_idx, [], [])

    xcomplex = set(int(i) for i in K.xcomplex)
    herm = set(K.scomplex)

    # Treat c as one extra data "row" appended after all constraints; its
    # imaginary part is dropped (objective = Re <c,x>).
    data = sp.hstack([At, sp.csc_matrix(np.asarray(c).reshape(-1, 1))]).tocsr()

    # Walk user coordinates, building rows of the realified data.
    # For data value a and variable u: <a,u> = conj(a)*u.
    rows_re: list[sp.spmatrix] = []   # each: (seg_n1 x (m+1)) real
    rows_im: list[sp.spmatrix] = []
    re_idx = np.full(n_user, -1, np.int64)
    im_idx = np.full(n_user, -1, np.int64)
    herm_blocks: list[tuple[int, int, int]] = []

    f1 = l1 = 0
    q1: list[int] = []
    r1: list[int] = []
    s1: list[int] = []

    off = 0     # user coordinate offset
    off1 = 0    # realified coordinate offset

    def scalar_segment(dim: int, base_1based: int):
        """Realify `dim` scalar vars starting at user offset `off`;
        xcomplex indices are 1-based over the f+q+r scalar vars only in the
        reference; we accept global 1-based indices into x."""
        nonlocal off, off1
        seg = data[off: off + dim, :]
        new_dim = 0
        out_re = []
        out_im = []
        for j in range(dim):
            a = seg[j, :]
            uid = off + j
            if (uid + 1) in xcomplex:
                ar, ai = np.real(a.toarray()).ravel(), np.imag(a.toarray()).ravel()
                # u = ur + i ui: Re<a,u> = ar ur + ai ui ; Im = ar ui - ai ur
                out_re.append(sp.csr_matrix(np.stack([ar, ai])))
                out_im.append(sp.csr_matrix(np.stack([-ai, ar])))
                re_idx[uid] = off1 + new_dim
                im_idx[uid] = off1 + new_dim + 1
                new_dim += 2
            else:
                out_re.append(sp.csr_matrix(np.real(a.toarray())))
                out_im.append(sp.csr_matrix(-np.imag(a.toarray())))
                re_idx[uid] = off1 + new_dim
                new_dim += 1
        rows_re.extend(out_re)
        rows_im.extend(out_im)
        off += dim
        off1 += new_dim
        return new_dim

    # free part
    f1 = scalar_segment(K.f, 1) if K.f else 0
    # lp part (never complex)
    if K.l:
        seg = data[off: off + K.l, :]
        rows_re.append(sp.csr_matrix(np.real(seg.toarray())) if K.l < 10000
                       else seg.real)
        rows_im.append(sp.csr_matrix(-np.imag(seg.toarray())) if K.l < 10000
                       else -seg.imag)
        re_idx[off: off + K.l] = off1 + np.arange(K.l)
        l1 = K.l
        off += K.l
        off1 += K.l
    # q cones
    for d in K.q:
        q1.append(scalar_segment(d, 1))
    # r cones
    for d in K.r:
        r1.append(scalar_segment(d, 1))
    # s blocks
    for bi, d in enumerate(K.s, start=1):
        n2 = d * d
        seg = sp.csc_matrix(data[off: off + n2, :])
        if bi in herm:
            # real-embed: output block (2d)^2
            out_re = sp.lil_matrix((4 * n2, m + 1))
            out_im = sp.lil_matrix((4 * n2, m + 1))
            cols = np.unique(seg.nonzero()[1])
            for cc in cols:
                v = np.asarray(seg[:, cc].todense()).ravel()
                M = v.reshape(d, d, order="F")
                H = _herm(M)
                S = 0.5 * (M - M.conj().T)
                D_re = 0.5 * _rho(H)
                # Herm(iM) = -Im(S) + i Re(S)
                D_im = 0.5 * _rho(-np.imag(S) + 1j * np.real(S))
                out_re[:, cc] = D_re.reshape(-1, order="F")[:, None]
                out_im[:, cc] = D_im.reshape(-1, order="F")[:, None]
            rows_re.append(sp.csr_matrix(out_re))
            rows_im.append(sp.csr_matrix(out_im))
            herm_blocks.append((off, d, off1))
            re_idx[off: off + n2] = -2
            s1.append(2 * d)
            off += n2
            off1 += 4 * n2
        else:
            sym_re = _sym_vec_csc(seg.real, d)
            sym_im = _sym_vec_csc(-seg.imag if np.iscomplexobj(seg.data) else 0.0 * seg.real, d)
            rows_re.append(sp.csr_matrix(sym_re))
            rows_im.append(sp.csr_matrix(sym_im))
            re_idx[off: off + n2] = off1 + np.arange(n2)
            s1.append(d)
            off += n2
            off1 += n2

    A_re = sp.vstack(rows_re).tocsc()   # n1 x (m+1)
    A_im = sp.vstack(rows_im).tocsc()
    n1 = A_re.shape[0]
    assert off == n_user and off1 == n1

    c1 = np.asarray(A_re[:, m].todense()).ravel()
    At1_re = A_re[:, :m]
    At1_im = A_im[:, :m]
    yc0 = [i - 1 for i in ycomplex]
    At1 = sp.hstack([At1_re, At1_im[:, yc0]]).tocsc() if yc0 else At1_re
    b1 = np.concatenate([np.real(b), np.imag(b)[yc0]]) if yc0 else np.real(b).astype(np.float64)

    K1 = ConeSpec(f=f1, l=l1, q=tuple(q1), r=tuple(r1), s=tuple(s1))
    return At1, b1.astype(np.float64), c1, K1, re_idx, im_idx, herm_blocks, ycomplex


# ---------------------------------------------------------------------------
# Step B: real canonicalization
# ---------------------------------------------------------------------------


def _detect_diag_sdp(At1: sp.csc_matrix, c1: np.ndarray, K1: ConeSpec) -> list[int]:
    """1-based indices of s-blocks whose data touches only the diagonal
    (pretransfo.m:231-247)."""
    out = []
    off = K1.f + K1.l + sum(K1.q) + sum(K1.r)
    rowsum = np.abs(At1).sum(axis=1).A.ravel() + np.abs(c1)
    for bi, d in enumerate(K1.s, start=1):
        n2 = d * d
        mask = rowsum[off: off + n2].reshape(d, d, order="F")
        offdiag = mask - np.diag(np.diag(mask))
        if not offdiag.any():
            out.append(bi)
        off += n2
    return out


def pretransfo(A, b, c, K: ConeSpec, pars: Pars) -> Problem:
    """Full canonicalization pipeline (pretransfo.m analog)."""
    K = ConeSpec.make(K)
    b = np.asarray(b.todense() if sp.issparse(b) else b).ravel()
    m = b.size
    c_arr = np.asarray(c.todense() if sp.issparse(c) else c).ravel()
    n = K.dim
    A = sp.csc_matrix(A)
    # Accept A (m x n) or its transpose (sedumi.m:168-178 auto-transpose).
    # The documented convention A (m x n) takes precedence when the matrix
    # is square and both interpretations fit.
    if A.shape == (m, n):
        At = sp.csc_matrix(A.T)
    elif A.shape == (n, m):
        At = A
    else:
        raise ValueError(f"A shape {A.shape} incompatible with m={m}, n={n}")
    if c_arr.size == 0:
        c_arr = np.zeros(n)
    if c_arr.size != n:
        raise ValueError(f"c has length {c_arr.size}, expected {n}")

    notes: list[str] = []
    At1, b1, c1, K1, re_idx, im_idx, herm_blocks, ycomplex = _realify(At, b, c_arr, K)
    complex_input = bool(ycomplex or K.scomplex or K.xcomplex or np.iscomplexobj(c_arr))
    n1 = At1.shape[0]
    m1 = At1.shape[1]
    if m1 != m:
        notes.append(f"split {m1 - m} complex constraint rows")

    # --- diagonal SDP detection ---
    diag_blocks = _detect_diag_sdp(At1, c1, K1) if pars.sdp else []
    if diag_blocks:
        notes.append(f"{len(diag_blocks)} diagonal SDP block(s) -> LP")

    # --- build T (N_int x n1): x1 = T' x_int ---
    # Internal ordering: [ l : l1 + sum(diag dims) + 2*f1(split) |
    #                      q : K1.q, rotated K1.r, free-embed cone last |
    #                      s : non-diagonal blocks ]
    f1, l1 = K1.f, K1.l
    split_free = (pars.free == 0)
    diag_set = set(diag_blocks)
    diag_dims = [K1.s[i - 1] for i in diag_blocks]
    s_keep = [d for bi, d in enumerate(K1.s, start=1) if bi not in diag_set]
    # per-kept-block Hermitian-embedded flag (K.scomplex order survives
    # _realify verbatim); embedded blocks must not be packed with real
    # ones nor padded — the native complex eigensolver path needs each
    # block to be EXACTLY the rho-embedding of one complex matrix
    herm_set = set(K.scomplex)
    herm1 = [bi in herm_set for bi in range(1, len(K.s) + 1)]
    s_keep_herm = [h for bi, h in enumerate(herm1, start=1)
                   if bi not in diag_set]

    l_int = l1 + sum(diag_dims) + (2 * f1 if split_free and f1 else 0)
    q_int = list(K1.q) + list(K1.r)
    if f1 and not split_free:
        q_int.append(f1 + 1)

    # --- PSD superblock packing (TPU tiling; see cones.pack_plan) ---
    # groups[g] = list of kept-block indices merged into superblock g;
    # sub_place[k] = (group, offset inside the superblock) per kept block.
    real_ids = [i for i in range(len(s_keep)) if not s_keep_herm[i]]
    herm_ids = [i for i in range(len(s_keep)) if s_keep_herm[i]]
    if pars.pack_dim and len(real_ids) > 1:
        groups_r = pack_plan([s_keep[i] for i in real_ids],
                             int(pars.pack_dim))
        groups = [[real_ids[j] for j in g] for g in groups_r]
    else:
        groups = [[i] for i in real_ids]
    n_real_groups = len(groups)
    groups = groups + [[i] for i in herm_ids]
    s_group_herm = [False] * n_real_groups + [True] * len(herm_ids)
    s_content = [sum(s_keep[i] for i in g) for g in groups]
    # Barrier padding: round superblock orders up to a multiple of
    # pars.pack_round so distinct superblocks share one bucket (one compiled
    # kernel pipeline instead of one per odd size).  A padded diagonal
    # coordinate never appears in A (it is a primal variable with objective
    # coefficient +1): its dual slack is tau > 0 (strictly interior) and
    # its primal value is mu/tau -> 0, so the padded problem is an exact
    # reformulation in the limit and central paths coincide off the pad.
    rnd = int(pars.pack_round) if pars.pack_dim and len(s_keep) > 1 else 0
    if rnd:
        # Hermitian-embedded groups stay unpadded (rho structure)
        s_packed = [D if h else max(-(-D // rnd) * rnd, D)
                    for D, h in zip(s_content, s_group_herm)]
    else:
        s_packed = list(s_content)
    sub_place: dict[int, tuple[int, int]] = {}
    for gi, g in enumerate(groups):
        o = 0
        for i in g:
            sub_place[i] = (gi, o)
            o += s_keep[i]
    if any(len(g) > 1 for g in groups) or s_packed != s_content:
        notes.append(
            f"packed {len(s_keep)} PSD block(s) into {len(groups)} "
            f"superblock(s) of orders {s_packed} (content {s_content})"
        )

    layout = Layout(l=l_int, q=tuple(q_int), s=tuple(s_packed),
                    s_herm=tuple(s_group_herm))
    N_int = layout.N

    rows: list[int] = []
    cols: list[int] = []
    vals: list[float] = []

    # user-realified offsets
    off1_f = 0
    off1_l = f1
    off1_q = f1 + l1
    off1_r = off1_q + sum(K1.q)
    off1_s = off1_r + sum(K1.r)

    # internal offsets
    int_l = 0                         # within [0, l_int)
    q_offs = layout.q_offsets()
    s_offs = layout.s_offsets()

    # l part
    for j in range(l1):
        rows.append(int_l + j)
        cols.append(off1_l + j)
        vals.append(1.0)
    int_l_next = l1

    # diagonal SDP blocks -> LP
    off_b = off1_s
    s_int_i = 0
    diag_l_pos = int_l_next
    for bi, d in enumerate(K1.s, start=1):
        n2 = d * d
        if bi in diag_set:
            for j in range(d):
                rows.append(diag_l_pos)
                cols.append(off_b + j * d + j)  # diagonal entry (col-major)
                vals.append(1.0)
                diag_l_pos += 1
        else:
            gi, o = sub_place[s_int_i]
            D = s_packed[gi]
            base = s_offs[gi]
            # entry (r, c) of the d x d sub-block (col-major j = c*d + r)
            # lands at (o+r, o+c) of the D x D superblock
            jj = np.arange(n2)
            cc, rr = divmod(jj, d)
            rows.extend((base + (o + cc) * D + (o + rr)).tolist())
            cols.extend((off_b + jj).tolist())
            vals.extend([1.0] * n2)
            s_int_i += 1
        off_b += n2
    int_l_next = diag_l_pos

    # free part
    if f1:
        if split_free:
            for j in range(f1):
                rows.append(int_l_next + j)
                cols.append(off1_f + j)
                vals.append(1.0)
                rows.append(int_l_next + f1 + j)
                cols.append(off1_f + j)
                vals.append(-1.0)
            int_l_next += 2 * f1
            notes.append(f"split {f1} free variable(s)")
        else:
            qi = len(q_int) - 1
            base = q_offs[qi]
            for j in range(f1):
                rows.append(base + 1 + j)
                cols.append(off1_f + j)
                vals.append(1.0)
            notes.append(f"embedded {f1} free variable(s) in a Lorentz cone")

    # q cones: identity
    pos = off1_q
    for qi, d in enumerate(K1.q):
        base = q_offs[qi]
        for j in range(d):
            rows.append(base + j)
            cols.append(pos + j)
            vals.append(1.0)
        pos += d

    # r cones -> q via rotation
    pos = off1_r
    rt = 1.0 / np.sqrt(2.0)
    for ri, d in enumerate(K1.r):
        qi = len(K1.q) + ri
        base = q_offs[qi]
        # y1 = (x1+x2)/sqrt2, y2 = (x1-x2)/sqrt2, tail identity
        rows += [base, base + 1, base, base + 1]
        cols += [pos, pos, pos + 1, pos + 1]
        vals += [rt, rt, rt, -rt]
        for j in range(2, d):
            rows.append(base + j)
            cols.append(pos + j)
            vals.append(1.0)
        pos += d
    if K1.r:
        notes.append(f"rotated {len(K1.r)} r-cone(s) into Lorentz cones")

    T = sp.csc_matrix(
        (np.asarray(vals), (np.asarray(rows), np.asarray(cols))), shape=(N_int, n1)
    )

    At_int = sp.csc_matrix(T @ At1)
    c_int = np.asarray(T @ c1).ravel()

    # barrier-padding objective: +1 on every padded diagonal entry
    if rnd:
        cnorm = float(np.max(np.abs(c_int))) if c_int.size else 0.0
        pad_cost = 1.0 + cnorm
        for gi, D in enumerate(s_packed):
            D0 = s_content[gi]
            if D > D0:
                base = s_offs[gi]
                jj = np.arange(D0, D)
                c_int[base + jj * D + jj] = pad_cost

    if pars.prep and pars.fid and notes:
        for s_ in notes:
            print("prep: " + s_)

    return Problem(
        At=At_int, b=b1, c=c_int, layout=layout,
        K_orig=K, m_orig=m, T=T,
        n_user=n, re_idx=re_idx, im_idx=im_idx,
        herm_blocks=herm_blocks, ycomplex=tuple(ycomplex),
        complex_input=complex_input, prep_notes=notes,
    )


# ---------------------------------------------------------------------------
# Recovery (posttransfo.m analog)
# ---------------------------------------------------------------------------


def posttransfo_x(prob: Problem, x_int: np.ndarray) -> np.ndarray:
    """Internal solution -> user x (complex where the user's K is)."""
    x1 = prob.T.T @ np.asarray(x_int).ravel()
    dtype = np.complex128 if prob.complex_input else np.float64
    x = np.zeros(prob.n_user, dtype)
    mask = prob.re_idx >= 0
    x[mask] = x1[prob.re_idx[mask]]
    cmask = prob.im_idx >= 0
    if cmask.any():
        x[cmask] = x[cmask] + 1j * x1[prob.im_idx[cmask]]
    for (uoff, d, off1) in prob.herm_blocks:
        Y = x1[off1: off1 + 4 * d * d].reshape(2 * d, 2 * d, order="F")
        Xc = 0.5 * (Y[:d, :d] + Y[d:, d:]) + 0.5j * (Y[d:, :d] - Y[:d, d:])
        x[uoff: uoff + d * d] = Xc.reshape(-1, order="F")
    return x


def posttransfo_y(prob: Problem, y_int: np.ndarray) -> np.ndarray:
    """Internal multipliers -> user y (complex at ycomplex rows)."""
    y_int = np.asarray(y_int).ravel()
    m = prob.m_orig
    if not prob.ycomplex:
        return y_int[:m].copy()
    y = y_int[:m].astype(np.complex128)
    for k, i in enumerate(prob.ycomplex):
        y[i - 1] = y[i - 1] + 1j * y_int[m + k]
    return y
