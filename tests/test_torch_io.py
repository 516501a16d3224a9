"""The port's readers and writers (sedumi_tpu_torch/io_sdpa.py, io_mps.py,
io_pack.py) against the reference's, on the CPU.

Mirrors tests/test_io_sdpa.py and tests/test_io_conv.py case by case.
Each reader and writer of the port is held to the reference's on the same
file or arrays with exact equality: the files' text identical, dense
arrays by np.array_equal, sparse matrices equal entry for entry in the
same shape and dtype.  Where a mirrored test solves, the port solves on
the CPU, and its solve of the data read back is held to its solve of the
in-memory arrays (the readers' parity with the reference and the solve
parity of tests/test_torch_solve.py cover the rest), and the reference
test's own gate is kept.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sedumi_tpu_torch as pt
from sedumi_tpu import cones as jcones
from sedumi_tpu import io_mps as jmps
from sedumi_tpu import io_pack as jpack
from sedumi_tpu import io_sdpa as jsdpa
from sedumi_tpu_torch import cones as tcones
from sedumi_tpu_torch import io_mps as tmps
from sedumi_tpu_torch import io_pack as tpack
from sedumi_tpu_torch import io_sdpa as tsdpa
from sedumi_tpu_torch.generators import feasible_problem

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)


def _same(a, b) -> bool:
    """Exact equality of two arrays or sparse matrices: shape, dtype and
    every entry."""
    if sp.issparse(a) or sp.issparse(b):
        if not (sp.issparse(a) and sp.issparse(b)):
            return False
        a, b = a.toarray(), b.toarray()
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _same_problem(p, q) -> bool:
    """(At, b, c, K) tuples equal: arrays exactly, K as a dict."""
    return all(_same(u, v) for u, v in zip(p[:3], q[:3])) and p[3] == q[3]


def _cx(c, x) -> float:
    return float(np.real(np.vdot(c, x)))


# --------------------------------------------------------------------------
# tests/test_io_sdpa.py
# --------------------------------------------------------------------------


def test_roundtrip(tmp_path, rng):
    """The writers emit the same text; each package's reader returns the
    same arrays from it; and the reference test's round trip holds for
    the port's pair."""
    At, b, c, K = feasible_problem({"l": 3, "s": [3, 2]}, m=4, seed=7)
    K = {"l": 3, "s": [3, 2]}
    ft, fj = str(tmp_path / "t.dat-s"), str(tmp_path / "j.dat-s")
    tsdpa.write_sdpa(ft, At, b, c, K)
    jsdpa.write_sdpa(fj, At, b, c, K)
    assert open(ft).read() == open(fj).read()
    got = tsdpa.read_sdpa(ft)
    assert _same_problem(got, jsdpa.read_sdpa(ft))
    At2, b2, c2, K2 = got
    np.testing.assert_allclose(b2, b, rtol=1e-15)
    assert K2["l"] == 3 and K2["s"] == [3, 2]

    def sym_flat(Amat):
        Amat = sp.csc_matrix(Amat).toarray()
        out = Amat.copy()
        off = 3
        for d in [3, 2]:
            blk = Amat[off:off + d * d, :].reshape(d, d, -1)
            out[off:off + d * d, :] = (
                0.5 * (blk + blk.transpose(1, 0, 2))).reshape(d * d, -1)
            off += d * d
        return out

    np.testing.assert_allclose(sym_flat(At2), sym_flat(At), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(sym_flat(c2.reshape(-1, 1)),
                               sym_flat(np.asarray(c).reshape(-1, 1)),
                               rtol=1e-12, atol=1e-14)


def test_read_and_solve(tmp_path, rng):
    """min <C,X> s.t. tr X = 1 written and read back by the port: the
    reference reader reads the same arrays, the port's solve of them is
    its solve of the in-memory problem, bit for bit, and reaches
    lambda_min(C) (the reference test's gate)."""
    d = 4
    C = rng.normal(size=(d, d))
    C = 0.5 * (C + C.T)
    At = sp.csc_matrix(np.eye(d).reshape(-1, 1))
    fname = str(tmp_path / "eig.dat-s")
    tsdpa.write_sdpa(fname, At, np.array([1.0]), C.reshape(-1), {"s": [d]})
    At2, b2, c2, K2 = tsdpa.read_sdpa(fname)
    assert _same_problem((At2, b2, c2, K2), jsdpa.read_sdpa(fname))
    x, y, info = pt.sedumi(At2, b2, c2, K2, {"fid": 0}, device="cpu")
    x0, y0, _ = pt.sedumi(At, np.array([1.0]), C.reshape(-1), {"s": [d]},
                          {"fid": 0}, device="cpu")
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(y, y0)
    lam_min = np.linalg.eigvalsh(C).min()
    assert abs(_cx(c2, x) - lam_min) < 1e-7 * (1 + abs(lam_min))


def test_comments_and_formats(tmp_path):
    txt = """* test problem
" another comment
2
2
{2, -1}
(1.0, 2.0)
0 1 1 1 1.0
1 1 1 2 0.5
1 2 1 1 1.0
2 1 2 2 1.0
2 2 1 1 1.0
"""
    fname = str(tmp_path / "c.dat-s")
    open(fname, "w").write(txt)
    At, b, c, K = tsdpa.read_sdpa(fname)
    assert _same_problem((At, b, c, K), jsdpa.read_sdpa(fname))
    assert K["l"] == 1 and K["s"] == [2]
    np.testing.assert_allclose(b, [1.0, 2.0])
    assert At.shape == (5, 2)
    assert c[1] == -1.0 and c[0] == 0.0


# --------------------------------------------------------------------------
# tests/test_io_conv.py
# --------------------------------------------------------------------------

MPS_SAMPLE = """* sample LP (afiro-style structure)
NAME          TESTLP
ROWS
 N  COST
 L  LIM1
 G  LIM2
 E  MYEQN
COLUMNS
    X1        COST         1.0   LIM1         1.0
    X1        LIM2         1.0
    X2        COST         2.0   LIM1         1.0
    X2        MYEQN       -1.0
    X3        COST        -1.0   LIM2         1.0
    X3        MYEQN        1.0
RHS
    RHS       LIM1         4.0   LIM2         1.0
    RHS       MYEQN        7.0
BOUNDS
 UP BND       X1           4.0
 LO BND       X2          -1.0
ENDATA
"""


@pytest.fixture
def mps_file(tmp_path):
    p = tmp_path / "test.mps"
    p.write_text(MPS_SAMPLE)
    return str(p)


def _linprog_reference():
    from scipy.optimize import linprog

    return linprog([1.0, 2.0, -1.0],
                   A_ub=[[1.0, 1.0, 0.0], [-1.0, 0.0, -1.0]],
                   b_ub=[4.0, -1.0], A_eq=[[0.0, -1.0, 1.0]], b_eq=[7.0],
                   bounds=[(0, 4), (-1, None), (0, None)], method="highs")


def test_read_mps_shapes(mps_file):
    p, q = tmps.read_mps(mps_file), jmps.read_mps(mps_file)
    for f in ("name", "ncols", "row_names", "col_names", "row_types",
              "obj_name", "ranges", "objconst"):
        assert getattr(p, f) == getattr(q, f), f
    for f in ("A", "c", "rhs", "lb", "ub"):
        assert _same(getattr(p, f), getattr(q, f)), f
    assert p.name == "TESTLP"
    assert p.ncols == 3
    assert p.row_types == ["L", "G", "E"]
    assert p.rhs.tolist() == [4.0, 1.0, 7.0]
    assert p.ub[0] == 4.0 and p.lb[1] == -1.0


def test_prelp_standard_form_matches_linprog(mps_file):
    from scipy.optimize import linprog

    got = tmps.prelp(mps_file)
    want = jmps.prelp(mps_file)
    assert all(_same(u, v) for u, v in zip(got[:3], want[:3]))
    assert got[3] == want[3] and _same(got[4], want[4]) \
        and got[5] == want[5]
    A, b, c, lenx, lbounds, objconst = got
    assert lenx == 3
    res = linprog(c, A_eq=A.todense(), b_eq=b,
                  bounds=[(0, None)] * A.shape[1], method="highs")
    assert res.status == 0
    res0 = _linprog_reference()
    assert res0.status == 0
    assert np.isclose(res.fun + objconst, res0.fun, rtol=1e-9)


def test_mps_solve_with_sedumi(mps_file):
    """The port's read_mps_as_sedumi is the reference's; the port's solve
    of what it reads is its solve of the same arrays built in memory
    (the reference reader's), bit for bit, and meets the reference test's
    gate against linprog."""
    At, b, c, K, objconst = tmps.read_mps_as_sedumi(mps_file)
    jAt, jb, jc, jK, jconst = jmps.read_mps_as_sedumi(mps_file)
    assert _same_problem((At, b, c, K), (jAt, jb, jc, jK))
    assert objconst == jconst
    x, y, info = pt.sedumi(At, b, c, K, {"fid": 0}, device="cpu")
    x0, y0, _ = pt.sedumi(jAt.copy(), jb.copy(), jc.copy(), dict(jK),
                          {"fid": 0}, device="cpu")
    np.testing.assert_array_equal(x, x0)
    assert info["pinf"] == 0 and info["dinf"] == 0
    res0 = _linprog_reference()
    cx = float(c @ np.real(x)) + objconst
    assert np.isclose(cx, res0.fun, rtol=1e-6, atol=1e-6)


def test_svec_smat_roundtrip(rng):
    dims = [3, 5, 2]
    rows = []
    for _ in range(4):
        parts = []
        for d in dims:
            M = rng.normal(size=(d, d))
            M = 0.5 * (M + M.T)
            parts.append(M.ravel(order="F"))
        rows.append(np.concatenate(parts))
    F = sp.csc_matrix(np.stack(rows))
    S = tpack.svec_rows(F, dims)
    assert _same(S, jpack.svec_rows(F, dims))
    F2 = tpack.smat_rows(S, dims)
    assert _same(F2, jpack.smat_rows(S, dims))
    np.testing.assert_allclose(F2.todense(), F.todense(), atol=1e-12)
    g_full = (F @ F.T).todense()
    g_svec = (S @ S.T).todense()
    np.testing.assert_allclose(g_svec, g_full, atol=1e-10)
    # blockdiag_to_vec, the reverse map of a block-diagonal matrix
    B = sp.block_diag([np.reshape(rows[0][:9], (3, 3), order="F"),
                       np.reshape(rows[0][9:34], (5, 5), order="F"),
                       np.reshape(rows[0][34:], (2, 2), order="F")])
    assert _same(tpack.blockdiag_to_vec(B, dims),
                 jpack.blockdiag_to_vec(B, dims))


def test_sdppack_roundtrip_and_solve(rng):
    """to_sdppack and from_sdppack give the reference's arrays; the port's
    solve of the round-tripped problem is held to its solve of the
    original arrays (c'x within 1e-8 relative; the round trip rounds the
    PSD rows by sqrt(2) scalings) and, as in the reference test, is
    feasible."""
    K = {"l": 3, "q": [3], "s": [3]}
    At, b, c, _ = feasible_problem(K, m=5, seed=7)
    A_p, b_p, C_p, blk = tpack.to_sdppack(At, b, c, K)
    jA_p, jb_p, jC_p, jblk = jpack.to_sdppack(At, b, c, K)
    assert blk == jblk and _same(b_p, jb_p)
    assert A_p.keys() == jA_p.keys() and C_p.keys() == jC_p.keys()
    assert all(_same(A_p[k], jA_p[k]) and _same(C_p[k], jC_p[k])
               for k in A_p)
    got = tpack.from_sdppack(A_p, b_p, C_p, blk)
    assert _same_problem(got, jpack.from_sdppack(A_p, b_p, C_p, blk))
    At2, b2, c2, K3 = got
    np.testing.assert_allclose(np.asarray(At2.todense()),
                               np.asarray(sp.csc_matrix(At).todense()),
                               atol=1e-12)
    np.testing.assert_allclose(c2, np.asarray(c).ravel(), atol=1e-12)
    x, y, info = pt.sedumi(At2, b2, c2, K3, {"fid": 0}, device="cpu")
    x0, y0, _ = pt.sedumi(At, b, c, K, {"fid": 0}, device="cpu")
    assert info["pinf"] == 0 and info["dinf"] == 0
    assert abs(_cx(c2, x) - _cx(c, x0)) <= 1e-8 * (1 + abs(_cx(c, x0)))


def test_write_sdppack_smoke(tmp_path):
    At, b, c, _ = feasible_problem({"l": 2, "s": [2]}, m=3, seed=1)
    K = {"l": 2, "s": [2]}
    fname, jname = str(tmp_path / "prob.sdpa"), str(tmp_path / "j.sdpa")
    tpack.write_sdppack(fname, At, b, c, K)
    jpack.write_sdppack(jname, At, b, c, K)
    assert open(fname).read() == open(jname).read()
    txt = open(fname).read().splitlines()
    assert txt[0].strip() == "3"
    assert os.path.getsize(fname) > 0


def test_pack_plan_exact_and_capacity():
    dims = [6, 6, 6, 6, 15, 15, 36, 15, 15, 36, 72, 36, 36, 20, 90, 90, 20,
            306, 306, 90, 90, 94]
    groups = tcones.pack_plan(dims, 128)
    assert groups == jcones.pack_plan(dims, 128)
    flat = sorted(i for g in groups for i in g)
    assert flat == list(range(len(dims)))
    for g in groups:
        tot = sum(dims[i] for i in g)
        assert tot <= 128 or len(g) == 1
    for g in groups:
        if any(dims[i] >= 128 for i in g):
            assert len(g) == 1


def test_packed_solve_matches_unpacked(rng):
    """Many small PSD blocks: the port's solve with its blocks packed into
    superblocks (pack_dim 8) lands where the unpacked one does, with a
    primal solution feasible in the original cones (the reference test's
    gates, on the port)."""
    K = {"l": 2, "s": [2, 3, 2, 4, 3, 2]}
    At, b, c, _ = feasible_problem(K, m=6, seed=3)
    x1, y1, i1 = pt.sedumi(At, b, c, K, {"fid": 0, "pack_dim": 8},
                           device="cpu")
    x2, y2, i2 = pt.sedumi(At, b, c, K, {"fid": 0, "pack_dim": 0},
                           device="cpu")
    assert i1["pinf"] == 0 and i1["dinf"] == 0
    assert np.isclose(_cx(c, x1), _cx(c, x2), rtol=1e-6, atol=1e-8)
    assert float(np.min(pt.eigK(np.real(x1), K))) > -1e-7
