"""Port parity for K2's needed entries and K4's shared splits, on the CPU.

* K2 (csrc/psd_coo.cu) forms B~ only at the distinct locations U of b_loc
  that its gather reads (opA.needed_entries).  The arrays map every
  nonzero into U, cut U into items and chunks as the kernel needs, and,
  walked chunk by chunk in the kernel's order (psd_emulation.
  contrib_chunks), give the reference's _psd_contrib_coo within 1e-12 of
  max|M| and bit for bit the emulation that builds U on its own (also cut
  into many chunks, so the sums carried from chunk to chunk are
  exercised); the sparse engine's pair values likewise.
* K4: dd_gemm with slices passed by the caller (the Gram's B' as B's rows,
  dd_chol's trailing operand as the first rows of A, one split of R_k for
  the congruence pair) equals the call that splits both operands, bit for
  bit; form_dd and dd_chol against the reference.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import psd_emulation as pe
from sedumi_tpu import ddengine as jddengine
from sedumi_tpu import ddlinalg as jdd
from sedumi_tpu import nt as jnt
from sedumi_tpu import opA as jopA
from sedumi_tpu import schur as jschur
from sedumi_tpu import transform as jtf
from sedumi_tpu.examples import load_example
from sedumi_tpu.generators import feasible_problem
from sedumi_tpu.params import Pars as JPars
from sedumi_tpu.structs import ConeVec as JCV
from sedumi_tpu_torch import convert, schur, sparse_engine
from sedumi_tpu_torch import ddengine as tddengine
from sedumi_tpu_torch import ddlinalg as tdd
from sedumi_tpu_torch import opA as topA
from sedumi_tpu_torch.cones import Layout
from sedumi_tpu_torch.params import Pars

torch.set_num_threads(1)


def _random_problem(seed, keep, K=None, m=11):
    """test_torch_kernels' random layouts: LP, Lorentz, PSD 5, 5, 7."""
    rng = np.random.default_rng(seed)
    At, b, c, K = feasible_problem(
        K or {"l": 3, "q": [4, 3], "s": [5, 5, 7]}, m, seed=seed)
    At = sp.csc_matrix(At)
    At.data[rng.random(At.nnz) > keep] = 0.0
    At.eliminate_zeros()
    return jtf.pretransfo(At, b, c, K, JPars(fid=0))


_PROBS = {}


def _problem(case):
    if case not in _PROBS:
        if case == "arch0":
            ex = load_example("arch0")
            _PROBS[case] = (jtf.pretransfo(ex.At, ex.b, ex.c, ex.K,
                                           JPars(fid=0)), 3.0)
        else:
            _PROBS[case] = (_random_problem(*case), 0.0)
    return _PROBS[case]


CASES = [(7, 0.2), (8, 0.5), (9, 1.0), "arch0"]


def _coo_parts(case, chunk=None, monkeypatch=None):
    """The port's numpy COO parts of `case` (coo_arrays), with chunks of
    at most `chunk` entries of U when given."""
    prob, discount = _problem(case)
    if chunk is not None:
        monkeypatch.setattr(topA, "CHUNK_ENTRIES", chunk)
    Al, _, _, parts, metas = topA.coo_arrays(prob.At, prob.c, prob.layout,
                                             discount)
    return prob, discount, Al.shape[0], [
        (p, m) for p, m in zip(parts, metas) if m[0] == "coo"]


def _w(k, d, seed):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((k, d, d)) / np.sqrt(d) + np.eye(d)
    return r, r @ r.transpose(0, 2, 1)


@pytest.mark.parametrize("case", CASES)
def test_needed_entries_cover_the_gather(case, monkeypatch):
    """Every nonzero maps into U; chunks are ranges of U in one block, at
    most CHUNK_ENTRIES (also when cut small); items are segments of at most
    ITEM_ENTRIES entries of one row, inside their chunk, ordered by
    (segment, row), that cover the chunk once; g_of inverts g_slot."""
    for chunk in (None, 37):
        _, _, mp1, parts = _coo_parts(case, chunk, monkeypatch)
        assert parts
        for part, (rep, k, d, G, pad2, T) in parts:
            dd = d * d
            U = np.unique(part["b_loc"])
            assert U.size <= T
            np.testing.assert_array_equal(part["u_e"], U % d)
            np.testing.assert_array_equal(U[part["b_uidx"]], part["b_loc"])
            same = part["b_row"][1:] == part["b_row"][:-1]
            assert np.all(np.diff(part["b_uidx"])[same] > 0)
            ch, it = part["ch"], part["it"]
            assert tuple(ch[-1]) == (it.shape[0], U.size, 0, 0)
            cap = chunk or topA.CHUNK_ENTRIES
            for c in range(ch.shape[0] - 1):
                (i0, u0, a_lo, a_hi), (i1, u1) = ch[c], ch[c + 1, :2]
                assert 0 < u1 - u0 <= cap and i1 > i0
                blk, a = U[u0:u1] // dd, U[u0:u1] % dd // d
                assert np.all(blk == blk[0]) and (a_lo, a_hi) == (a[0], a[-1])
                seen = np.zeros(u1 - u0, int)
                key = []
                for ab, ua, nr in it[i0:i1]:
                    n, rot = nr & 15, nr >> 4
                    assert 0 < n <= topA.ITEM_ENTRIES and u0 <= ua
                    assert 0 <= rot < topA.ITEM_ENTRIES
                    assert ua + n <= u1
                    np.testing.assert_array_equal(
                        U[ua:ua + n] // d, blk[0] * d + ab % d)
                    assert ab // d == blk[0]
                    seen[ua - u0:ua - u0 + n] += 1
                    key.append(((ua - u0) - np.searchsorted(a, ab % d), ab))
                assert np.all(seen == 1)
                assert key == sorted(key)
            g_of = part["g_of"]
            assert g_of.size == mp1 * k
            np.testing.assert_array_equal(g_of[part["g_slot"]],
                                          np.arange(G))
            assert np.count_nonzero(g_of >= 0) == G


@pytest.mark.parametrize("case", CASES)
def test_needed_entry_order_matches_reference(case, monkeypatch):
    """K2's order over the needed entries against the reference's whole
    blocks (rtol 1e-12 of max|M|), and bit for bit the emulation that
    builds U itself, with one chunk and with chunks of 37 entries."""
    prob, discount, mp1, parts = _coo_parts(case)
    aj = jopA.build_coo_aop(prob.At, prob.c, prob.layout,
                            gemm_discount=discount)
    jparts = [p for p, m in zip(aj.s_parts, aj.s_meta) if m[0] == "coo"]
    _, _, _, small = _coo_parts(case, 37, monkeypatch)
    for n, ((part, (rep, k, d, G, pad2, T)), jpart, (spart, _)) in \
            enumerate(zip(parts, jparts, small)):
        r, W = _w(k, d, n)
        Mj = np.asarray(jschur._psd_contrib_coo(jpart, k, d, G, pad2, mp1,
                                                jnp.asarray(r)))
        Mc = pe.contrib_chunks(part, k, d, mp1, W, exact=False)
        assert np.abs(Mc - Mj).max() <= 1e-12 * np.abs(Mj).max()
        Mu = pe.contrib_coo(part, k, d, mp1, W, exact=False)
        np.testing.assert_array_equal(Mc, Mu)
        if case != "arch0":
            assert spart["ch"].shape[0] > 2
        np.testing.assert_array_equal(
            pe.contrib_chunks(spart, k, d, mp1, W, exact=False), Mu)


def test_exact_emulation_small_bucket(monkeypatch):
    """The exact-fma order (the card tests' bit-for-bit yardstick), f64 and
    f32, on one small bucket cut into chunks of 5: the chunk walk equals
    the independent emulation bit for bit, and the plain twin (held to
    the reference in test_torch_kernels.py) within 1e-12 (f64) or 1e-5
    (f32) of max|M|."""
    _PROBS.setdefault("small", (_random_problem(4, 0.4, {"s": [4, 3]}, 5),
                                0.0))
    prob, discount, mp1, parts = _coo_parts("small", 5, monkeypatch)
    part, (rep, k, d, G, pad2, T) = parts[0]
    assert part["ch"].shape[0] > 3
    r, W = _w(k, d, 3)
    Mp = schur._psd_contrib_coo_plain(
        {key: torch.as_tensor(a) for key, a in part.items()}, k, d, G, pad2,
        mp1, torch.as_tensor(W)).numpy()
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        Mc = pe.contrib_chunks(part, k, d, mp1, W.astype(dtype), dtype)
        np.testing.assert_array_equal(
            Mc, pe.contrib_coo(part, k, d, mp1, W.astype(dtype), dtype))
        assert Mc.dtype == dtype
        assert np.abs(Mc - Mp).max() <= tol * np.abs(Mp).max()


def test_exact_fma_is_correctly_rounded():
    """The emulation's fma: exact product and sum, one rounding (ties to
    even), against numpy's correctly rounded sums and products, an fma
    that a separate product would round away, ties and signed zeros."""
    rng = np.random.default_rng(5)
    for dtype in (np.float64, np.float32):
        x = (rng.standard_normal(200)
             * np.exp2(rng.integers(-30, 30, 200))).astype(dtype)
        y = rng.standard_normal(200).astype(dtype)
        for a, b in zip(x, y):
            assert pe.fma(a, 1.0, b, dtype) == a + b
            assert pe.fma(a, b, 0.0, dtype) == a * b
    one = 1.0 + 2.0**-52
    assert pe.fma(one, 1.0 - 2.0**-52, -1.0, np.float64) == -2.0**-104
    assert pe.fma(1.0, 1.0, 2.0**-53, np.float64) == 1.0    # tie to even
    assert pe.fma(1.0, 1.0, 3 * 2.0**-53, np.float64) == 1.0 + 2.0**-51
    assert pe.fma(np.float32(1.0), 1.0, 2.0**-24, np.float32) == 1.0
    assert np.signbit(pe.fma(-0.0, 1.0, -0.0, np.float64))
    assert not np.signbit(pe.fma(-0.0, 1.0, 0.0, np.float64))
    assert not np.signbit(pe.fma(2.0, 3.0, -6.0, np.float64))


def test_sparse_pair_values_match_emulation():
    """The sparse engine's pair entry (plain twin on the CPU) against the
    emulation's per-pair order, within 1e-13 of max|value|, on a small
    SDP plan."""
    rng = np.random.default_rng(4)
    m, nb, d = 40, 12, 4
    rows, cols, vals = [], [], []
    for i in range(m):
        for bk in rng.choice(nb, size=2, replace=False):
            p, q = rng.integers(0, d, 2)
            for a, b in {(p, q), (q, p)}:
                rows.append(i)
                cols.append(bk * d * d + a * d + b)
                vals.append(rng.standard_normal())
    A = sp.csc_matrix((vals, (rows, cols)), shape=(m, nb * d * d))
    layout = Layout(l=0, q=(), s=(d,) * nb)
    c = np.tile(np.eye(d).ravel(), nb)
    arrays, meta = sparse_engine.plan_sparse_lq(A.T.tocsc(), c, layout,
                                                Pars(fid=0))
    r, W = _w(nb, d, 6)
    for bi in range(len(meta["s_shapes"])):
        args = [arrays[key][bi] for key in ("sg_blk", "sg_p", "sg_q",
                                            "sg_v", "sp_g", "sp_loc",
                                            "sp_val")]
        got = schur.psd_pair_values(
            torch.as_tensor(W), *(torch.as_tensor(np.asarray(a, np.int64))
                                  for a in args[:3]),
            torch.as_tensor(args[3]),
            *(torch.as_tensor(np.asarray(a, np.int64)) for a in args[4:6]),
            torch.as_tensor(args[6])).numpy()
        want = pe.pair_values(W, *args, exact=False)
        assert got.size == args[4].size > 0
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


# ------------------------------------------------------------------- K4


def _same(got, want):
    return all(torch.equal(g.view(torch.int64), w.contiguous()
                           .view(torch.int64)) for g, w in zip(got, want))


def test_dd_gemm_with_passed_slices_is_bit_for_bit():
    """Gram, dd_chol's trailing update and the congruence pair: passing
    the slices gives the two-split call's bits."""
    rng = np.random.default_rng(9)
    # the Gram B B' (form_dd)
    Bh = torch.as_tensor(rng.standard_normal((13, 75))
                         * np.exp2(rng.integers(-8, 9, (13, 75))))
    Bl = Bh * 2.0**-55
    As = tdd.ozaki_split(Bh, 75, axis=-1)
    assert _same(tdd.dd_gemm(Bh, Bl, Bh.T, Bl.T, As=As,
                             Bs=[s.T for s in As]),
                 tdd.dd_gemm(Bh, Bl, Bh.T, Bl.T))
    # dd_chol's trailing update: B's lines are A's first w rows
    Lh = torch.as_tensor(np.tril(rng.standard_normal((40, 40))))
    Ll = Lh * 2.0**-54
    p0, p1 = 16, 24
    As = tdd.ozaki_split(Lh[p0:, :p0], p0, axis=-1)
    assert _same(tdd.dd_gemm(Lh[p0:, :p0], Ll[p0:, :p0],
                             Lh[p0:p1, :p0].T, Ll[p0:p1, :p0].T, As=As,
                             Bs=[s[:p1 - p0].T for s in As]),
                 tdd.dd_gemm(Lh[p0:, :p0], Ll[p0:, :p0],
                             Lh[p0:p1, :p0].T, Ll[p0:p1, :p0].T))
    # the congruence pair: one split of R_k for both products
    d = 6
    Ak = torch.as_tensor(rng.standard_normal((5 * d, d)))
    Rk = torch.as_tensor(rng.standard_normal((d, d)))
    Rs = tdd.ozaki_split(Rk, d, axis=0)
    Th, Tl = tdd.dd_gemm(Ak, None, Rk, None, Bs=Rs)
    assert _same((Th, Tl), tdd.dd_gemm(Ak, None, Rk, None))
    assert _same(tdd.dd_gemm(Th, Tl, Rk, None, Bs=Rs),
                 tdd.dd_gemm(Th, Tl, Rk, None))


def test_form_dd_and_dd_chol_match_reference():
    """form_dd (COO PSD buckets and LP, split once per operand) and
    dd_chol against the reference's: M to the dd level, 1e-26 of max|M|,
    the factor within 1e-26 of max|L| in dd."""
    At, b, c, K = feasible_problem({"l": 4, "s": [6, 5]}, 12, seed=13)
    prob = jtf.pretransfo(At, b, c, K, JPars(fid=0))
    aop_j = jopA.build_coo_aop(prob.At, prob.c, prob.layout,
                               gemm_discount=1e-9)
    aop_t = topA.build_coo_aop(prob.At, prob.c, prob.layout, device="cpu",
                               gemm_discount=1e-9)
    assert all(meta[0] == "coo" for meta in aop_t.s_meta)
    rng = np.random.default_rng(13)

    def interior():
        s = []
        for bk in prob.layout.s_buckets:
            a = rng.standard_normal((bk.count, bk.dim, bk.dim))
            s.append(a @ a.transpose(0, 2, 1) / bk.dim + 2 * np.eye(bk.dim))
        return JCV(l=jnp.asarray(rng.random(prob.layout.l) + 0.5), q=(),
                   s=tuple(map(jnp.asarray, s)))

    S_j = jnt.compute_scaling(interior(), interior())
    S_t = convert.scaling_from_numpy(
        jax.tree_util.tree_map(np.asarray, S_j), device="cpu")
    m = aop_j.m
    Mh, Ml = tddengine.form_dd(aop_t, S_t, 0.0)
    ctx_j = jddengine.DdSchurEngine().prepare(aop_j, S_j,
                                              jnp.float64(0.0))[0]
    Mj = np.asarray(ctx_j[0], np.longdouble) + np.asarray(ctx_j[1])
    Mt = (np.asarray(Mh.numpy(), np.longdouble) + Ml.numpy())[:m, :m]
    assert float(np.abs(Mt - Mj[:m, :m]).max()) \
        <= 1e-26 * float(np.abs(Mj).max())
    A = Mh[:m, :m].numpy()
    f_t = tdd.dd_chol(Mh[:m, :m], Ml[:m, :m], nb=4)
    f_j = jdd.dd_chol(A, Ml[:m, :m].numpy(), nb=4)
    Lt = np.asarray(f_t.Lh.numpy(), np.longdouble) + f_t.Ll.numpy()
    Lj = np.asarray(np.asarray(f_j.Lh), np.longdouble) + np.asarray(f_j.Ll)
    assert float(np.abs(Lt - Lj).max()) <= 1e-26 * float(np.abs(Lj).max())
