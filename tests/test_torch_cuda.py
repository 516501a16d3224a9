"""The port's CUDA kernels against their plain-PyTorch twins, on the card.

Every test here is marked `cuda` and skips on a host without a CUDA
device.  This file imports neither jax nor the reference package, so on
the card (where jax is not installed) it runs without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -s \
        tests/test_torch_cuda.py

(-s shows the JSON line that test_arch0_witness prints.)
"""

import json
import os
import warnings

import numpy as np
import pytest
import scipy
import scipy.sparse as sp
import torch

import sedumi_tpu_torch as st
from chip_smoke import random_sparse_lp
from sedumi_tpu_torch import chol, ddlinalg, df, ipm, kernels, opA, pcg, \
    schur, sparse_chol, sparse_engine, transform
from sedumi_tpu_torch.examples import load_example
from sedumi_tpu_torch.params import Pars

# cuBLAS is deterministic under torch.use_deterministic_algorithms only
# with a fixed workspace; it must be set before the first cuBLAS handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

EPS = float(np.finfo(np.float64).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def residual_case(m, seed):
    """cond ~ 1e14 matrix and v = M^-1 rhs: a cancellation-heavy residual."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    M = (q * np.logspace(0, -14, m)) @ q.T
    M = 0.5 * (M + M.T)
    rhs = rng.standard_normal(m)
    return M, np.linalg.solve(M, rhs), rhs


def indefinite(m, seed):
    """SPD part plus decoupled negative pivots (add only) and coupled ones
    (add, then skip)."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((m, m))
    M = B @ B.T / m + np.eye(m)
    for j in range(3, m, 11):
        M[j, :] = 0.0
        M[:, j] = 0.0
        M[j, j] = -1.0
    for j in range(7, m, 13):
        M[j, j] = -1.0
    return M


def sparse_sdp(seed):
    """A random sparse problem with LP, Lorentz and three PSD blocks."""
    rng = np.random.default_rng(seed)
    K = {"l": 3, "q": [4, 3], "s": [5, 5, 7]}
    n = 3 + 4 + 3 + 25 + 25 + 49
    At = sp.random(n, 11, density=0.2, random_state=seed, format="csc")
    c = rng.standard_normal(n)
    return transform.pretransfo(At, rng.standard_normal(11), c, K,
                                Pars(fid=0))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [7, 123, 666])
def test_dd_residual_kernel(cuda, m):
    M, v, rhs = (torch.as_tensor(a, device=cuda)
                 for a in residual_case(m, m))
    n0 = kernels.LAUNCHES["dd_matvec_residual"]
    r_k = pcg.dd_matvec_residual(M, v, rhs)
    assert kernels.LAUNCHES["dd_matvec_residual"] == n0 + 1
    r_p = pcg.dd_matvec_residual_plain(M, v, rhs)
    tol = 2 * EPS * r_p.abs() + 1e-28 * (M.abs() @ v.abs())
    assert bool(torch.all((r_k - r_p).abs() <= tol))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2])
def test_psd_contrib_coo_kernel(cuda, seed):
    prob = sparse_sdp(seed)
    aop = opA.build_coo_aop(prob.At, prob.c, prob.layout, device=cuda,
                            gemm_discount=0.0)
    rng = np.random.default_rng(seed)
    for part, (rep, k, d, G, pad2, T) in zip(aop.s_parts, aop.s_meta):
        assert rep == "coo"
        W = schur.psd_gram(torch.as_tensor(
            rng.standard_normal((k, d, d)), device=cuda))
        Mk = schur._psd_contrib_coo_kernel(part, k, d, G, pad2, aop.m + 1, W)
        Mp = schur._psd_contrib_coo_plain(part, k, d, G, pad2, aop.m + 1, W)
        assert float((Mk - Mp).abs().max()) <= 1e-12 * float(
            Mp.abs().max())
        # the sparse engine's layout: one B~ per group, slots 0..G-1
        args = (W, part["g_blk"], part["gp"], part["gq"], part["gv"],
                torch.arange(G, device=cuda), G)
        Bk = schur._psd_outer_kernel(*args)
        Bp = schur.psd_outer_plain(*args)
        assert Bk.shape == (G, d, d)
        assert float((Bk - Bp).abs().max()) <= 1e-12 * float(
            Bp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [12, 174])
def test_ldl_masked_kernel(cuda, m):
    """The masks and the factor agree bit for bit with the plain twin."""
    M = torch.as_tensor(indefinite(m, 3), device=cuda)
    fk = chol.ldl_masked(M)
    fp = chol.ldl_masked_plain(M)
    assert bool(fp.skip.any())
    for a, b in zip(fk, fp):
        assert torch.equal(a, b)


def bits_equal(a, b) -> bool:
    ints = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(ints), b.contiguous().view(ints))


# ------------------------------------------- the precision ladder's kernels

U32 = 2.0**-24


@pytest.mark.cuda
@pytest.mark.parametrize("m", [7, 123, 666])
def test_dd_residual_f32_kernel(cuda, m):
    """K1-f32 within 2u|r| + (n + 2L + 2D + 14) u^2 sum|M v| of its twin
    (u = 2^-24; see chip_smoke.check_dd_residual_f32)."""
    rng = np.random.default_rng(m)
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    M = torch.as_tensor((q * np.logspace(0, -6, m)) @ q.T,
                        dtype=torch.float32, device=cuda)
    M = 0.5 * (M + M.T)
    rhs = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32,
                          device=cuda)
    v = torch.linalg.solve(M.double(), rhs.double()).float()
    n0 = kernels.LAUNCHES["dd_matvec_residual_f32"]
    r_k = pcg.dd_matvec_residual(M, v, rhs)
    assert kernels.LAUNCHES["dd_matvec_residual_f32"] == n0 + 1
    assert r_k.dtype == torch.float32
    r_p = pcg.dd_matvec_residual_plain(M, v, rhs).double()
    c = m + 2 * (-(-m // 32)) + 2 * int(np.ceil(np.log2(max(m, 2)))) + 14
    tol = 2 * U32 * r_p.abs() + c * U32 * U32 * (M.double().abs()
                                                 @ v.double().abs())
    assert bool(torch.all((r_k.double() - r_p).abs() <= tol))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2])
def test_psd_contrib_coo_f32_kernel(cuda, seed):
    """K2-f32 within 2 (pad2 + Tmax + 3) u M_abs of its twin (see
    chip_smoke.check_psd_coo_f32)."""
    prob = sparse_sdp(seed)
    aop = opA.build_coo_aop(prob.At, prob.c, prob.layout, device=cuda,
                            gemm_discount=0.0, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    for part, (rep, k, d, G, pad2, T) in zip(aop.s_parts, aop.s_meta):
        assert rep == "coo" and part["gv"].dtype == torch.float32
        W = schur.psd_gram(torch.as_tensor(
            rng.standard_normal((k, d, d)), dtype=torch.float32,
            device=cuda))
        n0 = kernels.LAUNCHES["psd_contrib_coo_f32"]
        Mk = schur._psd_contrib_coo_kernel(part, k, d, G, pad2, aop.m + 1, W)
        assert kernels.LAUNCHES["psd_contrib_coo_f32"] == n0 + 1
        Mp = schur._psd_contrib_coo_plain(part, k, d, G, pad2, aop.m + 1, W)
        absp = {key: (v.abs().double() if v.is_floating_point() else v)
                for key, v in part.items()}
        Mabs = schur._psd_contrib_coo_plain(absp, k, d, G, pad2, aop.m + 1,
                                            W.abs().double())
        c = 2 * (pad2 + int(torch.diff(part["b_rowptr"]).max()) + 3)
        assert bool(torch.all((Mk.double() - Mp.double()).abs()
                              <= c * U32 * Mabs))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [12, 174])
def test_ldl_masked_f32_kernel(cuda, m):
    """K3-f32: masks, pivots and factor bit for bit with the f32 twin."""
    M = torch.as_tensor(indefinite(m, 3), dtype=torch.float32, device=cuda)
    n0 = kernels.LAUNCHES["ldl_masked_f32"]
    fk = chol.ldl_masked(M)
    assert kernels.LAUNCHES["ldl_masked_f32"] == n0 + 1
    fp = chol.ldl_masked_plain(M)
    assert bool(fp.skip.any()) and fk.L.dtype == torch.float32
    assert torch.equal(fk.skip, fp.skip)
    for a, b in ((fk.L, fp.L), (fk.d, fp.d), (fk.diagadd, fp.diagadd)):
        assert bits_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 33), (124, 2383), (37, 5000),
                                    (1001, 65536)])
def test_df_gemv_kernels(cuda, rows, n):
    """K11: df_matvec and df_vecmat within (c_kernel + c_tree) 2^-48
    sum|a x| of the reference's tree arithmetic (see
    chip_smoke.check_df_gemv), and within 1e-12 of the f64 product."""
    rng = np.random.default_rng(rows)
    A = torch.as_tensor(rng.standard_normal((rows, n))
                        * np.exp(rng.standard_normal((rows, n))),
                        device=cuda)
    Ah, Al = df.df_split64(A)
    A64 = df.df_to64(Ah, Al)
    for fn, length in (("df_matvec", n), ("df_vecmat", rows)):
        xh, xl = df.df_split64(torch.as_tensor(rng.standard_normal(length),
                                               device=cuda))
        x64 = df.df_to64(xh, xl)
        n0 = kernels.LAUNCHES[fn]
        if fn == "df_matvec":
            got = df.df_to64(*df.df_matvec(Ah, Al, xh, xl))
            want = df.df_to64(*df.df_matvec_plain(Ah, Al, xh, xl))
            S, exact = A64.abs() @ x64.abs(), A64 @ x64
            L, D, k = -(-n // 32) + 5, 14, -(-n // 16384)
        else:
            got = df.df_to64(*df.df_vecmat(xh, xl, Ah, Al))
            want = df.df_to64(*df.df_vecmat_plain(xh, xl, Ah, Al))
            S, exact = x64.abs() @ A64.abs(), x64 @ A64
            L, D, k = rows, int(np.ceil(np.log2(max(rows, 2)))), 1
        assert kernels.LAUNCHES[fn] == n0 + 1
        c = (3 * L + 30) + ((D + k) * (D + k + 2) + 7)
        assert bool(torch.all((got - want).abs() <= c * 2.0**-48 * S)), fn
        assert float(((got - exact).abs() / S).max()) < 1e-12, fn


def solve_nb_mixed(device):
    ex = load_example("nb")
    before = dict(kernels.LAUNCHES)
    x, y, info = st.sedumi(ex.At, ex.b, ex.c, ex.K,
                           {"fid": 0, "dtype": "mixed"}, device=device)
    return {"cx": float(ex.c @ x), "by": float(ex.b @ y),
            "phases": {k: v["iters"] for k, v in info["phases"].items()},
            "pinf": int(info["pinf"]), "dinf": int(info["dinf"]),
            "numerr": int(info["numerr"]),
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in kernels.LAUNCHES
                         if kernels.LAUNCHES[k] != before[k]}}


@pytest.mark.cuda
def test_mixed_ladder_nb_witness(cuda):
    """nb with pars.dtype='mixed' on the card and on the CPU, both under
    deterministic algorithms: the same phases in the same order (the
    reference's on a CPU: f32 8, host64 16), the same host64 iterations,
    pinf, dinf and numerr, and c'x within 1e-9 relative; the card's f32
    phase ran K1-f32.  nb's f32 phase ends on a rejected direction before
    real progress, so its iterates are discarded and host64 restarts in
    f64 from the initial point; which f32 iteration is rejected moves
    with the order of the f32 sums (card 7, CPU 8 in the first card run),
    so the f32 count is printed, not held."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {"cpu": solve_nb_mixed("cpu"), "card": solve_nb_mixed(cuda)}
    finally:
        torch.use_deterministic_algorithms(False)
    print(json.dumps({"nb_mixed_witness": runs}), flush=True)
    cpu, card = runs["cpu"], runs["card"]
    assert list(card["phases"]) == list(cpu["phases"]) == ["f32", "host64"]
    assert card["phases"]["host64"] == cpu["phases"]["host64"]
    for key in ("pinf", "dinf", "numerr"):
        assert card[key] == cpu[key] == 0, key
    assert abs(card["cx"] - cpu["cx"]) <= 1e-9 * abs(cpu["cx"])
    assert card["launches"].get("dd_matvec_residual_f32", 0) > 0


def wide(shape, seed):
    """Values over many binades, with exact powers of two and zeros."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * np.exp2(rng.integers(-20, 21, shape))
    flat = a.reshape(-1)
    flat[::7] = np.exp2(rng.integers(-20, 21, flat[::7].shape))
    flat[::11] = 0.0
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,axis,transposed", [
    ((667, 2048), 2048, -1, False), ((667, 2048), 2048, 0, True),
    ((175 * 161, 161), 161, -1, False), ((161, 161), 161, 0, False),
    ((7, 3), 7, 0, False)])
def test_ozaki_split_kernel(cuda, shape, k, axis, transposed):
    """K4 bit for bit; a transposed operand runs on the flipped layout."""
    A = torch.as_tensor(wide(shape, sum(shape)), device=cuda)
    if transposed:
        A = A.T
    n0 = kernels.LAUNCHES["ozaki_split"]
    got = ddlinalg.ozaki_split(A, k, axis)
    assert kernels.LAUNCHES["ozaki_split"] == n0 + 1
    for g, w in zip(got, ddlinalg.ozaki_split_plain(A, k, axis)):
        assert bits_equal(g, w)


@pytest.mark.cuda
def test_dd_elem_kernel(cuda):
    """K5's three entry points bit for bit."""
    Sh, P = (torch.as_tensor(wide((300, 170), s), device=cuda)
             for s in (1, 2))
    Sl = Sh * 2.0**-60
    for normalize in (False, True):
        got = ddlinalg.dd_accumulate(Sh.clone(), Sl.clone(), P, normalize)
        want = ddlinalg.dd_accumulate_plain(Sh.clone(), Sl.clone(), P,
                                            normalize)
        assert all(bits_equal(g, w) for g, w in zip(got, want))
    bl = P * 2.0**-57
    for lo in (bl, None):
        for k_fn, p_fn in ((ddlinalg.dd_add, ddlinalg.dd_add_plain),
                           (ddlinalg.dd_sub, ddlinalg.dd_sub_plain)):
            assert all(bits_equal(g, w) for g, w in zip(
                k_fn(Sh, Sl, P, lo), p_fn(Sh, Sl, P, lo)))
    v = P[0].contiguous()
    assert all(bits_equal(g, w) for g, w in zip(
        ddlinalg.two_prod_cols(Sh, v), ddlinalg.two_prod_cols_plain(Sh, v)))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [5, 48, 123, 666])
def test_dd_gemv_kernel(cuda, m):
    """K6 within 2 (n + 4)^2 u^2 sum_j |A_ij| |x_j| of the Ozaki route
    (each route's error bound on Gaussian data; see chip_smoke.py
    check_dd_gemv), on A, on a row panel and on a transposed panel."""
    rng = np.random.default_rng(m)
    Ah = torch.as_tensor(rng.standard_normal((m, m)), device=cuda)
    Al = Ah * torch.as_tensor(2.0**-54 * rng.random((m, m)), device=cuda)
    xh = torch.as_tensor(rng.standard_normal(m), device=cuda)
    xl = xh * torch.as_tensor(2.0**-54 * rng.random(m), device=cuda)
    h = m // 2
    u = 2.0**-53
    for A, Alo, x, xlo in [(Ah, Al, xh, xl),
                           (Ah[h:, :h], Al[h:, :h], xh[:h], xl[:h]),
                           (Ah[h:, :h].T, Al[h:, :h].T, xh[h:], xl[h:])]:
        kh, kl = ddlinalg.dd_gemv(A, Alo, x, xlo)
        ph, pl = ddlinalg.dd_gemv_plain(A, Alo, x, xlo)
        n = A.shape[1]
        tol = 2.0 * (n + 4) ** 2 * u * u * (A.abs() @ x.abs())
        assert bool(torch.all(((kh - ph) + (kl - pl)).abs() <= tol))


@pytest.mark.cuda
@pytest.mark.parametrize("m,pivot", [(120, False), (200, True)])
def test_dd_panel_chol_kernel(cuda, m, pivot, monkeypatch):
    """K7 inside dd_chol bit for bit against the plain panel, at cond 1e14
    or with a forced non-positive pivot (ok False)."""
    if pivot:
        B = np.random.default_rng(m).standard_normal((m, m))
        M = B @ B.T / m + np.eye(m)
        M[70, 70] = -5.0
    else:
        M, _, _ = residual_case(m, m)
    A = torch.as_tensor(M, device=cuda)
    n0 = kernels.LAUNCHES["dd_panel_chol"]
    fk = ddlinalg.dd_chol(A)
    assert kernels.LAUNCHES["dd_panel_chol"] == n0 + -(-m // 48)
    monkeypatch.setattr(ddlinalg, "dd_panel_chol",
                        ddlinalg.dd_panel_chol_plain)
    fp = ddlinalg.dd_chol(A)
    assert bool(fk.ok) == bool(fp.ok) == (not pivot)
    assert bits_equal(fk.Lh, fp.Lh) and bits_equal(fk.Ll, fp.Ll)
    for pk, pp in zip(fk.inv_diag, fp.inv_diag):
        assert all(bits_equal(a, b) for a, b in zip(pk, pp))


def ada_matrix(n, seed):
    """A A' + (n/2) I for a random sparse A with 1.5 nonzeros per column:
    an LP-like Schur pattern whose first level has several columns."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, 2 * n, density=1.5 / n, random_state=rng, format="csc")
    return sp.csc_matrix(A @ A.T + sp.identity(n) * n * 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(3000, 128), (600, 32)])
def test_tile_kernels(cuda, n, B):
    """K8 and K9 level by level against the plain versions from the same
    storage (rungs equal; factor within 1e-10 of max|L|; update within
    2 (B + P + 1) eps (|D| + sum |A| |B|'), P the destination's pair
    count), then K10 on the kernels' factor (within 1e-10 of max|x|)."""
    M = ada_matrix(n, n)
    f = sparse_chol.SparseCholesky(M, B=B, device=cuda)
    st = f.storage(M)
    assert f.plan.nlev >= 3 and f.levels[0]["cols"].numel() >= 3
    for lv in f.levels:
        ref = st.clone()
        n0 = kernels.LAUNCHES["tile_factor"]
        rk = sparse_chol.tile_factor(st, lv, 0.0)
        assert kernels.LAUNCHES["tile_factor"] > n0
        assert torch.equal(rk, sparse_chol.tile_factor_plain(ref, lv, 0.0))
        slots = torch.cat([lv["dslot"], lv["off_slot"]])
        assert float((st[slots] - ref[slots]).abs().max()) <= 1e-10 * float(
            ref[slots].abs().max())
        if not lv["pair_a"].numel():
            continue
        dst, ptr = lv["pair_dst"], lv["pair_ptr"]
        didx = torch.repeat_interleave(torch.arange(dst.numel(), device=cuda),
                                       torch.diff(ptr))
        bound = st[dst].abs().index_add_(
            0, didx, st[lv["pair_a"]].abs() @ st[lv["pair_b"]].abs().mT)
        c = 2.0 * (B + float(torch.diff(ptr).max()) + 1.0)
        ref = st.clone()
        sparse_chol.tile_update(st, lv)
        sparse_chol.tile_update_plain(ref, lv)
        assert bool(torch.all((st[dst] - ref[dst]).abs() <= c * EPS * bound))
    rhs = torch.as_tensor(np.random.default_rng(n).standard_normal(f.plan.n),
                          device=cuda)
    n0 = kernels.LAUNCHES["tile_solve"]
    xk = sparse_chol.tile_solve(st, rhs, f.levels)
    assert kernels.LAUNCHES["tile_solve"] > n0
    xp = sparse_chol.tile_solve_plain(st, rhs, f.levels)
    assert float((xk - xp).abs().max()) <= 1e-10 * float(xp.abs().max())


@pytest.mark.cuda
def test_tile_factor_escalation_rungs(cuda):
    """Three 128 x 128 diagonal tiles built for rungs 0 (SPD), 1 (fails
    the lifted factor only) and 2 (fails both): the kernel takes the plain
    version's rungs; rungs 0-1 agree to 1e-12 of max|L|, the rung-2
    diagonal bit for bit."""
    B = 128
    rng = np.random.default_rng(0)
    G = rng.standard_normal((B, B))
    D = G @ G.T / B + np.eye(B)
    first, both = D.copy(), D.copy()
    first[3, 3] = -0.5
    both[5, 4] = both[4, 5] = 50.0
    st = torch.as_tensor(np.stack([np.tril(a) for a in (D, first, both)]),
                         device=cuda)
    ref = st.clone()
    lv = {"dslot": torch.arange(3, device=cuda),
          "off_slot": torch.zeros(0, dtype=torch.int64, device=cuda),
          "off_dslot": torch.zeros(0, dtype=torch.int64, device=cuda)}
    assert sparse_chol.tile_factor(st, lv, 0.0).tolist() == [0, 1, 2]
    assert sparse_chol.tile_factor_plain(ref, lv, 0.0).tolist() == [0, 1, 2]
    assert float((st[:2] - ref[:2]).abs().max()) <= 1e-12 * float(
        ref[:2].abs().max())
    assert bits_equal(st[2], ref[2])


def solve_arch0(device):
    ex = load_example("arch0")
    before = dict(kernels.LAUNCHES)
    x, y, info = st.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0},
                           device=device)
    cx, by = float(ex.c @ x), float(ex.b @ y)
    return {"cx": cx, "by": by, "iter": int(info["iter"]),
            "rel": max(abs(cx - ex.optval), abs(by - ex.optval))
            / abs(ex.optval),
            "pinf": int(info["pinf"]), "dinf": int(info["dinf"]),
            "numerr": int(info["numerr"]), "r0": float(info["r0"]),
            "phases": {k: v["iters"] for k, v in info["phases"].items()},
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in kernels.LAUNCHES},
            "x": x, "y": y}


def use_plain_twins(mp):
    """Put the seven kernels' plain twins where the path calls them."""
    mp.setattr(pcg, "dd_matvec_residual", pcg.dd_matvec_residual_plain)
    mp.setattr(schur, "_psd_contrib_coo_kernel",
               schur._psd_contrib_coo_plain)
    mp.setattr(ipm, "ldl_masked", chol.ldl_masked_plain)
    for name in ("ozaki_split", "dd_accumulate", "dd_add", "dd_sub",
                 "two_prod_cols", "dd_gemv", "dd_panel_chol"):
        mp.setattr(ddlinalg, name, getattr(ddlinalg, name + "_plain"))


@pytest.mark.cuda
def test_arch0_witness(cuda, monkeypatch):
    """Separates what moves arch0's landing point on the card (the kernels,
    the card's libraries, or the order of its sums).  Solves arch0 with
    the port on the CPU; on the card as the main path runs it, twice; with
    deterministic algorithms (ordered index_add_), twice; and with
    deterministic algorithms and the plain twins in place of the seven
    kernels.  Prints one JSON line with the library versions, each run's
    c'x, b'y, iterations, phases, rel, pinf, dinf, numerr, r0 and kernel
    launches, and which ops warned that they have no deterministic
    implementation.  Asserts that every run enters dd64 and passes the
    reference gate, that the deterministic runs repeat bit for bit, that
    the plain twins land where the kernels land, and that the card lands
    where the CPU of the same host lands."""
    runs = {"cpu": solve_arch0("cpu")}
    runs["card_1"] = solve_arch0(cuda)
    runs["card_2"] = solve_arch0(cuda)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs["det_1"] = solve_arch0(cuda)
            runs["det_2"] = solve_arch0(cuda)
            with monkeypatch.context() as mp:
                use_plain_twins(mp)
                runs["det_plain"] = solve_arch0(cuda)
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split("\n")[0][:120] for w in caught
                     if "deterministic" in str(w.message)})

    def same(a, b):
        return bool(np.array_equal(runs[a]["x"], runs[b]["x"])
                    and np.array_equal(runs[a]["y"], runs[b]["y"]))

    print(json.dumps({
        "versions": {"torch": torch.__version__, "numpy": np.__version__,
                     "scipy": scipy.__version__},
        "arch0_witness": {k: {f: v for f, v in r.items()
                              if f not in ("x", "y")}
                          for k, r in runs.items()},
        "card_runs_identical": same("card_1", "card_2"),
        "det_runs_identical": same("det_1", "det_2"),
        "nondeterministic_ops": nondet}), flush=True)
    for r in runs.values():
        assert np.all(np.isfinite(r["x"])) and np.all(np.isfinite(r["y"]))
        assert r["pinf"] == 0 and r["dinf"] == 0
        assert "dd64" in r["phases"]
        assert r["rel"] <= 1e-6 and r["numerr"] < 2
    assert runs["det_1"]["launches"]["psd_contrib_coo"] > 0
    assert all(runs["det_1"]["launches"][k] > 0 for k in (
        "ozaki_split", "dd_accumulate", "dd_gemv", "dd_panel_chol"))
    assert sum(runs["det_plain"]["launches"].values()) == 0
    assert same("det_1", "det_2") and not nondet

    def close(a, b, tol):
        return all(abs(runs[a][f] - runs[b][f]) <= tol * abs(runs[b][f])
                   for f in ("cx", "by"))

    assert close("det_plain", "det_1", 1e-9)
    assert close("det_1", "cpu", 1e-8)


def dense_column_lp():
    """test_dense_columns_keep_pattern_sparse_and_match's LP (m = 900, three
    dense columns), from numpy.random.default_rng(12345) as the suite's
    conftest seeds it, by chip_smoke.py's copy of the generator."""
    return random_sparse_lp(900, 200, np.random.default_rng(12345),
                            dense_cols=3)


def solve_lp(device, sparse=1):
    A, b, c, K = dense_column_lp()
    before = dict(kernels.LAUNCHES)
    x, y, info = st.sedumi(A, b, c, K, {"fid": 0, "sparse": sparse,
                                        "optstep": 0}, device=device)
    return {"cx": float(c @ x), "by": float(b @ y), "iter": int(info["iter"]),
            "engine": info["lin_engine"], "err": max(info["err"]),
            "pinf": int(info["pinf"]), "dinf": int(info["dinf"]),
            "numerr": int(info["numerr"]),
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in kernels.LAUNCHES},
            "x": x, "y": y}


@pytest.mark.cuda
def test_sparse_witness(cuda, monkeypatch):
    """The dense-column LP (m = 900, Kd = 3) through the sparse engine: on
    that machine's CPU; on the card; deterministically, twice; and
    deterministically with the plain versions in place of every kernel;
    and forced dense on the card.  Prints one JSON line.  Asserts
    the reference's gate on every run (lin_engine 'sparse', pinf = dinf =
    0, max(err) < 1e-7), that K3 and K8-K10 launched, that deterministic
    runs repeat bit for bit, that the card lands within 1e-8 relative of
    the CPU, and that the sparse c'x is within 1e-6 of the dense
    one (test_sparse_matches_dense_answer's bound)."""
    runs = {"cpu": solve_lp("cpu"), "card": solve_lp(cuda)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs["det_1"] = solve_lp(cuda)
            runs["det_2"] = solve_lp(cuda)
            with monkeypatch.context() as mp:
                use_plain_twins(mp)
                mp.setattr(sparse_engine, "ldl_masked",
                           chol.ldl_masked_plain)
                for name in ("tile_factor", "tile_update", "tile_solve"):
                    mp.setattr(sparse_chol, name,
                               getattr(sparse_chol, name + "_plain"))
                runs["det_plain"] = solve_lp(cuda)
        finally:
            torch.use_deterministic_algorithms(False)
    runs["dense"] = solve_lp(cuda, sparse=0)
    nondet = sorted({str(w.message).split("\n")[0][:120] for w in caught
                     if "deterministic" in str(w.message)})
    same = bool(np.array_equal(runs["det_1"]["x"], runs["det_2"]["x"])
                and np.array_equal(runs["det_1"]["y"], runs["det_2"]["y"]))
    print(json.dumps({
        "sparse_witness": {k: {f: v for f, v in r.items()
                               if f not in ("x", "y")}
                           for k, r in runs.items()},
        "det_runs_identical": same, "nondeterministic_ops": nondet}),
        flush=True)
    for name, r in runs.items():
        assert r["engine"] == ("dense" if name == "dense" else "sparse")
        assert r["pinf"] == 0 and r["dinf"] == 0 and r["err"] < 1e-7
    for k in ("ldl_masked", "tile_factor", "tile_update", "tile_solve"):
        assert runs["det_1"]["launches"][k] > 0, k
    assert sum(runs["det_plain"]["launches"].values()) == 0
    assert same and not nondet
    assert abs(runs["card"]["cx"] - runs["cpu"]["cx"]) <= 1e-8 * abs(
        runs["cpu"]["cx"])
    cd = runs["dense"]["cx"]
    assert abs(runs["card"]["cx"] - cd) <= 1e-6 * (1.0 + abs(cd))
