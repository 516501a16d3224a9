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

import dd_emulation as ddemu
import ldl_emulation as ldlemu
from ldl_emulation import indefinite
import psd_emulation as psdemu
import sedumi_tpu_torch as st
import tile_emulation as emu
from chip_smoke import TILE_TOL, df_call, df_emulated, df_vectors, \
    jacobi_compare, k1_emulated, k1_operands, nt_like, random_sparse_lp, \
    same_words
from sedumi_tpu_torch import chol, ddengine, ddlinalg, df, ipm, kernels, \
    lax_eigh, linalg_ops, opA, pcg, schur, sparse_chol, sparse_engine, \
    transform
from sedumi_tpu_torch.examples import load_example
from sedumi_tpu_torch.generators import feasible_problem
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


def coo_pairs(part, k, d):
    """(sp_g, sp_loc, sp_val) of a COO part's nonzeros: each nonzero's
    own group and its location in the d x d block."""
    g_of = part["g_of"].long()
    blk = part["b_loc"] // (d * d)
    return (g_of[part["b_row"] * k + blk], part["b_loc"] % (d * d),
            part["b_val"])


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
        # the sparse engine's entry: B~ of a nonzero's own group at its
        # location, times its value, one value a pair
        pair = coo_pairs(part, k, d)
        Bk = schur._psd_pair_values_kernel(W, part["g_blk"], part["gp"],
                                           part["gq"], part["gv"], *pair)
        Bp = schur.psd_pair_values_plain(W, part["g_blk"], part["gp"],
                                         part["gq"], part["gv"], *pair)
        assert Bk.shape == (T,)
        assert float((Bk - Bp).abs().max()) <= 1e-12 * float(
            Bp.abs().max())


# K3's orders: m = 1, both sides of each variant edge (chol.ldl_plan: the
# warp up to 32, shared memory up to 240 in f64 and 340 in f32), the
# path's 12-174 and control07's 666 (the device variant)
K3_F64_ORDERS = [1, 12, 32, 33, 174, 240, 241, 666]
K3_F32_ORDERS = [1, 12, 32, 33, 174, 340, 341, 666]


def nan_bits_equal(a, b) -> bool:
    """Equal bits but where both are NaN (the card's NaN payloads are its
    own)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    a, b = a.contiguous(), b.contiguous()
    nan = torch.isnan(a)
    ints = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.view(ints)[~nan], b.view(ints)[~nan])


def k3_against_twins(M, **kw):
    """K3 (K3-f32) on M, called twice: both calls bit for bit
    ldl_masked_plain and the emulation of its schedule
    (tests/ldl_emulation.py), M unchanged, one launch a call counted
    under ldl_plan's variant."""
    m = M.shape[0]
    name = "ldl_masked_f32" if M.dtype == torch.float32 else "ldl_masked"
    variant, blocks, warps = chol.ldl_plan(m, M.dtype)
    key = f"{name}:{variant}@{m}"
    M0 = M.clone()
    n0 = kernels.LAUNCHES[name]
    v0 = kernels.VARIANT_LAUNCHES.get(key, 0)
    fk = chol.ldl_masked(M, **kw)
    fk2 = chol.ldl_masked(M, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 2
    assert kernels.VARIANT_LAUNCHES.get(key, 0) == v0 + 2
    assert nan_bits_equal(M, M0)
    fp = chol.ldl_masked_plain(M, **kw)
    fe = [torch.as_tensor(x, device=M.device) for x in ldlemu.ldl(
        M.cpu().numpy(), nw=blocks * warps, **kw)]
    assert fk.L.dtype == M.dtype and fk.skip.dtype == torch.bool
    for a, a2, b, e in zip(fk, fk2, fp, fe):
        assert nan_bits_equal(a, b) and nan_bits_equal(a2, b)
        assert nan_bits_equal(a, e)
    return fp


@pytest.mark.cuda
@pytest.mark.parametrize("m", K3_F64_ORDERS)
def test_ldl_masked_kernel(cuda, m):
    """K3 in each variant: the masks and the factor bit for bit the plain
    twin and the emulation, twice, M untouched."""
    M = torch.as_tensor(indefinite(m, 3), device=cuda)
    fp = k3_against_twins(M)
    if m >= 12:
        assert bool(fp.skip.any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [12, 174, 666])
def test_ldl_masked_nan_matrix(cuda, m, dtype):
    """A NaN entry below the diagonal, a NaN pivot, a +inf pivot and a
    zero row: the same NaNs, masks and bits as the plain twin."""
    M = indefinite(m, 5)
    M[m // 2 + 1, m // 3] = np.nan
    M[m // 4, m // 4] = np.nan
    M[m - 2, m - 2] = np.inf
    M[1, :] = 0.0
    M[:, 1] = 0.0
    k3_against_twins(torch.as_tensor(M, dtype=dtype, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m", [40, 400])
@pytest.mark.parametrize("case", ldlemu.CASES)
def test_ldl_masked_adversarial(cuda, case, m, dtype):
    """tests/test_torch_ldl.py's adversarial columns (NaN, inf, subnormal,
    zero and cancelled pivots, all skipped, no skipping) on the kernel, in
    the shared and the device variant."""
    M, kw = ldlemu.adversarial(case, dtype, m)
    k3_against_twins(torch.as_tensor(M, device=cuda), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,emax", [(np.float64, 250),
                                        (np.float32, 30)])
@pytest.mark.parametrize("m", [12, 174, 666])
def test_ldl_masked_scaled_quotients(cuda, m, dtype, emax):
    """Quotients over the whole exponent range (S A S, skip_pivots=False so
    every one shows in L): the kernel's reciprocal-and-corrections rule and
    its division fallback give the division's bits."""
    M = ldlemu.scaled(m, dtype, emax, seed=m)
    k3_against_twins(torch.as_tensor(M, device=cuda), skip_pivots=False)


def quotient_cases(dtype, m, seed):
    """(divisor, dividends) pairs whose mantissas are the hard cases of a
    reciprocal-based division (all ones, 1, 1 + ulp, 2 - ulp, random),
    over the exponent range, some outside the kernel's fast range."""
    rng = np.random.default_rng(seed)
    f = np.finfo(dtype)
    edge = np.array([1.0, np.nextafter(dtype(1), dtype(2)),
                     np.nextafter(dtype(2), dtype(1)), 1.5], dtype=dtype)
    emax = 60 if dtype == np.float32 else 500
    ds = np.concatenate([edge, rng.uniform(1, 2, 4).astype(dtype)])
    ds = np.concatenate([ds, ds * dtype(2.0 ** -(emax // 4)),
                         ds * dtype(2.0 ** (emax // 4))])
    for d in ds:
        mant = np.concatenate([np.resize(edge, m // 2),
                               rng.uniform(1, 2, m - m // 2)]).astype(dtype)
        e = rng.integers(-emax, emax + 1, m).astype(np.float64)
        x = (mant * np.exp2(e) * rng.choice([-1, 1], m)).astype(dtype)
        x[:4] = [0.0, -0.0, f.tiny, f.max / 4]
        yield dtype(d), x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m", [32, 240, 300])
def test_ldl_masked_quotient_rule(cuda, m, dtype):
    """Column 0 of I with [d; x] in it (lb = 0, no skipping) divides x by d
    alone: L[1:, 0] is the card's division x / d bit for bit, for divisors
    and dividends at the edge mantissas and exponents of the kernel's
    reciprocal-and-corrections rule, in the warp and the shared variant
    and (f64 at 300) the device variant's chunked column; the rest of the
    factor as the plain twin and the emulation."""
    kw = dict(canceltol=0.0, abstol=0.0, skip_pivots=False)
    for d, x in quotient_cases(dtype, m - 1, m):
        M = np.eye(m, dtype=dtype)
        M[0, 0] = d
        M[1:, 0] = M[0, 1:] = x
        Mt = torch.as_tensor(M, device=cuda)
        k3_against_twins(Mt, **kw)
        L = chol.ldl_masked(Mt, **kw).L
        assert nan_bits_equal(L[1:, 0], Mt[1:, 0] / Mt[0, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("m,plan", [(33, ("warp", 1, 1)),
                                    (241, ("shared", 1, 16)),
                                    (174, ("shared", 1, 17)),
                                    (174, ("shared", 2, 8)),
                                    (666, ("device", 4, 9)),
                                    (666, ("device", 100000, 2))])
def test_ldl_masked_refused_plan(cuda, m, plan):
    """A plan the card refuses (a warp past 32 rows, shared memory past
    227 KB, more warps than a variant's launch bound, a second block, a
    grid that cannot be resident) raises, launches nothing, and leaves no
    error behind."""
    M = torch.as_tensor(indefinite(m, 3), device=cuda)
    n0 = dict(kernels.LAUNCHES)
    v0 = dict(kernels.VARIANT_LAUNCHES)
    with pytest.raises(RuntimeError):
        chol._ldl_cuda(M, 1e-12, 5e5, 1e-20, True, plan)
    assert kernels.LAUNCHES == n0 and kernels.VARIANT_LAUNCHES == v0
    k3_against_twins(M)


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
    chip_smoke.check_psd_coo)."""
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
@pytest.mark.parametrize("m", K3_F32_ORDERS)
def test_ldl_masked_f32_kernel(cuda, m):
    """K3-f32 in each variant: masks, pivots and factor bit for bit the f32
    twin and the emulation, twice, M untouched."""
    M = torch.as_tensor(indefinite(m, 3), dtype=torch.float32, device=cuda)
    fp = k3_against_twins(M)
    if m >= 12:
        assert bool(fp.skip.any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ldl_masked_strided_rows(cuda, dtype):
    """M read through its row stride (ADA is a view of the augmented
    Schur complement): bit for bit the plain twin on the same view."""
    m = 124
    Maug = torch.as_tensor(np.pad(indefinite(m, 3), ((0, 1), (0, 1))),
                           dtype=dtype, device=cuda)
    k3_against_twins(Maug[:m, :m])


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


# ------------------------------------ K1 and K11 against their emulation


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,n,view", [
    (1, 1, None), (7, 7, None), (123, 123, None), (174, 174, None),
    (666, 666, None), (7, 1, None), (124, 2383, None), (123, 123, "offset"),
    (174, 123, "stride"), (7, 1, "offset")])
def test_gemv_dd_residual_matches_emulation(cuda, m, n, view, dtype):
    """K1 and K1-f32 bit for bit their emulation (tests/gemv_emulation.py)
    with and without lo, at rows on and off 16-byte boundaries; a second
    call gives the same bits; a fused call is one launch."""
    name = "dd_matvec_residual" + ("" if dtype == torch.float64 else "_f32")
    M, v, rhs, lo = k1_operands(m, n, dtype, m + n, cuda, view)
    for low in (None, lo):
        n0 = kernels.LAUNCHES[name]
        got = pcg.dd_matvec_residual(M, v, rhs, low)
        assert kernels.LAUNCHES[name] == n0 + 1
        assert same_words(got, k1_emulated(M, v, rhs, low))
        assert same_words(got, pcg.dd_matvec_residual(M, v, rhs, low))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gemv_refine_solve_dd_one_launch_a_pass(cuda, dtype):
    """refine_solve_dd: one K1 launch a pass and no product with M beside
    it (its lo term is summed in the kernel's pass over M); the result is
    the passes written out with the fused call."""
    from torch.overrides import TorchFunctionMode

    name = "dd_matvec_residual" + ("" if dtype == torch.float64 else "_f32")
    M0, _, rhs, _ = k1_operands(174, 174, dtype, 3, cuda)
    M = M0 @ M0.T + 174 * torch.eye(174, dtype=dtype, device=cuda)
    f = chol.chol_factor(M, 0.0)

    def solve(b):
        return chol.chol_solve(f, b)

    products = []

    class Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if any(a is M for a in args) and func in (
                    torch.Tensor.__matmul__, torch.matmul, torch.mv,
                    torch.Tensor.matmul, torch.Tensor.mv, torch.addmv):
                products.append(func)
            return func(*args, **(kwargs or {}))

    n0 = kernels.LAUNCHES[name]
    with Count():
        x = pcg.refine_solve_dd(M, solve, rhs, iters=3)
    assert kernels.LAUNCHES[name] == n0 + 3 and not products
    hi = solve(rhs)
    lo = torch.zeros_like(hi)
    for _ in range(3):
        s, e = pcg.two_sum(hi, solve(pcg.dd_matvec_residual(M, hi, rhs,
                                                            lo)))
        hi, lo = s, lo + e
    assert same_words(x, hi + lo)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,view", [
    (1, 1, None), (7, 7, None), (121, 400, None), (124, 2383, None),
    (124, 2383, "offset"), (3, 130, "offset"), (5, 9000, None),
    (1001, 65536, None)])
def test_gemv_df_matches_emulation(cuda, rows, n, view):
    """K11's df_matvec and df_vecmat bit for bit their emulation (tests/
    gemv_emulation.py) at the wrapper's slab plans, on rows on and off
    16-byte boundaries; a second call gives the same bits (the slab
    tickets are back at zero)."""
    g = torch.Generator().manual_seed(rows + n)
    A = torch.randn(rows, n, generator=g, dtype=torch.float64)
    pair = df.df_split64(A)
    if view == "offset":
        Ah, Al = (torch.empty(rows * n + 1, dtype=torch.float32,
                              device=cuda)[1:].view(rows, n)
                  for _ in range(2))
        Ah.copy_(pair[0])
        Al.copy_(pair[1])
    else:
        Ah, Al = (t.to(cuda) for t in pair)
    for k, fn in enumerate(("df_matvec", "df_vecmat")):
        xh, xl = df_vectors(n if fn == "df_matvec" else rows, k, cuda)
        n0 = kernels.LAUNCHES[fn]
        got = df_call(fn, Ah, Al, xh, xl)
        assert kernels.LAUNCHES[fn] == n0 + 1
        want = df_emulated(fn, Ah, Al, xh, xl)
        again = df_call(fn, Ah, Al, xh, xl)
        for a, b, c in zip(got, want, again):
            assert same_words(a, b) and same_words(a, c), fn


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


# ------------------------------------------------ K12 / K13 (Jacobi)


def jacobi_pair(A, sweeps, vectors, plan=None):
    """(kernel, plain) results on the card; the kernel launched once (K12
    with `plan` if given, else the plan of the dispatch)."""
    name = lax_eigh._KERNELS[A.dtype][2]
    plain = lax_eigh._jacobi_herm_plain if A.is_complex() \
        else lax_eigh._jacobi_plain
    n0 = kernels.LAUNCHES[name]
    got = lax_eigh._jacobi_cuda(A, sweeps, vectors, 0, plan) if plan \
        else lax_eigh._jacobi(A, sweeps, vectors)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 1
    return got, plain(A, sweeps, vectors)


def check_jacobi_case(A, sweeps, vectors, plan=None):
    """The kernel against its plain version at chip_smoke's tolerance
    (jacobi_compare states it), and K12 bit for bit with the plain
    version's sweep count; prints the comparison."""
    got, want = jacobi_pair(A, sweeps, vectors, plan)
    res = jacobi_compare(A, got, want, sweeps, vectors)
    print(json.dumps({"n": A.shape[-1], "dtype": str(A.dtype),
                      "vectors": vectors, "plan": plan, **res}))
    assert res["ok"], res
    if not A.is_complex():
        assert res["bit_equal"], res
        assert torch.equal(got[2], want[2]), res
    return got, want


def k12_plans(n, dtype, vectors):
    """K12's plans at even order n: for a batch of two (a cluster spread
    over the card) and for one that fills the card (one block or the
    fewest CTAs that hold the matrix)."""
    sms = lax_eigh._sm_count(torch.device("cuda"))
    return sorted({lax_eigh.jacobi_plan(n, dtype, vectors, b, sms)
                   for b in (2, sms // 2 + 1)})


# both sides of every edge of jacobi_plan, run with vectors at the full
# budget and without at the coarse budget.  With vectors: one block up
# to 168 in f32 and 118 in f64; 2, 4, 8 and 16 CTAs up to 194, 272, 384
# and 544 in f32 and 136, 192, 272 and 384 in f64; device memory beyond.
# Without: one block up to 238 in f32 and 168 in f64; 4, 8 and 16 CTAs
# up to 336, 472 and 672 in f32 and 236, 334 and 466 in f64; device
# memory beyond.  A batch of two spreads over a cluster from
# CLUSTER_MIN_N: 100 in f32, 80 in f64.
K12_ORDERS = {torch.float32: [2, 3, 8, 17, 64, 98, 100, 110, 112, 162, 168,
                              170, 194, 196, 238, 240, 272, 274, 322, 336,
                              338, 384, 386, 472, 474, 544, 546, 672, 674],
              torch.float64: [2, 3, 17, 64, 78, 80, 118, 120, 136, 138, 162,
                              168, 170, 192, 194, 236, 238, 272, 274, 322,
                              334, 336, 384, 386, 466, 468]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(dt, n) for dt, ns in K12_ORDERS.items()
                                     for n in ns])
def test_jacobi_eigh_kernel(cuda, n, dtype):
    """K12 against its plain version, bit for bit and in sweeps, in each
    plan it takes for a small and a full batch, on both sides of every
    variant edge (K12_ORDERS), at the full budget with vectors and the
    coarse budget without."""
    A = nt_like(2, n, dtype, torch.Generator().manual_seed(n)).to(cuda)
    m = n + n % 2
    for sweeps, vectors in ((lax_eigh._sweeps_for(n, dtype), True),
                            (lax_eigh.coarse_sweeps_for(n, dtype), False)):
        for plan in k12_plans(m, dtype, vectors):
            check_jacobi_case(A, sweeps, vectors, plan)
    with pytest.raises(ValueError):
        lax_eigh._jacobi(A.to(torch.float16), 2, False)


@pytest.mark.cuda
def test_jacobi_cluster_batch_beyond_residency(cuda):
    """A batch of 40 matrices of order 322 in f32 (trto3's order) takes
    eight CTAs each: 320 CTAs, more than the card holds at once, so the
    clusters run in waves; bit for bit against the plain version."""
    A = nt_like(40, 322, torch.float32, torch.Generator().manual_seed(40))
    sms = lax_eigh._sm_count(cuda)
    plan = lax_eigh.jacobi_plan(322, torch.float32, True, 40, sms)
    assert plan[0] == "cluster" and 40 * plan[1] > sms
    check_jacobi_case(A.to(cuda), lax_eigh._sweeps_for(322, torch.float32),
                      True)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [("block", 1), ("cluster", 2),
                                  ("cluster", 32)])
def test_jacobi_refused_plan_raises(cuda, plan):
    """A plan the card refuses (one block or two CTAs cannot hold order
    322 with vectors; no cluster has 32 CTAs) raises, and nothing falls
    back to another variant or to the plain version."""
    A = nt_like(1, 322, torch.float32, torch.Generator().manual_seed(3))
    before = dict(lax_eigh.VARIANT_LAUNCHES)
    n0 = kernels.LAUNCHES["jacobi_eigh_f32"]
    with pytest.raises(RuntimeError):
        lax_eigh._jacobi_cuda(A.to(cuda), 2, True, 0, plan)
    assert kernels.LAUNCHES["jacobi_eigh_f32"] == n0
    assert lax_eigh.VARIANT_LAUNCHES == before


def fused_plans(n, dtype, vectors):
    """Every fused plan that holds a matrix of even order n: one block
    where its shared memory does, each cluster size that does."""
    plans = [("block", 1)] if lax_eigh.smem_bytes(n, dtype, vectors) \
        <= lax_eigh.SMEM_MAX else []
    return plans + [("cluster", c) for c in lax_eigh.CLUSTER_SIZES
                    if lax_eigh.cluster_fits(n, dtype, vectors, c)]


def bits_or_nan(a, b) -> bool:
    """NaN in the same places, every other entry bit for bit."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) \
        and bits_equal(a[~nan], b[~nan])


def same_result(got, want, vectors) -> bool:
    """(w, V, sweeps) bit for bit, NaN where the other has NaN."""
    return bits_or_nan(got[0], want[0]) \
        and (not vectors or bits_or_nan(got[1], want[1])) \
        and torch.equal(got[2], want[2])


# both sides of every edge of K13's plan.  With vectors: one block up to
# 84 in complex128 and 118 in complex64; 2, 4, 8 and 16 CTAs up to 96,
# 136, 192 and 262 in complex128 and 136, 192, 272 and 384 in
# complex64; device memory beyond.  Without: one block up to 118 and 168;
# 16 CTAs up to 320 and 466.
K13_ORDERS = [3, 8, 60, 84, 86, 96, 98, 118, 120, 136, 138, 168, 170, 192,
              194, 262, 264, 272, 274, 320, 322, 384, 386]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("n", K13_ORDERS)
def test_jacobi_herm_kernel(cuda, n, dtype):
    """K13 against its plain version through the dispatch, with and
    without vectors (jacobi_compare's tolerance), and in every fused plan
    that holds the matrix (one block, 2-16 CTAs) bit for bit equal to the
    device-memory variant in w, V and the sweeps run."""
    A = nt_like(2, n, dtype, torch.Generator().manual_seed(n)).to(cuda)
    m = n + n % 2
    sweeps = lax_eigh._sweeps_for(n, lax_eigh._real_dtype(dtype))
    for vectors in (True, False):
        check_jacobi_case(A, sweeps if vectors else
                          lax_eigh.coarse_sweeps_for(
                              n, lax_eigh._real_dtype(dtype)), vectors)
        want = lax_eigh._jacobi_cuda(A, sweeps, vectors, 0, ("device", 1))
        for plan in fused_plans(m, dtype, vectors):
            got = lax_eigh._jacobi_cuda(A, sweeps, vectors, 0, plan)
            assert same_result(got, want, vectors), (plan, vectors)


@pytest.mark.cuda
def test_jacobi_nan_and_multi_bucket(cuda):
    """A batch holding a NaN stops after the two unconditional sweeps
    with NaN in that entry only, in one block (order 12) and in a cluster
    of CTAs (one matrix of order 161).  The padded multi-bucket batch: the
    kernel against its plain version on the padded batch, and
    linalg_ops.eigh_multi (Jacobi by default on the card) returns that
    batch's corners per bucket, bit for bit (the same kernel on the same
    input)."""
    gen = torch.Generator().manual_seed(5)
    A = nt_like(3, 12, torch.float32, gen)
    A[1, 2, 5] = float("nan")
    got, want = check_jacobi_case(A.to(cuda), 6, True)
    assert int(got[2]) == 2 and int(want[2]) == 2
    assert bool(torch.isnan(got[0][1]).all())
    assert bool(torch.isfinite(got[0][[0, 2]]).all())
    mats = [nt_like(k, d, torch.float32, gen).to(cuda)
            for k, d in ((3, 7), (1, 12), (2, 4))]
    P, _ = linalg_ops._pad_stack(mats)
    (w0, V0, _), _ = check_jacobi_case(
        P, lax_eigh._sweeps_for(12, P.dtype), True)
    n0 = kernels.LAUNCHES["jacobi_eigh_f32"]
    out = linalg_ops.eigh_multi(mats)
    assert kernels.LAUNCHES["jacobi_eigh_f32"] == n0 + 1
    off = 0
    for (w, V), m in zip(out, mats):
        k, d = m.shape[0], m.shape[-1]
        assert torch.equal(w, w0[off:off + k, :d])
        assert torch.equal(V, V0[off:off + k, :d, :d])
        off += k
    # the cluster variant: its sweep-end ratio is reduced over the CTAs
    # and its rows move by DSMEM stores
    A = nt_like(1, 161, torch.float32, gen)
    A[0, 2, 5] = float("nan")
    plan = ("cluster", lax_eigh.MAX_CLUSTER)
    assert lax_eigh.jacobi_plan(162, A.dtype, True, 1,
                                lax_eigh._sm_count(cuda)) == plan
    got, want = check_jacobi_case(
        A.to(cuda), lax_eigh._sweeps_for(161, A.dtype), True, plan)
    assert int(got[2]) == 2 and int(want[2]) == 2
    assert bool(torch.isnan(got[0]).all())
    # K13's cluster variant on a NaN matrix: two sweeps, NaN, and bit for
    # bit its device-memory variant
    for dt in (torch.complex128, torch.complex64):
        A = nt_like(1, 121, dt, gen)
        A[0, 2, 5] = float("nan")
        A = A.to(cuda)
        assert lax_eigh.jacobi_plan(122, dt, True, 1,
                                    lax_eigh._sm_count(cuda)) == plan
        sweeps = lax_eigh._sweeps_for(121, lax_eigh._real_dtype(dt))
        got, _ = check_jacobi_case(A, sweeps, True)
        assert int(got[2]) == 2 and bool(torch.isnan(got[0]).all())
        assert same_result(got, lax_eigh._jacobi_cuda(
            A, sweeps, True, 0, ("device", 1)), True)


def arch0_launches(device, dtype):
    ex = load_example("arch0")
    before = dict(kernels.LAUNCHES)
    st.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0, "dtype": dtype},
              device=device)
    return {k: kernels.LAUNCHES[k] - before[k] for k in
            ("jacobi_eigh", "jacobi_eigh_f32", "jacobi_eigh_herm",
             "jacobi_eigh_herm_c64")}


@pytest.mark.cuda
def test_arch0_eigensolver_per_phase(cuda):
    """'mixed' arch0 on the card runs K12-f32 in its f32 phase and no f64
    or complex Jacobi (host64 and dd64 take the library); 'auto' (f64)
    runs none."""
    mixed = arch0_launches(cuda, "mixed")
    assert mixed["jacobi_eigh_f32"] > 0
    assert mixed["jacobi_eigh"] == mixed["jacobi_eigh_herm"] \
        == mixed["jacobi_eigh_herm_c64"] == 0
    assert sum(arch0_launches(cuda, "auto").values()) == 0


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


def small_coo(device, dtype, chunk, monkeypatch):
    """The COO bucket of a small PSD problem (blocks 4 and 3, m = 5, packed
    into one block of order 64 by the data layer), built with chunks of at
    most `chunk` entries of U, and a random W = R R' of its shape."""
    monkeypatch.setattr(opA, "CHUNK_ENTRIES", chunk)
    At, b, c, K = feasible_problem({"s": [4, 3]}, 5, seed=4)
    At = sp.csc_matrix(At)
    At.data[np.random.default_rng(4).random(At.nnz) > 0.4] = 0.0
    At.eliminate_zeros()
    prob = transform.pretransfo(At, b, c, K, Pars(fid=0))
    aop = opA.build_coo_aop(prob.At, prob.c, prob.layout, device=device,
                            gemm_discount=0.0, dtype=dtype)
    part, (rep, k, d, G, pad2, T) = aop.s_parts[0], aop.s_meta[0]
    assert rep == "coo"
    rng = np.random.default_rng(chunk)
    W = schur.psd_gram(torch.as_tensor(
        rng.standard_normal((k, d, d)) / np.sqrt(d) + np.eye(d),
        dtype=dtype, device=device))
    return aop, part, (k, d, G, pad2, T), W


def numpy_part(part):
    return {key: a.cpu().numpy() for key, a in part.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("chunk", [4096, 7])
def test_psd_schur_matches_emulation(cuda, dtype, chunk, monkeypatch):
    """K2 (one launch) bit for bit the exact-fma emulation of its order,
    f64 and f32, in one chunk and in chunks of 7 entries of U (the sums
    carried through M between chunks)."""
    aop, part, (k, d, G, pad2, T), W = small_coo(cuda, dtype, chunk,
                                                 monkeypatch)
    mp1 = aop.m + 1
    assert (part["ch"].shape[0] > 2) == (chunk < 4096)
    sfx = "_f32" if dtype == torch.float32 else ""
    n0 = kernels.LAUNCHES["psd_contrib_coo" + sfx]
    Mk = schur._psd_contrib_coo_kernel(part, k, d, G, pad2, mp1, W)
    assert kernels.LAUNCHES["psd_contrib_coo" + sfx] == n0 + 1
    npdt = np.float32 if dtype == torch.float32 else np.float64
    want = psdemu.contrib_chunks(numpy_part(part), k, d, mp1,
                                 W.cpu().numpy(), npdt)
    assert bits_equal(Mk.cpu(), torch.as_tensor(want))
    assert bits_equal(Mk, schur._psd_contrib_coo_kernel(part, k, d, G, pad2,
                                                        mp1, W))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_psd_pair_values_match_emulation(cuda, dtype):
    """K2's sparse-engine entry bit for bit the exact-fma emulation, f64
    and f32, on a small SDP plan's pair list."""
    from chip_smoke import random_sparse_sdp

    A, b, c, K = random_sparse_sdp(60, 20, 4, np.random.default_rng(3))
    prob = transform.pretransfo(A, b, c, K, Pars(fid=0))
    arrays, meta = sparse_engine.plan_sparse_lq(prob.At, prob.c,
                                                prob.layout, Pars(fid=0))
    aop = sparse_engine.make_sparse_lq_op(arrays, meta, dtype=dtype,
                                          device=cuda)
    rng = np.random.default_rng(5)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    for bi, (k, d) in enumerate(meta["s_shapes"]):
        a = aop.arrays
        W = schur.psd_gram(torch.as_tensor(
            rng.standard_normal((k, d, d)) + 2 * np.eye(d), dtype=dtype,
            device=cuda))
        args = [a[key][bi] for key in ("sg_blk", "sg_p", "sg_q", "sg_v",
                                       "sp_g", "sp_loc", "sp_val")]
        got = schur.psd_pair_values(W, *args)
        want = psdemu.pair_values(W.cpu().numpy(),
                                  *(x.cpu().numpy() for x in args), npdt)
        assert got.numel() > 0
        assert bits_equal(got.cpu(), torch.as_tensor(want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ld,offset,k", [
    ((85376, 128), 128, 0, 128),          # control07's A_k and T'
    ((175, 25921), 25921, 0, 25921),      # arch0's Gram operand
    ((667, 16384), 16384, 0, 16384),      # control07's Gram operand
    ((618, 48), 666, 48 * 666, 48),       # dd_chol's first update, 666
    ((42, 624), 666, 624 * 666, 624),     # its last
    ((301, 77), 79, 1, 77),               # rows off the 16-byte boundary
    ((9, 1200), 1203, 3, 1200),           # a cluster of one CTA
    ((3, 70001), 70001, 1, 70001),        # beyond the registers
    ((5, 1), 3, 1, 2)])
def test_ozaki_split_path_shapes(cuda, shape, ld, offset, k):
    """K4 bit for bit the plain split at the path's row shapes (the warp,
    cluster and long-row variants) and on misaligned views."""
    R, C = shape
    base = torch.as_tensor(wide((offset + R * ld,), R + C), device=cuda)
    A = base.as_strided((R, C), (ld, 1), offset)
    n0 = kernels.LAUNCHES["ozaki_split"]
    got = ddlinalg.ozaki_split(A, k, -1)
    assert kernels.LAUNCHES["ozaki_split"] == n0 + 1
    for g, w in zip(got, ddlinalg.ozaki_split_plain(A, k, -1)):
        assert bits_equal(g, w)


@pytest.mark.cuda
def test_ozaki_split_launches_per_dd64_prepare(cuda, monkeypatch):
    """One control07-sized dd64 prepare (form_dd, then dd_chol of m = 666)
    launches K4 17 times: R_k, A_k and T' once each, the Gram's operand
    once, one per dd_chol trailing update; M and the factor equal the
    route that splits every operand of every dd_gemm (the earlier build's
    32 launches) bit for bit."""
    from chip_smoke import dense_case

    aop, S = dense_case("control07", cuda)
    m = aop.m
    kernels.reset_launch_counts()
    Mh, Ml = ddengine.form_dd(aop, S, 0.0)
    f = ddlinalg.dd_chol(Mh[:m, :m], Ml[:m, :m])
    torch.cuda.synchronize()
    sites = {key: v for key, v in kernels.VARIANT_LAUNCHES.items()
             if key.startswith("ozaki_split@")}
    print(json.dumps(sites))
    assert kernels.LAUNCHES["ozaki_split"] == 17
    plain = ddlinalg.dd_gemm
    inside = []

    def split_both(Ah, Al, Bh, Bl, As=None, Bs=None):
        n0 = kernels.LAUNCHES["ozaki_split"]
        out = plain(Ah, Al, Bh, Bl)
        inside.append(kernels.LAUNCHES["ozaki_split"] - n0)
        return out

    monkeypatch.setattr(ddlinalg, "dd_gemm", split_both)
    Mh2, Ml2 = ddengine.form_dd(aop, S, 0.0)
    f2 = ddlinalg.dd_chol(Mh2[:m, :m], Ml2[:m, :m])
    assert sum(inside) == 32 and len(inside) == 16
    for a, b in ((Mh, Mh2), (Ml, Ml2), (f.Lh, f2.Lh), (f.Ll, f2.Ll),
                 (f.inv_h, f2.inv_h), (f.inv_l, f2.inv_l)):
        assert bits_equal(a, b)


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
    """K6 bit for bit equal to the emulation of its lane order
    (tests/dd_emulation.py), and within 2 (n + 4)^2 u^2 sum_j |A_ij| |x_j|
    of the Ozaki route (each route's error bound on Gaussian data; see
    chip_smoke.py check_dd_gemv), on A, on a row panel and on a
    transposed panel."""
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
        eh, el = ddemu.gemv(*(t.cpu().numpy() for t in (A, Alo, x, xlo)))
        assert bits_equal(kh.cpu(), torch.as_tensor(eh))
        assert bits_equal(kl.cpu(), torch.as_tensor(el))
        ph, pl = ddlinalg.dd_gemv_plain(A, Alo, x, xlo)
        n = A.shape[1]
        tol = 2.0 * (n + 4) ** 2 * u * u * (A.abs() @ x.abs())
        assert bool(torch.all(((kh - ph) + (kl - pl)).abs() <= tol))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [48, 100, 174, 666])
def test_dd_chol_solve_kernel(cuda, m):
    """The fused dd_chol_solve: one launch, and no K6 or K5 launch, per
    solve; z bit for bit equal to the composition of K6 and K5 launches
    (dd_chol_solve_panels) and to the emulation of their order
    (tests/dd_emulation.py), with and without a low part of b, at cond
    1e14."""
    rng = np.random.default_rng(m)
    q = np.linalg.qr(rng.standard_normal((m, m)))[0]
    M = (q * np.logspace(0, -14, m)) @ q.T
    f = ddlinalg.dd_chol(torch.as_tensor(0.5 * (M + M.T), device=cuda))
    b = torch.as_tensor(rng.standard_normal(m), device=cuda)
    inv = [(h.cpu().numpy(), l.cpu().numpy()) for h, l in f.inv_diag]
    for bl in (None, b * torch.as_tensor(2.0**-54 * rng.random(m),
                                         device=cuda)):
        before = dict(kernels.LAUNCHES)
        zh, zl = ddlinalg.dd_chol_solve(f, b, bl)
        counts = {k: kernels.LAUNCHES[k] - before[k] for k in
                  ("dd_chol_solve", "dd_gemv", "dd_accumulate")}
        assert counts == {"dd_chol_solve": 1, "dd_gemv": 0,
                          "dd_accumulate": 0}
        ph, pl = ddlinalg.dd_chol_solve_panels(f, b, bl)
        assert bits_equal(zh, ph) and bits_equal(zl, pl)
        eh, el = ddemu.dd_chol_solve(
            f.Lh.cpu().numpy(), f.Ll.cpu().numpy(), inv, f.nb,
            b.cpu().numpy(), None if bl is None else bl.cpu().numpy())
        assert bits_equal(zh.cpu(), torch.as_tensor(eh))
        assert bits_equal(zl.cpu(), torch.as_tensor(el))


@pytest.mark.cuda
def test_dd_chol_solve_refuses_orders(cuda):
    """The fused solve keeps the whole solution in each CTA's shared
    memory: at nb = 48 it takes m = 5472 and refuses m = 5473 (raises,
    launching nothing)."""
    for m, fits in ((5472, True), (5473, False)):
        L = torch.eye(m, dtype=torch.float64, device=cuda)
        inv = torch.eye(48, dtype=torch.float64, device=cuda).repeat(
            -(-m // 48), 1, 1)
        f = ddlinalg.DdCholFactor(L, torch.zeros_like(L), inv,
                                  torch.zeros_like(inv), 48,
                                  torch.ones((), dtype=torch.bool))
        b = torch.arange(m, dtype=torch.float64, device=cuda)
        n0 = kernels.LAUNCHES["dd_chol_solve"]
        if fits:
            zh, zl = ddlinalg.dd_chol_solve(f, b)
            assert bits_equal(zh, b) and not bool(zl.any())
            assert kernels.LAUNCHES["dd_chol_solve"] == n0 + 1
        else:
            with pytest.raises(RuntimeError):
                ddlinalg.dd_chol_solve(f, b)
            assert kernels.LAUNCHES["dd_chol_solve"] == n0


@pytest.mark.cuda
@pytest.mark.parametrize("m,case", [(120, "cond"), (200, "pivot"),
                                    (48, "cond"), (666, "cond"),
                                    (100, "nan")])
def test_dd_panel_chol_kernel(cuda, m, case, monkeypatch):
    """K7 inside dd_chol bit for bit against the plain panel (L, the
    panels' inverses, ok), at cond 1e14 (m = 48: one panel, nr == w; m =
    666: a last panel 42 wide), with a forced non-positive pivot or with
    a NaN pivot (ok False; NaN where the plain version has NaN)."""
    if case == "cond":
        M, _, _ = residual_case(m, m)
    else:
        B = np.random.default_rng(m).standard_normal((m, m))
        M = B @ B.T / m + np.eye(m)
        M[70, 70] = -5.0 if case == "pivot" else np.nan
    A = torch.as_tensor(M, device=cuda)
    n0 = kernels.LAUNCHES["dd_panel_chol"]
    fk = ddlinalg.dd_chol(A)
    assert kernels.LAUNCHES["dd_panel_chol"] == n0 + -(-m // 48)
    monkeypatch.setattr(ddlinalg, "dd_panel_chol",
                        ddlinalg.dd_panel_chol_plain)
    fp = ddlinalg.dd_chol(A)
    assert bool(fk.ok) == bool(fp.ok) == (case == "cond")
    same = bits_equal if case != "nan" else bits_or_nan
    assert same(fk.Lh, fp.Lh) and same(fk.Ll, fp.Ll)
    for pk, pp in zip(fk.inv_diag, fp.inv_diag):
        assert all(same(a, b) for a, b in zip(pk, pp))


@pytest.mark.cuda
def test_dd_panel_chol_strided_panel(cuda):
    """K7 reads a column panel of A through its row stride, without a
    copy, and leaves it untouched: the same bits as on a contiguous copy
    and as the plain version, at m = 666 (one panel 666 x 48)."""
    M, _, _ = residual_case(666, 7)
    A = torch.as_tensor(M, device=cuda)
    Al = A * 2.0**-55
    Sh, Sl = A[:, 96:144], Al[:, 96:144]
    before = (Sh.clone(), Sl.clone())
    got = ddlinalg.dd_panel_chol(Sh, Sl)
    assert bits_equal(Sh, before[0]) and bits_equal(Sl, before[1])
    for want in (ddlinalg.dd_panel_chol(Sh.contiguous(), Sl.contiguous()),
                 ddlinalg.dd_panel_chol_plain(Sh, Sl)):
        assert all(bits_or_nan(a, b) for a, b in zip(got[:4], want[:4]))
        assert bool(got[4]) == bool(want[4])


def ada_matrix(n, seed):
    """A A' + (n/2) I for a random sparse A with 1.5 nonzeros per column:
    an LP-like Schur pattern whose first level has several columns."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, 2 * n, density=1.5 / n, random_state=rng, format="csc")
    return sp.csc_matrix(A @ A.T + sp.identity(n) * n * 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(3000, 128), (600, 32), (800, 48),
                                 (300, 20)])
def test_tile_kernels(cuda, n, B):
    """K8 and K9 level by level against the plain versions from the same
    storage (rungs equal; factor within 1e-10 of max|L|; update within
    2 (B + P + 1) eps (|D| + sum |A| |B|'), P the destination's pair
    count, and bit for bit equal to a second call), then K10 on the
    kernels' factor (within 1e-10 of max|x|).  B = 48 is not a multiple
    of K9's 64-wide block tile, B = 20 not of its 16-wide slab."""
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
        ref, again = st.clone(), st.clone()
        sparse_chol.tile_update(st, lv)
        sparse_chol.tile_update(again, lv)
        sparse_chol.tile_update_plain(ref, lv)
        assert bool(torch.all((st[dst] - ref[dst]).abs() <= c * EPS * bound))
        assert bits_equal(st, again)
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
    """Put the kernels' plain twins where the path calls them: K1-K7 and
    the fused dd_chol_solve (its twin, dd_chol_solve_panels, then runs on
    the plain dd_gemv and dd_sub)."""
    mp.setattr(pcg, "dd_matvec_residual", pcg.dd_matvec_residual_plain)
    mp.setattr(schur, "_psd_contrib_coo_kernel",
               schur._psd_contrib_coo_plain)
    mp.setattr(ipm, "ldl_masked", chol.ldl_masked_plain)
    for name in ("ozaki_split", "dd_accumulate", "dd_add", "dd_sub",
                 "two_prod_cols", "dd_gemv", "dd_panel_chol"):
        mp.setattr(ddlinalg, name, getattr(ddlinalg, name + "_plain"))
    mp.setattr(ddlinalg, "dd_chol_solve", ddlinalg.dd_chol_solve_panels)


@pytest.mark.cuda
def test_arch0_witness(cuda, monkeypatch):
    """Separates what moves arch0's landing point on the card (the kernels,
    the card's libraries, or the order of its sums).  Solves arch0 with
    the port on the CPU; on the card as the main path runs it, twice; with
    deterministic algorithms (ordered index_add_), twice; and with
    deterministic algorithms and the plain twins in place of the
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
        "ozaki_split", "dd_accumulate", "dd_gemv", "dd_chol_solve",
        "dd_panel_chol"))
    assert sum(runs["det_plain"]["launches"].values()) == 0
    assert same("det_1", "det_2") and not nondet

    def close(a, b, tol):
        return all(abs(runs[a][f] - runs[b][f]) <= tol * abs(runs[b][f])
                   for f in ("cx", "by"))

    assert close("det_plain", "det_1", 1e-9)
    assert close("det_1", "cpu", 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(3000, 128), (600, 32), (800, 48),
                                 (300, 20)])
def test_tile_kernels_f32(cuda, n, B):
    """K8-f32 and K9-f32 level by level against the plain f32 versions
    from the same f32 storage (rungs equal; factor within 1e-4 of max|L|:
    cuSOLVER's f32 factor rounds in another order on an A A' + (n/2) I of
    condition < 1e2; update within 2 (B + P + 1) (eps32 (|D| + sum |A|
    |B|') + tiny32), the underflow term because the fill's products reach
    the f32 subnormal range, which the plain GEMM may flush to zero), then
    K10-f32 on the kernels' factor (within 1e-4 of max|x|);
    every launch counted under the f32 names, none under the f64 ones."""
    M = ada_matrix(n, n)
    f = sparse_chol.SparseCholesky(M, B=B, device=cuda)
    st = f.storage(M).to(torch.float32)
    eps32 = float(np.finfo(np.float32).eps)
    tiny32 = float(np.finfo(np.float32).tiny)
    before = dict(kernels.LAUNCHES)
    for lv in f.levels:
        ref = st.clone()
        rk = sparse_chol.tile_factor(st, lv, 0.0)
        assert torch.equal(rk, sparse_chol.tile_factor_plain(ref, lv, 0.0))
        slots = torch.cat([lv["dslot"], lv["off_slot"]])
        assert float((st[slots] - ref[slots]).abs().max()) <= 1e-4 * float(
            ref[slots].abs().max())
        if not lv["pair_a"].numel():
            continue
        dst, ptr = lv["pair_dst"], lv["pair_ptr"]
        didx = torch.repeat_interleave(torch.arange(dst.numel(), device=cuda),
                                       torch.diff(ptr))
        bound = st[dst].abs().index_add_(
            0, didx, st[lv["pair_a"]].abs() @ st[lv["pair_b"]].abs().mT)
        c = 2.0 * (B + float(torch.diff(ptr).max()) + 1.0)
        ref, again = st.clone(), st.clone()
        sparse_chol.tile_update(st, lv)
        sparse_chol.tile_update(again, lv)
        sparse_chol.tile_update_plain(ref, lv)
        assert bits_equal(st, again)
        diff = (st[dst] - ref[dst]).abs()
        excess = diff - c * (eps32 * bound + tiny32)
        w = int(torch.argmax(excess))
        assert bool(torch.all(excess <= 0)), {
            "diff": float(diff.flatten()[w]),
            "bound": float(bound.flatten()[w]), "at": w,
            "kernel": float(st[dst].flatten()[w]),
            "plain": float(ref[dst].flatten()[w]),
            "n_over": int((excess > 0).sum()), "finite": bool(
                torch.isfinite(st[dst]).all() & torch.isfinite(ref[dst]).all())}
    rhs = torch.as_tensor(np.random.default_rng(n).standard_normal(f.plan.n),
                          dtype=torch.float32, device=cuda)
    xk = sparse_chol.tile_solve(st, rhs, f.levels)
    xp = sparse_chol.tile_solve_plain(st, rhs, f.levels)
    assert xk.dtype == torch.float32
    assert float((xk - xp).abs().max()) <= 1e-4 * float(xp.abs().max())
    delta = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    assert all(delta[k + "_f32"] > 0 for k in ("tile_factor", "tile_update",
                                                "tile_solve"))
    assert delta["tile_factor"] == delta["tile_update"] == \
        delta["tile_solve"] == 0


def split_level(B, dtype, dev, seed=3):
    """Random tile storage and a level whose destination 0 takes 12
    pairs and destinations 1-4 one each: K9 cuts destination 0 into
    chunks (update_chunks) summed by the last block to arrive."""
    rng = np.random.default_rng(seed)
    st = torch.as_tensor(rng.standard_normal((40, B, B)), dtype=dtype,
                         device=dev)
    ptr = np.array([0, 12, 13, 14, 15, 16])
    lv = dict(pair_dst=np.arange(30, 35), pair_ptr=ptr,
              pair_a=rng.integers(0, 30, 16), pair_b=rng.integers(0, 30, 16))
    lv.update(sparse_chol.update_chunks(ptr))
    assert lv["part_chunk"].size > 1
    lv = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
          for k, v in lv.items()}
    lv["upd_ticket"] = torch.zeros(4 * 5, dtype=torch.int32, device=dev)
    return st, lv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B", [128, 48, 20])
def test_tile_update_split_destination(cuda, dtype, B):
    """K9 (K9-f32) on a level with one destination of 12 pairs, cut into
    chunks reduced in chunk order by the last block to arrive: within
    K9's bound of the plain update, bit for bit equal to a second call,
    the tickets back at zero; tiles of order above 128 and levels without
    the work list raise, launching nothing."""
    st, lv = split_level(B, dtype, cuda)
    eps = float(torch.finfo(dtype).eps)
    tiny = float(torch.finfo(dtype).tiny) if dtype == torch.float32 else 0.0
    didx = torch.repeat_interleave(torch.arange(5, device=cuda),
                                   torch.diff(lv["pair_ptr"]))
    bound = st[lv["pair_dst"]].abs().index_add_(
        0, didx, st[lv["pair_a"]].abs() @ st[lv["pair_b"]].abs().mT)
    ref, again = st.clone(), st.clone()
    sparse_chol.tile_update(st, lv)
    assert lv["upd_ticket"].abs().sum().item() == 0
    sparse_chol.tile_update(again, lv)
    sparse_chol.tile_update_plain(ref, lv)
    dst = lv["pair_dst"]
    assert bool(torch.all((st[dst] - ref[dst]).abs()
                          <= 2.0 * (B + 12 + 1) * (eps * bound + tiny)))
    assert bits_equal(st, again)
    big, lv_big = split_level(136, dtype, cuda)
    name = "tile_update" + ("_f32" if dtype == torch.float32 else "")
    n0 = kernels.LAUNCHES[name]
    with pytest.raises(ValueError):
        sparse_chol.tile_update(big, lv_big)
    lv.pop("upd_ticket")
    with pytest.raises(ValueError):
        sparse_chol.tile_update(st, lv)
    assert kernels.LAUNCHES[name] == n0


@pytest.mark.cuda
def test_tile_factor_escalation_rungs_f32(cuda):
    """The three 128 x 128 rung tiles in f32 storage, with the reference's
    canceltol (1e-12, rounded to f32; the lift's + 1e-300 rounds to 0):
    K8-f32 takes the plain version's rungs 0, 1, 2; rungs 0-1 agree to
    1e-5 of max|L|, the rung-2 diagonal to 1 ulp."""
    B = 128
    rng = np.random.default_rng(0)
    G = rng.standard_normal((B, B))
    D = G @ G.T / B + np.eye(B)
    first, both = D.copy(), D.copy()
    first[3, 3] = -0.5
    both[5, 4] = both[4, 5] = 50.0
    st = torch.as_tensor(np.stack([np.tril(a) for a in (D, first, both)]),
                         dtype=torch.float32, device=cuda)
    ref = st.clone()
    lv = {"dslot": torch.arange(3, device=cuda),
          "off_slot": torch.zeros(0, dtype=torch.int64, device=cuda),
          "off_dslot": torch.zeros(0, dtype=torch.int64, device=cuda)}
    assert sparse_chol.tile_factor(st, lv, 0.0).tolist() == [0, 1, 2]
    assert sparse_chol.tile_factor_plain(ref, lv, 0.0).tolist() == [0, 1, 2]
    assert float((st[:2] - ref[:2]).abs().max()) <= 1e-5 * float(
        ref[:2].abs().max())
    np.testing.assert_array_max_ulp(st[2].cpu().numpy(), ref[2].cpu().numpy(),
                                    maxulp=1)


def chain_matrix(n, seed):
    """G G' / n + I with G dense: a dense SDP-like pattern, every tile
    filled, one column a level."""
    G = np.random.default_rng(seed).standard_normal((n, n))
    return sp.csc_matrix(G @ G.T / n + np.eye(n))


def tile_plan(kind, B, dev):
    """(matrix, SparseCholesky on dev): LP-like (ada_matrix, several
    columns in the first level) or chain-like (one column a level)."""
    if kind == "lp":
        M = ada_matrix({16: 300, 32: 600, 128: 3000}[B], 7)
    else:
        M = chain_matrix(B * {16: 8, 32: 6, 128: 4}[B] - 5, 7)
    return M, sparse_chol.SparseCholesky(M, B=B, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind,B", [("lp", 16), ("lp", 32), ("lp", 128),
                                    ("chain", 16), ("chain", 32),
                                    ("chain", 128)])
def test_tile_solve_plans(cuda, kind, B, dtype):
    """K10 (K10-f32) on LP-like and chain-like plans: two launches per
    solve; within chip_smoke.TILE_TOL of the plain solve (of max|x|); bit
    for bit equal to its emulation (tests/tile_emulation.py), to a second
    call, and to calls on one block and on three (the order of every sum
    is fixed, whatever the grid)."""
    M, f = tile_plan(kind, B, cuda)
    L = f.factor(M).to(dtype)
    rhs = torch.as_tensor(np.random.default_rng(B).standard_normal(f.plan.n),
                          dtype=dtype, device=cuda)
    name = "tile_solve" + ("_f32" if dtype == torch.float32 else "")
    n0 = kernels.LAUNCHES[name]
    xk = sparse_chol.tile_solve(L, rhs, f.levels)
    assert kernels.LAUNCHES[name] == n0 + 2
    xp = sparse_chol.tile_solve_plain(L, rhs, f.levels)
    assert float((xk - xp).abs().max()) <= TILE_TOL[dtype]["solve"] * float(
        xp.abs().max())
    flat_cpu = {k: v.cpu() for k, v in f.levels.flat.items()}
    assert bits_equal(xk.cpu(), emu.tile_solve(L.cpu(), rhs.cpu(), flat_cpu))
    assert bits_equal(xk, sparse_chol.tile_solve(L, rhs, f.levels))
    for grid in (1, 3):
        xg = sparse_chol._tile_solve_kernel(L, rhs, f.levels, grid)
        assert bits_equal(xk, xg)


@pytest.mark.cuda
def test_tile_solve_refused_grid_raises(cuda):
    """A grid the card cannot hold resident is refused before any block
    runs: the launch raises, nothing is counted, and nothing falls back to
    per-level launches or to the plain version."""
    M, f = tile_plan("lp", 32, cuda)
    L = f.factor(M)
    rhs = torch.ones(f.plan.n, dtype=torch.float64, device=cuda)
    n0 = kernels.LAUNCHES["tile_solve"]
    with pytest.raises(RuntimeError):
        sparse_chol._tile_solve_kernel(L, rhs, f.levels, 100000)
    assert kernels.LAUNCHES["tile_solve"] == n0
    with pytest.raises(ValueError):
        sparse_chol.tile_solve(L, rhs, tuple(f.levels))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tile_factor_blocked_rungs(cuda, dtype):
    """K8 (K8-f32) on four 128 x 128 diagonal tiles, SPD and built to fail
    at pivot 3 (rung 1), at pivot 70 in the third panel (rung 1) and
    beyond dmax + 1 (rung 2), each with an off tile: the plain version's
    rungs, the rung-2 tile bit for bit equal to the plain version's, and
    every tile bit for bit equal to the emulation of the blocked order."""
    B = 128
    rng = np.random.default_rng(0)
    G = rng.standard_normal((B, B))
    D = G @ G.T / B + np.eye(B)
    first, late, both = D.copy(), D.copy(), D.copy()
    first[3, 3] = late[70, 70] = -0.5
    both[5, 4] = both[4, 5] = 50.0
    diags = [np.tril(a) for a in (D, first, late, both)]
    offs = [rng.standard_normal((B, B)) for _ in diags]
    st = torch.as_tensor(np.stack(diags + offs), dtype=dtype, device=cuda)
    lv = {"dslot": torch.arange(4, device=cuda),
          "off_slot": torch.arange(4, 8, device=cuda),
          "off_dslot": torch.arange(4, device=cuda)}
    ref, cpu = st.clone(), st.cpu()
    assert sparse_chol.tile_factor(st, lv, 0.0).tolist() == [0, 1, 1, 2]
    assert sparse_chol.tile_factor_plain(ref, lv, 0.0).tolist() == \
        [0, 1, 1, 2]
    assert bits_equal(st[3], ref[3])
    lv_cpu = {k: v.cpu() for k, v in lv.items()}
    assert emu.tile_factor(cpu, lv_cpu, 0.0).tolist() == [0, 1, 1, 2]
    assert bits_equal(st.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B", [("lp", 32), ("chain", 128)])
def test_tile_factor_levels_match_emulation(cuda, kind, B):
    """K8 level by level on an LP-like and a chain-like plan, with K9
    between levels, bit for bit equal to the emulation of its blocked
    order run on the same storage."""
    M, f = tile_plan(kind, B, cuda)
    st = f.storage(M)
    for lv in f.levels:
        cpu = st.cpu()
        rk = sparse_chol.tile_factor(st, lv, 0.0)
        re = emu.tile_factor(cpu, {k: v.cpu() for k, v in lv.items()}, 0.0)
        assert rk.tolist() == re.tolist()
        slots = torch.cat([lv["dslot"], lv["off_slot"]])
        assert bits_equal(st[slots].cpu(), cpu[slots.cpu()])
        sparse_chol.tile_update(st, lv)


def dense_column_lp():
    """test_dense_columns_keep_pattern_sparse_and_match's LP (m = 900, three
    dense columns), from numpy.random.default_rng(12345) as the suite's
    conftest seeds it, by chip_smoke.py's copy of the generator."""
    return random_sparse_lp(900, 200, np.random.default_rng(12345),
                            dense_cols=3)


def solve_lp(device, sparse=1, **pars):
    A, b, c, K = dense_column_lp()
    before = dict(kernels.LAUNCHES)
    x, y, info = st.sedumi(A, b, c, K, {"fid": 0, "sparse": sparse,
                                        "optstep": 0, **pars}, device=device)
    return {"cx": float(c @ x), "by": float(b @ y), "iter": int(info["iter"]),
            "engine": info["lin_engine"], "err": max(info["err"]),
            "pinf": int(info["pinf"]), "dinf": int(info["dinf"]),
            "numerr": int(info["numerr"]),
            "phases": {k: v["iters"] for k, v in info["phases"].items()},
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


@pytest.mark.cuda
def test_mixed_sparse_solve_card_matches_cpu(cuda):
    """The dense-column LP with pars.dtype='mixed' through the sparse
    engine on that machine's CPU and on the card: the same phase sequence
    on the sparse engine, the reference's gate on both, K8-f32 to K10-f32
    and K3-f32 launched on the card, and c'x within 1e-7 relative."""
    runs = {"cpu": solve_lp("cpu", dtype="mixed"),
            "card": solve_lp(cuda, dtype="mixed")}
    print(json.dumps({"mixed_sparse": {k: {f: v for f, v in r.items()
                                           if f not in ("x", "y")}
                                       for k, r in runs.items()}}),
          flush=True)
    for r in runs.values():
        assert r["engine"] == "sparse"
        assert r["pinf"] == 0 and r["dinf"] == 0 and r["err"] < 1e-7
    assert list(runs["card"]["phases"]) == list(runs["cpu"]["phases"])
    assert "f32" in runs["card"]["phases"]
    for k in ("tile_factor_f32", "tile_update_f32", "tile_solve_f32",
              "ldl_masked_f32"):
        assert runs["card"]["launches"][k] > 0, k
    assert abs(runs["card"]["cx"] - runs["cpu"]["cx"]) <= 1e-7 * abs(
        runs["cpu"]["cx"])


@pytest.mark.cuda
@pytest.mark.parametrize("bs,mp", [(4, 32), (32, 128), (64, 256),
                                   (128, 1024)])
def test_panel_kernels(cuda, bs, mp):
    """K14 on every block column (and a non-PD diagonal block: NaN from
    it on) and K15 in a two-panel substitution, against their plain
    versions within 1e-12 of max|L| and of max|x|."""
    from chip_smoke import PANEL_TOL, panel_case

    c = panel_case(bs, mp, torch.Generator().manual_seed(bs + mp), cuda)
    nb = mp // bs
    assert c["counts"] == {"dist_panel_chol": nb + 1,
                           "dist_trisolve_fwd": nb,
                           "dist_trisolve_bwd_contrib": 2 * nb,
                           "dist_trisolve_bwd_solve": nb}
    assert c["rel_l"] <= PANEL_TOL and c["rel_x"] <= PANEL_TOL
    assert c["fac"] <= 1e-8 and c["resid"] <= 1e-8 and c["nan_ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [4, 8, 16, 32, 48, 64, 128])
def test_panel_kernels_match_emulation(cuda, bs):
    """K14 on every block column of an 8-block matrix (and on a block that
    fails in its last pivot) and K15 in the two-panel substitution and
    step by step, bit for bit equal to tests/panel_emulation.py, at the
    widths _bs_for yields and at 48 (a short last panel); two calls agree
    bit for bit, K14's result does not depend on its grid (1 and 3 CTAs,
    each then solving several chunks of rows against its Ljj, against
    one a chunk), and K15's sums do not depend on the cluster's size (1,
    3 and 8 CTAs against the default)."""
    _panel_emulation_case(cuda, bs, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [4, 8, 16, 32, 48, 64, 128])
def test_panel_kernels_f32_match_emulation(cuda, bs):
    """K14-f32 and K15-f32 as test_panel_kernels_match_emulation holds
    K14/K15: bit for bit the emulation run in float32, on chip_smoke's
    f32 matrix (cond 1e3)."""
    _panel_emulation_case(cuda, bs, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,mp", [(4, 32), (32, 128), (64, 256),
                                   (128, 1024)])
def test_panel_kernels_f32(cuda, bs, mp):
    """K14-f32 and K15-f32 against their plain versions in f32, within
    chip_smoke.PANEL_CASE's f32 tolerances; they count as the f32 builds."""
    from chip_smoke import PANEL_CASE, panel_case

    f32 = torch.float32
    c = panel_case(bs, mp, torch.Generator().manual_seed(bs + mp), cuda, f32)
    nb = mp // bs
    assert c["counts"] == {"dist_panel_chol_f32": nb + 1,
                           "dist_trisolve_fwd_f32": nb,
                           "dist_trisolve_bwd_contrib_f32": 2 * nb,
                           "dist_trisolve_bwd_solve_f32": nb}
    tol = PANEL_CASE[f32]
    assert c["rel_l"] <= tol["tol"] and c["rel_x"] <= tol["tol"]
    assert c["fac"] <= tol["fac"] and c["resid"] <= tol["resid"]
    assert c["nan_ok"] and c["emu_ok"] and c["x"].dtype == f32


def _panel_emulation_case(cuda, bs, dtype):
    """The body of the emulation tests, in `dtype` (f64: K14/K15, on a
    matrix of cond 1e6; f32: their f32 builds, cond 1e3)."""
    import panel_emulation as pe
    from chip_smoke import PANEL_CASE, panel_chain, panel_columns, panel_spd
    from sedumi_tpu_torch.parallel import panels as pn

    nb = 8
    mp = nb * bs
    gen = torch.Generator().manual_seed(bs)
    Cs, L = panel_columns(panel_spd(mp, gen, cuda, dtype,
                                    PANEL_CASE[dtype]["cond"]), bs)
    for j, C in enumerate(Cs):
        got = pn.panel_chol_step(C, j)
        assert bits_equal(got.cpu(), pe.chol_column(C.cpu(), j)), j
        assert bits_equal(got, pn.panel_chol_step(C, j)), j
        for ncta in (1, 3):     # CTAs with several chunks (rows_solve)
            assert bits_equal(pn._panel_chol_kernel(C, j, ncta), got), \
                (j, ncta)
    bad = Cs[4].clone()
    bad[4, bs - 1, bs - 1] = -1.0
    got = pn.panel_chol_step(bad, 4)
    assert bits_equal(got.cpu(), pe.chol_column(bad.cpu(), 4))
    assert torch.isnan(got[4:]).all() and (got[:4] == 0).all()
    assert bits_equal(pn._panel_chol_kernel(bad, 4, 1), got)
    b = torch.randn(mp, generator=gen, dtype=torch.float64).to(dtype) \
        .to(cuda)
    x = panel_chain(L, b, bs, 2, pn.trisolve_fwd_step,
                    pn.trisolve_bwd_contrib, pn.trisolve_bwd_solve)
    assert bits_equal(x.cpu(), pe.dist_solve(L.cpu(), b.cpu(), bs, 2))
    # the last forward step (the longest row product) on its own
    j = nb - 1
    row, bj = L[j * bs:], b[j * bs:]
    xs = torch.cat([x[:j * bs], torch.zeros(bs, dtype=x.dtype,
                                            device=cuda)])
    xj = pn._fwd_step_kernel(row, xs, bj, j)
    assert bits_equal(xj.cpu(), pe.fwd_step(row.cpu(), xs.cpu(), bj.cpu(),
                                            j))
    for ncta in (1, 3, 8):
        assert bits_equal(pn._fwd_step_kernel(row, xs, bj, j, ncta), xj)
    # panel 1's contributions: every row, part of them, none
    L3 = L[4 * bs:]
    for jj in (0, 4, 5, 7):
        c = pn._bwd_contrib_kernel(L3, x, bs, 4, jj)
        assert bits_equal(c.cpu(), pe.bwd_contrib(L3.cpu(), x.cpu(), bs, 4,
                                                  jj)), jj
        for ncta in (1, 3, 8):
            assert bits_equal(pn._bwd_contrib_kernel(L3, x, bs, 4, jj, ncta),
                              c), (jj, ncta)
    Ljj = L[:bs, :bs].contiguous()
    xb = pn.trisolve_bwd_solve(Ljj, b[:bs], x[:bs])
    assert bits_equal(xb.cpu(), pe.bwd_solve(Ljj.cpu(), b[:bs].cpu(),
                                             x[:bs].cpu()))
    assert bits_equal(xb, pn.trisolve_bwd_solve(Ljj, b[:bs], x[:bs]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,scale", [(torch.float32, 2.0**-100),
                                         (torch.float32, 2.0**-112),
                                         (torch.float64, 2.0**-990)])
def test_panel_kernels_division_fallback(cuda, dtype, scale):
    """Where the reciprocal rule's range (div_rn.cuh) fails for a quotient
    (a matrix scaled by 2^-100 or 2^-112 in f32, 2^-990 in f64: numerators
    below its bound), K14 runs its column (or a later chunk of rows, on
    one CTA) again with the division and K15's triangles their panel:
    still bit for bit the emulation, with the finite factor of the scaled
    matrix."""
    import panel_emulation as pe
    from chip_smoke import PANEL_CASE, panel_chain, panel_columns, panel_spd
    from sedumi_tpu_torch.parallel import panels as pn

    bs, nb = 64, 4
    mp = nb * bs
    gen = torch.Generator().manual_seed(17)
    M = panel_spd(mp, gen, "cpu", torch.float64,
                  PANEL_CASE[dtype]["cond"]) * scale
    Cs, L = panel_columns(M.to(dtype).to(cuda), bs)
    for j in (0, nb - 1):
        got = pn.panel_chol_step(Cs[j], j)
        assert bits_equal(got.cpu(), pe.chol_column(Cs[j].cpu(), j)), j
        assert torch.isfinite(got).all(), j
        assert bits_equal(pn._panel_chol_kernel(Cs[j], j, 1), got), j
    b = (torch.randn(mp, generator=gen, dtype=torch.float64)
         * scale).to(dtype).to(cuda)
    x = panel_chain(L, b, bs, 2, pn.trisolve_fwd_step,
                    pn.trisolve_bwd_contrib, pn.trisolve_bwd_solve)
    assert bits_equal(x.cpu(), pe.dist_solve(L.cpu(), b.cpu(), bs, 2))


@pytest.mark.cuda
def test_panel_kernels_refuse_shapes(cuda):
    """What K14/K15 do not take raises and counts no launch, with no
    fallback to the plain versions: bs above 128 in the wrappers; in the
    launches a block row past mp, a cluster of more than 8 CTAs, an f64
    panel off a 16-byte boundary (the f64 contribution's loads) and a
    block column past the matrix."""
    from sedumi_tpu_torch.parallel import panels as pn

    before = dict(kernels.LAUNCHES)
    f64 = dict(dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="bs <= 128"):
        pn.panel_chol_step(torch.zeros(2, 129, 129, **f64), 0)
    with pytest.raises(ValueError, match="bs <= 128"):
        pn.trisolve_bwd_solve(torch.eye(129, **f64), torch.zeros(129, **f64),
                              torch.zeros(129, **f64))
    row, x, bj = torch.zeros(16, 64, **f64), torch.zeros(64, **f64), \
        torch.zeros(16, **f64)
    with pytest.raises(RuntimeError):
        pn._fwd_step_kernel(row, x, bj, 4)          # (4 + 1) 16 > 64
    with pytest.raises(RuntimeError):
        pn._fwd_step_kernel(row, x, bj, 1, ncta=9)
    with pytest.raises(RuntimeError):
        pn._bwd_contrib_kernel(row, x, 16, 0, 0, ncta=9)
    with pytest.raises(RuntimeError):
        pn._bwd_contrib_kernel(torch.zeros(16 * 64 + 1, **f64)[1:]
                               .view(16, 64), x, 16, 0, 0)
    C = torch.zeros(2, 16, 16, **f64)
    with pytest.raises(RuntimeError):
        kernels.launch("panel_chol.cu", "panel_chol_launch", C.data_ptr(),
                       C.data_ptr(), 2, 16, 2, 0)
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
def test_mesh_panels_witness(cuda):
    """nb with {"panels": 2} on two ranks sharing this card (gloo): the
    reference gate, the same x on both ranks, K14 and K15 launched on
    each, no dd64 kernel or K3; c'x within 1e-8 relative of the
    unsharded card solve.  Prints one JSON line."""
    from sedumi_tpu_torch.parallel import entry
    from sedumi_tpu_torch.parallel.launch import run_spmd

    ex = load_example("nb")
    res = run_spmd(entry.rank_sedumi, 2,
                   args=(("example", "nb"),
                         {"fid": 0, "mesh_shape": {"panels": 2}}, "cuda"),
                   device="cuda", timeout_s=300)
    x0, y0, _ = st.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0}, device=cuda)
    cx0 = float(ex.c @ x0)
    print(json.dumps({"mesh_nb": [{k: v for k, v in r.items()
                                   if k not in ("x", "y")} for r in res],
                      "cx_unsharded": cx0}), flush=True)
    r0 = res[0]
    rel = abs(r0["cx"] - ex.optval) / abs(ex.optval)
    assert r0["info"]["pinf"] == 0 and r0["info"]["dinf"] == 0
    assert r0["info"]["numerr"] < 2 and rel <= 1e-6
    assert abs(r0["cx"] - cx0) <= 1e-8 * abs(cx0)
    for r in res:
        np.testing.assert_array_equal(r["x"], r0["x"])
        for k in ("dist_panel_chol", "dist_trisolve_fwd",
                  "dist_trisolve_bwd_contrib", "dist_trisolve_bwd_solve"):
            assert r["launches"].get(k, 0) > 0, k
        for k in ("ldl_masked", "dd_panel_chol", "dd_gemv"):
            assert r["launches"].get(k, 0) == 0, k


@pytest.mark.cuda
def test_mesh_oh_witness(cuda):
    """OH with {"panels": 2} on two ranks of this card: as it runs; under
    torch.use_deterministic_algorithms; and deterministically with
    K14/K15's plain versions; beside the unsharded card solve.  Prints
    one JSON line (iterations, numerr, c'x of each).  Every run must meet
    the mesh path's gate (pinf = dinf = 0, numerr < 2, c'x within
    1e-6 (1 + |c'x|) of the unsharded solve)."""
    from sedumi_tpu_torch.parallel import entry
    from sedumi_tpu_torch.parallel.launch import run_spmd

    name = "OH_2Pi_STO-6GN9r12g1T2"
    ex = load_example(name)
    pars = {"fid": 0, "mesh_shape": {"panels": 2}}
    x0, _, info0 = st.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0}, device=cuda)
    cx0 = float(ex.c @ x0)
    runs = {"card": run_spmd(entry.rank_sedumi, 2,
                             args=(("example", name), pars, "cuda"),
                             device="cuda", timeout_s=900)}
    for label, plain in (("deterministic", False),
                         ("deterministic_plain", True)):
        runs[label] = run_spmd(entry.rank_sedumi_witness, 2,
                               args=(("example", name), pars, plain, "cuda"),
                               device="cuda", timeout_s=900)
    summary = {k: {f: r[0][f] for f in ("info", "phases", "cx", "wall",
                                        "comm_calls", "comm_s")}
               for k, r in runs.items()}
    summary["unsharded"] = {"iter": info0["iter"],
                            "numerr": info0["numerr"], "cx": cx0}
    print(json.dumps({"mesh_oh": summary}), flush=True)
    for res in runs.values():
        r0 = res[0]
        assert r0["info"]["pinf"] == 0 and r0["info"]["dinf"] == 0
        assert r0["info"]["numerr"] < 2
        assert abs(r0["cx"] - cx0) <= 1e-6 * (1.0 + abs(cx0))
        np.testing.assert_array_equal(res[1]["x"], r0["x"])


@pytest.mark.cuda
def test_mesh_mixed_ladder(cuda):
    """nb under 'mixed' with {"hosts": 2, "panels": 2} on four ranks
    sharing this card: the mesh's ladder (f32 first, no dd64) at the
    reference gate, the same x on every rank, K14-f32/K15-f32 and
    K14/K15 launched on each, no dd64 kernel or K3.  Prints one JSON
    line."""
    from sedumi_tpu_torch.parallel import entry
    from sedumi_tpu_torch.parallel.launch import run_spmd

    ex = load_example("nb")
    res = run_spmd(entry.rank_sedumi, 4,
                   args=(("example", "nb"),
                         {"fid": 0, "dtype": "mixed",
                          "mesh_shape": {"hosts": 2, "panels": 2}}, "cuda"),
                   device="cuda", timeout_s=600)
    print(json.dumps({"mesh_nb_mixed": [{k: v for k, v in r.items()
                                         if k not in ("x", "y")}
                                        for r in res]}), flush=True)
    r0 = res[0]
    rel = abs(r0["cx"] - ex.optval) / abs(ex.optval)
    assert r0["info"]["pinf"] == 0 and r0["info"]["dinf"] == 0
    assert r0["info"]["numerr"] < 2 and rel <= 1e-6
    assert next(iter(r0["phases"])) == "f32" and "dd64" not in r0["phases"]
    for r in res:
        np.testing.assert_array_equal(r["x"], r0["x"])
        for k in ("dist_panel_chol", "dist_trisolve_fwd",
                  "dist_trisolve_bwd_contrib", "dist_trisolve_bwd_solve"):
            assert r["launches"].get(k, 0) > 0, k
            assert r["launches"].get(k + "_f32", 0) > 0, k + "_f32"
        for k in ("ldl_masked", "dd_panel_chol", "dd_gemv"):
            assert r["launches"].get(k, 0) == 0, k


@pytest.mark.cuda
@pytest.mark.parametrize("pars,engine", [({}, "dense"),
                                         ({"dtype": "mixed"}, "dense"),
                                         ({"sparse": 1}, "sparse")])
def test_profile_on_the_card(cuda, pars, engine):
    """pars.profile=1 on the card (arch0; the sparse engine forced on it
    too): info["profile"] has its engine's keys, every value positive and
    finite (the times are fenced by torch.cuda.synchronize); under
    'mixed' the f32 bundle's scaling launches K12-f32."""
    ex = load_example("arch0")
    kernels.reset_launch_counts()
    _, _, info = st.sedumi(ex.At, ex.b, ex.c, ex.K,
                           {"fid": 0, "profile": 1, "refine": 0, **pars},
                           device=cuda)
    prof = info["profile"]
    print(json.dumps({"profile": prof, "pars": pars}), flush=True)
    assert info["lin_engine"] == engine
    keys = {"dense": {"nt_scaling_ms", "schur_ms", "chol_ms", "schur_tflops",
                      "chol_tflops", "schur_flop_count", "chol_flop_count"},
            "sparse": {"nt_scaling_ms", "prepare_ms", "solve_ms"}}[engine]
    assert set(prof) == keys
    assert all(np.isfinite(v) and v > 0 for v in prof.values()), prof
    if pars.get("dtype") == "mixed":
        assert kernels.LAUNCHES["jacobi_eigh_f32"] > 0
