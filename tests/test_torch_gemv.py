"""The order of K1 (compensated residual) and K11 (double-float GEMV
pair), on the CPU.

K1 (csrc/dd_residual.cu) and K11 (csrc/df_gemv.cu) run only on the card;
here their order of operations, emulated in numpy (tests/
gemv_emulation.py: the alignment peel, the threads' or slabs' shares and
the fixed merge trees), is held against the reference's JAX functions on
numpy-seeded inputs within the stated bounds:

* K1 (f64 and f32, with and without `lo`) against
  sedumi_tpu.pcg.dd_matvec_residual and the reference's refinement line
  (dd_matvec_residual(M, hi, rhs) - M @ lo): within 2u|r| + (2(L + D) +
  2n + 8) u^2 sum|M v| (+ (L + D + n + 2) u sum|M lo| with `lo`), L the
  emulated thread's chain, D the tree's depth, u the dtype's unit
  roundoff; and on the 24 x 24 Hilbert matrix within 2 eps |r| + 1e-28
  sum|M v| of the exact rational residual;
* K11 (df_matvec, df_vecmat) against sedumi_tpu.df within
  (3 L + 30) + ((D + k)(D + k + 2) + 7) times 2^-48 sum|a x|.

The port's plain `lo` form must stay bit for bit the old two-step
expression, so the CPU path and its parity with the reference do not
move.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemv_emulation as emu
from sedumi_tpu import df as jdf
from sedumi_tpu import pcg as jpcg
from sedumi_tpu_torch import df as tdf
from sedumi_tpu_torch import pcg as tpcg

torch.set_num_threads(1)

UDF = 2.0**-48
# the reference's functions, one XLA compile a shape (op by op, each of
# their many small ops would compile on its own)
J_RESIDUAL = jax.jit(jpcg.dd_matvec_residual)
J_MATVEC = jax.jit(jdf.df_matvec)
J_VECMAT = jax.jit(jdf.df_vecmat)


def unit(dt) -> float:
    return float(np.finfo(dt).eps) / 2


def residual_case(m, n, dt, seed):
    """M [m, n] of cond ~1e14 (f64) / ~1e6 (f32) on its leading square
    part, v = M^-1 rhs there (a cancellation-heavy residual), a small
    refinement correction lo."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    cond = 14 if dt == np.float64 else 6
    M = rng.standard_normal((m, n)) * 1e-3
    M[:k, :k] = (q * np.logspace(0, -cond, k)) @ q.T
    M = M.astype(dt)
    rhs = rng.standard_normal(m).astype(dt)
    v = np.linalg.lstsq(M.astype(np.float64), rhs.astype(np.float64),
                        rcond=None)[0].astype(dt)
    lo = (v * unit(dt) * rng.standard_normal(n)).astype(dt)
    return M, v, rhs, lo


def k1_chain(n, dt, parts, phase, lda, m):
    """The longest chain a K1 thread sums, and the tree's depth."""
    W = 16 // np.dtype(dt).itemsize
    h, nv, tl = emu.row_peel(m, n, W, phase, lda)
    L = int(np.max(h + W * -(-nv // parts) + tl)) + 1
    return L, int(np.log2(parts))


def check_k1(M, v, rhs, lo, parts, phase=0, lda=None):
    dt = M.dtype
    u = unit(dt)
    got = emu.residual(M, v, rhs, lo, parts, phase, lda)
    assert got.dtype == dt
    r_j = np.asarray(J_RESIDUAL(M, v, rhs))
    if lo is not None:
        r_j = r_j - np.asarray(jnp.asarray(M) @ jnp.asarray(lo))
    m, n = M.shape
    L, D = k1_chain(n, dt, parts, phase, lda, m)
    M64 = M.astype(np.float64)
    S = np.abs(M64) @ np.abs(v.astype(np.float64))
    tol = 2 * u * np.abs(r_j.astype(np.float64)) \
        + (2 * (L + D) + 2 * n + 8) * u * u * S
    if lo is not None:
        tol += (L + D + n + 2) * u * (np.abs(M64) @ np.abs(lo.astype(
            np.float64)))
    err = np.abs(got.astype(np.float64) - r_j.astype(np.float64))
    assert np.all(err <= tol), float(np.max(err / tol))
    return got


# ------------------------------------------------------------------- K1


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("m,n", [(1, 1), (7, 7), (123, 123), (174, 174),
                                 (666, 666), (7, 1), (9, 130)])
def test_k1_order_matches_reference(m, n, dt):
    """K1's order at the plan's parts (residual_parts), on aligned rows
    and at every storage offset (phase), with and without `lo`."""
    M, v, rhs, lo = residual_case(m, n, dt, seed=m * 1000 + n)
    parts = tpcg.residual_parts(n, np.dtype(dt).itemsize)
    W = 16 // np.dtype(dt).itemsize
    for phase in range(W):
        for with_lo in (False, True):
            check_k1(M, v, rhs, lo if with_lo else None, parts, phase)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_k1_every_parts_and_row_stride(dt):
    """Every thread count a row can take, and a row stride that moves each
    row's alignment (a view into a wider matrix)."""
    M, v, rhs, lo = residual_case(174, 123, dt, seed=5)
    for parts in (32, 64, 128, 256):
        check_k1(M, v, rhs, lo, parts, phase=1, lda=127)
        check_k1(M, v, rhs, None, parts, phase=0, lda=129)


@pytest.mark.parametrize("parts", [32, 128])
@pytest.mark.parametrize("phase", [0, 1])
def test_k1_hilbert_exact_rational(parts, phase):
    """24 x 24 Hilbert matrix (cond ~ 1e18 in f64): K1's order against the
    exact rational residual of v = H^-1 rhs, as the plain version is held
    in test_torch_kernels."""
    m = 24
    H = 1.0 / (np.arange(m)[:, None] + np.arange(m)[None, :] + 1.0)
    rhs = np.random.default_rng(24).standard_normal(m)
    v = np.linalg.solve(H, rhs)
    exact = np.array([float(Fraction(rhs[i]) - sum(
        Fraction(H[i, j]) * Fraction(v[j]) for j in range(m)))
        for i in range(m)])
    got = emu.residual(H, v, rhs, None, parts, phase)
    tol = 2 * unit(np.float64) * 2 * np.abs(exact) \
        + 1e-28 * (np.abs(H) @ np.abs(v))
    assert np.all(np.abs(got - exact) <= tol)
    plain = rhs - H @ v
    assert np.max(np.abs(plain - exact)) > 1e3 * np.max(
        np.abs(got - exact) + 1e-300)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_lo_form_is_the_two_step_bit_for_bit(dtype):
    """The CPU path: dd_matvec_residual(M, v, rhs, lo) is bit for bit
    dd_matvec_residual_plain(M, v, rhs) - M @ lo, and refine_solve_dd is
    bit for bit the reference's loop written with the two-step line."""
    dt = np.float64 if dtype == torch.float64 else np.float32
    M, v, rhs, lo = (torch.as_tensor(a)
                     for a in residual_case(66, 66, dt, seed=3))
    want = tpcg.dd_matvec_residual_plain(M, v, rhs) - M @ lo
    for got in (tpcg.dd_matvec_residual(M, v, rhs, lo),
                tpcg.dd_matvec_residual_plain(M, v, rhs, lo)):
        assert torch.equal(got.view(torch.int64 if dt == np.float64
                                    else torch.int32),
                           want.view(torch.int64 if dt == np.float64
                                     else torch.int32))
    A = M @ M.T + 66 * torch.eye(66, dtype=dtype)

    def solve(b):
        return torch.linalg.solve(A, b)

    hi = solve(rhs)
    lo2 = torch.zeros_like(hi)
    for _ in range(3):
        r = tpcg.dd_matvec_residual_plain(A, hi, rhs) - A @ lo2
        s, e = tpcg.two_sum(hi, solve(r))
        hi, lo2 = s, lo2 + e
    assert torch.equal(tpcg.refine_solve_dd(A, solve, rhs), hi + lo2)


def test_residual_parts_plan():
    """Powers of two from 32 to 256, the fewest that leave a thread at
    most eight vectors in f64 and one in f32."""
    for itemsize, most in ((8, 8), (4, 1)):
        for n in (1, 7, 123, 174, 544, 666, 948, 4000, 100000):
            p = tpcg.residual_parts(n, itemsize)
            assert p in (32, 64, 128, 256)
            assert p == 256 or most * p >= n * itemsize // 16
            assert p == 32 or most * p < 2 * (n * itemsize // 16)
    assert [tpcg.residual_parts(n, 4) for n in (123, 174, 544, 666)] \
        == [32, 64, 256, 256]
    assert [tpcg.residual_parts(n, 8) for n in (123, 174, 544, 666)] \
        == [32, 32, 64, 64]


# ------------------------------------------------------------------ K11


def df_case(rows, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((rows, n)) * np.exp(rng.standard_normal((rows,
                                                                     n)))
    Ah, Al = (np.asarray(a) for a in jdf.df_split64(A))
    return Ah, Al, rng


def df_check(got, want, exact, S, c):
    got = got[0].astype(np.float64) + got[1].astype(np.float64)
    want = np.asarray(want[0], np.float64) + np.asarray(want[1], np.float64)
    assert np.all(np.abs(got - want) <= c * UDF * S), \
        float(np.max(np.abs(got - want) / (c * UDF * S)))
    assert np.max(np.abs(got - exact) / S) < 1e-12


@pytest.mark.parametrize("rows,n,plan", [
    (1, 1, None), (7, 7, None), (121, 400, None), (124, 2383, None),
    (5, 1001, (3, 84)), (3, 130, (5, 7)), (2, 9000, None)])
def test_df_matvec_order_matches_reference(rows, n, plan):
    """K11's df_matvec at its plan (matvec_plan, or the slabs given) and
    at every storage offset of the rows."""
    Ah, Al, rng = df_case(rows, n, rows * 7 + n)
    xh, xl = (np.asarray(a) for a in jdf.df_split64(rng.standard_normal(n)))
    nslab, vps = plan or tdf.matvec_plan(rows, n)
    assert nslab * vps >= n // 4
    want = J_MATVEC(Ah, Al, xh, xl)
    A64 = Ah.astype(np.float64) + Al.astype(np.float64)
    x64 = xh.astype(np.float64) + xl.astype(np.float64)
    S, exact = np.abs(A64) @ np.abs(x64), A64 @ x64
    L = 4 * -(-vps // 32) + 2 + 5 + nslab - 1
    D, k = 14, -(-n // 16384)
    c = (3 * L + 30) + ((D + k) * (D + k + 2) + 7)
    for phase in range(4):
        got = emu.df_matvec(Ah, Al, xh, xl, nslab, vps, phase)
        df_check(got, want, exact, S, c)


@pytest.mark.parametrize("rows,n,plan", [
    (1, 1, None), (7, 7, None), (121, 400, None), (124, 2383, None),
    (666, 3, None), (9, 1030, (3, 3)), (1001, 70, (4, 251))])
def test_df_vecmat_order_matches_reference(rows, n, plan):
    """K11's df_vecmat at its plan (vecmat_plan, or the slabs given)."""
    Ah, Al, rng = df_case(rows, n, rows * 11 + n)
    xh, xl = (np.asarray(a) for a in jdf.df_split64(
        rng.standard_normal(rows)))
    nslab, rps = plan or tdf.vecmat_plan(rows, n)
    assert nslab * rps >= rows > (nslab - 1) * rps
    want = J_VECMAT(xh, xl, Ah, Al)
    A64 = Ah.astype(np.float64) + Al.astype(np.float64)
    x64 = xh.astype(np.float64) + xl.astype(np.float64)
    S, exact = np.abs(x64) @ np.abs(A64), x64 @ A64
    L = rps + nslab - 1
    D = int(np.ceil(np.log2(max(rows, 2))))
    c = (3 * L + 30) + ((D + 1) * (D + 3) + 7)
    df_check(emu.df_vecmat(xh, xl, Ah, Al, nslab, rps), want, exact, S, c)


def test_df_plans_cover_the_operator():
    """Every vector of a row lies in a slab, every row in a row slab, and
    no slab is empty."""
    for rows in (1, 2, 7, 121, 124, 1001, 5000):
        for n in (1, 3, 400, 2383, 65536, 200000):
            nslab, vps = tdf.matvec_plan(rows, n)
            assert nslab >= 1 and nslab * vps >= n // 4
            assert nslab == 1 or (nslab - 1) * vps < n // 4
            nslab, rps = tdf.vecmat_plan(rows, n)
            assert nslab * rps >= rows > (nslab - 1) * rps
