"""Port parity, the three kernel modules (pcg, schur, chol).

Each kernel's plain-PyTorch twin -- what the port runs on a CPU tensor --
is held against the reference's JAX function on the same numpy inputs:

* dd_matvec_residual_plain: within 2 eps |r| + 1e-28 sum_j |M_ij v_j| of the
  reference (both are compensated; the summation orders differ), and of
  the exactly rounded residual on an ill-conditioned 24 x 24 case;
* _psd_contrib_coo_plain / build_schur: rtol 1e-12 of max|M|;
* ldl_masked_plain: identical skip/add masks, L and d at rtol 1e-12.

The kernels themselves run only on the card: tests/test_torch_cuda.py
holds each against its twin there.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sedumi_tpu import chol as jchol
from sedumi_tpu import nt as jnt
from sedumi_tpu import opA as jopA
from sedumi_tpu import pcg as jpcg
from sedumi_tpu import schur as jschur
from sedumi_tpu import transform as jtf
from sedumi_tpu.examples import load_example
from sedumi_tpu.generators import feasible_problem
from sedumi_tpu.params import Pars as JPars
from sedumi_tpu.structs import ConeVec as JCV
from sedumi_tpu_torch import chol as tchol
from sedumi_tpu_torch import kernels
from sedumi_tpu_torch import nt as tnt
from sedumi_tpu_torch import opA as topA
from sedumi_tpu_torch import pcg as tpcg
from sedumi_tpu_torch import schur as tschur
from sedumi_tpu_torch.structs import ConeVec as TCV

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)

EPS = float(np.finfo(np.float64).eps)


def ill_conditioned(rng, m, cond):
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    M = (q * np.logspace(0, -np.log10(cond), m)) @ q.T
    return 0.5 * (M + M.T)


def residual_case(m, seed, cond=1e14):
    rng = np.random.default_rng(seed)
    M = ill_conditioned(rng, m, cond)
    rhs = rng.standard_normal(m)
    v = np.linalg.solve(M, rhs)        # cancellation-heavy residual
    return M, v, rhs


def residual_tol(M, v, r):
    return 2 * EPS * np.abs(r) + 1e-28 * (np.abs(M) @ np.abs(v))


# ------------------------------------------------------------------- K1


@pytest.mark.parametrize("m", [1, 7, 24, 123, 666])
def test_dd_residual_plain_matches_reference(m):
    M, v, rhs = residual_case(m, seed=m)
    r_j = np.asarray(jpcg.dd_matvec_residual(jnp.asarray(M), jnp.asarray(v),
                                             jnp.asarray(rhs)))
    r_t = tpcg.dd_matvec_residual(torch.as_tensor(M), torch.as_tensor(v),
                                  torch.as_tensor(rhs)).numpy()
    assert np.all(np.abs(r_t - r_j) <= residual_tol(M, v, r_j))


def test_dd_residual_plain_exact_rational():
    """24 x 24 Hilbert matrix (cond ~ 1e18 in f64): the compensated
    residual of v = H^-1 rhs against the exact rational one."""
    m = 24
    H = 1.0 / (np.arange(m)[:, None] + np.arange(m)[None, :] + 1.0)
    rng = np.random.default_rng(24)
    rhs = rng.standard_normal(m)
    v = np.linalg.solve(H, rhs)
    exact = np.array([float(Fraction(rhs[i]) - sum(
        Fraction(H[i, j]) * Fraction(v[j]) for j in range(m)))
        for i in range(m)])
    r_t = tpcg.dd_matvec_residual(torch.as_tensor(H), torch.as_tensor(v),
                                  torch.as_tensor(rhs)).numpy()
    # a plain f64 residual misses by ~eps sum|H v|; this one must not
    assert np.all(np.abs(r_t - exact) <= residual_tol(H, v, exact))
    plain = rhs - H @ v
    assert np.max(np.abs(plain - exact)) > 1e3 * np.max(
        np.abs(r_t - exact) + 1e-300)


def test_refine_and_pcg_match_reference():
    # cond 1e6: both solutions are accurate to ~1e-10, so they must agree
    # to 1e-8 (at cond ~ 1e9 they agree only to cond * eps)
    M, _, rhs = residual_case(60, seed=5, cond=1e6)
    fj = jchol.chol_factor(jnp.asarray(M), 0.0)
    ft = tchol.chol_factor(torch.as_tensor(M), 0.0)
    assert bool(fj.ok) and bool(ft.ok)
    xj = np.asarray(jpcg.refine_solve_dd(jnp.asarray(M), fj,
                                         jnp.asarray(rhs), iters=2))
    xt = tpcg.refine_solve_dd(torch.as_tensor(M), ft, torch.as_tensor(rhs),
                              iters=2).numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-8 * np.abs(xj).max())
    pj = jpcg.pcg(lambda u: jnp.asarray(M) @ u,
                  lambda b: jchol.chol_solve(fj, b), jnp.asarray(rhs),
                  jnp.asarray(xj), maxiter=12, restol=1e-16)
    pt = tpcg.pcg(lambda u: torch.as_tensor(M) @ u,
                  lambda b: tchol.chol_solve(ft, b), torch.as_tensor(rhs),
                  torch.as_tensor(xj.copy()), maxiter=12, restol=1e-16)
    np.testing.assert_allclose(pt.x.numpy(), np.asarray(pj.x), rtol=1e-8,
                               atol=1e-8 * np.abs(xj).max())


# ------------------------------------------------------------------- K2


def _interior(layout, rng):
    l = rng.random(layout.l) + 0.5
    q = [np.concatenate([rng.random((b.count, 1)) + 2.0,
                         0.3 * rng.standard_normal((b.count, b.dim - 1))],
                        axis=1) for b in layout.q_buckets]
    s = []
    for b in layout.s_buckets:
        a = rng.standard_normal((b.count, b.dim, b.dim))
        s.append(a @ a.transpose(0, 2, 1) / b.dim + 2 * np.eye(b.dim))
    return l, q, s


def _scalings(layout, seed):
    rng = np.random.default_rng(seed)
    x, z = _interior(layout, rng), _interior(layout, rng)

    def cvj(v):
        return JCV(l=jnp.asarray(v[0]), q=tuple(map(jnp.asarray, v[1])),
                   s=tuple(map(jnp.asarray, v[2])))

    def cvt(v):
        return TCV(l=torch.as_tensor(v[0]),
                   q=tuple(map(torch.as_tensor, v[1])),
                   s=tuple(map(torch.as_tensor, v[2])))

    return (jnt.compute_scaling(cvj(x), cvj(z)),
            tnt.compute_scaling(cvt(x), cvt(z)))


def _random_problem(seed, keep):
    rng = np.random.default_rng(seed)
    K = {"l": 3, "q": [4, 3], "s": [5, 5, 7]}
    At, b, c, Kspec = feasible_problem(K, 11, seed=seed)
    At = sp.csc_matrix(At)
    At.data[rng.random(At.nnz) > keep] = 0.0
    At.eliminate_zeros()
    return jtf.pretransfo(At, b, c, Kspec, JPars(fid=0))


def _schur_pair(prob, discount, seed):
    aj = jopA.build_coo_aop(prob.At, prob.c, prob.layout,
                            gemm_discount=discount)
    at = topA.build_coo_aop(prob.At, prob.c, prob.layout, device="cpu",
                            gemm_discount=discount)
    Sj, St = _scalings(prob.layout, seed)
    return aj, at, Sj, St


@pytest.mark.parametrize("seed,keep", [(7, 0.2), (8, 0.5), (9, 1.0)])
def test_psd_contrib_coo_plain_random_layouts(seed, keep):
    prob = _random_problem(seed, keep)
    aj, at, Sj, St = _schur_pair(prob, 0.0, seed)
    assert all(meta[0] == "coo" for meta in at.s_meta)
    mp1 = aj.m + 1
    for i, (rep, k, d, G, pad2, T) in enumerate(at.s_meta):
        Mj = np.asarray(jschur._psd_contrib_coo(aj.s_parts[i], k, d, G,
                                                pad2, mp1, Sj.s_r[i]))
        Mt = tschur._psd_contrib_coo(at.s_parts[i], k, d, G, pad2, mp1,
                                     St.s_r[i]).numpy()
        assert np.abs(Mt - Mj).max() <= 1e-12 * np.abs(Mj).max()


def test_psd_contrib_coo_plain_arch0():
    ex = load_example("arch0")
    prob = jtf.pretransfo(ex.At, ex.b, ex.c, ex.K, JPars(fid=0))
    aj, at, _, _ = _schur_pair(prob, 3.0, 0)
    rep, k, d, G, pad2, T = at.s_meta[0]
    assert rep == "coo"
    rng = np.random.default_rng(1)
    r = rng.standard_normal((k, d, d)) / np.sqrt(d) + np.eye(d)
    mp1 = aj.m + 1
    Mj = np.asarray(jschur._psd_contrib_coo(aj.s_parts[0], k, d, G, pad2,
                                            mp1, jnp.asarray(r)))
    Mt = tschur._psd_contrib_coo(at.s_parts[0], k, d, G, pad2, mp1,
                                 torch.as_tensor(r)).numpy()
    assert np.abs(Mt - Mj).max() <= 1e-12 * np.abs(Mj).max()


@pytest.mark.parametrize("discount", [0.0, 3.0, 1e9])
def test_build_schur_matches_reference(discount):
    """Whole augmented Schur complement (LP + SOC + PSD dense or coo)."""
    prob = _random_problem(11, 0.3)
    aj, at, Sj, St = _schur_pair(prob, discount, 11)
    Mj = np.asarray(jschur.build_schur(aj, Sj))
    Mt = tschur.build_schur(at, St).numpy()
    assert np.abs(Mt - Mj).max() <= 1e-12 * np.abs(Mj).max()


# ------------------------------------------------------------------- K3


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


CASES = {
    "spd": lambda: (lambda B: B @ B.T / 40 + np.eye(40))(
        np.random.default_rng(1).standard_normal((40, 40))),
    "indefinite": lambda: indefinite(60, 2),
    "arch0-size": lambda: indefinite(174, 3),
    "graded": lambda: ill_conditioned(np.random.default_rng(4), 50, 1e3),
}


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_ldl_masked_plain_matches_reference(case, skip):
    M = CASES[case]()
    fj = jchol.ldl_masked(jnp.asarray(M), skip_pivots=skip)
    ft = tchol.ldl_masked(torch.as_tensor(M), skip_pivots=skip)
    np.testing.assert_array_equal(ft.skip.numpy(), np.asarray(fj.skip))
    np.testing.assert_array_equal(ft.diagadd.numpy() > 0,
                                  np.asarray(fj.diagadd) > 0)
    for a, b in ((ft.L, fj.L), (ft.d, fj.d), (ft.diagadd, fj.diagadd)):
        a, b = a.numpy(), np.asarray(b)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin)
        scale = np.abs(b[fin]).max() if fin.any() else 1.0
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12,
                                   atol=1e-12 * scale)
    if case == "indefinite" and skip:
        assert ft.skip.any() and (ft.diagadd > 0).sum() > ft.skip.sum()
    rhs = np.random.default_rng(5).standard_normal(M.shape[0])
    xj = np.asarray(jchol.ldl_solve(fj, jnp.asarray(rhs)))
    xt = tchol.ldl_solve(ft, torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-9,
                               atol=1e-9 * np.abs(xj).max())


# ---------------------------------------------------- twins on the CPU


def test_kernel_wrappers_count_only_launches():
    """On CPU tensors the wrappers take the plain twins and count none."""
    kernels.reset_launch_counts()
    M, v, rhs = residual_case(8, 0)
    tpcg.dd_matvec_residual(*map(torch.as_tensor, (M, v, rhs)))
    tchol.ldl_masked(torch.as_tensor(indefinite(12, 0)))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
