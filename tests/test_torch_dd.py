"""Port parity, the dd64 rung: ddlinalg, ddengine and the [f64, dd64] ladder.

Reference and port side by side on the CPU, on the same seeded numpy
inputs (the port's wrappers take their plain-PyTorch twins on CPU
tensors; tests/test_torch_cuda.py holds the kernels K4-K7 against those
twins on the card):

* element ops (TwoSum, TwoProd, dd add/sub/mul/div/sqrt), the dd
  accumulation and the Ozaki split: bit for bit;
* dd_gemm: within the rounding bound of the slice products that are not
  exact, and at the long-double floor (the reference's own test);
* dd_chol / dd_chol_solve at cond 1e14: the factor against the
  reference's, and the reference's accuracy claims on the port;
* the dd GEMV kernel's lane order (tests/dd_emulation.py, which the card
  tests hold K6 and the fused dd_chol_solve to bit for bit): each product
  of a solve within the GEMV bound of the plain route, the solve against
  the reference's;
* K7's arrangement of the panel Cholesky (dd_emulation.panel_chol) bit
  for bit against the plain panel and the reference's one-panel dd_chol;
* DdSchurEngine.prepare/solve against the reference's engine (JAX through
  its pure_callback) from one scaling, dense and COO PSD buckets;
* the dd64 phase breaking the f64 floor end to end, with the reference's
  phases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dd_emulation as ddemu
from sedumi_tpu import ddengine as jddengine
from sedumi_tpu import ddlinalg as jdd
from sedumi_tpu import nt as jnt
from sedumi_tpu import opA as jopA
from sedumi_tpu import transform as jtf
from sedumi_tpu.generators import feasible_problem
from sedumi_tpu.params import Pars as JPars
from sedumi_tpu.structs import ConeVec as JCV
from sedumi_tpu_torch import convert, kernels
from sedumi_tpu_torch import ddengine as tddengine
from sedumi_tpu_torch import ddlinalg as tdd
from sedumi_tpu_torch import opA as topA

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)

EPS = float(np.finfo(np.float64).eps)
U = EPS / 2.0          # unit roundoff


def T(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def N(t):
    return t.numpy()


def same_bits(a, b) -> bool:
    return np.array_equal(np.asarray(a).view(np.int64),
                          np.asarray(b).view(np.int64))


def wide(rng, shape):
    """Values over many binades, with exact powers of two and zeros."""
    a = rng.standard_normal(shape) * np.exp2(rng.integers(-30, 30, shape))
    flat = a.reshape(-1)
    flat[::7] = np.exp2(rng.integers(-20, 20, flat[::7].shape))
    flat[::11] = 0.0
    return a


# ------------------------------------------------------------ element ops


def test_element_ops_bitwise():
    rng = np.random.default_rng(1)
    a, b = wide(rng, 4000), wide(rng, 4000)
    al, bl = a * 2.0**-60 * rng.random(4000), b * 2.0**-60 * rng.random(4000)
    bpos = np.abs(b) + 1e-3
    for name, args in [
            ("two_sum", (a, b)), ("two_prod", (a, b)),
            ("dd_mul", (a, al, b, bl)), ("dd_div", (a, al, bpos, bl)),
            ("dd_sqrt", (np.abs(a), np.abs(al)))]:
        ref = getattr(jdd, name)(*args)
        got = getattr(tdd, name)(*map(T, args))
        for r, g in zip(ref, got):
            assert same_bits(N(g), r), name
    for port, ref in [(tdd.dd_add, jdd.dd_add), (tdd.dd_sub, jdd.dd_sub)]:
        for r, g in zip(ref(a, al, b, bl), port(*map(T, (a, al, b, bl)))):
            assert same_bits(N(g), r), port.__name__
    # bl absent is bl = 0 (the reference's _form_dd passes zeros)
    for r, g in zip(jdd.dd_add(a, al, b, np.zeros_like(b)),
                    tdd.dd_add(T(a), T(al), T(b))):
        assert same_bits(N(g), r)


def test_accumulate_and_two_prod_cols_bitwise():
    """K5's twins: dd_gemm's TwoSum accumulation with the final normalise
    (ddlinalg.py:113-127), and two_prod(Al, d_l) (ddengine.py:53)."""
    rng = np.random.default_rng(2)
    parts = [wide(rng, (30, 20)) for _ in range(5)]
    Sh, Sl = parts[0].copy(), np.zeros((30, 20))
    for P in parts[1:]:
        Sh, e = jdd.two_sum(Sh, P)
        Sl += e
    Sh, Sl = jdd.dd_normalize(Sh, Sl)
    th, tl = T(parts[0]), torch.zeros(30, 20, dtype=torch.float64)
    for n, P in enumerate(parts[1:]):
        out = tdd.dd_accumulate(th, tl, T(P), normalize=n == 3)
        assert out[0] is th and out[1] is tl      # in place
    assert same_bits(N(th), Sh) and same_bits(N(tl), Sl)
    A, v = wide(rng, (30, 20)), wide(rng, 20)
    for r, g in zip(jdd.two_prod(A, v[None, :]), tdd.two_prod_cols(T(A),
                                                                   T(v))):
        assert same_bits(N(g), r)


@pytest.mark.parametrize("shape,axis,k", [
    ((40, 70), -1, 70), ((70, 40), 0, 70), ((175, 161), -1, 161),
    ((161, 161), 0, 161), ((12, 2048), -1, 2048), ((5, 1), 0, 5)])
def test_ozaki_split_bitwise(shape, axis, k):
    rng = np.random.default_rng(sum(shape))
    A = wide(rng, shape)
    A[1] = 0.0                                   # an all-zero line
    A[..., 0] = 0.0
    ref = jdd._ozaki_split(A, k, axis)
    got = tdd.ozaki_split(T(A), k, axis)
    assert all(same_bits(N(g), r) for g, r in zip(got, ref))
    # and on a transposed view (the kernel's flipped layout)
    got_t = tdd.ozaki_split(T(A.T).T, k, axis)
    assert all(same_bits(N(g), r) for g, r in zip(got_t, ref))


def test_split_bits_is_the_reference_t():
    for k in list(range(2, 70)) + [127, 128, 129, 16384, 16385, 10**6]:
        t_ref = max(1, (53 - max(int(np.ceil(np.log2(max(k, 2)))), 1)) // 2)
        assert tdd.split_bits(k) == t_ref, k


# -------------------------------------------------------------------- GEMM


def gamma_k(k):
    return k * U / (1 - k * U)


def _gemm_error_bound(A, B):
    """Elementwise bound on |dd_gemm(A, B) - A B| for either package: the
    slice products with slice 2 in them are the only inexact ones (each
    within gamma_k sum |A_i||B_j|); the Sl accumulation and the normalise
    add at most 16 u^2 |C|.  Slices from the reference's split."""
    k = A.shape[1]
    As, Bs = jdd._ozaki_split(A, k, -1), jdd._ozaki_split(B, k, 0)
    inexact = sum(np.abs(As[i]) @ np.abs(Bs[j]) for i in range(3)
                  for j in range(3) if 2 in (i, j))
    return gamma_k(k) * inexact + 16 * U * U * np.abs(A) @ np.abs(B)


def test_dd_gemm_matches_reference(rng):
    A = rng.normal(size=(60, 90)) * np.exp(rng.normal(size=(60, 90)) * 2)
    B = rng.normal(size=(90, 50))
    Al = A * 2.0**-55 * rng.random(A.shape)
    Bl = B * 2.0**-55 * rng.random(B.shape)
    for al, bl in [(None, None), (Al, Bl)]:
        rh, rl = jdd.dd_gemm(A, al, B, bl)
        th, tl = tdd.dd_gemm(T(A), None if al is None else T(al), T(B),
                             None if bl is None else T(bl))
        diff = (np.asarray(N(th), np.longdouble) + N(tl)) \
            - (np.asarray(rh, np.longdouble) + rl)
        bound = 2 * _gemm_error_bound(A, B)
        if al is not None:
            # the cross terms Ah Bl and Al Bh are f64 GEMMs, Al Bl is dropped
            bound = bound + 2 * (gamma_k(90) + U) * (
                np.abs(A) @ np.abs(Bl) + np.abs(Al) @ np.abs(B)) \
                + 2 * np.abs(Al) @ np.abs(Bl)
        assert np.all(np.abs(np.asarray(diff, np.float64)) <= bound)


def test_dd_gemm_beats_f64_on_the_port(rng):
    """The reference's test_dd_gemm_beats_f64 on the port."""
    m, k, n = 80, 120, 70
    A = rng.normal(size=(m, k)) * np.exp(rng.normal(size=(m, k)) * 2)
    B = rng.normal(size=(k, n))
    Ch, Cl = (N(t) for t in tdd.dd_gemm(T(A), None, T(B), None))
    ref = np.asarray(A, np.longdouble) @ np.asarray(B, np.longdouble)
    scale = np.max(np.abs(ref))
    err_dd = float(np.max(np.abs((np.asarray(Ch, np.longdouble) + Cl)
                                 - ref))) / scale
    err_f64 = float(np.max(np.abs(np.asarray(A @ B, np.longdouble)
                                  - ref))) / scale
    assert err_dd < 1e-17
    assert err_dd < err_f64 / 10


# ---------------------------------------------------------------- Cholesky


def ill_conditioned(rng, m, cond=1e14):
    q = np.linalg.qr(rng.normal(size=(m, m)))[0]
    A = (q * np.logspace(0, -np.log10(cond), m)) @ q.T
    return 0.5 * (A + A.T)


def test_dd_chol_matches_reference(rng):
    """m = 120 (three panels) at cond 1e14.  The panels' arithmetic is the
    reference's; only the trailing updates' cross terms and remainder
    slices round in another order (eps^2 level), so the factors agree to
    1e-20 of max|L| (dd forward error at cond 1e14 is ~1e-18 relative),
    the diagonal inverses to that times the panel's condition number, and
    the solves to 1e-12."""
    m = 120
    A = ill_conditioned(rng, m)
    f_j = jdd.dd_chol(A)
    f_t = tdd.dd_chol(T(A))
    assert f_j.ok and bool(f_t.ok)
    scale = np.abs(f_j.Lh).max()
    dL = (np.asarray(N(f_t.Lh), np.longdouble) + N(f_t.Ll)) \
        - (np.asarray(f_j.Lh, np.longdouble) + f_j.Ll)
    assert float(np.abs(dL).max()) <= 1e-20 * scale
    for p, ((ih, il), (jh, jl)) in enumerate(zip(f_t.inv_diag,
                                                 f_j.inv_diag)):
        dI = (np.asarray(N(ih), np.longdouble) + N(il)) \
            - (np.asarray(jh, np.longdouble) + jl)
        Lpp = f_j.Lh[48 * p:48 * (p + 1), 48 * p:48 * (p + 1)]
        assert float(np.abs(dI).max()) <= 1e-20 * np.linalg.cond(Lpp) \
            * np.abs(jh).max()
    b = rng.normal(size=m)
    xh_j, xl_j = jdd.dd_chol_solve(f_j, b)
    xh_t, xl_t = tdd.dd_chol_solve(f_t, T(b))
    assert np.abs(N(xh_t) - xh_j).max() <= 1e-12 * np.abs(xh_j).max()


def test_dd_chol_solve_ill_conditioned_on_the_port(rng):
    """The reference's test_dd_chol_solve_ill_conditioned on the port:
    at cond 1e14 the dd solve's residual is below 1e-5 and 100x below the
    f64 solve's."""
    m = 120
    A = ill_conditioned(rng, m)
    f = tdd.dd_chol(T(A))
    assert bool(f.ok)
    b = rng.normal(size=m)
    xh, xl = tdd.dd_chol_solve(f, T(b))
    r = np.asarray(b, np.longdouble) - np.asarray(A, np.longdouble) @ (
        np.asarray(N(xh), np.longdouble) + N(xl))
    rel_dd = float(np.linalg.norm(np.asarray(r, np.float64))) \
        / np.linalg.norm(b)
    xf = np.linalg.solve(A, b)
    rel_f64 = np.linalg.norm(b - A @ xf) / np.linalg.norm(b)
    assert rel_dd < 1e-5
    assert rel_dd < rel_f64 / 100


def exact_gemv_err(Ah, Al, xh, xl, yh, yl):
    """|(Ah + Al)(xh + xl) - (yh + yl)| per row, the product exact (as
    Fractions), the difference rounded once."""
    from fractions import Fraction as Q
    x = [Q(h) + Q(l) for h, l in zip(xh, xl)]
    return np.array([
        float(abs(sum((Q(h) + Q(l)) * xj for h, l, xj in zip(rh, rl, x))
                  - Q(y) - Q(z)))
        for rh, rl, y, z in zip(Ah, Al, yh, yl)])


def test_dd_chol_solve_lane_order_emulation(rng):
    """dd_chol_solve in K6's lane order (tests/dd_emulation.py) at m = 100
    (panels of 48, 48 and a partial 4), cond 1e14, with a dd right-hand
    side.  Each product of the solve (the forward and backward panel
    products, both diagonal-inverse products) is within half the bound
    of chip_smoke.check_dd_gemv, (n + 4)^2 u^2 sum_j |A_ij| |x_j|, of the
    exact product.  (The plain route, the Ozaki dd_gemm, is not: its
    slices are scaled by the largest |x_j|, and this solve's x spans
    many binades, so its error on the last forward panel is ~100x that
    bound.)  The solve lands within 1e-18 of max|z| of the plain route's
    on the same factor (two dd solves whose products differ below 1e-23
    relative, at cond(L) ~ 1e7), and within 1e-12 of the reference's
    (test_dd_chol_matches_reference's tolerance: the two factors differ
    at eps^2)."""
    m = 100
    A = ill_conditioned(rng, m)
    f = tdd.dd_chol(T(A))
    assert bool(f.ok)
    b = rng.normal(size=m)
    bl = b * 2.0**-54 * rng.random(m)
    ratios = []

    def gemv(Ah, Al, xh, xl):
        yh, yl = ddemu.gemv(Ah, Al, xh, xl)
        n = Ah.shape[1]
        tol = (n + 4) ** 2 * U * U * (np.abs(Ah) @ np.abs(xh))
        err = exact_gemv_err(Ah, Al, xh, xl, yh, yl)
        ratios.append(float(np.max(err / tol)))
        return yh, yl

    inv = [(N(h), N(l)) for h, l in f.inv_diag]
    assert [ih.shape[0] for ih, _ in inv] == [48, 48, 4]
    zh, zl = ddemu.dd_chol_solve(N(f.Lh), N(f.Ll), inv, f.nb, b, bl,
                                 gemv=gemv)
    # 3 diagonal products and 2 panel products each way
    assert len(ratios) == 10 and max(ratios) <= 1.0, ratios
    ph, pl = (N(t) for t in tdd.dd_chol_solve(f, T(b), T(bl)))
    dz = (np.asarray(zh, np.longdouble) + zl) \
        - (np.asarray(ph, np.longdouble) + pl)
    assert float(np.abs(dz).max()) <= 1e-18 * np.abs(ph).max()
    f_j = jdd.dd_chol(A)
    xh_j, _ = jdd.dd_chol_solve(f_j, b, bl)
    assert np.abs(zh - xh_j).max() <= 1e-12 * np.abs(xh_j).max()


def test_dd_chol_pivot_rule_matches_reference():
    """A non-positive pivot is replaced by max(|d|, 1e-300), flags ok =
    False, and the factor still matches the reference's panel arithmetic
    (one panel: no trailing update, so bit for bit)."""
    rng = np.random.default_rng(5)
    B = rng.normal(size=(40, 40))
    A = B @ B.T / 40 + np.eye(40)
    A[7, 7] = -2.0
    A[20, :] = 0.0
    A[:, 20] = 0.0
    with np.errstate(all="ignore"):   # the 1e-300 pivot overflows L
        f_j = jdd.dd_chol(A)
    f_t = tdd.dd_chol(T(A))
    assert not f_j.ok and not bool(f_t.ok)
    fin = np.isfinite(f_j.Lh)
    assert np.array_equal(np.isfinite(N(f_t.Lh)), fin)
    assert same_bits(N(f_t.Lh)[fin], f_j.Lh[fin])
    assert same_bits(N(f_t.Ll)[fin], f_j.Ll[fin])


def panel_case(case, nr=100, w=48):
    """A panel S [nr, w] of an SPD matrix of order nr: cond 1e14, a
    non-positive pivot, a zero row and column (zero numerators over
    pivots and diagonal entries of both signs), or a NaN pivot."""
    rng = np.random.default_rng(nr + w)
    if case == "cond":
        A = ill_conditioned(rng, nr)
    else:
        B = rng.normal(size=(nr, nr))
        A = B @ B.T / nr + np.eye(nr)
        A[7, 7] = -2.0
        if case == "zeros":
            A[20, :] = 0.0
            A[:, 20] = 0.0
        elif case == "nan":
            A[30, 30] = np.nan
    return A[:, :w].copy(), A[:, :w] * 2.0**-55


def bits_or_nan(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.all(
        (a.view(np.int64) == b.view(np.int64)) | (np.isnan(a) & np.isnan(b))))


@pytest.mark.parametrize("case", ["cond", "pivot", "zeros", "nan"])
@pytest.mark.parametrize("nr", [48, 100])
def test_dd_panel_chol_lane_order_emulation(case, nr):
    """K7's arrangement (dd_emulation.panel_chol: the diagonal block's
    factor on its lower triangle, each row below a chain over the columns
    against it, each column of the inverse its own substitution, with
    qdiv's signed zeros) gives dd_panel_chol_plain's L, inverse and ok bit
    for bit (NaN where it has NaN): the order of each entry's operations
    is the plain version's."""
    Sh, Sl = panel_case(case, nr)
    got = ddemu.panel_chol(Sh, Sl)
    want = tdd.dd_panel_chol_plain(T(Sh), T(Sl))
    for a, b in zip(got[:4], want[:4]):
        assert bits_or_nan(a, N(b))
    assert got[4] == bool(want[4]) == (case == "cond")


def test_dd_panel_chol_emulation_is_the_reference_panel():
    """On one panel (m = 40, no trailing update) K7's arrangement is the
    reference's dd_chol bit for bit, L and the diagonal inverse, with a
    non-positive pivot and a zero row and column (finite entries; the
    1e-300 pivot overflows L)."""
    Sh, _ = panel_case("zeros", 40, 40)
    Lh, Ll, Ih, Il, ok = ddemu.panel_chol(Sh, np.zeros_like(Sh))
    with np.errstate(all="ignore"):
        f_j = jdd.dd_chol(Sh)
    assert not f_j.ok and not ok
    (jh, jl), = f_j.inv_diag
    for a, b in ((Lh, f_j.Lh), (Ll, f_j.Ll), (Ih, jh), (Il, jl)):
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin)
        assert same_bits(a[fin], b[fin])


# ------------------------------------------------------------------ engine


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


def _engine_inputs(K, discount, seed=12):
    At, b, c, Ks = feasible_problem(K, 12, seed=seed)
    prob = jtf.pretransfo(At, b, c, Ks, JPars(fid=0))
    aop_j = jopA.build_coo_aop(prob.At, prob.c, prob.layout,
                               gemm_discount=discount)
    aop_t = topA.build_coo_aop(prob.At, prob.c, prob.layout, device="cpu",
                               gemm_discount=discount)
    rng = np.random.default_rng(seed)
    x, z = (_interior(prob.layout, rng) for _ in range(2))

    def cvj(v):
        return JCV(l=jnp.asarray(v[0]), q=tuple(map(jnp.asarray, v[1])),
                   s=tuple(map(jnp.asarray, v[2])))

    S_j = jnt.compute_scaling(cvj(x), cvj(z))
    S_t = convert.scaling_from_numpy(
        jax.tree_util.tree_map(np.asarray, S_j), device="cpu")
    return aop_j, aop_t, S_j, S_t, rng.standard_normal(aop_j.m)


@pytest.mark.parametrize("discount,reg", [(3.0, 0.0), (1e-9, 0.0),
                                          (3.0, 1e-9)])
def test_dd_engine_matches_reference(discount, reg):
    """prepare/solve from one scaling.  The SOC term is formed in f64 in
    both packages by differently ordered sums, so M agrees to 1e-14 of
    max|M| (eps-level), the LP and PSD terms far below that; the directions
    agree to 1e-12 relative."""
    aop_j, aop_t, S_j, S_t, rhs = _engine_inputs(
        {"l": 4, "q": [3, 4], "s": [6, 5]}, discount)
    want = "coo" if discount < 1 else "dense"
    assert all(meta[0] == want for meta in aop_t.s_meta)
    eng_j, eng_t = jddengine.DdSchurEngine(), tddengine.DdSchurEngine()
    ctx_j, ahc_j, chc_j, ok_j = eng_j.prepare(aop_j, S_j, jnp.float64(reg))
    ctx_t, ahc_t, chc_t, ok_t = eng_t.prepare(aop_t, S_t, reg)
    assert bool(ok_j) and ok_t
    Mj = np.asarray(ctx_j[0], np.longdouble) + np.asarray(ctx_j[1])
    m = aop_j.m
    Mt = np.asarray(N(ctx_t[0]), np.longdouble) + N(ctx_t[1])
    scale = float(np.abs(Mj).max())
    assert float(np.abs(Mt - Mj[:m, :m]).max()) <= 1e-14 * scale
    assert np.abs(N(ahc_t) - np.asarray(ahc_j)).max() <= 1e-14 * scale
    assert abs(float(chc_t) - float(chc_j)) <= 1e-14 * scale
    x_j = np.asarray(eng_j.solve(ctx_j, jnp.asarray(rhs)))
    x_t = N(eng_t.solve(ctx_t, T(rhs)))
    assert np.abs(x_t - x_j).max() <= 1e-12 * np.abs(x_j).max()


def test_dd_engine_lp_psd_terms_in_dd():
    """Without SOC cones every term is formed in dd: the port's M agrees
    with the reference's to the dd level, 1e-26 of max|M|."""
    aop_j, aop_t, S_j, S_t, _ = _engine_inputs({"l": 4, "s": [6, 5]}, 3.0)
    ctx_j = jddengine.DdSchurEngine().prepare(aop_j, S_j,
                                              jnp.float64(0.0))[0]
    ctx_t = tddengine.DdSchurEngine().prepare(aop_t, S_t, 0.0)[0]
    m = aop_j.m
    Mj = (np.asarray(ctx_j[0], np.longdouble)
          + np.asarray(ctx_j[1]))[:m, :m]
    Mt = np.asarray(N(ctx_t[0]), np.longdouble) + N(ctx_t[1])
    assert float(np.abs(Mt - Mj).max()) <= 1e-26 * float(np.abs(Mj).max())


def test_wrappers_count_no_launch_on_cpu():
    """On CPU tensors the K4-K7 wrappers take their twins and count none."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    A = T(ill_conditioned(rng, 60, 1e6))
    f = tdd.dd_chol(A)
    tdd.dd_chol_solve(f, T(rng.normal(size=60)))
    tdd.two_prod_cols(A, A[0])
    assert all(n == 0 for n in kernels.LAUNCHES.values())


# --------------------------------------------------------------- end to end


def test_dd64_phase_breaks_f64_floor_on_the_port():
    """The reference's test_dd64_phase_breaks_f64_floor on the port: with
    eps = 1e-11 and no terminal refinement the f64 phase hits its floor,
    escalates, and dd64 delivers r0 <= 1e-10; the phases are the
    reference's on the same problem."""
    import sedumi_tpu
    import sedumi_tpu_torch as pt

    K = {"l": 4, "s": [6, 5]}
    At, b, c, _ = feasible_problem(K, 12, seed=3)
    pars = {"fid": 0, "eps": 1e-11, "refine": 0}
    _, _, info_j = sedumi_tpu.sedumi(At, b, c, K, pars)
    _, _, info_t = pt.sedumi(At, b, c, K, pars, device="cpu")
    assert info_t["r0"] <= 1e-10, info_t
    assert "dd64" in info_t["phases"]
    assert set(info_t["phases"]) == set(info_j["phases"])
    assert (info_t["pinf"], info_t["dinf"], info_t["numerr"]) == \
        (info_j["pinf"], info_j["dinf"], info_j["numerr"])


@pytest.mark.parametrize("name,admitted", [
    ("quantum", True), ("nb", True), ("arch0", True), ("control07", True),
    ("trto3", False), ("OH_2Pi_STO-6GN9r12g1T2", False)])
def test_dd64_gate_admits_the_reference_set(name, admitted):
    """The reference's gate: quantum, nb, arch0 (~4.1e10) and control07
    (~1.4e11) are admitted; trto3 and OH are not."""
    from sedumi_tpu.examples import load_example
    from sedumi_tpu_torch import solver as tsolver
    from sedumi_tpu_torch import transform as ttf
    from sedumi_tpu_torch.params import Pars as TPars

    ex = load_example(name)
    prob = ttf.pretransfo(ex.At, ex.b, ex.c, ex.K, TPars(fid=0))
    m = prob.At.shape[1]
    assert tsolver.dd64_admitted(prob.layout, m) == admitted
    cost = tsolver.dd_form_cost(prob.layout, m)
    if name == "arch0":
        assert 3.5e10 < cost < 4.5e10
    if name == "control07":
        assert 1.2e11 < cost < 1.6e11
