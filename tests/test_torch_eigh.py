"""Port parity, the Jacobi eigensolver: lax_eigh (the plain versions of
kernels K12/K13), linalg_ops' dispatch and multi-bucket batches, the
coarse budgets of nt/wregion under Jacobi, the per-phase table of the
solver, and one whole solve under Jacobi, against the reference.

Inputs come from numpy seeds and go through both packages on the CPU.
The eigensolver is chosen with impl_override or monkeypatch.setenv, never
a bare os.environ write (a file runs in one worker process).  Tolerances,
each with its reason:

* Eigenvalues in the same unsorted slots, within rtol * max|w|: rtol
  1e-12 in f64 and 1e-5 in f32.  Both packages run the same rotations in
  the same order, but XLA's CPU code fuses products into FMAs and torch's
  CPU sqrt is not correctly rounded, so the two round differently in the
  last bit of each rotation (measured: 1.3e-14 in f64 and 4.6e-6 in f32 at
  n = 40).
* Eigenvectors: 1e-10 in f64 and 2e-3 in f32 (their perturbation is
  ~eps ||A|| / gap; measured 4.1e-14 and 3.2e-5).
* Against LAPACK: the reference's own accuracy tests
  (tests/test_lax_eigh.py, tests/test_herm_native.py) at their bounds.
* Scalings, step bounds and spectra under Jacobi: rtol 1e-10 of each
  output's largest entry (the frames of R are the Jacobi's own, the same
  in both packages, so R itself is compared).
* The whole solve: the same phases and iterations, numerr, pinf and
  dinf, and c'x within 1e-9 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sedumi_tpu import lax_eigh as jle
from sedumi_tpu import linalg_ops as jlo
from sedumi_tpu import nt as jnt
from sedumi_tpu import wregion as jwr
from sedumi_tpu.cones import Layout as JLayout
from sedumi_tpu_torch import lax_eigh as tle
from sedumi_tpu_torch import linalg_ops as tlo
from sedumi_tpu_torch import nt as tnt
from sedumi_tpu_torch import solver as tsolver
from sedumi_tpu_torch import wregion as twr
from sedumi_tpu_torch.cones import Layout
from test_torch_cones import close, random_pair, soc_interior, sym, to_j, \
    to_t

torch.set_num_threads(1)

F32 = torch.float32
TOL_W = {np.float64: 1e-12, np.float32: 1e-5, np.complex128: 1e-12,
         np.complex64: 1e-5}
TOL_V = {np.float64: 1e-10, np.float32: 2e-3, np.complex128: 1e-10,
         np.complex64: 2e-3}


def sym_or_herm(rng, k, n, dt):
    a = rng.standard_normal((k, n, n))
    if np.dtype(dt).kind == "c":
        a = a + 1j * rng.standard_normal((k, n, n))
    return (0.5 * (a + np.conj(a.transpose(0, 2, 1)))).astype(dt)


def same_slots(wt, wj, dt):
    wj = np.asarray(wj)
    wt = wt.numpy()
    assert wt.shape == wj.shape
    assert np.max(np.abs(wt - wj)) <= TOL_W[dt] * np.max(np.abs(wj))


# ------------------------------------------------------------ schedule


def test_schedule_and_budgets_match_reference():
    for n in range(2, 42, 2):
        np.testing.assert_array_equal(tle._round_robin_schedule(n),
                                      jle._round_robin_schedule(n))
    for n in (2, 15, 16, 17, 64, 65, 161, 256, 257, 322, 600):
        for dj, dt in ((None, None), (np.float64, torch.float64),
                       (np.float32, torch.float32), ("float32", F32)):
            assert tle._sweeps_for(n, dt) == jle._sweeps_for(n, dj)
            assert tle.coarse_sweeps_for(n, dt) == \
                jle.coarse_sweeps_for(n, dj)


def test_closed_form_schedule_matches_table():
    """K12's kernels compute each round's pivot pairs from the closed form
    (slot 0 holds player 0, the tail turns right by one a round) instead
    of loading the table: the form against _round_robin_schedule."""
    for n in list(range(2, 130, 2)) + [162, 170, 322, 546]:
        np.testing.assert_array_equal(tle.closed_form_schedule(n),
                                      tle._round_robin_schedule(n))


# ------------------------------------- the fused step, emulated
#
# Elements carry a trailing component axis: [..., 1] for a real matrix,
# [..., 2] (re, im) for a Hermitian one.  RealOps and HermOps hold the
# kernels' element arithmetic (csrc/jacobi_eigh.cu RealTraits,
# csrc/jacobi_herm.cu HermTraits): the complex products written as the
# kernel writes them, (ac - bd, ad + bc) with each real product and sum
# rounded on its own.


class RealOps:
    @staticmethod
    def rotation(app, aqq, apq, ueps):
        _, c, s = tle._angle(app[..., 0], aqq[..., 0], apq[..., 0], ueps)
        return c[..., None], s[..., None]

    @staticmethod
    def row(c, s, xp, xq):
        return c * xp - s * xq, s * xp + c * xq

    col = row


def cmul(a, b):
    a0, a1, b0, b1 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    return torch.stack([a0 * b0 - a1 * b1, a0 * b1 + a1 * b0], -1)


def conj(a):
    return torch.stack([a[..., 0], -a[..., 1]], -1)


class HermOps:
    """HermTraits: the real angle of (re a_pp, re a_qq, hypot(a_pq)), the
    phase u = a_pq / |a_pq| (1 if small) folded into s u; rows p, q <- c
    A_p - su A_q, conj(su) A_p + c A_q; columns p, q <- c A_p - conj(su)
    A_q, su A_p + c A_q; c enters as the element (c, 0)."""

    @staticmethod
    def rotation(app, aqq, apq, ueps):
        mag = torch.hypot(apq[..., 0], apq[..., 1])
        small, c, s = tle._angle(app[..., 0], aqq[..., 0], mag, ueps)
        m1 = mag.masked_fill(small, 1.0)
        u = torch.stack([torch.where(small, 1.0, apq[..., 0] / m1),
                         torch.where(small, 0.0, apq[..., 1] / m1)], -1)
        zero = torch.zeros_like(c)
        return (torch.stack([c, zero], -1),
                cmul(torch.stack([s, zero], -1), u))

    @staticmethod
    def row(c, su, xp, xq):
        return (cmul(c, xp) - cmul(su, xq),
                cmul(conj(su), xp) + cmul(c, xq))

    @staticmethod
    def col(c, su, xp, xq):
        return (cmul(c, xp) - cmul(conj(su), xq),
                cmul(su, xp) + cmul(c, xq))


def round_rotations(A, p, q, ops, ueps):
    return ops.rotation(A[..., p, p, :], A[..., q, q, :], A[..., p, q, :],
                        ueps)


def three_step_round(A, V, p, q, c, s, ops):
    """One round as the plain version and the device-memory kernel run it:
    rows p, q of A by each pair's rotation, then columns p, q of A and
    V."""
    ck, sk = c[..., :, None, :], s[..., :, None, :]
    A[..., p, :, :], A[..., q, :, :] = ops.row(ck, sk, A[..., p, :, :],
                                               A[..., q, :, :])
    cl, sl = c[..., None, :, :], s[..., None, :, :]
    for M in (A, V):
        M[..., :, p, :], M[..., :, q, :] = ops.col(cl, sl, M[..., :, p, :],
                                                   M[..., :, q, :])


def fused_block_round(A, V, p, q, c, s, ops):
    """One round as the block variant computes it: each 2 x 2 block
    {p_k, q_k} x {p_l, q_l} of A rotated by rotation k over its rows, then
    by rotation l over its columns; each row of V by the column
    rotations."""
    P, Q, Pl, Ql = p[:, None], q[:, None], p[None, :], q[None, :]
    ck, sk = c[..., :, None, :], s[..., :, None, :]
    cl, sl = c[..., None, :, :], s[..., None, :, :]
    app, apq = A[..., P, Pl, :], A[..., P, Ql, :]
    aqp, aqq = A[..., Q, Pl, :], A[..., Q, Ql, :]
    rpp, rqp = ops.row(ck, sk, app, aqp)
    rpq, rqq = ops.row(ck, sk, apq, aqq)
    A[..., P, Pl, :], A[..., P, Ql, :] = ops.col(cl, sl, rpp, rpq)
    A[..., Q, Pl, :], A[..., Q, Ql, :] = ops.col(cl, sl, rqp, rqq)
    V[..., :, p, :], V[..., :, q, :] = ops.col(cl, sl, V[..., :, p, :],
                                               V[..., :, q, :])


def colrot(R, pairs, c, s, ops):
    """R's columns rotated by one round's column rotations (pairs [h, 2],
    c, s [h, comps])."""
    out = R.clone()
    p, q = pairs[:, 0], pairs[:, 1]
    out[..., p, :], out[..., q, :] = ops.col(c, s, R[..., p, :],
                                             R[..., q, :])
    return out


def cluster_sweep(A, V, C, ueps, ops):
    """One sweep as the cluster variant computes it on a matrix A (and
    its V) over C CTAs: CTA c holds the rows of the round's pairs
    [c h / C, (c+1) h / C) at positions 2 (k - c h / C) + side (side 0:
    slot k, side 1: slot n-1-k), and stores A' = the round's rows rotated
    and its columns not yet (the column rotation of round r is applied in
    round r + 1, from the broadcast rotations, and after the last round);
    V's rows stay where they are.  Each round: each pair's rotation from
    its own rows' pivots, then each row column-rotated by the previous
    round and row-rotated by this one, written to the position (in
    whichever CTA) of its pair next round.  Returns A and V after the
    sweep."""
    n = A.shape[-2]
    h, m = n // 2, n - 1
    assert C <= h
    k = np.arange(h)

    def player(r, t):
        return np.where(t == 0, 0, np.where(t - r >= 1, t - r, t - r + m))

    def slot(r, x):
        return np.where(x == 0, 0, np.where(x + r <= m, x + r, x + r - m))

    def place(r, x):
        """(CTA, position) of row x in round r."""
        t = slot(r, x)
        kk = np.minimum(t, n - 1 - t)
        c = ((kk + 1) * C - 1) // h
        return (torch.as_tensor(c),
                torch.as_tensor(2 * (kk - c * h // C) + (t > n - 1 - t)))

    # the two rows of pair k, as (CTA, position) index tensors
    ka, kb = place(0, player(0, k)), place(0, player(0, n - 1 - k))
    bufs = torch.zeros((C, 2 * -(-h // C)) + A.shape[-2:], dtype=A.dtype)
    bufs[ka] = A[player(0, k)]
    bufs[kb] = A[player(0, n - 1 - k)]
    V = V.clone()
    prev = None
    for r in range(n - 1):
        a, b = player(r, k), player(r, n - 1 - k)
        ra, rb = bufs[place(r, a)], bufs[place(r, b)]
        if prev is not None:
            ra, rb = colrot(ra, *prev, ops), colrot(rb, *prev, ops)
        isp = torch.as_tensor(a < b)[:, None, None]
        rp, rq = torch.where(isp, ra, rb), torch.where(isp, rb, ra)
        p = torch.as_tensor(np.minimum(a, b))
        q = torch.as_tensor(np.maximum(a, b))
        kt = torch.as_tensor(k)
        c_r, s_r = ops.rotation(rp[kt, p], rq[kt, q], rp[kt, q], ueps)
        nxt = torch.zeros_like(bufs)
        nxt[place(r + 1, p.numpy())], nxt[place(r + 1, q.numpy())] = \
            ops.row(c_r[:, None], s_r[:, None], rp, rq)
        if prev is not None:
            V = colrot(V, *prev, ops)
        bufs = nxt
        prev = (torch.stack([p, q], -1), c_r, s_r)
    out = torch.empty_like(A)
    out[player(0, k)] = colrot(bufs[ka], *prev, ops)
    out[player(0, n - 1 - k)] = colrot(bufs[kb], *prev, ops)
    return out, colrot(V, *prev, ops)


FUSED_CASES = {"odd17": (17, 2, 17), "n60": (60, 2, 60),
               "n162": (162, 1, 162), "nan": (12, 3, 12)}
# order 162 is K12's: the complex cases stop at K13's 60
FUSED_DTYPES = [(case, dt) for case in FUSED_CASES
                for dt in (np.float32, np.float64, np.complex64,
                           np.complex128)
                if case != "n162" or np.dtype(dt).kind == "f"]


@pytest.mark.parametrize("kernel", ["block", "cluster"])
@pytest.mark.parametrize("case,dt", FUSED_DTYPES)
def test_fused_step_is_the_plain_round_bit_for_bit(case, dt, kernel):
    """The fused 2 x 2-block step (block variant) and its pairs-per-CTA
    form with the column rotations one round late (cluster variant, with
    its storage and row moves between CTAs), emulated round by round in
    torch ops with the closed-form pairs, against the three-step round
    (all rows, then all columns) written with the same element arithmetic:
    after a sweep, all of A and V bit for bit (NaN where the three-step
    round has NaN), at a padded odd order, at K13's order 60, at order
    162 and on a batch with a NaN.  For a real dtype the three-step round
    is also _sweep_loop's, bit for bit (K12); for a complex dtype the
    complex products are the kernel's (each real product and sum rounded
    on its own, not torch's complex multiply), as K13's device-memory
    sweep computes them."""
    seed, k, n0 = FUSED_CASES[case]
    rng = np.random.default_rng(seed)
    A = sym_or_herm(rng, k, n0, dt)
    if case == "nan":
        A[1, 2, 5] = A[1, 5, 2] = np.nan
    AV = tle._start(torch.as_tensor(A), True)
    n = AV.shape[-1]
    herm = np.dtype(dt).kind == "c"
    ops = HermOps if herm else RealOps
    ueps = float(np.finfo(dt).eps)
    parts = torch.view_as_real(AV) if herm else AV[..., None]
    want = parts.clone()
    sched = torch.as_tensor(tle.closed_form_schedule(n), dtype=torch.long)
    for r in range(n - 1):
        p, q = sched[r, :, 0], sched[r, :, 1]
        Aw, Vw = want[..., :n, :, :], want[..., n:, :, :]
        c, s = round_rotations(Aw, p, q, ops, ueps)
        three_step_round(Aw, Vw, p, q, c, s, ops)
    if not herm:
        plain = AV.clone()
        tle._sweep_loop(plain, n, 1, 0, ueps, tle._real_rotations(ueps))
        nan = torch.isnan(plain)
        assert torch.equal(torch.isnan(want[..., 0]), nan)
        assert torch.equal(want[..., 0][~nan], plain[~nan])
    Ak, Vk = parts[..., :n, :, :].clone(), parts[..., n:, :, :].clone()
    if kernel == "block":
        for r in range(n - 1):
            p, q = sched[r, :, 0], sched[r, :, 1]
            c, s = round_rotations(Ak, p, q, ops, ueps)
            fused_block_round(Ak, Vk, p, q, c, s, ops)
    else:
        # the cluster sizes the plan takes at these orders: 2 and 8 CTAs
        C = 2 if n < 64 else 8
        for i in range(Ak.shape[0]):
            Ak[i], Vk[i] = cluster_sweep(Ak[i], Vk[i], C, ueps, ops)
    got = torch.cat([Ak, Vk], dim=-3)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert bool(nan.any()) == (case == "nan")
    assert torch.equal(got[~nan], want[~nan])


def test_jacobi_plan_edges():
    """The plan at each edge: one block's shared memory (with vectors: f32
    up to 168, f64 and complex64 up to 118, complex128 up to 84), each
    cluster size's capacity at a batch that fills the card (the fewest
    CTAs that hold the matrix), the largest cluster's capacity (then
    device memory), the per-dtype block/cluster crossover and the
    spreading of a small batch over more CTAs."""
    f32, f64 = torch.float32, torch.float64
    c64, c128 = torch.complex64, torch.complex128
    big = tle.NUM_SMS  # a batch that leaves no SM idle
    plan = tle.jacobi_plan
    for dt, vec, block, caps in (
            (f32, True, 168, {2: 194, 4: 272, 8: 384, 16: 544}),
            (f64, True, 118, {2: 136, 4: 192, 8: 272, 16: 384}),
            (f32, False, 238, {4: 336, 8: 472, 16: 672}),
            (f64, False, 168, {4: 236, 8: 334, 16: 466}),
            (c64, True, 118, {2: 136, 4: 192, 8: 272, 16: 384}),
            (c64, False, 168, {4: 236, 8: 334, 16: 466}),
            (c128, True, 84, {2: 96, 4: 136, 8: 192, 16: 262}),
            (c128, False, 118, {4: 166, 8: 232, 16: 320})):
        assert tle.smem_bytes(block, dt, vec) <= tle.SMEM_MAX \
            < tle.smem_bytes(block + 2, dt, vec)
        assert plan(block, dt, vec, big) == ("block", 1)
        prev = block
        for c, cap in caps.items():
            assert tle.cluster_fits(cap, dt, vec, c)
            assert not tle.cluster_fits(cap + 2, dt, vec, c)
            assert plan(prev + 2, dt, vec, big) == ("cluster", c)
            assert plan(cap, dt, vec, big) == ("cluster", c)
            prev = cap
        assert plan(prev + 2, dt, vec, big) == ("device", 1)
        assert plan(prev + 2, dt, vec, 1) == ("device", 1)
    # every CTA owns a pair
    assert not tle.cluster_fits(30, f32, True, 16)
    assert tle.cluster_fits(32, f32, True, 16)
    # a batch of one NT bucket spreads over MAX_CLUSTER CTAs; below
    # CLUSTER_MIN_N (by dtype) one block, with or without vectors
    for n, dt in ((162, f32), (322, f32), (162, f64), (322, f64),
                  (120, c128), (200, c128), (120, c64)):
        assert plan(n, dt, True, 1) == ("cluster", tle.MAX_CLUSTER)
    assert tle.CLUSTER_MIN_N == {f32: 100, f64: 80, c64: 72, c128: 56}
    for dt in (f32, f64, c64, c128):
        n = tle.CLUSTER_MIN_N[dt]
        for vec in (True, False):
            assert plan(n - 2, dt, vec, 1) == ("block", 1)
            assert plan(n, dt, vec, 1) == ("cluster", tle.MAX_CLUSTER)
    # K13's timed case: 2 x 60 takes 16 CTAs in complex128, one block in
    # complex64
    assert plan(60, c128, True, 2) == ("cluster", tle.MAX_CLUSTER)
    assert plan(60, c64, True, 2) == ("block", 1)
    assert plan(2, f32, True, 1) == ("block", 1)
    # the batch caps the spread (batch x C <= SMs); one block where it
    # holds the matrix and the cluster would have fewer than
    # CLUSTER_MIN_CTAS CTAs or more CTAs than the card has SMs
    for batch, want in ((8, ("cluster", 16)), (9, ("cluster", 8)),
                        (17, ("cluster", 4)), (33, ("cluster", 4)),
                        (34, ("block", 1)), (67, ("block", 1))):
        assert plan(162, f32, True, batch) == want, batch
    assert plan(238, f32, False, 33) == ("cluster", 4)
    assert plan(238, f32, False, 34) == ("block", 1)
    assert plan(322, f32, True, 40) == ("cluster", 8)
    assert plan(4, f32, True, 2500) == ("block", 1)
    with pytest.raises(ValueError):
        plan(161, f32, True, 1)


# ------------------------------------------------ plain K12 / K13 twins


@pytest.mark.parametrize("dt", [np.float64, np.float32, np.complex128,
                                np.complex64])
@pytest.mark.parametrize("n", [2, 3, 5, 8, 17, 40])
def test_jacobi_matches_reference(n, dt):
    """Full and coarse budgets, with and without vectors: the reference's
    eigenvalues in the same slots and its eigenvectors."""
    rng = np.random.default_rng(100 + n)
    A = sym_or_herm(rng, 3, n, dt)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    if np.dtype(dt).kind == "c":
        wj, Vj = jle.jacobi_eigh_herm(Aj)
        wt, Vt = tle.jacobi_eigh_herm(At)
        same_slots(wt, wj, dt)
        assert np.max(np.abs(Vt.numpy() - np.asarray(Vj))) <= TOL_V[dt]
        return
    for sw in (None, jle.coarse_sweeps_for(n, dt)):
        wj, Vj = jle.jacobi_eigh(Aj, sweeps=sw, sort=False)
        wt, Vt = tle.jacobi_eigh(At, sweeps=sw, sort=False)
        same_slots(wt, wj, dt)
        assert np.max(np.abs(Vt.numpy() - np.asarray(Vj))) <= TOL_V[dt]
        same_slots(tle.jacobi_eigvalsh(At, sweeps=sw, sort=False),
                   jle.jacobi_eigvalsh(Aj, sweeps=sw, sort=False), dt)
    # sorted output, the reference's default
    same_slots(tle.jacobi_eigh(At)[0], jle.jacobi_eigh(Aj)[0], dt)


def test_sweep_counts_and_nan_batch():
    """The early exit: an already diagonal batch stops after the two
    unconditional sweeps, a random one runs to its off-norm threshold
    within the budget, and a batch holding a NaN stops after two sweeps
    with NaN where the reference has NaN."""
    rng = np.random.default_rng(7)
    eye = torch.eye(6, dtype=torch.float64).expand(2, 6, 6)
    assert int(tle._jacobi_plain(eye, 8, True)[2]) == 2
    A = sym(rng, 3, 12)
    assert 2 < int(tle._jacobi_plain(torch.as_tensor(A), 8, True)[2]) < 8
    A[1, 2, 5] = np.nan
    w, V, nsw = tle._jacobi_plain(torch.as_tensor(A), 8, True)
    assert int(nsw) == 2
    wj, Vj = jle.jacobi_eigh(jnp.asarray(A), sort=False)
    np.testing.assert_array_equal(np.isnan(w.numpy()), np.isnan(wj))
    assert np.isnan(w[1]).all() and np.isfinite(w[[0, 2]]).all()
    np.testing.assert_allclose(w[[0, 2]].numpy(), np.asarray(wj)[[0, 2]],
                               rtol=0, atol=1e-12 * np.nanmax(np.abs(A)) * 12)


def test_lead_groups_converge_independently():
    """`lead` dimensions are separate problems (the reference's vmap): a
    group that is already diagonal stops after two sweeps while the
    other runs on, and each group's result is its own solve's."""
    rng = np.random.default_rng(8)
    A = np.stack([sym(rng, 2, 10), np.broadcast_to(np.eye(10), (2, 10, 10))])
    w, _, nsw = tle._jacobi_plain(torch.as_tensor(A), 8, False, lead=1)
    assert nsw.tolist()[1] == 2 and nsw.tolist()[0] > 2
    w0, _, _ = tle._jacobi_plain(torch.as_tensor(A[0]), 8, False)
    assert torch.equal(w[0], w0)
    wj = jnp.stack([jle.jacobi_eigvalsh(jnp.asarray(a), sort=False)
                    for a in A])
    same_slots(w, wj, np.float64)


# ------------------------------------------- accuracy against LAPACK


def test_clustered_scaled_and_odd_against_lapack():
    """The reference's tests/test_lax_eigh.py cases on the port."""
    rng = np.random.default_rng(12345)
    n = 30
    w_true = np.concatenate([np.full(10, 1e-9), np.full(10, 1.0),
                             np.geomspace(1e3, 1e9, 10)])
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = torch.as_tensor((Q * w_true) @ Q.T)[None]
    w = tle.jacobi_eigvalsh(A)[0].numpy()
    tol = 50 * np.finfo(np.float64).eps * np.abs(w_true).max()
    np.testing.assert_allclose(np.sort(w), np.sort(w_true), rtol=1e-8,
                               atol=tol)
    B = rng.normal(size=(7, 7))
    B = 0.5 * (B + B.T)
    w, V = tle.jacobi_eigh(torch.as_tensor(B))
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(B),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(V.numpy() @ np.diag(w.numpy()) @ V.numpy().T,
                               B, atol=1e-12)


def test_near_singular_nt_against_lapack():
    """Endgame NT matrices, the reference's
    test_jacobi_eigh_near_singular_nt with its draws (one generator for
    both orders): absolute eigenvalue error and residual ~1e-8 ||A||, no
    spurious large negative eigenvalue.  (The residual bound is the
    reference's for these draws: on other draws at n = 180 the
    reference's own Jacobi exceeds it, 2.1e-6 against the port's 1.5e-6
    with default_rng(180).)"""
    rng = np.random.default_rng(12345)
    for n, cond in [(96, 1e12), (180, 1e15)]:
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A = (Q * np.geomspace(1.0, 1.0 / cond, n)) @ Q.T
        A = 0.5 * (A + A.T)
        w, V = tle.jacobi_eigh(torch.as_tensor(A), sort=False)
        w_, V_ = w.numpy(), V.numpy()
        assert np.max(np.abs(np.sort(w_) - np.linalg.eigvalsh(A))) < 1e-7
        assert np.linalg.norm(A @ V_ - V_ * w_) / np.linalg.norm(A) < 1e-6
        assert np.min(w_) > -3e-8


def test_herm_against_lapack():
    """The reference's tests/test_herm_native.py case on the port."""
    rng = np.random.default_rng(12345)
    for d in (4, 33, 80):
        M = rng.normal(size=(3, d, d)) + 1j * rng.normal(size=(3, d, d))
        A = M @ M.conj().transpose(0, 2, 1) + d * np.eye(d) \
            - (d + 1) * np.eye(d)
        w, V = tle.jacobi_eigh_herm(torch.as_tensor(A))
        wr = np.linalg.eigvalsh(A)
        np.testing.assert_allclose(np.sort(w.numpy(), -1), wr, rtol=1e-11,
                                   atol=1e-10 * np.max(np.abs(wr)))
        rec = np.einsum("bik,bk,bjk->bij", V.numpy(), w.numpy(),
                        np.conj(V.numpy()))
        np.testing.assert_allclose(rec, A, atol=1e-10 * np.max(np.abs(A)))


# --------------------------------------------------- linalg_ops dispatch


def test_use_jacobi_and_phase_table(monkeypatch):
    """The reference's dispatch with the tensors' device for its backend,
    and the card's per-phase table, without a card."""
    monkeypatch.delenv("SEDUMI_TPU_EIGH", raising=False)
    assert tlo._use_jacobi("cuda") and tlo._use_jacobi(torch.device("cuda"))
    assert not tlo._use_jacobi("cpu")
    monkeypatch.setenv("SEDUMI_TPU_EIGH", "jacobi")
    assert tlo._use_jacobi("cpu")
    with tlo.impl_override("xla"):
        assert not tlo._use_jacobi("cuda")
    monkeypatch.setenv("SEDUMI_TPU_EIGH", "xla")
    assert not tlo._use_jacobi("cuda")
    with tlo.impl_override("jacobi"):
        assert tlo._use_jacobi("cpu")
    assert tlo._FORCE_IMPL is None
    card = {ph: tsolver.phase_eigh_impl(ph, "cuda")
            for ph in ("f64", "f32", "hybrid", "host64", "dd64")}
    assert card == {"f64": "xla", "f32": None, "hybrid": None,
                    "host64": "xla", "dd64": "xla"}
    assert all(tsolver.phase_eigh_impl(ph, "cpu") is None for ph in card)
    # an outer override holds in the phases the table leaves alone
    monkeypatch.delenv("SEDUMI_TPU_EIGH")
    with tlo.impl_override("jacobi"):
        with tsolver._phase_eigh("f32", "cuda"):
            assert tlo._use_jacobi("cpu")
        with tsolver._phase_eigh("host64", "cuda"):
            assert not tlo._use_jacobi("cuda")


BUCKETS = [(3, 7), (1, 12), (2, 4)]


@pytest.mark.parametrize("kind", ["eigh", "eigvalsh", "herm"])
def test_multi_under_jacobi_matches_reference(kind):
    """One padded Jacobi batch over buckets of three orders: the
    reference's slots, its eigenvectors, and (its early exit being
    batch-global) its sweep count."""
    rng = np.random.default_rng(31)
    dt = np.complex128 if kind == "herm" else np.float64
    mats = [sym_or_herm(rng, k, d, dt) for k, d in BUCKETS]
    fn = {"eigh": "eigh_multi", "eigvalsh": "eigvalsh_multi",
          "herm": "eigh_herm_multi"}[kind]
    with jlo.impl_override("jacobi"):
        outj = getattr(jlo, fn)([jnp.asarray(m) for m in mats])
    with tlo.impl_override("jacobi"):
        outt = getattr(tlo, fn)([torch.as_tensor(m) for m in mats])
    for oj, ot, (k, d) in zip(outj, outt, BUCKETS):
        if kind == "eigvalsh":
            assert tuple(ot.shape) == (k, d)
            same_slots(ot, oj, dt)
            continue
        same_slots(ot[0], oj[0], dt)
        assert tuple(ot[1].shape) == (k, d, d)
        assert np.max(np.abs(ot[1].numpy() - np.asarray(oj[1]))) <= 1e-10
    # the library path per bucket, ascending, as before
    for (w, _), m in zip(tlo.eigh_multi([torch.as_tensor(m) for m in mats]),
                         mats):
        if kind != "herm":
            np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(m),
                                       atol=1e-12)


# -------------------------------------- cone algebra under the Jacobi


def test_compute_scaling_herm_bucket_under_jacobi():
    """A point with a Hermitian bucket: under Jacobi both packages take
    the real embedding (the reference's herm_ok gate) and agree on the
    spectrum slot for slot, on the metric W = R R', and on the frames R
    of the real bucket (the embedding's eigenvalues come in equal pairs,
    whose frames are not unique); under the library both take the native
    complex path."""
    kw = dict(l=2, q=(3,), s=(6, 5), s_herm=(True, False))
    lt = Layout(**kw)
    rng = np.random.default_rng(41)
    x, z = random_pair(lt, rng)
    herm = tuple(b.herm for b in lt.s_buckets)
    for impl in ("jacobi", "xla"):
        with jlo.impl_override(impl):
            Sj = jnt.compute_scaling(to_j(x), to_j(z), herm=herm)
        with tlo.impl_override(impl):
            St = tnt.compute_scaling(to_t(x), to_t(z), herm=herm)
        for rj, rt, lj_, lt_, h in zip(Sj.s_r, St.s_r, Sj.s_lam, St.s_lam,
                                       herm):
            rj = np.asarray(rj)
            close(rt @ rt.transpose(-1, -2), rj @ rj.transpose(0, 2, 1),
                  rtol=1e-10)
            if impl == "jacobi":
                close(lt_, lj_, rtol=1e-10)
                if not h:
                    close(rt, rj, rtol=1e-10)
            else:
                close(torch.sort(lt_, dim=-1).values,
                      np.sort(np.asarray(lj_), axis=-1))


def mixed_point(seed):
    """Scaled-space base points and directions over LP, Lorentz and two
    PSD buckets of different orders (so the padded batch is used)."""
    lt = Layout(l=4, q=(3, 5), s=(4, 6))
    rng = np.random.default_rng(seed)
    x, z = random_pair(lt, rng)
    d1, d2 = [(rng.standard_normal(lt.l),
               [rng.standard_normal((b.count, b.dim)) for b in lt.q_buckets],
               [sym(rng, b.count, b.dim) for b in lt.s_buckets])
              for _ in range(2)]
    return lt, rng, x, z, d1, d2


@pytest.mark.parametrize("which", ["pair", "scaled", "prod_spectrum",
                                   "widelen", "jordan"])
def test_line_search_spectra_under_jacobi(which):
    """maxstep_pair/maxstep_from, maxstep_scaled, prod_spectrum and
    widelen_batched at the coarse budget, and jordan's s_eig, s_eigh and
    s_maxstep_scaled at the full one, under Jacobi, against the
    reference's (widelen's trial steps run under the reference's
    jax.vmap: each trial with its own early exit, the port's `lead`
    groups)."""
    lt, rng, x, z, d1, d2 = mixed_point(51)
    with jlo.impl_override("jacobi"), tlo.impl_override("jacobi"):
        if which == "pair":
            for a, b in zip(tnt.maxstep_pair(to_t(x), to_t(d1), to_t(z),
                                             to_t(d2)),
                            jnt.maxstep_pair(to_j(x), to_j(d1), to_j(z),
                                             to_j(d2))):
                close(a, b, rtol=1e-10)
            close(tnt.maxstep_from(to_t(x), to_t(d1)),
                  jnt.maxstep_from(to_j(x), to_j(d1)), rtol=1e-10)
        elif which == "scaled":
            herm = (False, False)
            Sj = jnt.compute_scaling(to_j(x), to_j(z), herm=herm)
            St = tnt.compute_scaling(to_t(x), to_t(z), herm=herm)
            close(tnt.maxstep_scaled(St, to_t(d1)),
                  jnt.maxstep_scaled(Sj, to_j(d1)), rtol=1e-10)
        elif which == "jordan":
            from sedumi_tpu import jordan as jjd
            from sedumi_tpu_torch import jordan as tjd

            s6 = d1[2][1]
            close(tjd.s_eig(torch.as_tensor(s6)), jjd.s_eig(jnp.asarray(s6)),
                  rtol=1e-10)
            for a, b in zip(tjd.s_eigh(torch.as_tensor(s6)),
                            jjd.s_eigh(jnp.asarray(s6))):
                close(a, b, rtol=1e-10)
            lam = np.diagonal(x[2][1], axis1=1, axis2=2).copy()
            close(tjd.s_maxstep_scaled(torch.as_tensor(lam),
                                       torch.as_tensor(s6)),
                  jjd.s_maxstep_scaled(jnp.asarray(lam), jnp.asarray(s6)),
                  rtol=1e-10)
        elif which == "prod_spectrum":
            close(twr.prod_spectrum(to_t(x), to_t(z)),
                  jwr.prod_spectrum(to_j(x), to_j(z)), rtol=1e-10)
        else:
            lam = (rng.random(lt.l) + 0.5,
                   [soc_interior(rng, b.count, b.dim)
                    for b in lt.q_buckets],
                   [np.einsum("ij,ni->nij", np.eye(b.dim),
                              rng.random((b.count, b.dim)) + 0.5)
                    for b in lt.s_buckets])
            args = (1.0, -0.3, 0.8, 0.2, 0.9)
            tj, dj = jwr.widelen_batched(
                to_j(lam), to_j(d1), to_j(d2), *map(jnp.asarray, args),
                0.25, 0.5, fullt=jnp.asarray(2.0))
            tt, dt = twr.widelen_batched(
                to_t(lam), to_t(d1), to_t(d2),
                *(torch.tensor(a, dtype=torch.float64) for a in args),
                0.25, 0.5, fullt=torch.tensor(2.0, dtype=torch.float64))
            close(dt, dj, rtol=1e-10)
            close(tt, tj)


# ------------------------------------------------------- whole solve


def test_f64_solve_under_jacobi_matches_reference():
    """The e2e ladder instance in f64 with both packages under
    impl_override('jacobi') (the reference: c'x 300.4585009871591, f64
    14, dd64 2).  The f64 phase ends on a direction defect that sits at
    the 0.1 gate at iteration 13, so, as in the mixed e2e test, the port
    runs with two torch threads, where its sums take the reference's
    decision (with one thread it leaves f64 two iterations earlier, under
    the library as under Jacobi).  The reference's step cache is keyed
    without the eigensolver, so it is cleared around its Jacobi solve."""
    import sedumi_tpu
    import sedumi_tpu.solver as jsolver
    import sedumi_tpu_torch as pt
    from sedumi_tpu.generators import feasible_problem

    K = {"l": 8, "q": [5, 4], "s": [8, 6]}
    At, b, c, Kspec = feasible_problem(K, 30, seed=11)
    jsolver._STEP_CACHE.clear()
    try:
        with jlo.impl_override("jacobi"):
            xj, _, ij = sedumi_tpu.sedumi(At, b, c, Kspec, {"fid": 0})
    finally:
        jsolver._STEP_CACHE.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with tlo.impl_override("jacobi"):
            xt, _, it = pt.sedumi(At, b, c, K, {"fid": 0}, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert {k: v["iters"] for k, v in it["phases"].items()} == \
        {k: v["iters"] for k, v in ij["phases"].items()}
    assert it["iter"] == ij["iter"]
    for key in ("pinf", "dinf", "numerr"):
        assert it[key] == ij[key], key
    cxj = float(np.real(np.vdot(c, xj)))
    assert abs(float(c @ xt) - cxj) <= 1e-9 * abs(cxj)


def test_chip_smoke_generates_the_reference_instances():
    """chip_smoke.py's generator, the port's copy of the reference's
    feasible_problem (sedumi_tpu_torch.generators: chip_smoke.py may not
    import the reference), draws the same e2e ladder instance and dense
    SOCP as the reference's."""
    from chip_smoke import E2E_LADDER, SOCP_DENSE, feasible_problem
    from sedumi_tpu.generators import feasible_problem as ref_problem

    for K, m, seed in (E2E_LADDER, SOCP_DENSE):
        got = feasible_problem(K, m, seed)
        want = ref_problem(K, m, seed=seed)
        assert (got[0] != want[0]).nnz == 0
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
