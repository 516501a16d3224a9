"""Port parity, the precision ladder on the sparse tile engine: f32 tile
storage, the f32 operator and engine, and whole forced-sparse solves with
pars.dtype='mixed' and 'float32'.

Reference and port side by side on the CPU, on inputs made from numpy
seeds (the port's wrappers take their plain-PyTorch twins on CPU tensors;
tests/test_torch_cuda.py holds K8-f32, K9-f32 and K10-f32 against those
twins on the card).  Tolerances, each with its reason:

* tile factor and solve in f32: both packages run a backward-stable f32
  Cholesky (LAPACK through XLA and through torch) and f32 triangular
  solves on the same storage, summed in other orders, so the factors
  agree to 1e-5 of max|L| (about 100 ulps) and the solves to 1e-4 of
  max|x|; the rung each tile takes is equal, and the rung-2 diagonal (a
  square root of f32 operands) to 1 ulp;
* the f32 operator: apply/adj/adj_y sum a few f32 products per entry in
  another order: 1e-6 of the largest entry;
* the f32 engine: A H c and c' H c to 1e-5 relative (f32 scaling and
  sums); the PCG solution to 2e-3 of max|x|: both run f32 PCG to the
  reference's tolerances from f32 factors, so they end at the f32 noise
  level of an ill-conditioned A H A';
* whole solves: the reference's phases, lin_engine, pinf, dinf and numerr;
  c'x and b'y within 1e-7 relative (the f64 endgame) or 1e-6 (float32);
  iterations per phase equal, or within 2 where f32 rounding moves where
  the endgame goes.  The f32 phase hands host64 an iterate that differs
  by f32 rounding, and host64's count swings with that rounding (quantum,
  tests/test_torch_precision.py); so the SDP's host64 count is held by
  starting the port's host64 phase from the reference's escalation
  iterate, and both free-running counts are printed.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sedumi_tpu
import sedumi_tpu_torch as pt
from sedumi_tpu import ipm as jipm
from sedumi_tpu import nt as jnt
from sedumi_tpu import sparse_chol as jsc
from sedumi_tpu import sparse_engine as jse
from sedumi_tpu.params import Pars as JPars
from sedumi_tpu.structs import ConeVec as JCV
from sedumi_tpu_torch import convert, kernels
from sedumi_tpu_torch import ipm as tipm
from sedumi_tpu_torch import sparse_chol as tsc
from sedumi_tpu_torch import sparse_engine as tse
from sedumi_tpu_torch.params import Pars as TPars
from sedumi_tpu_torch.structs import ConeVec
from chip_smoke import sparse_socp
from test_sparse_engine import _random_sparse_lp, _random_sparse_sdp
from test_torch_sparse import PROBLEMS, _interior, _internal, _one_tile_plan

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)

F32 = torch.float32


def _f32_scaling(S):
    """The port's Scaling with every leaf cast to f32."""
    return type(S)(*[v.to(F32) if isinstance(v, torch.Tensor)
                     else tuple(a.to(F32) for a in v) for v in S])


def _setup(name, seed=3):
    """Both packages' f32 operators of one problem's plan and the f32 NT
    scaling (the reference's, carried across) of a random interior
    point."""
    _, prob = _internal(name)
    lay = prob.layout
    aj, mj = jse.plan_sparse_lq(prob.At, prob.c, lay, JPars(fid=0))
    at, mt = tse.plan_sparse_lq(prob.At, prob.c, lay, TPars(fid=0))
    op_j = jse.make_sparse_lq_op(aj, mj, dtype=np.float32)
    op_t = tse.make_sparse_lq_op(at, mt, dtype=F32, device="cpu")
    rng = np.random.default_rng(seed)
    x, z = (_interior(lay, rng) for _ in range(2))

    def cvj(v):
        return JCV(l=jnp.asarray(v[0], jnp.float32),
                   q=tuple(jnp.asarray(a, jnp.float32) for a in v[1]),
                   s=tuple(jnp.asarray(a, jnp.float32) for a in v[2]))

    S_j = jnt.compute_scaling(cvj(x), cvj(z))
    S_t = _f32_scaling(convert.scaling_from_numpy(
        jax.tree_util.tree_map(np.asarray, S_j), device="cpu"))
    return at, op_j, op_t, S_j, S_t, rng


def _ref_factor(levels_plan, st, reg):
    """The reference's factor_tiles_ur in f32, reg rounded to f32 as its
    engine rounds it."""
    pl = levels_plan
    fac = jax.jit(partial(jsc.factor_tiles_ur, lv_lists=pl["lv_lists"]))
    return np.asarray(fac(
        jnp.asarray(st), *(jnp.asarray(pl[k]) for k in (
            "dslot", "oslot", "omask", "pa", "pb", "pdst", "pmask")),
        reg=jnp.asarray(reg, jnp.float32)))


# ----------------------------------------------------- K8-K10 plain f32


def test_tile_factor_and_solve_f32_match_reference():
    """f32 tile storage of A H A' from one interior scaling of the LP with
    Lorentz blocks: the port's plain f32 factor_tiles and tile_solve
    against the reference's factor_tiles_ur / solve_tiles_ur on the same
    storage (factor to 1e-5 of max|L| on every tile it defines, solve to
    1e-4 of max|x|)."""
    at, _, op_t, _, S_t, rng = _setup("socp")
    meta = op_t.meta
    vals, _, _ = tse.ada_values(op_t, S_t)
    st = tsc.assemble_tiles(meta["nslot"], meta["B"], op_t.arrays["asm"],
                            vals, op_t.arrays["pad_idx"])
    assert st.dtype == F32
    plan = dict(at, lv_lists=meta["lv_lists"])
    L_j = _ref_factor(plan, st.numpy().copy(), 0.0)
    L_t = tsc.factor_tiles(st, op_t.levels, 0.0).numpy()
    scale = np.abs(L_j).max()
    ntc = meta["ntc"]
    for j in range(ntc):
        d = at["dslot"][j]
        np.testing.assert_allclose(np.tril(L_t[d]), np.tril(L_j[d]), rtol=0,
                                   atol=1e-5 * scale)
        for s in at["oslot"][j][at["omask"][j]]:
            np.testing.assert_allclose(L_t[s], L_j[s], rtol=0,
                                       atol=1e-5 * scale)
    rhs = rng.standard_normal(meta["ntiles_n"]).astype(np.float32)
    x_t = tsc.tile_solve(torch.as_tensor(L_t), torch.as_tensor(rhs),
                         op_t.levels).numpy()
    x_j = np.asarray(jax.jit(partial(
        jsc.solve_tiles_ur, lv_lists=meta["lv_lists"], ntc=ntc))(
        jnp.asarray(L_j), jnp.asarray(rhs), *(jnp.asarray(at[k]) for k in (
            "dslot", "oslot", "omask", "orow"))))
    assert x_t.dtype == x_j.dtype == np.float32
    np.testing.assert_allclose(x_t, x_j, rtol=0,
                               atol=1e-4 * np.abs(x_j).max())


@pytest.mark.parametrize("kind,rung", [("spd", 0), ("first", 1),
                                       ("both", 2)])
def test_escalation_rungs_f32_match_reference(kind, rung):
    """A tile built to pass, to fail the lifted f32 factor only, and to
    fail both rungs, in f32 storage with the reference's canceltol (1e-12,
    so the lift is max(reg, fl32(1e-12) dmax) and its + 1e-300 rounds to
    0): the port's plain f32 factor takes the rung the test built, and its
    factor equals the reference's (1e-5 of max|L|; rung 2 to 1 ulp)."""
    B = 16
    rng = np.random.default_rng(rung)
    G = rng.standard_normal((B, B))
    D = G @ G.T / B + np.eye(B)
    if kind == "first":
        D[3, 3] = -0.5
    elif kind == "both":
        D[5, 4] = D[4, 5] = 50.0
    f, st = _one_tile_plan(D, B)
    st = st.to(F32)
    pl = f.plan
    plan = {k: getattr(pl, k) for k in ("dslot", "oslot", "omask", "pa",
                                        "pb", "pdst", "pmask", "lv_lists")}
    L_j = _ref_factor(plan, st.numpy().copy(), 0.0)[pl.dslot[0]]
    got = tsc.tile_factor(st, f.levels[0], 0.0)
    assert got.tolist() == [rung]
    L_t = st[pl.dslot[0]].numpy()
    assert L_t.dtype == L_j.dtype == np.float32
    assert np.all(np.isfinite(L_t))
    if rung == 2:
        np.testing.assert_array_max_ulp(L_t, L_j, maxulp=1)
    else:
        np.testing.assert_allclose(L_t, L_j, rtol=0,
                                   atol=1e-5 * np.abs(L_j).max())


def test_wrappers_count_no_launch_on_cpu_f32():
    """On CPU tensors the f32 wrappers take the plain versions: no launch
    is counted, the f32 names included."""
    kernels.reset_launch_counts()
    _, _, op_t, _, S_t, _ = _setup("lp")
    eng = tse.TileSchurEngine(TPars(fid=0))
    ctx, _, _, _ = eng.prepare(op_t, S_t, 0.0)
    eng.solve(ctx, torch.ones(op_t.m, dtype=F32))
    assert ctx.L.dtype == F32
    assert all(n == 0 for n in kernels.LAUNCHES.values())


# ------------------------------------------------------- the f32 operator


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_sparse_lq_op_f32_matches_reference(name):
    """make_sparse_lq_op(dtype=float32): every float field is f32, and
    apply, adj and adj_y match the reference's f32 operator to 1e-6 of the
    largest entry."""
    _, op_j, op_t, _, _, rng = _setup(name)
    meta = op_t.meta
    for k, v in op_t.arrays.items():
        for a in (v if isinstance(v, tuple) else (v,)):
            assert a.dtype in (F32, torch.int64), k
    lay = _internal(name)[1].layout
    l, q, s = _interior(lay, rng)
    xj = JCV(l=jnp.asarray(l, jnp.float32),
             q=tuple(jnp.asarray(a, jnp.float32) for a in q),
             s=tuple(jnp.asarray(a, jnp.float32) for a in s))
    xt = ConeVec(l=torch.as_tensor(l, dtype=F32),
                 q=tuple(torch.as_tensor(a, dtype=F32) for a in q),
                 s=tuple(torch.as_tensor(a, dtype=F32) for a in s))
    w = rng.standard_normal(meta["m"] + 1).astype(np.float32)

    def close(a, r):
        a, r = np.asarray(a), np.asarray(r)
        assert a.dtype == r.dtype == np.float32
        np.testing.assert_allclose(a, r, rtol=0,
                                   atol=1e-6 * np.abs(r).max())

    close(op_t.apply(xt).numpy(), op_j.apply(xj))
    for got, want in ((op_t.adj(torch.as_tensor(w)), op_j.adj(jnp.asarray(w))),
                      (op_t.adj_y(torch.as_tensor(w[:-1]),
                                  torch.as_tensor(w[-1])),
                       op_j.adj_y(jnp.asarray(w[:-1]), jnp.asarray(w[-1])))):
        for a, r in zip([got.l, *got.q, *got.s], [want.l, *want.q, *want.s]):
            close(a.numpy(), r)


# --------------------------------------------------------- the f32 engine


@pytest.mark.parametrize("name", ["lp", "sdp"])
def test_engine_f32_matches_reference(name):
    """TileSchurEngine.prepare/solve in f32 from one f32 scaling through
    both packages: the LP's dense columns take the Woodbury capacitance
    (K3-f32's twin), the SDP's PSD groups the group build (K2-f32's twin).
    A H c and c' H c agree to 1e-5 relative, one PCG solve to 2e-3 of
    max|x|; everything stays f32."""
    _, op_j, op_t, S_j, S_t, rng = _setup(name)
    rhs = rng.standard_normal(op_t.m).astype(np.float32)
    eng_j = jse.TileSchurEngine(JPars(fid=0))
    eng_t = tse.TileSchurEngine(TPars(fid=0))

    @jax.jit
    def reference(op, S, r):
        ctx, ahc, chc, ok = eng_j.prepare(op, S, jnp.float32(0.0))
        return ahc, chc, ok, eng_j.solve(ctx, r)

    ahc_j, chc_j, ok_j, x_j = (np.asarray(a) for a in
                               reference(op_j, S_j, jnp.asarray(rhs)))
    ctx_t, ahc_t, chc_t, ok_t = eng_t.prepare(op_t, S_t, 0.0)
    assert bool(ok_j) and ok_t
    assert (ctx_t.Ud.shape[1] > 0) == (name == "lp")
    assert (op_t.meta["s_G"] != ()) == (name == "sdp")
    assert ctx_t.L.dtype == ahc_t.dtype == chc_t.dtype == F32
    if ctx_t.fC is not None:
        assert ctx_t.fC.L.dtype == F32
    np.testing.assert_allclose(ahc_t.numpy(), ahc_j, rtol=0,
                               atol=1e-5 * np.abs(ahc_j).max())
    assert abs(float(chc_t) - float(chc_j)) <= 1e-5 * abs(float(chc_j))
    x_t = eng_t.solve(ctx_t, torch.as_tensor(rhs))
    assert x_t.dtype == F32 and x_j.dtype == np.float32
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0,
                               atol=2e-3 * np.abs(x_j).max())


# ------------------------------------------------------------ whole solves


def _phases(info):
    return {k: v["iters"] for k, v in info["phases"].items()}


def _np_state(s):
    def cv(v):
        return (np.asarray(v.l), [np.asarray(a) for a in v.q],
                [np.asarray(a) for a in v.s])

    return (cv(s.x), np.asarray(s.y), cv(s.z), float(s.tau),
            float(s.kappa))


SOLVES = {
    # small instances of the reference's sparse-path generators
    # (tests/test_sparse_engine.py; chip_smoke.py's copy of
    # test_sparse_socp_with_cones's at m = 400, 30 cones), each from
    # default_rng(12345).  The SOCP is the witness of the hybrid phase on
    # the sparse route: both packages take f32 6, hybrid 1, host64 4 there.
    "lp": lambda: _random_sparse_lp(300, 60, np.random.default_rng(12345)),
    "socp": lambda: sparse_socp(np.random.default_rng(12345), m=400,
                                ncones=30),
    "sdp": lambda: _random_sparse_sdp(120, 36, 4,
                                      np.random.default_rng(12345)),
}
LADDERS = {"lp": ["f32", "host64"], "socp": ["f32", "hybrid", "host64"],
           "sdp": ["f32", "host64"]}


@pytest.mark.parametrize("name", list(SOLVES))
def test_mixed_sparse_solve_matches_reference(name, monkeypatch):
    """pars.dtype='mixed' with sparse=1 end to end: the reference's phase
    sequence on the sparse engine (the SOCP through the hybrid phase, the
    LP and the SDP from f32 straight to host64), equal pinf/dinf/numerr,
    c'x and b'y within 1e-7 relative, the f32 and hybrid phases'
    iterations equal.  The host64 count: within 2 on the LP and the SOCP;
    on the SDP the free-running counts differ (printed), and the port's
    host64 phase started from the reference's escalation iterate takes the
    reference's count within 2 and lands at its c'x to 1e-9."""
    A, b, c, K = SOLVES[name]()
    pars = {"fid": 0, "sparse": 1, "optstep": 0, "dtype": "mixed"}
    entering = []
    make_recenter = jipm.make_recenter

    def recording(layout, dtype=jnp.float64):
        fn = make_recenter(layout, dtype)

        def rec(s):
            if np.dtype(dtype) == np.float64:
                entering.append(jax.tree_util.tree_map(np.asarray, s))
            return fn(s)
        return rec

    monkeypatch.setattr(jipm, "make_recenter", recording)
    xj, yj, ij = sedumi_tpu.sedumi(A, b, c, K, pars)
    monkeypatch.undo()
    xt, yt, it = pt.sedumi(A, b, c, K, pars, device="cpu")
    pj, ptt = _phases(ij), _phases(it)
    print(f"{name} 'mixed': reference {pj}, port {ptt}")
    assert it["lin_engine"] == ij["lin_engine"] == "sparse"
    assert list(ptt) == list(pj) == LADDERS[name]
    for key in ("pinf", "dinf", "numerr"):
        assert it[key] == ij[key], key
    for got, want in ((c @ xt, c @ xj), (b @ yt, b @ yj)):
        assert abs(float(got) - float(want)) <= 1e-7 * abs(float(want))
    assert ptt["f32"] == pj["f32"] and ptt.get("hybrid") == pj.get("hybrid")
    if name != "sdp":
        assert abs(ptt["host64"] - pj["host64"]) <= 2
        return
    # the port's host64 phase from the reference's escalation iterate
    make_t = tipm.make_recenter

    def substituted(layout, dtype=torch.float64):
        fn = make_t(layout, dtype)

        def rec(s):
            if dtype == torch.float64 and not rec.done:
                rec.done = True
                s = convert.state_from_numpy(
                    layout, *_np_state(entering[0]), device="cpu")
            return fn(s)
        rec.done = False
        return rec

    monkeypatch.setattr(tipm, "make_recenter", substituted)
    xs, _, i_s = pt.sedumi(A, b, c, K, pars, device="cpu")
    print(f"{name}: port's host64 from the reference's iterate "
          f"{_phases(i_s)}")
    assert abs(_phases(i_s)["host64"] - pj["host64"]) <= 2
    assert abs(float(c @ xs) - float(c @ xj)) <= 1e-9 * abs(float(c @ xj))


def test_float32_sparse_solve_matches_reference():
    """pars.dtype='float32' with sparse=1 on the LP: the reference's single
    f32 phase on the sparse engine, its pinf/dinf/numerr, its iterations
    within 2, and c'x, b'y within 1e-6 relative."""
    A, b, c, K = SOLVES["lp"]()
    pars = {"fid": 0, "sparse": 1, "optstep": 0, "dtype": "float32"}
    xj, yj, ij = sedumi_tpu.sedumi(A, b, c, K, pars)
    xt, yt, it = pt.sedumi(A, b, c, K, pars, device="cpu")
    pj, ptt = _phases(ij), _phases(it)
    print(f"lp 'float32': reference {pj}, port {ptt}")
    assert it["lin_engine"] == ij["lin_engine"] == "sparse"
    assert list(ptt) == list(pj) == ["f32"]
    assert abs(ptt["f32"] - pj["f32"]) <= 2
    for key in ("pinf", "dinf", "numerr"):
        assert it[key] == ij[key], key
    assert np.all(np.isfinite(xt)) and np.all(np.isfinite(yt))
    for got, want in ((c @ xt, c @ xj), (b @ yt, b @ yj)):
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_schur_dtype_is_not_read_on_the_sparse_route():
    """The reference's TileSchurEngine never reads pars.schur_dtype, so a
    forced-sparse solve with schur_dtype='float32' is the f64 sparse solve,
    bit for bit, in one f64 phase."""
    A, b, c, K = SOLVES["socp"]()
    pars = {"fid": 0, "sparse": 1, "optstep": 0}
    x0, y0, i0 = pt.sedumi(A, b, c, K, pars, device="cpu")
    x1, y1, i1 = pt.sedumi(A, b, c, K, {**pars, "schur_dtype": "float32"},
                           device="cpu")
    assert i1["lin_engine"] == "sparse" and list(i1["phases"]) == ["f64"]
    assert _phases(i1) == _phases(i0)
    assert np.array_equal(x0, x1) and np.array_equal(y0, y1)
