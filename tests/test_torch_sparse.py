"""Port parity, the sparse Schur engine: native, sparse_chol, sparse_engine
and the solver's routing.

Reference and port side by side on the CPU, on the same seeded inputs
(the port's wrappers take their plain-PyTorch twins on CPU tensors;
tests/test_torch_cuda.py holds the kernels K8-K10 against those twins on
the card):

* native: AMD, etree, postorder, column counts, supernodes, the symbolic
  pattern and the levels equal the reference's integer arrays exactly;
* plan_tiles and plan_sparse_lq: every array and meta entry equals the
  reference's (LP with dense columns, SOCP with cones, sparse SDP);
* SparseCholesky against scipy (the reference's own tests, mirrored), the
  level factor and solve against the reference's factor_tiles_ur /
  solve_tiles_ur, the escalation rungs;
* TileSchurEngine.prepare/solve against the reference's engine from one
  scaling: ADA values, A H c, c' H c and the solve;
* whole forced-sparse solves: the reference's iterations and phases, c'x
  within 1e-8 relative, the same pinf/dinf/numerr; the gates that admit
  dd64 and the projected start only with the dense engine;
* the automatic route at m = 1000 through route_engine, without a solve.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from sedumi_tpu import native as jnative
from sedumi_tpu import nt as jnt
from sedumi_tpu import sparse_chol as jsc
from sedumi_tpu import sparse_engine as jse
from sedumi_tpu import transform as jtf
from sedumi_tpu.params import Pars as JPars
from sedumi_tpu.structs import ConeVec as JCV
from sedumi_tpu_torch import convert, kernels
from sedumi_tpu_torch import native as tnative
from sedumi_tpu_torch import solver as tsolver
from sedumi_tpu_torch import sparse_chol as tsc
from sedumi_tpu_torch import sparse_engine as tse
from sedumi_tpu_torch.params import Pars as TPars
from test_sparse_engine import _random_sparse_lp, _random_sparse_sdp

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)

EPS = float(np.finfo(np.float64).eps)


def _random_spd(n, density, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csc")
    return sp.csc_matrix(A @ A.T + sp.identity(n) * n * 0.5)


def _random_spd_pattern(n, density, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csc")
    return (A + A.T).tocsc() + sp.identity(n) * (n + 1.0)


def _arrow(n=50):
    rows = list(range(n)) + [0] * (n - 1) + list(range(1, n))
    cols = list(range(n)) + list(range(1, n)) + [0] * (n - 1)
    return sp.csc_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))


def _sparse_socp(m, n_extra, ncones, rng):
    """A problem shaped as test_sparse_socp_with_cones's: a sparse LP plus
    `ncones` Lorentz cones of dimension 3, each touching 3 random
    constraints."""
    A, b, c, K = _random_sparse_lp(m, n_extra, rng)
    n = A.shape[1]
    qdims = [3] * ncones
    rows, cols, vals = [], [], []
    off = 0
    for d in qdims:
        r = rng.choice(m, size=3, replace=False)
        for j in range(d):
            rows.append(r)
            cols.append(np.full(r.size, n + off + j))
            vals.append(rng.standard_normal(r.size) * 0.2)
        off += d
    Aq = sp.lil_matrix(sp.csc_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m, n + sum(qdims))))
    Aq[:, :n] = A
    Aq = sp.csc_matrix(Aq)
    xq = np.zeros(sum(qdims))
    zq = np.zeros(sum(qdims))
    o = 0
    for d in qdims:
        xq[o], zq[o] = 2.0, 1.5
        xq[o + 1:o + d] = rng.standard_normal(d - 1) * 0.3
        zq[o + 1:o + d] = rng.standard_normal(d - 1) * 0.2
        o += d
    bq = Aq @ np.concatenate([rng.random(n) + 0.5, xq])
    cq = Aq.T @ (rng.standard_normal(m) * 0.1) + np.concatenate(
        [rng.random(n) + 0.5, zq])
    return Aq, bq, cq, {"l": n, "q": qdims}


# small instances of the reference's generators (tests/test_sparse_engine)
PROBLEMS = {
    "lp": lambda rng: _random_sparse_lp(200, 120, rng, dense_cols=2),
    "socp": lambda rng: _sparse_socp(150, 50, 15, rng),
    "sdp": lambda rng: _random_sparse_sdp(160, 80, 3, rng),
}


def _internal(name, seed=12345):
    A, b, c, K = PROBLEMS[name](np.random.default_rng(seed))
    prob = jtf.pretransfo(A, b, c, K, JPars(fid=0))
    return (A, b, c, K), prob


# ----------------------------------------------------------------- native


NATIVE_CASES = {"spd30": lambda: _random_spd_pattern(30, 0.1, 0),
                "spd50": lambda: _random_spd_pattern(50, 0.05, 1),
                "spd80": lambda: _random_spd_pattern(80, 0.03, 2),
                "arrow": _arrow}


@pytest.mark.parametrize("case", list(NATIVE_CASES))
def test_native_matches_reference(case):
    """Exact integer equality with the reference's host engine (the port
    builds its own copy of the same source)."""
    assert jnative.HAVE_NATIVE
    S = NATIVE_CASES[case]()
    np.testing.assert_array_equal(tnative.amd_order(S), jnative.amd_order(S))
    parent = jnative.etree(S)
    np.testing.assert_array_equal(tnative.etree(S), parent)
    np.testing.assert_array_equal(tnative.postorder(parent),
                                  jnative.postorder(parent))
    counts = jnative.col_counts(S, parent)
    np.testing.assert_array_equal(tnative.col_counts(S, parent), counts)
    np.testing.assert_array_equal(tnative.supernodes(parent, counts, 4),
                                  jnative.supernodes(parent, counts, 4))
    np.testing.assert_array_equal(tnative.levels(parent),
                                  jnative.levels(parent))
    Lt, Lj = (m.symbolic_pattern(S, parent) for m in (tnative, jnative))
    np.testing.assert_array_equal(Lt.indptr, Lj.indptr)
    np.testing.assert_array_equal(Lt.indices, Lj.indices)


def test_native_builds_into_port_build_dir():
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert "sedumi_tpu_torch" in str(path)


# ------------------------------------------------------------------- plans


PLAN_FIELDS = ("dslot", "oslot", "omask", "pa", "pb", "pdst", "pmask",
               "orow", "asm_dst", "lv_cols", "lv_cmask", "perm")


@pytest.mark.parametrize("n,density,B,seed", [(120, 0.06, 16, 4),
                                              (300, 0.02, 64, 5)])
def test_plan_tiles_matches_reference(n, density, B, seed):
    M = _random_spd(n, density, seed)
    pj, pt_ = jsc.plan_tiles(M, B=B), tsc.plan_tiles(M, B=B)
    for f in ("n", "B", "ntc", "nslot", "nlev", "lv_lists", "slot_of"):
        assert getattr(pj, f) == getattr(pt_, f), f
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(pt_, f),
                                      np.asarray(getattr(pj, f)), f)
    # the per-level maps cover every valid off tile and pair exactly once
    noff = sum(lv["off_slot"].size for lv in pt_.levels)
    npair = sum(lv["pair_a"].size for lv in pt_.levels)
    assert noff == int(pt_.omask.sum()) and npair == int(pt_.pmask.sum())


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_plan_sparse_lq_matches_reference(name):
    _, prob = _internal(name)
    aj, mj = jse.plan_sparse_lq(prob.At, prob.c, prob.layout, JPars(fid=0))
    at, mt = tse.plan_sparse_lq(prob.At, prob.c, prob.layout, TPars(fid=0))
    assert mt == mj
    assert set(at) == set(aj) | {"levels"}
    for key, val in aj.items():
        got = at[key]
        if isinstance(val, tuple):
            assert len(got) == len(val), key
            for g, v in zip(got, val):
                np.testing.assert_array_equal(g, np.asarray(v), key)
        else:
            np.testing.assert_array_equal(got, np.asarray(val), key)
    if name == "lp":
        assert mj["Kd"] == 2
    if name == "sdp":
        assert mj["psd_pair_entries"] > 0


# ----------------------------------------------------------- sparse_chol


@pytest.mark.parametrize("n,density,B,seed", [(50, 0.10, 16, 0),
                                              (130, 0.05, 32, 1),
                                              (300, 0.02, 64, 2)])
def test_sparse_cholesky_matches_scipy(n, density, B, seed):
    """test_sparse_chol.test_factor_solve_matches_scipy on the port."""
    M = _random_spd(n, density, seed)
    f = tsc.SparseCholesky(M, B=B, device="cpu")
    assert f.plan.nlev >= 3
    L = f.factor(M)
    b = np.random.default_rng(seed + 100).normal(size=n)
    np.testing.assert_allclose(f.solve(L, b), spla.spsolve(M, b), rtol=1e-8,
                               atol=1e-10)


def test_refactor_same_plan_different_values():
    M1 = _random_spd(80, 0.06, 3)
    f = tsc.SparseCholesky(M1, B=32, device="cpu")
    rng = np.random.default_rng(9)
    M2 = sp.csc_matrix(M1.multiply(1.0)) + sp.diags(
        np.abs(rng.normal(size=80)) + 0.5)
    b = rng.normal(size=80)
    np.testing.assert_allclose(f.solve(f.factor(M2), b), spla.spsolve(M2, b),
                               rtol=1e-8, atol=1e-10)


def test_storage_follows_the_planned_pattern():
    """storage() places M's nonzeros by the plan's assembly map whatever
    their order (a COO with shuffled entries assembles the same tiles,
    bit for bit), and refuses a nonzero outside the planned pattern."""
    M = _random_spd(70, 0.06, 7)
    f = tsc.SparseCholesky(M, B=16, device="cpu")
    coo = M.tocoo()
    p = np.random.default_rng(7).permutation(coo.nnz)
    shuffled = sp.coo_matrix((coo.data[p], (coo.row[p], coo.col[p])),
                             shape=M.shape)
    assert torch.equal(f.storage(shuffled), f.storage(M))
    outside = np.argwhere(M.toarray() == 0)[0]
    extra = M.tolil()
    extra[outside[0], outside[1]] = extra[outside[1], outside[0]] = 1.0
    with pytest.raises(ValueError, match="planned pattern"):
        f.storage(extra.tocsc())


def test_diag_add_never_fails():
    """test_sparse_chol.test_diag_add_never_fails on the port: a massively
    indefinite matrix factors to a finite L."""
    n = 40
    M = _random_spd(n, 0.1, 5)
    M = M - sp.diags(M.diagonal()) + sp.diags(np.ones(n) * 1e-18)
    f = tsc.SparseCholesky(sp.csc_matrix(np.abs(M) + sp.identity(n)), B=16,
                           device="cpu")
    L = f.factor(sp.csc_matrix(np.abs(M) + sp.identity(n) * 1e-18))
    assert bool(torch.isfinite(L).all())


def _ref_factor_ur(pl, st_j, reg):
    """The reference's factor_tiles_ur, jitted (one compile instead of one
    per eager op)."""
    fac = jax.jit(partial(jsc.factor_tiles_ur, lv_lists=pl.lv_lists))
    return fac(st_j, jnp.asarray(pl.dslot), jnp.asarray(pl.oslot),
               jnp.asarray(pl.omask), jnp.asarray(pl.pa), jnp.asarray(pl.pb),
               jnp.asarray(pl.pdst), jnp.asarray(pl.pmask),
               reg=jnp.asarray(reg))


def _ur_storage(M, f):
    """The same assembled storage for both packages' level factors."""
    st = f.storage(M)
    return st, jnp.asarray(st.numpy().copy())


@pytest.mark.parametrize("n,density,B,seed,reg", [(120, 0.06, 16, 4, 0.0),
                                                  (300, 0.02, 64, 5, 1e-6)])
def test_level_factor_matches_reference_ur(n, density, B, seed, reg):
    """The port's level schedule against factor_tiles_ur / solve_tiles_ur
    on the same storage.  Both are backward stable; on this SPD matrix
    (cond < 1e3) the factors agree to 1e-12 of max|L| and the solves to
    1e-10 relative."""
    M = _random_spd(n, density, seed)
    f = tsc.SparseCholesky(M, B=B, device="cpu")
    pl = f.plan
    st_t, st_j = _ur_storage(M, f)
    L_t = tsc.factor_tiles(st_t, f.levels, reg)
    L_j = np.asarray(_ref_factor_ur(pl, st_j, reg))
    # every tile the factor defines (the diagonal tiles' upper triangles
    # hold only partial updates in the reference's storage)
    for j in range(pl.ntc):
        d = pl.dslot[j]
        np.testing.assert_allclose(np.tril(L_t[d].numpy()), np.tril(L_j[d]),
                                   rtol=0, atol=1e-12 * np.abs(L_j).max())
        for s in pl.oslot[j][pl.omask[j]]:
            np.testing.assert_allclose(L_t[s].numpy(), L_j[s], rtol=0,
                                       atol=1e-12 * np.abs(L_j).max())
    rhs = np.random.default_rng(seed).normal(size=pl.n)
    x_t = tsc.tile_solve(L_t, torch.as_tensor(rhs), f.levels).numpy()
    x_j = np.asarray(jax.jit(partial(
        jsc.solve_tiles_ur, lv_lists=pl.lv_lists, ntc=pl.ntc))(
        jnp.asarray(L_j), jnp.asarray(rhs), jnp.asarray(pl.dslot),
        jnp.asarray(pl.oslot), jnp.asarray(pl.omask), jnp.asarray(pl.orow)))
    np.testing.assert_allclose(x_t, x_j, rtol=1e-10,
                               atol=1e-10 * np.abs(x_j).max())


def _one_tile_plan(D, B):
    """A one-column plan whose only tile holds D's lower triangle."""
    M = sp.csc_matrix(np.ones((B, B)))
    f = tsc.SparseCholesky(M, B=B, device="cpu")
    st = torch.zeros(f.plan.nslot, B, B, dtype=torch.float64)
    st[f.plan.dslot[0]] = torch.as_tensor(np.tril(D))
    return f, st


@pytest.mark.parametrize("kind,rung", [("spd", 0), ("first", 1),
                                       ("both", 2)])
def test_escalation_rungs_match_reference(kind, rung):
    """A tile built to pass, to fail the lifted factor only, and to fail
    both rungs: the rung taken and the factor equal the reference's
    (to 1e-14 of max|L|; the diagonal last resort exactly)."""
    B = 16
    rng = np.random.default_rng(rung)
    G = rng.standard_normal((B, B))
    D = G @ G.T / B + np.eye(B)
    if kind == "first":        # indefinite by less than dmax + 1
        D[3, 3] = -0.5
    elif kind == "both":       # indefinite beyond dmax + 1
        D[5, 4] = D[4, 5] = 50.0
    f, st = _one_tile_plan(D, B)
    pl = f.plan
    st_j = jnp.asarray(st.numpy().copy())
    got = tsc.tile_factor(st, f.levels[0], 0.0)
    assert got.tolist() == [rung]
    L_j = np.asarray(_ref_factor_ur(pl, st_j, 0.0))[pl.dslot[0]]
    L_t = st[pl.dslot[0]].numpy()
    assert np.all(np.isfinite(L_t))
    if rung == 2:
        np.testing.assert_array_equal(L_t, L_j)
    else:
        np.testing.assert_allclose(L_t, L_j, rtol=0,
                                   atol=1e-14 * np.abs(L_j).max())


def test_wrappers_count_no_launch_on_cpu():
    kernels.reset_launch_counts()
    M = _random_spd(60, 0.08, 6)
    f = tsc.SparseCholesky(M, B=16, device="cpu")
    f.solve(f.factor(M), np.ones(60))
    assert all(n == 0 for n in kernels.LAUNCHES.values())


# ---------------------------------------------------------- the engine


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


def _engines(name, seed=3):
    _, prob = _internal(name)
    lay = prob.layout
    aj, mj = jse.plan_sparse_lq(prob.At, prob.c, lay, JPars(fid=0))
    at, mt = tse.plan_sparse_lq(prob.At, prob.c, lay, TPars(fid=0))
    op_j = jse.make_sparse_lq_op(aj, mj)
    op_t = tse.make_sparse_lq_op(at, mt, device="cpu")
    rng = np.random.default_rng(seed)
    x, z = (_interior(lay, rng) for _ in range(2))

    def cvj(v):
        return JCV(l=jnp.asarray(v[0]), q=tuple(map(jnp.asarray, v[1])),
                   s=tuple(map(jnp.asarray, v[2])))

    S_j = jnt.compute_scaling(cvj(x), cvj(z))
    S_t = convert.scaling_from_numpy(
        jax.tree_util.tree_map(np.asarray, S_j), device="cpu")
    return prob, at, op_j, op_t, S_j, S_t, rng.standard_normal(mj["m"])


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_engine_matches_reference(name):
    """From one scaling: the port's ADA values (plus the Woodbury term
    Ud diag(sd) Ud') equal the exact A H A' at every pattern entry to
    1e-13 of max|ADA|; A H c and c' H c equal the reference's to 1e-13;
    the PCG solutions agree to 1e-8 relative (both stop at
    max(1e-9 ||rhs||, restol mu) against the exact matvec)."""
    prob, plan, op_j, op_t, S_j, S_t, rhs = _engines(name)
    m = op_t.m
    eng_j = jse.TileSchurEngine(JPars(fid=0))
    eng_t = tse.TileSchurEngine(TPars(fid=0))

    @jax.jit
    def reference(op, S, r):
        ctx, ahc, chc, ok = eng_j.prepare(op, S, 0.0)
        return ahc, chc, ok, eng_j.solve(ctx, r)

    ahc_j, chc_j, ok_j, x_j = reference(op_j, S_j, jnp.asarray(rhs))
    ctx_t, ahc_t, chc_t, ok_t = eng_t.prepare(op_t, S_t, 0.0)
    assert bool(ok_j) and ok_t
    assert (ctx_t.Ud.shape[1] > 0) == (name == "lp")

    # exact A H A' from the operator, column by column
    H = np.stack([op_t.apply(tse.nt.H_apply(S_t, op_t.adj(torch.as_tensor(
        np.eye(m + 1)[i]))))[:m].numpy() for i in range(m)], axis=1)
    vals, _, _ = tse.ada_values(op_t, S_t)
    ri, ci = _lower_nz(plan, op_t.meta)
    assert ri.size == vals.numel()
    dense = ((ctx_t.Ud * ctx_t.sd) @ ctx_t.Ud.T).numpy()
    np.testing.assert_allclose(vals.numpy() + dense[ri, ci], H[ri, ci],
                               rtol=0, atol=1e-13 * np.abs(H).max())

    np.testing.assert_allclose(ahc_t.numpy(), np.asarray(ahc_j), rtol=0,
                               atol=1e-13 * np.abs(np.asarray(ahc_j)).max())
    assert abs(float(chc_t) - float(chc_j)) <= 1e-13 * abs(float(chc_j))
    x_j = np.asarray(x_j)
    x_t = eng_t.solve(ctx_t, torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-8,
                               atol=1e-8 * np.abs(x_j).max())


def _lower_nz(a, meta):
    """(row, col) of the plan's lower-triangle nz in its order, recovered
    from the host plan's assembly map (tile slot and in-tile position,
    permuted)."""
    B = meta["B"]
    dslot, oslot, omask, orow = a["dslot"], a["oslot"], a["omask"], a["orow"]
    ntc = dslot.size - 1
    tr = np.full(meta["nslot"], -1)
    tc = np.full(meta["nslot"], -1)
    tr[dslot[:ntc]] = tc[dslot[:ntc]] = np.arange(ntc)
    cols = np.repeat(np.arange(ntc + 1)[:, None], oslot.shape[1], axis=1)
    tr[oslot[omask]] = orow[omask]
    tc[oslot[omask]] = cols[omask]
    slot, rem = np.divmod(a["asm"], B * B)
    perm = a["perm"]
    return perm[tr[slot] * B + rem // B], perm[tc[slot] * B + rem % B]


# ---------------------------------------------------------- whole solves


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_forced_sparse_solve_matches_reference(name, monkeypatch):
    """sparse=1 end to end: lin_engine 'sparse', the reference's iterations
    and phases (f64 only: m <= 1200 would admit dd64 with the dense
    engine), c'x within 1e-8 relative, equal pinf/dinf/numerr; the
    projected start (dense engine only) is never tried."""
    import sedumi_tpu
    import sedumi_tpu_torch as pt

    (A, b, c, K), _ = _internal(name)
    pars = {"fid": 0, "sparse": 1, "optstep": 0}
    xj, yj, ij = sedumi_tpu.sedumi(A, b, c, K, pars)
    tried = []
    monkeypatch.setattr(tsolver, "_projected_start",
                        lambda *a, **k: tried.append(1))
    xt, yt, it = pt.sedumi(A, b, c, K, pars, device="cpu")
    assert not tried
    assert it["lin_engine"] == ij["lin_engine"] == "sparse"
    assert it["iter"] == ij["iter"]
    assert {k: v["iters"] for k, v in it["phases"].items()} == \
        {k: v["iters"] for k, v in ij["phases"].items()}
    assert set(it["phases"]) == {"f64"}
    for key in ("pinf", "dinf", "numerr"):
        assert it[key] == ij[key], key
    cxj, cxt = float(c @ xj), float(c @ xt)
    assert abs(cxt - cxj) <= 1e-8 * abs(cxj)


def test_dd64_and_projected_start_gates_follow_the_engine():
    """The reference admits dd64 (solver.py:642) and the projected start
    (:522) only with the dense engine."""
    _, prob = _internal("lp")
    m = prob.At.shape[1]
    assert m <= 1200 and tsolver.dd64_admitted(prob.layout, m)
    assert tsolver.phase_ladder("dense", prob.layout, m) == ["f64", "dd64"]
    assert tsolver.phase_ladder("sparse", prob.layout, m) == ["f64"]


# ----------------------------------------------------------------- routing


def _route(A, b, c, K, pars):
    prob = jtf.pretransfo(A, b, c, K, JPars(fid=0))
    return tsolver.route_engine(sp.csc_matrix(prob.At), prob.c, prob.layout,
                                TPars.make(pars))


def test_auto_route_picks_sparse_at_m1000():
    """test_sparse_lp_routes_and_solves's LP (m = 1000): the automatic
    route plans and keeps the sparse engine, by the reference's rule on
    the reference's own plan."""
    A, b, c, K = _random_sparse_lp(1000, 600, np.random.default_rng(12345))
    kind, plan = _route(A, b, c, K, {"fid": 0})
    assert kind == "sparse"
    prob = jtf.pretransfo(A, b, c, K, JPars(fid=0))
    _, mj = jse.plan_sparse_lq(prob.At, prob.c, prob.layout, JPars(fid=0))
    assert mj["ada_density"] <= 0.35 and plan[1] == mj


@pytest.mark.parametrize("pars,want", [({"sparse": 0}, "dense"),
                                       ({"sparse": 1}, "sparse"),
                                       ({}, "dense")])
def test_route_by_pars_below_800(pars, want):
    """Below m = 800 the automatic route stays dense; sparse=0/1 force."""
    A, b, c, K = _random_sparse_lp(300, 200, np.random.default_rng(1))
    kind, plan = _route(A, b, c, K, {"fid": 0, **pars})
    assert kind == want and (plan is None) == (want == "dense")
