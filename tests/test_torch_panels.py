"""The port's Schur-panel routines (sedumi_tpu_torch/parallel/panels.py)
against the reference's (sedumi_tpu/parallel/panels.py), on the CPU.

The port runs on 4 gloo ranks (parallel.launch.run_spmd, one spawn for the
whole module); the reference on make_mesh(4) of the suite's 8 virtual
devices, so both split the same way.  Inputs come from numpy with a seed
and go to both packages.  Mirrors tests/test_panels.py, plus the plain
versions of kernels K14/K15 against numpy and the non-PD case, and the
panel engine in the precision ladder's phases under a mesh (formed,
factored and solved in f32; formed in f32 with an f64 factor) against the
port's dense engine in the same dtypes.
"""

import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import __graft_entry__ as ge  # noqa: E402
from sedumi_tpu import nt as jnt  # noqa: E402
from sedumi_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from sedumi_tpu.parallel import panels as jpanels  # noqa: E402
from sedumi_tpu_torch import convert  # noqa: E402
from sedumi_tpu_torch.ipm import DenseSchurEngine  # noqa: E402
from sedumi_tpu_torch.opA import DenseAOp  # noqa: E402
from sedumi_tpu_torch.structs import cv_cast  # noqa: E402
from sedumi_tpu_torch.nt import Scaling  # noqa: E402
from sedumi_tpu_torch.parallel import entry  # noqa: E402
from sedumi_tpu_torch.parallel import panels as tpanels  # noqa: E402
from sedumi_tpu_torch.parallel.launch import run_spmd  # noqa: E402

N = 4          # ranks of the port, devices of the reference's mesh
EPS32 = float(np.finfo(np.float32).eps)


def _spd(m, rng, cond=1e3):
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    d = np.geomspace(1.0, 1.0 / cond, m)
    return (Q * d) @ Q.T


def _engine_inputs():
    """The reference test's panel-engine case: its _small_problem(4, 4,
    24, seed=1) operator and the NT scaling of its start, as numpy."""
    _, (aop, b, rs, state, reg), _ = ge._small_problem(
        n_blocks_s=4, n_blocks_q=4, m=24, seed=1)
    S = jnt.compute_scaling(state.x, state.z)
    S_np = types.SimpleNamespace(**{
        f: np.asarray(v) if f in ("d_l", "lam_l")
        else [np.asarray(a) for a in v]
        for f, v in zip(Scaling._fields, S)})
    aop_np = (np.asarray(aop.Al), [np.asarray(a) for a in aop.Aq],
              [np.asarray(a) for a in aop.As], aop.q_shapes, aop.s_shapes)
    rhs = np.random.default_rng(0).standard_normal(aop.m)
    return aop, S, aop_np, S_np, float(reg), rhs


@pytest.fixture(scope="module")
def case():
    """Every input, the reference's answers, and the port's from one
    spawn of N ranks."""
    rng = np.random.default_rng(12345)
    M_chol = _spd(N * 8 * 3, rng)                 # bs 8, 3 blocks a rank
    M_solve = _spd(N * 4 * 2, rng)                # bs 4, 2 blocks a rank
    b_solve = rng.standard_normal(M_solve.shape[0])
    M_bad = M_chol.copy()
    M_bad[40, 40] = -1.0                          # block 5's pivot < 0
    aop, S, aop_np, S_np, reg, rhs = _engine_inputs()
    jobs = [("chol", M_chol, 8), ("solve", M_solve, b_solve, 4),
            ("chol", M_bad, 8),
            ("engine", aop_np, S_np, reg, rhs, 4)]
    jobs += [("engine", aop_np, S_np, reg, rhs, 4, "float32", fdt)
             for fdt in (None, "float64")]
    port = run_spmd(entry.rank_panel_jobs, N, args=(jobs, "cpu"),
                    device="cpu", timeout_s=240)
    mesh = jmake_mesh(N)
    ref = {
        "chol": np.asarray(jpanels.dist_cholesky(jnp.asarray(M_chol), mesh,
                                                 "blocks", 8)),
        "bad": np.asarray(jpanels.dist_cholesky(jnp.asarray(M_bad), mesh,
                                                "blocks", 8)),
    }
    L = jpanels.dist_cholesky(jnp.asarray(M_solve), mesh, "blocks", 4)
    y = jpanels._dist_trisolve(L, jnp.asarray(b_solve), mesh, "blocks", 4,
                               lower=True)
    ref["solve"] = np.asarray(jpanels._dist_trisolve(L, y, mesh, "blocks",
                                                     4, lower=False))
    eng = jpanels.PanelSchurEngine(mesh, bs=4)
    ctx, ahc, chc, ok = eng.prepare(aop, S, reg)
    ref["engine"] = (np.asarray(ahc), float(chc), bool(ok),
                     np.asarray(eng.solve(ctx, jnp.asarray(rhs))))
    return dict(M_chol=M_chol, M_solve=M_solve, b_solve=b_solve,
                aop_np=aop_np, S_np=S_np, reg=reg, rhs=rhs, port=port,
                ref=ref)


def test_dist_cholesky_matches_reference(case):
    """Sums in another order: within cond * m * eps of max|L|."""
    L_ref = case["ref"]["chol"]
    for r, out in enumerate(case["port"]):
        L = out[0]
        assert np.abs(L - L_ref).max() <= 1e-10 * np.abs(L_ref).max(), r


def test_dist_cholesky_matches_lapack(case):
    """The reference test's check, and the strict upper triangle exactly
    0, on every rank."""
    Lref = np.linalg.cholesky(case["M_chol"])
    for out in case["port"]:
        L = out[0]
        assert np.allclose(L, Lref, rtol=0, atol=1e-9 * np.abs(Lref).max())
        assert np.all(np.triu(L, 1) == 0.0)


def test_dist_trisolves_match_reference(case):
    x_ref = case["ref"]["solve"]
    xsol = np.linalg.solve(case["M_solve"], case["b_solve"])
    for out in case["port"]:
        x = out[1]
        assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
        assert np.allclose(x, xsol, atol=1e-8 * np.abs(xsol).max())


def test_non_pd_matrix_gives_nan_in_both_packages(case):
    """A non-positive pivot: NaN from that block column on, so the
    engine's ok (all finite) is False in both packages."""
    bad_ref = case["ref"]["bad"]
    assert not np.all(np.isfinite(bad_ref))
    for out in case["port"]:
        L = out[2]
        assert not np.all(np.isfinite(L))
        # the columns before the failed block are the good factor's
        np.testing.assert_array_equal(np.isfinite(L[:, :40]),
                                      np.isfinite(bad_ref[:, :40]))


def test_panel_engine_matches_reference(case):
    """PanelSchurEngine.prepare/solve (bs 4) against the reference's on
    its _small_problem(4, 4, 24, seed=1) and NT scaling."""
    ahc_r, chc_r, ok_r, x_r = case["ref"]["engine"]
    for out in case["port"]:
        ahc, chc, ok, x = out[3]
        assert ok and ok_r
        assert np.abs(ahc - ahc_r).max() <= 1e-12 * max(
            1.0, np.abs(ahc_r).max())
        assert abs(float(chc) - chc_r) <= 1e-12 * max(1.0, abs(chc_r))
        assert np.abs(x - x_r).max() <= 1e-10 * np.abs(x_r).max()


def test_panel_engine_matches_dense_engine(case):
    """The port's panel engine against its DenseSchurEngine at the
    reference test's tolerances."""
    aop = convert.dense_aop_from_numpy(*case["aop_np"], device="cpu")
    S = convert.scaling_from_numpy(case["S_np"], device="cpu")
    dense = DenseSchurEngine()
    ctx, ahc_d, chc_d, ok_d = dense.prepare(aop, S, case["reg"])
    x_d = dense.solve(ctx, torch.as_tensor(case["rhs"])).numpy()
    ahc, chc, ok, x = case["port"][0][3]
    assert ok_d and ok
    assert np.allclose(ahc, ahc_d.numpy(), atol=1e-10)
    assert np.allclose(float(chc), float(chc_d), atol=1e-10)
    assert np.allclose(x, x_d, rtol=1e-8, atol=1e-10 * np.abs(x_d).max())


@pytest.mark.parametrize("k,fdt,tol", [(4, None, 1e-5),
                                       (5, torch.float64, 1e-6)])
def test_panel_engine_ladder_phases_match_dense_engine(case, k, fdt, tol):
    """PanelSchurEngine as the ladder's phases run it under a mesh, on
    the reference test's inputs in f32: formed, factored and solved in
    f32 (the f32 phase; K14-f32/K15-f32's plain versions here), and
    formed in f32 with an f64 factor (the hybrid phase's factor_dtype, as
    ipm.make_step sets it), against the port's DenseSchurEngine in the
    same dtypes: ahc and chc (the same f32 formation, summed in another
    thread count's order) within 4 eps_f32 of their largest entry, x in
    f32 within `tol` of max|x| (the f32 factors' refinements differ: cond
    eps_f32; the f64 factor's solve rounds once to f32), the same x on
    every rank."""
    f32 = torch.float32
    aop = convert.dense_aop_from_numpy(*case["aop_np"], device="cpu")
    aop = DenseAOp(aop.Al.to(f32), [a.to(f32) for a in aop.Aq],
                   [a.to(f32) for a in aop.As], aop.q_shapes, aop.s_shapes)
    S = cv_cast(convert.scaling_from_numpy(case["S_np"], device="cpu"), f32)
    dense = DenseSchurEngine(factor_dtype=fdt)
    ctx, ahc_d, chc_d, ok_d = dense.prepare(aop, S, case["reg"])
    x_d = dense.solve(ctx, torch.as_tensor(case["rhs"], dtype=f32)).numpy()
    for out in case["port"]:
        ahc, chc, ok, x = out[k]
        assert ok and ok_d
        assert x.dtype == np.float32 and ahc.dtype == np.float32
        amax = max(1.0, float(ahc_d.abs().max()))
        assert np.abs(ahc - ahc_d.numpy()).max() <= 4 * EPS32 * amax
        assert abs(float(chc) - float(chc_d)) <= 4 * EPS32 * max(
            1.0, abs(float(chc_d)))
        assert np.abs(x - x_d).max() <= tol * np.abs(x_d).max()
        np.testing.assert_array_equal(x, case["port"][0][k][3])


@pytest.mark.parametrize("j", [0, 2, 4])
def test_panel_chol_plain_column_step(j):
    """K14's plain version for one block column against numpy."""
    rng = np.random.default_rng(7 + j)
    nb, bs = 5, 6
    C = rng.standard_normal((nb, bs, bs))
    C[j] = _spd(bs, rng, cond=1e2)
    Lcol = tpanels.panel_chol_plain(torch.as_tensor(C), j).numpy()
    Ljj = np.linalg.cholesky(C[j])
    want = np.zeros_like(C)
    want[j] = Ljj
    for k in range(j + 1, nb):
        want[k] = C[k] @ np.linalg.inv(Ljj).T
    assert np.abs(Lcol - want).max() <= 1e-12 * np.abs(want).max()
    assert np.all(Lcol[:j] == 0.0) and np.all(np.triu(Lcol[j], 1) == 0.0)


def test_panel_chol_plain_non_pd_block_is_nan():
    rng = np.random.default_rng(3)
    C = np.stack([_spd(4, rng) for _ in range(3)])
    C[1, 2, 2] = -1.0
    Lcol = tpanels.panel_chol_plain(torch.as_tensor(C), 1).numpy()
    assert np.all(Lcol[0] == 0.0)
    assert np.all(np.isnan(Lcol[1:]))


def test_trisolve_plain_steps():
    """K15's three plain steps against numpy: the forward step of block
    row j, the backward contribution of a panel and the backward solve."""
    rng = np.random.default_rng(11)
    bs, nb = 4, 6
    mp = bs * nb
    L = np.linalg.cholesky(_spd(mp, rng))
    j = 3
    x = np.zeros(mp)
    x[:j * bs] = rng.standard_normal(j * bs)
    bj = rng.standard_normal(bs)
    row = L[j * bs:(j + 1) * bs]
    got = tpanels.trisolve_fwd_plain(torch.as_tensor(row), torch.as_tensor(x),
                                     torch.as_tensor(bj), j).numpy()
    Ljj = L[j * bs:(j + 1) * bs, j * bs:(j + 1) * bs]
    want = np.linalg.solve(Ljj, bj - row[:, :j * bs] @ x[:j * bs])
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # backward: the panel of blocks 2..3 (g0 = 2) for column block j = 2
    xb = rng.standard_normal(mp)
    g0, nb_loc = 2, 2
    L3 = L[g0 * bs:(g0 + nb_loc) * bs]
    contrib = tpanels.trisolve_bwd_contrib_plain(
        torch.as_tensor(L3), torch.as_tensor(xb), bs, g0, 2).numpy()
    rows = slice(3 * bs, 4 * bs)                  # only block 3 > 2
    want_c = L[rows, 2 * bs:3 * bs].T @ xb[rows]
    assert np.abs(contrib - want_c).max() <= 1e-12 * np.abs(want_c).max()
    xj = tpanels.trisolve_bwd_solve_plain(
        torch.as_tensor(Ljj), torch.as_tensor(bj),
        torch.as_tensor(contrib)).numpy()
    want_x = np.linalg.solve(Ljj.T, bj - contrib)
    assert np.abs(xj - want_x).max() <= 1e-12 * np.abs(want_x).max()


def test_bs_for_matches_reference():
    """The adaptive panel width: 128 halved while n * bs > m, floor 4."""
    for n in (1, 2, 4, 8):
        ref = jpanels.PanelSchurEngine(
            types.SimpleNamespace(shape={"blocks": n}))
        port = tpanels.PanelSchurEngine(
            types.SimpleNamespace(axis_size=lambda axis, n=n: n))
        for m in (0, 1, 5, 16, 33, 100, 257, 948, 1024, 5000):
            assert port._bs_for(m) == ref._bs_for(m), (n, m)
    fixed = tpanels.PanelSchurEngine(
        types.SimpleNamespace(axis_size=lambda axis: 2), bs=12)
    assert fixed._bs_for(5000) == 12


def test_step_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors the K14/K15 wrappers run the plain versions and
    count no launch; the kernels' width limit raises, never falls back."""
    from sedumi_tpu_torch import kernels

    rng = np.random.default_rng(5)
    C = torch.as_tensor(np.stack([_spd(4, rng) for _ in range(3)]))
    before = dict(kernels.LAUNCHES)
    assert torch.equal(tpanels.panel_chol_step(C, 1),
                       tpanels.panel_chol_plain(C, 1))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="bs <= 128"):
        tpanels._check_bs(256)
