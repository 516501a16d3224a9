"""The port's multi-device path (sedumi_tpu_torch/parallel, solver's
pars.mesh_shape) against the reference's, on the CPU.

The port's mesh runs on 4 gloo ranks (parallel.launch.run_spmd: one
spawn serves the whole module); the reference's on its 8 virtual
devices.  Mirrors tests/test_parallel.py (entry, dryrun_multichip, the
sharded step) and the end-to-end panel solve of tests/test_panels.py,
holds the precision ladder under a mesh ('mixed' on {"hosts": 2,
"panels": 2}) to the port's unsharded 'mixed' solve (the reference's mesh
'mixed' solve, ~74 s on a CPU, is `slow`), and checks the routes that need
no spawn: a world smaller than the mesh, dd64 under a mesh, the ladder's
mesh plan and phases and the sparse route.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import __graft_entry__ as ge  # noqa: E402
import sedumi_tpu_torch as pt  # noqa: E402
from sedumi_tpu import sedumi as jsedumi  # noqa: E402
from sedumi_tpu_torch import solver  # noqa: E402
from sedumi_tpu_torch.generators import feasible_problem  # noqa: E402
from sedumi_tpu_torch.params import Pars  # noqa: E402
from sedumi_tpu_torch.parallel import entry  # noqa: E402
from sedumi_tpu_torch.parallel.launch import run_spmd  # noqa: E402

N = 4
E2E = ("feasible", {"l": 6, "q": [4, 4], "s": [6, 6]}, 25, 7)
# the precision ladder under a mesh: the f32 phase on the panel engine in
# f32, the formation split over "hosts"
MIXED_MESH = {"fid": 0, "mesh_shape": {"hosts": 2, "panels": 2},
              "dtype": "mixed"}


def _e2e_data():
    _, K, m, seed = E2E
    At, b, c, _ = feasible_problem(K, m, seed=seed)
    return At, b, c, K


@pytest.fixture(scope="module")
def spmd():
    """Every rank's results of one spawn of N ranks."""
    calls = [("rank_dryrun", (N,)),
             ("rank_sharded_step", (8, 7, 3)),
             ("rank_sedumi", (E2E, {"fid": 0, "mesh_shape": {"panels": 4}})),
             ("rank_sedumi", (E2E, {"fid": 0,
                                    "mesh_shape": {"hosts": 2,
                                                   "panels": 2}})),
             ("rank_sedumi", (E2E, MIXED_MESH))]
    return run_spmd(entry.rank_batch, N, args=(calls, "cpu"), device="cpu",
                    timeout_s=300)


@pytest.fixture(scope="module")
def unsharded():
    At, b, c, K = _e2e_data()
    x, y, info = pt.sedumi(At, b, c, K, {"fid": 0}, device="cpu")
    return x, y, info, float(c @ x)


def test_entry_matches_reference():
    """One full step of the small problem, on one device."""
    fn, args = ge.entry()
    mu_ref = float(fn(*args)[1].mu)
    step, targs = entry.entry(device="cpu")
    mu = float(step(*targs)[1].mu)
    assert np.isfinite(mu)
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-10)


def test_dryrun_multichip_four_ranks(spmd):
    """The block-split step, the panel step and the 2-D mesh's two steps
    run on 4 ranks, agree on every rank and, for the first step, with the
    unsharded step."""
    outs = [r[0] for r in spmd]
    for out in outs[1:]:
        assert out == outs[0]
    out = outs[0]
    assert set(out) == {"blocks", "blocks_step2", "panels", "hosts_blocks",
                        "hosts_panels"}
    step, args, _ = entry._small_problem(2 * N, 2 * N, m=8, seed=1,
                                         device="cpu")
    _, st = step(*args)
    for key in ("blocks", "panels", "hosts_blocks", "hosts_panels"):
        np.testing.assert_allclose(out[key][0], float(st.mu), rtol=1e-10)
        np.testing.assert_allclose(out[key][1], float(st.alpha), rtol=1e-8)


def test_sharded_matches_unsharded(spmd):
    """The reference test's case and tolerances: the formation split over
    {"blocks": 4} against the unsharded step."""
    step, args, _ = entry._small_problem(8, 8, m=7, seed=3, device="cpu")
    ref_state, ref_stats = step(*args)
    for r in spmd:
        sh = r[1]
        np.testing.assert_allclose(sh["mu"], float(ref_stats.mu), rtol=1e-10)
        np.testing.assert_allclose(sh["alpha"], float(ref_stats.alpha),
                                   rtol=1e-8)
        np.testing.assert_allclose(sh["y"], ref_state.y.numpy(), rtol=1e-7,
                                   atol=1e-10)


def test_panels_end_to_end_matches_reference(spmd):
    """sedumi() with {"panels": 4} on 4 ranks against the reference's
    {"panels": 4} solve: pinf, dinf and numerr equal, c'x and b'y within
    1e-8 relative; every rank returns the same x, y and info."""
    At, b, c, K = _e2e_data()
    xr, yr, info_r = jsedumi(At, b, c, K,
                             {"fid": 0, "mesh_shape": {"panels": 4}})
    cxr, byr = float(c @ xr), float(b @ yr)
    port = [r[2] for r in spmd]
    p = port[0]
    print(f"\n{{\"panels\": 4}} iterations: port {p['info']['iter']} "
          f"{p['phases']}, reference {info_r['iter']}; comm "
          f"{p['comm_calls']} calls {p['comm_s']:.2f} s of {p['wall']:.2f} s")
    for key in ("pinf", "dinf", "numerr"):
        assert p["info"][key] == info_r[key], key
    assert abs(p["cx"] - cxr) <= 1e-8 * abs(cxr)
    assert abs(p["by"] - byr) <= 1e-8 * abs(byr)
    assert set(p["phases"]) == {"f64"}        # dd64 is off under a mesh
    for q in port[1:]:
        np.testing.assert_array_equal(q["x"], p["x"])
        np.testing.assert_array_equal(q["y"], p["y"])
        assert q["info"] == p["info"] and q["phases"] == p["phases"]


def test_hosts_panels_matches_unsharded(spmd, unsharded):
    """The 2-D mesh (formation split over "hosts", panels on "panels")
    within the reference test's 1e-6 (1 + |c'x|) of the unsharded solve."""
    _, _, _, cx0 = unsharded
    for r in spmd:
        p = r[3]
        assert p["info"]["pinf"] == 0 and p["info"]["dinf"] == 0
        assert p["info"]["numerr"] < 2
        assert abs(p["cx"] - cx0) <= 1e-6 * (1.0 + abs(cx0))
        np.testing.assert_array_equal(p["x"], spmd[0][3]["x"])


@pytest.fixture(scope="module")
def unsharded_mixed():
    At, b, c, K = _e2e_data()
    x, y, info = pt.sedumi(At, b, c, K, {"fid": 0, "dtype": "mixed"},
                           device="cpu")
    return x, y, info, float(c @ x)


def test_mixed_ladder_under_a_mesh(spmd, unsharded_mixed):
    """'mixed' on {"hosts": 2, "panels": 2} (4 ranks): the mesh's ladder
    (f32 first, no dd64) lands within 1e-6 relative of the port's
    unsharded 'mixed' c'x (which tests/test_torch_precision.py holds to
    the reference) with pinf = dinf = 0 and numerr < 2; every rank
    returns the same x, y and info."""
    _, _, info0, cx0 = unsharded_mixed
    p = spmd[0][4]
    print(f"\nmesh 'mixed' phases {p['phases']} (unsharded "
          f"{ {k: v['iters'] for k, v in info0['phases'].items()} }); comm "
          f"{p['comm_calls']} calls {p['comm_s']:.2f} s of {p['wall']:.2f} s")
    assert p["info"]["pinf"] == 0 and p["info"]["dinf"] == 0
    assert p["info"]["numerr"] < 2
    assert abs(p["cx"] - cx0) <= 1e-6 * abs(cx0)
    assert next(iter(p["phases"])) == "f32" and "dd64" not in p["phases"]
    assert set(p["phases"]) <= {"f32", "hybrid", "host64"}
    for r in spmd[1:]:
        q = r[4]
        np.testing.assert_array_equal(q["x"], p["x"])
        np.testing.assert_array_equal(q["y"], p["y"])
        assert q["info"] == p["info"] and q["phases"] == p["phases"]


@pytest.mark.slow
def test_mixed_ladder_under_a_mesh_matches_reference(spmd):
    """The reference's own mesh 'mixed' solve of the same instance on the
    same mesh (its virtual devices; ~74 s on a CPU): c'x within 1e-6
    relative, the same pinf, dinf and numerr, and neither ladder reaches
    dd64."""
    At, b, c, K = _e2e_data()
    xr, yr, info_r = jsedumi(At, b, c, K, dict(MIXED_MESH))
    cxr = float(c @ xr)
    p = spmd[0][4]
    print(f"\nmesh 'mixed': port {p['phases']}, reference "
          f"{ {k: v['iters'] for k, v in info_r['phases'].items()} }")
    for key in ("pinf", "dinf", "numerr"):
        assert p["info"][key] == info_r[key], key
    assert abs(p["cx"] - cxr) <= 1e-6 * abs(cxr)
    assert "dd64" not in info_r["phases"] and "dd64" not in p["phases"]


def test_world_smaller_than_mesh_runs_unsharded(unsharded):
    """No process group: the mesh is not built, the solve is the unsharded
    one (dd64 admitted as without a mesh), bit for bit."""
    At, b, c, K = _e2e_data()
    x, y, info = pt.sedumi(At, b, c, K,
                           {"fid": 0, "mesh_shape": {"panels": 4}},
                           device="cpu")
    x0, y0, info0, _ = unsharded
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(y, y0)
    assert "dd64" in info["phases"]


def test_dd64_is_off_under_a_mesh():
    """The reference's "no mesh" term of the dd64 gate."""
    from sedumi_tpu_torch.transform import pretransfo

    At, b, c, K = _e2e_data()
    prob = pretransfo(At, b, c, K, Pars(fid=0))
    m = prob.At.shape[1]
    assert solver.dd64_admitted(prob.layout, m)
    assert not solver.dd64_admitted(prob.layout, m, mesh=True)
    assert solver.phase_ladder("dense", prob.layout, m, "f64") == \
        ["f64", "dd64"]
    assert solver.phase_ladder("dense", prob.layout, m, "f64",
                               mesh=True) == ["f64"]


@pytest.fixture
def world4(monkeypatch):
    monkeypatch.setattr(solver, "world_size", lambda: 4)


@pytest.mark.parametrize("dtype", ["mixed", "float32"])
def test_ladder_under_a_mesh_raises(world4, dtype):
    """The ladder under a mesh, which this test once found refused
    (ROADMAP A10b), is admitted: mesh_plan builds the mesh (the panel
    engine on "blocks"), and the phases are the reference's mesh ladder,
    [f32, hybrid, host64] under 'mixed' and [f32] under 'float32', with
    no dd64 (solver.py:636-644 of the reference)."""
    from sedumi_tpu_torch.transform import pretransfo

    mode = "mixed" if dtype == "mixed" else "f32"
    pars = Pars.make({"mesh_shape": {"panels": 4}, "dtype": dtype})
    assert solver.mesh_plan(pars, "dense") == ({"blocks": 4}, (), "blocks")
    At, b, c, K = _e2e_data()
    prob = pretransfo(At, b, c, K, Pars(fid=0))
    m = prob.At.shape[1]
    assert solver.phase_ladder("dense", prob.layout, m, mode, mesh=True) \
        == (["f32", "hybrid", "host64"] if dtype == "mixed" else ["f32"])


@pytest.mark.parametrize("shape,plan", [
    ({"panels": 4}, ({"blocks": 4}, (), "blocks")),
    ({"blocks": 4}, ({"blocks": 4}, ("blocks",), None)),
    ({"hosts": 2, "panels": 2},
     ({"hosts": 2, "panels": 2}, ("hosts",), "panels")),
    ({"hosts": 2, "blocks": 2},
     ({"hosts": 2, "blocks": 2}, ("hosts", "blocks"), None)),
])
def test_mesh_plan_follows_the_reference(world4, shape, plan):
    """The reference's axes (solver.py:321-335, 357-369): a one-axis mesh
    is "blocks"; every axis but "panels" splits the formation; the panel
    engine takes "panels" when the mesh has it."""
    assert solver.mesh_plan(Pars.make({"mesh_shape": shape}),
                            "dense") == plan


def test_sparse_route_ignores_the_mesh(world4):
    pars = Pars.make({"mesh_shape": {"hosts": 2, "panels": 2},
                      "dtype": "mixed"})
    assert solver.mesh_plan(pars, "sparse") == \
        ({"hosts": 2, "panels": 2}, (), None)


def test_world_larger_than_mesh_raises(monkeypatch):
    monkeypatch.setattr(solver, "world_size", lambda: 8)
    with pytest.raises(ValueError, match="process group"):
        solver.mesh_plan(Pars.make({"mesh_shape": {"panels": 4}}), "dense")
    assert torch.distributed.is_available()


class _RankView:
    """One position of an n-rank axis, without a process group: the split
    bookkeeping needs only the axis size and this rank's index."""

    def __init__(self, n, i):
        self.n, self.i = n, i

    def axis_size(self, axis):
        return self.n

    def axis_index(self, axis):
        return self.i


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("coo", [False, True])
def test_formation_split_adds_up(n, coo):
    """Over the ranks of the axis, the split buckets' partial Schur
    complements plus the replicated parts, added once, give the unsharded
    formation at a random interior scaling.  The DenseAOp of the small
    problem splits its 8 Lorentz cones (its PSD blocks pack into one
    superblock); the CooAOp of 4 PSD blocks of order 70, kept dense,
    splits those too; n = 3 splits nothing."""
    from chip_smoke import interior_point
    from sedumi_tpu_torch import nt
    from sedumi_tpu_torch.opA import build_coo_aop
    from sedumi_tpu_torch.parallel import mesh as pm
    from sedumi_tpu_torch.schur import build_schur
    from sedumi_tpu_torch.transform import pretransfo

    if coo:
        K = {"l": 4, "q": [3] * 8, "s": [70] * 4}
        At, b, c, Ks = feasible_problem(K, 7, seed=3)
        prob = pretransfo(At, b, c, Ks, Pars(fid=0))
        layout = prob.layout
        aop = build_coo_aop(prob.At, prob.c, layout, device="cpu",
                            gemm_discount=1e9)      # dense PSD buckets
    else:
        _, (aop, *_), (layout, *_) = entry._small_problem(
            8, 8, m=7, seed=3, device="cpu")
    meta = {"nl": layout.l,
            "q_shapes": [(bk.count, bk.dim) for bk in layout.q_buckets],
            "s_shapes": [(bk.count, bk.dim) for bk in layout.s_buckets]}
    rng = np.random.default_rng(n)
    S = nt.compute_scaling(interior_point(meta, "cpu", rng),
                           interior_point(meta, "cpu", rng))
    want = build_schur(aop, S)
    shard = pm.shard_coo_aop if coo else pm.shard_aop
    got = None
    for i in range(n):
        sh = shard(aop, _RankView(n, i), "blocks")
        assert sh.q_split == [n != 3]
        assert sh.s_split == [coo and n != 3]
        s_loc, s_rest = sh._scalings(S)
        part = build_schur(sh.local, s_loc)
        got = part if got is None else got + part
    got = got + build_schur(sh.rest, s_rest)
    assert torch.allclose(got, want, rtol=1e-13,
                          atol=1e-13 * float(want.abs().max()))
    x = interior_point(meta, "cpu", rng)
    v = pm.shard_conevec(x, _RankView(n, 1), "blocks")
    assert v.q[0].shape[0] == (8 if n == 3 else 8 // n)
    assert torch.equal(v.q[0], x.q[0][(8 // n if n != 3 else 0):][
        :v.q[0].shape[0]])


def test_launcher_fails_on_a_failing_or_late_rank():
    """A rank that raises fails the call with its traceback; ranks that
    overrun timeout_s are killed and the call raises.  No rank outlives
    the call."""
    import multiprocessing

    with pytest.raises(RuntimeError, match="no-such-example"):
        run_spmd(entry.rank_sedumi, 2,
                 args=(("example", "no-such-example"), {"fid": 0}, "cpu"),
                 device="cpu", timeout_s=120)
    with pytest.raises(TimeoutError):
        run_spmd(entry.rank_dryrun, 2, args=(2, "cpu"), device="cpu",
                 timeout_s=0.5)
    assert multiprocessing.active_children() == []
