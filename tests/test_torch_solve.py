"""Port parity, whole solves: sedumi_tpu_torch.sedumi(..., device="cpu").

* quantum and nb: c'x and b'y within 1e-8 relative of the reference
  sedumi_tpu.sedumi on the same host, with equal pinf/dinf/numerr;
* every live pars variant of the f64 path converges (the reference's
  test_pars_live, on the port);
* argument sniffing, checkpoint/resume, the infeasibility certificate;
* the routes the port does not cover raise NotImplementedError (the
  precision ladder itself: tests/test_torch_precision.py).
Full arch0/control07 CPU solves are `slow`.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sedumi_tpu_torch as pt
from sedumi_tpu.generators import feasible_problem
from sedumi_tpu_torch.examples import load_example

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("name", ["quantum", "nb"])
def test_example_matches_reference(name):
    import sedumi_tpu

    ex = load_example(name)
    xj, yj, ij = sedumi_tpu.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0})
    xt, yt, it = pt.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0},
                           device="cpu")
    for key in ("pinf", "dinf", "numerr"):
        assert it[key] == ij[key], key
    cxj, cxt = (float(np.real(np.vdot(ex.c, x))) for x in (xj, xt))
    byj, byt = (float(np.real(np.vdot(ex.b, y))) for y in (yj, yt))
    assert _rel(cxt, cxj) <= 1e-8 and _rel(byt, byj) <= 1e-8
    # and the reference gate itself (examples/test_sedumi.m:22-44)
    assert _rel(cxt, ex.optval) <= 1e-6 and _rel(byt, ex.optval) <= 1e-6


def _problem(seed=0):
    K = {"l": 4, "q": [3, 4], "s": [5, 6]}
    At, b, c, _ = feasible_problem(K, 10, seed=seed)
    return At, b, c, K


@pytest.mark.parametrize("pars", [
    {"alg": 0}, {"alg": 1}, {"alg": 2}, {"wr": 0}, {"stepdif": 1},
    {"stepdif": 0}, {"cg": {"qprec": 0}}, {"mcc": 0},
    {"chol": {"skip": 0}}, {"vplot": 1}])
def test_pars_variants_converge(pars):
    At, b, c, K = _problem(seed=3)
    x, y, info = pt.sedumi(At, b, c, K, {"fid": 0, "maxiter": 80, **pars},
                           device="cpu")
    assert info["pinf"] == 0 and info["dinf"] == 0
    assert max(info["err"]) < 1e-7, (pars, info["err"])
    if "vplot" in pars:
        assert len(info["vplot"]["v"]) == info["iter"]


def _lp():
    # min x1 + 2 x2  s.t.  x1 + x2 = 1, x >= 0  -> x = (1, 0), opt 1
    return np.array([[1.0, 1.0]]), np.array([1.0]), np.array([1.0, 2.0])


@pytest.mark.parametrize("form", ["A", "At", "feas_b", "cone_K",
                                  "cone_K_pars"])
def test_argument_sniffing(form):
    A, b, c = _lp()
    if form == "A":
        x, y, info = pt.sedumi(A, b, c, pars={"fid": 0}, device="cpu")
        assert np.allclose(x, [1.0, 0.0], atol=1e-6)
    elif form == "At":
        x, y, info = pt.sedumi(A.T, b, c, pars={"fid": 0}, device="cpu")
        assert np.allclose(x, [1.0, 0.0], atol=1e-6)
    elif form == "feas_b":
        x, y, info = pt.sedumi(A, b, pars={"fid": 0}, device="cpu")
        assert abs(float((A @ x - b)[0])) < 1e-6 and np.all(x >= -1e-8)
    elif form == "cone_K":
        x, y, info = pt.sedumi(A, b, {"l": 2}, device="cpu")
        assert abs(float((A @ x - b)[0])) < 1e-6
    else:
        x, y, info = pt.sedumi(A, b, {"l": 2}, {"fid": 0, "maxiter": 40},
                               device="cpu")
        assert abs(float((A @ x - b)[0])) < 1e-6
    assert info["pinf"] == 0 and info["dinf"] == 0


def test_infeasible_lp_certificate():
    # x1 + x2 = -1 with x >= 0 is infeasible (Farkas y = -1)
    A = sp.csc_matrix(np.array([[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]]))
    x, y, info = pt.sedumi(A, np.array([-1.0, 1.0]), np.ones(3),
                           {"l": 3}, {"fid": 0}, device="cpu")
    assert info["pinf"] == 1 and info["dinf"] == 0


def test_checkpoint_resume(tmp_path):
    At, b, c, K = _problem(seed=5)
    path = str(tmp_path / "ck.npz")
    x0, y0, i0 = pt.sedumi(At, b, c, K, {"fid": 0}, device="cpu")
    pt.sedumi(At, b, c, K, {"fid": 0, "maxiter": 6, "checkpoint_every": 3,
                            "checkpoint_path": path}, device="cpu")
    assert int(np.load(path)["it"]) == 6
    x1, y1, i1 = pt.sedumi(At, b, c, K, {"fid": 0, "resume": 1,
                                         "checkpoint_path": path},
                           device="cpu")
    assert i1["pinf"] == 0 and i1["dinf"] == 0 and i1["numerr"] == 0
    assert _rel(float(c @ x1), float(c @ x0)) < 1e-7


@pytest.mark.parametrize("pars,item", [
    ({"debug": 1}, "item 11"),
    ({"mesh_shape": {"blocks": 2}, "dtype": "mixed"}, "item 10"),
    ({"profile": 1}, "item 11")])
def test_unported_routes_raise(pars, item, monkeypatch):
    """Routes the port does not cover raise instead of falling back.  (The
    precision ladder on the sparse engine is ported: its solves are held in
    tests/test_torch_sparse_precision.py.  The f64 mesh is ported, its
    solves held in tests/test_torch_parallel.py; the ladder under a mesh
    raises (item 10b) once the process group holds the mesh's ranks, which
    the test stands in for without spawning them.)"""
    from sedumi_tpu_torch import solver

    monkeypatch.setattr(solver, "world_size", lambda: 2)
    At, b, c, K = _problem()
    with pytest.raises(NotImplementedError, match=item):
        pt.sedumi(At, b, c, K, {"fid": 0, **pars}, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("name,gate", [("arch0", True),
                                       ("control07", False)])
def test_large_example_cpu(name, gate):
    """arch0 and control07 take the reference's phases (f64, then dd64)
    with its pinf, dinf and numerr.  arch0 lands within 1e-7 of the
    reference's c'x and b'y and passes the published gate; control07's
    dd64 tail wanders at the 1e-6 level (reference solver.py:1110-1117),
    so its landing point is printed, not held."""
    import sedumi_tpu

    ex = load_example(name)
    xj, yj, ij = sedumi_tpu.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0})
    x, y, info = pt.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0},
                           device="cpu")
    assert np.all(np.isfinite(x)) and np.all(np.isfinite(y))
    assert set(info["phases"]) == set(ij["phases"]) == {"f64", "dd64"}
    for key in ("pinf", "dinf", "numerr"):
        assert info[key] == ij[key], key
    cx, by = float(ex.c @ x), float(ex.b @ y)
    print(f"{name}: port c'x={cx!r} b'y={by!r} iter={info['iter']} "
          f"phases={info['phases']}; reference c'x={float(ex.c @ xj)!r} "
          f"b'y={float(ex.b @ yj)!r} iter={ij['iter']} "
          f"phases={ij['phases']}")
    if gate:
        assert _rel(cx, float(ex.c @ xj)) <= 1e-7
        assert _rel(by, float(ex.b @ yj)) <= 1e-7
        assert _rel(cx, ex.optval) <= 1e-6 and _rel(by, ex.optval) <= 1e-6
