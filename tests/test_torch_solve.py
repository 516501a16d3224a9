"""Port parity, whole solves: sedumi_tpu_torch.sedumi(..., device="cpu").

* quantum and nb: c'x and b'y within 1e-8 relative of the reference
  sedumi_tpu.sedumi on the same host, with equal pinf/dinf/numerr;
* every live pars variant of the f64 path converges (the reference's
  test_pars_live, on the port);
* argument sniffing, checkpoint/resume, the infeasibility certificate;
* pars.debug and pars.profile run and change no value, the sanitizer
  names the first non-finite leaf of a step, and the ladder under a mesh
  is admitted (its solves: tests/test_torch_parallel.py; the precision
  ladder itself: tests/test_torch_precision.py).
Full arch0/control07 CPU solves are `slow`.
"""

import re

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
    """The three routes this test once found unported (ROADMAP queue A,
    `item`) are ported and raise no more.  pars.debug and pars.profile run
    a whole solve on the CPU, bit for bit the solve without them (with
    info["profile"] for the latter); the precision ladder under a mesh is
    admitted by solver.mesh_plan once the process group holds the mesh's
    ranks, which the test stands in for without spawning them (the
    ladder's mesh solves are held in tests/test_torch_parallel.py)."""
    from sedumi_tpu_torch import solver
    from sedumi_tpu_torch.params import Pars

    monkeypatch.setattr(solver, "world_size", lambda: 2)
    if "mesh_shape" in pars:
        assert solver.mesh_plan(Pars.make(pars), "dense") == \
            ({"blocks": 2}, ("blocks",), None)
        return
    At, b, c, K = _problem()
    x, y, info = pt.sedumi(At, b, c, K, {"fid": 0, **pars}, device="cpu")
    x0, y0, _ = pt.sedumi(At, b, c, K, {"fid": 0}, device="cpu")
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(y, y0)
    assert ("profile" in info) == ("profile" in pars)


def _poison(out, leaf: str):
    """A step's (new_state, stats) with a NaN in the named leaf."""
    state, st = out
    if leaf.startswith("stats."):
        f = leaf[len("stats."):]
        return state, st._replace(**{f: getattr(st, f) * float("nan")})
    if "[" not in leaf:
        fam, part = leaf.split(".") if "." in leaf else (leaf, None)
        if part is None:
            return state._replace(**{fam: getattr(state, fam)
                                     * float("nan")}), st
        cv = getattr(state, fam)
        return state._replace(**{fam: cv._replace(
            **{part: getattr(cv, part) * float("nan")})}), st
    fam, rest = leaf.split(".")
    part, idx = rest[:-1].split("[")
    cv = getattr(state, fam)
    blocks = list(getattr(cv, part))
    blocks[int(idx)] = blocks[int(idx)] * float("nan")
    return state._replace(**{fam: cv._replace(**{part: tuple(blocks)})}), st


@pytest.mark.parametrize("leaves,named", [
    (("x.l",), "x.l"), (("y",), "y"), (("kappa",), "kappa"),
    (("stats.mu",), "stats.mu"), (("z.q[1]",), "z.q[1]"),
    (("x.s[0]", "stats.alpha", "z.s[0]"), "stats.alpha")])
def test_debug_names_the_first_non_finite_leaf(monkeypatch, leaves, named):
    """pars.debug's sanitizer (reference solver.py:184-215): a step that
    emits NaN in `leaves` (on its third call) raises FloatingPointError
    naming the first of them in the reference's order (x.l, y, tau,
    kappa, stats, then the x.q, x.s, z.q, z.s blocks)."""
    _poison_third_step(monkeypatch, leaves)
    At, b, c, K = _problem()
    with pytest.raises(FloatingPointError,
                       match=rf"non-finite values in '{re.escape(named)}'"):
        pt.sedumi(At, b, c, K, {"fid": 0, "debug": 1}, device="cpu")


def test_without_debug_a_non_finite_step_is_rejected(monkeypatch):
    """The same poisoned step without pars.debug: rejected anonymously
    (mu is NaN), and the solve goes on to a finite answer."""
    _poison_third_step(monkeypatch, ("stats.mu",))
    At, b, c, K = _problem()
    x, y, info = pt.sedumi(At, b, c, K, {"fid": 0}, device="cpu")
    assert np.all(np.isfinite(x)) and info["pinf"] == 0


def _poison_third_step(monkeypatch, leaves) -> None:
    """ipm.make_step's steps emit NaN in `leaves` on their third call."""
    from sedumi_tpu_torch import ipm

    make_step = ipm.make_step

    def poisoned_make_step(*args, **kw):
        step = make_step(*args, **kw)
        calls = [0]

        def bad(*a, **k):
            out = step(*a, **k)
            calls[0] += 1
            if calls[0] == 3:
                for leaf in leaves:
                    out = _poison(out, leaf)
            return out
        return bad

    monkeypatch.setattr(ipm, "make_step", poisoned_make_step)


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
