"""The port's CUDA kernels against their plain-PyTorch twins, on the card.

Every test here is marked `cuda` and skips on a host without a CUDA
device.  This file imports neither jax nor the reference package, so on
the card (where jax is not installed) it runs without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -s \
        tests/test_torch_cuda.py

(-s shows the JSON line that test_arch0_witness prints.)
"""

import json
import os
import warnings

import numpy as np
import pytest
import scipy
import scipy.sparse as sp
import torch

import sedumi_tpu_torch as st
from sedumi_tpu_torch import chol, ipm, kernels, opA, pcg, schur, transform
from sedumi_tpu_torch.examples import load_example
from sedumi_tpu_torch.params import Pars

# cuBLAS is deterministic under torch.use_deterministic_algorithms only
# with a fixed workspace; it must be set before the first cuBLAS handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

EPS = float(np.finfo(np.float64).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def residual_case(m, seed):
    """cond ~ 1e14 matrix and v = M^-1 rhs: a cancellation-heavy residual."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    M = (q * np.logspace(0, -14, m)) @ q.T
    M = 0.5 * (M + M.T)
    rhs = rng.standard_normal(m)
    return M, np.linalg.solve(M, rhs), rhs


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


def sparse_sdp(seed):
    """A random sparse problem with LP, Lorentz and three PSD blocks."""
    rng = np.random.default_rng(seed)
    K = {"l": 3, "q": [4, 3], "s": [5, 5, 7]}
    n = 3 + 4 + 3 + 25 + 25 + 49
    At = sp.random(n, 11, density=0.2, random_state=seed, format="csc")
    c = rng.standard_normal(n)
    return transform.pretransfo(At, rng.standard_normal(11), c, K,
                                Pars(fid=0))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [7, 123, 666])
def test_dd_residual_kernel(cuda, m):
    M, v, rhs = (torch.as_tensor(a, device=cuda)
                 for a in residual_case(m, m))
    n0 = kernels.LAUNCHES["dd_matvec_residual"]
    r_k = pcg.dd_matvec_residual(M, v, rhs)
    assert kernels.LAUNCHES["dd_matvec_residual"] == n0 + 1
    r_p = pcg.dd_matvec_residual_plain(M, v, rhs)
    tol = 2 * EPS * r_p.abs() + 1e-28 * (M.abs() @ v.abs())
    assert bool(torch.all((r_k - r_p).abs() <= tol))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2])
def test_psd_contrib_coo_kernel(cuda, seed):
    prob = sparse_sdp(seed)
    aop = opA.build_coo_aop(prob.At, prob.c, prob.layout, device=cuda,
                            gemm_discount=0.0)
    rng = np.random.default_rng(seed)
    for part, (rep, k, d, G, pad2, T) in zip(aop.s_parts, aop.s_meta):
        assert rep == "coo"
        W = schur.psd_gram(torch.as_tensor(
            rng.standard_normal((k, d, d)), device=cuda))
        Mk = schur._psd_contrib_coo_kernel(part, k, d, G, pad2, aop.m + 1, W)
        Mp = schur._psd_contrib_coo_plain(part, k, d, G, pad2, aop.m + 1, W)
        assert float((Mk - Mp).abs().max()) <= 1e-12 * float(
            Mp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [12, 174])
def test_ldl_masked_kernel(cuda, m):
    """The masks and the factor agree bit for bit with the plain twin."""
    M = torch.as_tensor(indefinite(m, 3), device=cuda)
    fk = chol.ldl_masked(M)
    fp = chol.ldl_masked_plain(M)
    assert bool(fp.skip.any())
    for a, b in zip(fk, fp):
        assert torch.equal(a, b)


def solve_arch0(device):
    ex = load_example("arch0")
    before = dict(kernels.LAUNCHES)
    x, y, info = st.sedumi(ex.At, ex.b, ex.c, ex.K, {"fid": 0},
                           device=device)
    cx, by = float(ex.c @ x), float(ex.b @ y)
    return {"cx": cx, "by": by, "iter": int(info["iter"]),
            "rel": max(abs(cx - ex.optval), abs(by - ex.optval))
            / abs(ex.optval),
            "pinf": int(info["pinf"]), "dinf": int(info["dinf"]),
            "numerr": int(info["numerr"]), "r0": float(info["r0"]),
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in kernels.LAUNCHES},
            "x": x, "y": y}


def use_plain_twins(mp):
    """Put the three kernels' plain twins where the path calls them."""
    mp.setattr(pcg, "dd_matvec_residual", pcg.dd_matvec_residual_plain)
    mp.setattr(schur, "_psd_contrib_coo_kernel",
               schur._psd_contrib_coo_plain)
    mp.setattr(ipm, "ldl_masked", chol.ldl_masked_plain)


@pytest.mark.cuda
def test_arch0_witness(cuda, monkeypatch):
    """Separates what moves arch0's landing point on the card (the kernels,
    the card's libraries, or the order of its sums).  Solves arch0 with
    the port on the CPU; on the card as the main path runs it, twice; with
    deterministic algorithms (ordered index_add_), twice; and with
    deterministic algorithms and the plain twins in place of the three
    kernels.  Prints one JSON line with the library versions, each run's
    c'x, b'y, iterations, rel, pinf, dinf, numerr, r0 and kernel launches,
    and which ops warned that they have no deterministic implementation.
    Asserts that the deterministic runs repeat bit for bit, that the plain
    twins land where the kernels land, and that the card lands where the
    CPU of the same host lands."""
    runs = {"cpu": solve_arch0("cpu")}
    runs["card_1"] = solve_arch0(cuda)
    runs["card_2"] = solve_arch0(cuda)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs["det_1"] = solve_arch0(cuda)
            runs["det_2"] = solve_arch0(cuda)
            with monkeypatch.context() as mp:
                use_plain_twins(mp)
                runs["det_plain"] = solve_arch0(cuda)
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split("\n")[0][:120] for w in caught
                     if "deterministic" in str(w.message)})

    def same(a, b):
        return bool(np.array_equal(runs[a]["x"], runs[b]["x"])
                    and np.array_equal(runs[a]["y"], runs[b]["y"]))

    print(json.dumps({
        "versions": {"torch": torch.__version__, "numpy": np.__version__,
                     "scipy": scipy.__version__},
        "arch0_witness": {k: {f: v for f, v in r.items()
                              if f not in ("x", "y")}
                          for k, r in runs.items()},
        "card_runs_identical": same("card_1", "card_2"),
        "det_runs_identical": same("det_1", "det_2"),
        "nondeterministic_ops": nondet}), flush=True)
    for r in runs.values():
        assert np.all(np.isfinite(r["x"])) and np.all(np.isfinite(r["y"]))
        assert r["pinf"] == 0 and r["dinf"] == 0
    assert runs["det_1"]["launches"]["psd_contrib_coo"] > 0
    assert sum(runs["det_plain"]["launches"].values()) == 0
    assert same("det_1", "det_2") and not nondet

    def close(a, b, tol):
        return all(abs(runs[a][f] - runs[b][f]) <= tol * abs(runs[b][f])
                   for f in ("cx", "by"))

    assert close("det_plain", "det_1", 1e-9)
    assert close("det_1", "cpu", 1e-8)
