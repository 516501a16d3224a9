"""The port's pars.profile (sedumi_tpu_torch/profiling.py and the solver's
hook) against the reference's (sedumi_tpu/profiling.py), on the CPU.

The analytic flop counts must equal the reference's on the same problem,
each package building its own operator from the same data: arch0 and the
sdp1200 instance of chip_smoke.py (COO PSD buckets), four PSD blocks of
order 70 kept dense in the CooAOp, and a small problem's all-dense
operator.  info["profile"] from
small solves on the CPU (dense f64, 'mixed', forced sparse) must carry the
reference's keys, read from its source, each a finite number; the timed
phases run on the CPU here and on the card in tests/test_torch_cuda.py
and chip_smoke.py.
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import sedumi_tpu  # noqa: E402
import sedumi_tpu_torch as pt  # noqa: E402
from chip_smoke import random_sparse_sdp  # noqa: E402
from sedumi_tpu import opA as jopA  # noqa: E402
from sedumi_tpu import profiling as jprof  # noqa: E402
from sedumi_tpu import transform as jtf  # noqa: E402
from sedumi_tpu_torch import opA as topA  # noqa: E402
from sedumi_tpu_torch import profiling as tprof  # noqa: E402
from sedumi_tpu_torch import transform as ttf  # noqa: E402
from sedumi_tpu_torch.examples import load_example  # noqa: E402
from sedumi_tpu_torch.generators import feasible_problem  # noqa: E402

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)


def _returned_keys(func: str) -> set:
    """The keys of the dict the reference's profiling.`func` returns."""
    tree = ast.parse((ROOT / "sedumi_tpu" / "profiling.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    ret = fn.body[-1]            # return {...}
    return {k.value for k in ret.value.keys}


def _problem(name):
    if name == "arch0":
        ex = load_example("arch0")
        return ex.At, ex.b, ex.c, ex.K
    if name == "sdp1200":
        return random_sparse_sdp(1200, 600, 4, np.random.default_rng(12345))
    K = {"l": 4, "q": [3] * 8, "s": [70] * 4} if name == "psd70" \
        else {"l": 4, "q": [3, 3], "s": [4, 5]}
    At, b, c, _ = feasible_problem(K, 9, seed=2)
    return At, b, c, K


@pytest.mark.parametrize("name,kind,discount", [
    ("arch0", "coo", 3.0), ("sdp1200", "coo", 3.0),
    ("psd70", "dense", 1e9), ("small", None, None)])
def test_flop_counts_match_reference(name, kind, discount):
    """schur_flops on each package's operator of the same data (a
    CooAOp whose PSD buckets take the representation `kind`, or the
    all-dense DenseAOp), chol_flops at its m and eigh_flops on each
    package's layout: equal."""
    At, b, c, K = _problem(name)
    jprob = jtf.pretransfo(At, b, c, K, sedumi_tpu.Pars())
    tprob = ttf.pretransfo(At, b, c, K, pt.Pars())
    if kind:
        ja = jopA.build_coo_aop(jprob.At, jprob.c, jprob.layout,
                                gemm_discount=discount)
        ta = topA.build_coo_aop(tprob.At, tprob.c, tprob.layout,
                                device="cpu", gemm_discount=discount)
        assert [m[0] for m in ta.s_meta] == [m[0] for m in ja.s_meta]
        assert {m[0] for m in ta.s_meta} == {kind}
    else:
        ja = jopA.build_dense_aop(jprob.At, jprob.c, jprob.layout)
        ta = topA.build_dense_aop(tprob.At, tprob.c, tprob.layout,
                                  device="cpu")
    assert tprof.schur_flops(ta) == jprof.schur_flops(ja) > 0
    m = tprob.At.shape[1]
    assert tprof.chol_flops(m) == jprof.chol_flops(m)
    assert tprof.eigh_flops(tprob.layout) == jprof.eigh_flops(jprob.layout)


@pytest.mark.parametrize("pars,engine", [({}, "dense"),
                                         ({"dtype": "mixed"}, "dense"),
                                         ({"sparse": 1}, "sparse")])
def test_profile_has_the_reference_keys(pars, engine):
    """pars.profile=1 on the CPU: info["profile"] holds exactly the keys
    the reference's profile_iteration (dense engine; in 'mixed' on the
    f32 phase's bundle) or profile_sparse_iteration (sparse engine)
    returns, each a finite non-negative number, and the solve itself is
    the solve without pars.profile, bit for bit."""
    At, b, c, K = feasible_problem({"l": 6, "q": [4], "s": [4]}, 8, seed=5)
    x0, y0, i0 = pt.sedumi(At, b, c, K, {"fid": 0, **pars}, device="cpu")
    x, y, info = pt.sedumi(At, b, c, K, {"fid": 0, "profile": 1, **pars},
                           device="cpu")
    assert info["lin_engine"] == engine
    want = _returned_keys("profile_iteration" if engine == "dense"
                          else "profile_sparse_iteration")
    assert set(info["profile"]) == want
    assert all(np.isfinite(v) and v >= 0 for v in info["profile"].values())
    assert "profile" not in i0
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(y, y0)


def test_bench_large_block_has_the_reference_keys():
    """The synthetic large-block probe at a small size on the CPU: the
    reference's keys, positive times."""
    out = tprof.bench_large_block(d=16, k=2, m=24, device="cpu")
    assert set(out) == _returned_keys("bench_large_block")
    assert (out["d"], out["k"], out["m"], out["dtype"]) == (16, 2, 24,
                                                            "float32")
    assert out["schur_ms"] > 0 and out["chol_ms"] > 0
