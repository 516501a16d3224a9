"""Port parity, host front end: the copied numpy modules and the operator.

pretransfo must give identical internal data (At, b, c, Layout buckets) in
sedumi_tpu_torch and the reference sedumi_tpu on all six bundled examples;
build_coo_aop must pick the same dense/coo representation per PSD bucket
(gemm_discount=3.0) and hold the same arrays.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sedumi_tpu_torch as pt
from sedumi_tpu import opA as j_opA
from sedumi_tpu import transform as j_tf
from sedumi_tpu.examples import load_example as j_load
from sedumi_tpu.params import Pars as JPars
from sedumi_tpu_torch import opA as t_opA
from sedumi_tpu_torch import transform as t_tf
from sedumi_tpu_torch.examples import load_example as t_load
from sedumi_tpu_torch.params import Pars as TPars

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)

EXAMPLES = ["quantum", "nb", "control07", "arch0", "trto3",
            "OH_2Pi_STO-6GN9r12g1T2"]


def _both(name):
    ej, et = j_load(name), t_load(name)
    pj = j_tf.pretransfo(ej.At, ej.b, ej.c, ej.K, JPars(fid=0))
    pt_ = t_tf.pretransfo(et.At, et.b, et.c, et.K, TPars(fid=0))
    return pj, pt_


@pytest.mark.parametrize("name", EXAMPLES)
def test_pretransfo_identical(name):
    pj, pt_ = _both(name)
    assert (sp.csc_matrix(pj.At) != sp.csc_matrix(pt_.At)).nnz == 0
    np.testing.assert_array_equal(pj.b, pt_.b)
    np.testing.assert_array_equal(pj.c, pt_.c)
    lj, lt = pj.layout, pt_.layout
    assert (lj.l, lj.q, lj.s, lj.s_herm) == (lt.l, lt.q, lt.s, lt.s_herm)
    for bj, bt in zip(lj.q_buckets + lj.s_buckets,
                      lt.q_buckets + lt.s_buckets):
        assert (bj.dim, bj.block_ids, bj.herm) == \
            (bt.dim, bt.block_ids, bt.herm)
    assert (sp.csc_matrix(pj.T) != sp.csc_matrix(pt_.T)).nnz == 0


# representation per PSD bucket (nb has no PSD bucket)
@pytest.mark.parametrize("name,reps", [("quantum", ["dense"]),
                                       ("control07", ["dense"]),
                                       ("arch0", ["coo"]),
                                       ("trto3", ["coo"])])
def test_build_coo_aop_matches_reference(name, reps):
    pj, pt_ = _both(name)
    aj = j_opA.build_coo_aop(pj.At, pj.c, pj.layout)
    at = t_opA.build_coo_aop(pt_.At, pt_.c, pt_.layout, device="cpu")
    assert tuple(aj.s_meta) == tuple(at.s_meta)
    assert [meta[0] for meta in at.s_meta] == reps
    np.testing.assert_array_equal(np.asarray(aj.Al), at.Al.numpy())
    for a, b in zip(aj.Aq, at.Aq):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for partj, partt, meta in zip(aj.s_parts, at.s_parts, aj.s_meta):
        for key, val in partj.items():
            np.testing.assert_array_equal(np.asarray(val),
                                          partt[key].numpy(), err_msg=key)
        if meta[0] == "coo":
            rowptr = partt["b_rowptr"].numpy()
            b_row = np.asarray(partj["b_row"])
            assert rowptr[-1] == b_row.size
            np.testing.assert_array_equal(np.diff(rowptr),
                                          np.bincount(b_row,
                                                      minlength=aj.m + 1))


def test_coo_apply_adjoint_match_reference():
    pj, pt_ = _both("arch0")
    aj = j_opA.build_coo_aop(pj.At, pj.c, pj.layout)
    at = t_opA.build_coo_aop(pt_.At, pt_.c, pt_.layout, device="cpu")
    rng = np.random.default_rng(3)
    lay = pj.layout
    xf = rng.standard_normal(lay.N)
    from sedumi_tpu.structs import from_flat as jff
    from sedumi_tpu_torch.structs import from_flat as tff

    yj = np.asarray(aj.apply(jff(lay, xf)))
    yt = at.apply(tff(lay, xf, "cpu")).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12,
                               atol=1e-12 * np.abs(yj).max())
    w = rng.standard_normal(aj.m + 1)
    import jax.numpy as jnp

    cj = aj.adj(jnp.asarray(w))
    ct = at.adj(torch.as_tensor(w))
    for a, b in zip([cj.l, *cj.q, *cj.s], [ct.l, *ct.q, *ct.s]):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                   atol=1e-12 * (np.abs(a).max() + 1))


@pytest.mark.parametrize("fn", ["eigK", "eyeK", "cellK"])
def test_userapi_matches_reference(fn):
    import sedumi_tpu.userapi as ju

    K = {"l": 3, "q": [3, 4], "r": [3], "s": [2, 3]}
    rng = np.random.default_rng(7)
    n = pt.ConeSpec.make(K).dim
    x = rng.standard_normal(n)
    if fn == "eyeK":
        np.testing.assert_array_equal(pt.eyeK(K), ju.eyeK(K))
    elif fn == "eigK":
        np.testing.assert_allclose(pt.eigK(x, K), ju.eigK(x, K), rtol=1e-14)
    else:
        for a, b in zip(pt.cellK(x, K), ju.cellK(x, K)):
            np.testing.assert_array_equal(a, b)


def test_pars_defaults_match_reference():
    import dataclasses

    tj, tt = JPars(), TPars()
    assert dataclasses.asdict(tj) == dataclasses.asdict(tt)
    with pytest.raises(ValueError):
        TPars.make({"no_such_field": 1})


@pytest.mark.parametrize("dtype", ["mixed", "float32"])
def test_precision_ladder_not_admitted(dtype):
    """'auto' does not admit the precision ladder (the card computes f64
    natively, as the reference's CPU backend does); asked for, the ladder
    maps as the reference's fp.precision_mode maps it."""
    import sedumi_tpu.fp as jfp
    from sedumi_tpu_torch import fp

    assert fp.precision_mode("auto") == "f64" == jfp.precision_mode("auto")
    assert fp.precision_mode("float64") == "f64"
    assert fp.precision_mode(dtype) == jfp.precision_mode(dtype) \
        == {"mixed": "mixed", "float32": "f32"}[dtype]
