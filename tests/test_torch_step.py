"""Port parity, one IPM iteration: the port's make_step, fed the reference's
iterate k (carried across by sedumi_tpu_torch.convert), must give the
reference's iterate k+1 and step statistics at rtol 1e-8 (each leaf
against its largest entry) -- for the first 10 steps of nb, the first 3 of
arch0 (the case that runs the sparse PSD Schur formation) and the 6 steps
of quantum that its solve keeps: quantum converges at iteration 7, and
its step 6 (mu ~ 1.6e-8) is so ill-conditioned that the reference's own
next iterate moves by more than 1e-8 when its input moves by 1e-15
(test_quantum_step_6_is_noise_limited).

Both packages start from the reference's identity start on the
row-equilibrated, objective-normalized data, as their solvers do.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sedumi_tpu import ipm as jipm
from sedumi_tpu import opA as jopA
from sedumi_tpu import transform as jtf
from sedumi_tpu.examples import load_example
from sedumi_tpu.params import Pars as JPars
from sedumi_tpu_torch import convert
from sedumi_tpu_torch import ipm as tipm
from sedumi_tpu_torch.cones import Layout
from sedumi_tpu_torch.params import Pars as TPars

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)

RTOL = 1e-8
STATS = ("mu", "alpha", "sigma", "err_p", "err_d", "gap_rel", "cx", "by",
         "tau", "kappa", "dir_defect", "wr_delta", "centered", "maxt1",
         "mu_floor")


def setup(name):
    """The solver's data preparation (reference solver.py:244-265)."""
    ex = load_example(name)
    prob = jtf.pretransfo(ex.At, ex.b, ex.c, ex.K, JPars(fid=0))
    At = sp.csc_matrix(prob.At)
    b, c = prob.b.astype(np.float64), prob.c.astype(np.float64)
    rnorm = np.sqrt(np.asarray(At.multiply(At).sum(axis=0)).ravel() + b**2)
    rs = np.where(rnorm > 0, 1.0 / np.maximum(rnorm, 1e-300), 1.0)
    normb, normc = float(np.max(np.abs(b))), float(np.max(np.abs(c)))
    cscale = 1.0 + normc
    At = At @ sp.diags(rs)
    return prob.layout, At, b * rs, c / cscale, rs, normb, normc, cscale


def jax_state_numpy(st):
    def cv(v):
        return (np.asarray(v.l), [np.asarray(a) for a in v.q],
                [np.asarray(a) for a in v.s])

    return (cv(st.x), np.asarray(st.y), cv(st.z), float(st.tau),
            float(st.kappa))


def leaves(s):
    x, y, z, tau, kappa = s
    return [x[0], *x[1], *x[2], y, z[0], *z[1], *z[2],
            np.asarray(tau), np.asarray(kappa)]


def assert_close(a, b, what, atol=1e-300):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if b.size else 0.0
    assert np.abs(a - b).max(initial=0.0) <= RTOL * scale + atol, \
        (what, np.abs(a - b).max(), scale)


@pytest.mark.parametrize("name,nsteps", [
    ("quantum", 6), ("nb", 10), ("arch0", 3)])
def test_step_matches_reference(name, nsteps):
    import jax.numpy as jnp

    layout_j, At, b, c_s, rs, normb, normc, cscale = setup(name)
    layout = Layout(l=layout_j.l, q=layout_j.q, s=layout_j.s,
                    s_herm=layout_j.s_herm)
    jp, tp = JPars(fid=0), TPars(fid=0)
    aop_j = jopA.build_coo_aop(At, c_s, layout_j)
    aop_t = convert.aop_from_numpy(
        np.asarray(aop_j.Al), [np.asarray(a) for a in aop_j.Aq],
        [{k: np.asarray(v) for k, v in p.items()} for p in aop_j.s_parts],
        aop_j.q_shapes, aop_j.s_meta, device="cpu")
    step_j = jipm.make_step(layout_j, jp, normb, normc, cscale)
    step_t = tipm.make_step(layout, tp, normb, normc, cscale)
    b_j, rs_j = jnp.asarray(b), jnp.asarray(rs)
    b_t, rs_t = torch.as_tensor(b), torch.as_tensor(rs)
    st_j = jipm.init_state(layout_j, aop_j, b, float(np.max(np.abs(b))),
                           float(np.max(np.abs(c_s))), jp)
    for k in range(nsteps):
        s_np = jax_state_numpy(st_j)
        new_j, stats_j = step_j(aop_j, b_j, rs_j, st_j, np.float64(0.0),
                                sd_on=np.asarray(False))
        st_t = convert.state_from_numpy(layout, *s_np, device="cpu")
        new_t, stats_t = step_t(aop_t, b_t, rs_t, st_t, 0.0, sd_on=False)
        ref = jax_state_numpy(new_j)
        got = convert.state_to_numpy(new_t)
        for i, (a, r) in enumerate(zip(leaves(got), leaves(ref))):
            assert_close(a, r, f"{name} step {k} leaf {i}")
        host = stats_t.to_host()
        for f in STATS:
            # dir_defect is a relative defect at the rounding floor
            # (~1e-16): only its size above 1e-12 carries information
            assert_close(host[f], float(getattr(stats_j, f)),
                         f"{name} step {k} {f}",
                         atol=1e-12 if f == "dir_defect" else 1e-300)
        assert bool(host["chol_ok"]) == bool(stats_j.chol_ok)
        st_j = new_j


def test_recenter_matches_reference():
    import jax.numpy as jnp

    layout_j, At, b, c_s, rs, normb, normc, cscale = setup("quantum")
    layout = Layout(l=layout_j.l, q=layout_j.q, s=layout_j.s,
                    s_herm=layout_j.s_herm)
    jp = JPars(fid=0)
    aop_j = jopA.build_coo_aop(At, c_s, layout_j)
    st = jipm.init_state(layout_j, aop_j, b, 1.0, 1.0, jp)
    # push x to the boundary: the recenter must lift it back
    st = st._replace(x=st.x._replace(s=tuple(a - 0.999999 * jnp.eye(
        a.shape[-1]) * a[..., :1, :1] for a in st.x.s)))
    ref = jax_state_numpy(jipm.make_recenter(layout_j)(st))
    got = convert.state_to_numpy(tipm.make_recenter(layout)(
        convert.state_from_numpy(layout, *jax_state_numpy(st),
                                 device="cpu")))
    for i, (a, r) in enumerate(zip(leaves(got), leaves(ref))):
        assert_close(a, r, f"recenter leaf {i}")


def test_quantum_step_6_is_noise_limited():
    """Why quantum's parity stops at 6 steps: from iterate 6, relative
    input noise of 1e-15 moves the reference's own next iterate by more
    than the 1e-8 parity tolerance."""
    import jax
    import jax.numpy as jnp

    layout_j, At, b, c_s, rs, normb, normc, cscale = setup("quantum")
    jp = JPars(fid=0)
    aop_j = jopA.build_coo_aop(At, c_s, layout_j)
    step_j = jipm.make_step(layout_j, jp, normb, normc, cscale)
    args = (aop_j, jnp.asarray(b), jnp.asarray(rs))
    st = jipm.init_state(layout_j, aop_j, b, float(np.max(np.abs(b))),
                         float(np.max(np.abs(c_s))), jp)
    for _ in range(6):
        st = step_j(*args, st, np.float64(0.0), sd_on=np.asarray(False))[0]
    rng = np.random.default_rng(6)
    noisy = jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-15 * rng.standard_normal(np.shape(a))), st)
    outs = [leaves(jax_state_numpy(step_j(*args, s_, np.float64(0.0),
                                          sd_on=np.asarray(False))[0]))
            for s_ in (st, noisy)]
    moved = max(np.abs(a - c).max() / np.abs(a).max()
                for a, c in zip(*outs) if np.size(a))
    assert moved > RTOL, moved
