"""Port parity, cone algebra: jordan, nt and wregion against the reference.

Random interior points and directions (numpy, seeded) go through the
reference's JAX function and the port's torch function on the CPU; results
agree to rtol 1e-12 (relative to each output's largest entry).  NT
scalings are compared through what is unique about them -- the spectrum
lam, the metric W = R R' and H applied to a vector -- since the frames R
depend on the eigensolver's choice of eigenvectors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sedumi_tpu import jordan as jjd
from sedumi_tpu import nt as jnt
from sedumi_tpu import wregion as jwr
from sedumi_tpu.cones import Layout as JLayout
from sedumi_tpu.structs import ConeVec as JCV
from sedumi_tpu_torch import jordan as tjd
from sedumi_tpu_torch import nt as tnt
from sedumi_tpu_torch import wregion as twr
from sedumi_tpu_torch.cones import Layout
from sedumi_tpu_torch.structs import ConeVec as TCV

# the suite runs in several worker processes: torch's CPU thread pool
# would spin on every core of each of them
torch.set_num_threads(1)

RTOL = 1e-12


def close(t, j, rtol=RTOL):
    a = np.asarray(j)
    b = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert a.shape == b.shape, (a.shape, b.shape)
    fin = np.abs(a[np.isfinite(a)])
    scale = fin.max() if fin.size else 0.0
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * (scale + 1e-300))


def soc_interior(rng, n, d):
    tail = rng.standard_normal((n, d - 1))
    head = np.linalg.norm(tail, axis=1) + rng.random(n) + 0.2
    return np.concatenate([head[:, None], tail], axis=1)


def psd_interior(rng, n, d):
    a = rng.standard_normal((n, d, d))
    return a @ a.transpose(0, 2, 1) / d + 0.3 * np.eye(d)


def sym(rng, n, d):
    a = rng.standard_normal((n, d, d))
    return 0.5 * (a + a.transpose(0, 2, 1))


# ---------------------------------------------------------------- jordan


Q_UNARY = ["q_tdet", "q_norm_bar", "q_eig", "q_inv", "q_sqrt"]
Q_BINARY = ["q_jdot", "q_jmul", "q_inv_jmul", "q_quad_rep_apply",
            "q_maxstep"]


@pytest.mark.parametrize("fn", Q_UNARY + Q_BINARY + ["q_remap"])
def test_lorentz_ops(fn):
    rng = np.random.default_rng(11)
    x = soc_interior(rng, 9, 5)
    y = rng.standard_normal((9, 5))
    if fn in Q_UNARY:
        args = (x,)
    elif fn == "q_remap":
        args = (x, rng.random((9, 2)) + 0.1)
    else:
        args = (x, y)
    out_j = getattr(jjd, fn)(*map(jnp.asarray, args))
    out_t = getattr(tjd, fn)(*map(torch.as_tensor, args))
    close(out_t, out_j)


@pytest.mark.parametrize("fn", ["s_jmul", "s_congr", "s_congr_t",
                                "s_inv_jmul_diag", "l_maxstep"])
def test_psd_and_lp_ops(fn):
    rng = np.random.default_rng(12)
    if fn == "s_inv_jmul_diag":
        args = (rng.random((4, 6)) + 0.5, sym(rng, 4, 6))
    elif fn == "l_maxstep":
        args = (rng.random(17) + 0.1, rng.standard_normal(17))
    else:
        args = (rng.standard_normal((4, 6, 6)), sym(rng, 4, 6))
    close(getattr(tjd, fn)(*map(torch.as_tensor, args)),
          getattr(jjd, fn)(*map(jnp.asarray, args)))


def test_psd_eigenvalues():
    rng = np.random.default_rng(13)
    x = sym(rng, 5, 7)
    close(tjd.s_eig(torch.as_tensor(x)),
          np.sort(np.asarray(jjd.s_eig(jnp.asarray(x))), axis=-1))


# ------------------------------------------------------------------- nt

LAYOUTS = {
    "mixed": dict(l=4, q=(3, 3, 5), s=(4, 4, 6)),
    "herm": dict(l=2, q=(3,), s=(6, 5), s_herm=(True, False)),
}


def random_pair(layout, rng):
    def cv():
        l = rng.random(layout.l) + 0.3
        q = [soc_interior(rng, b.count, b.dim) for b in layout.q_buckets]
        s = []
        for b in layout.s_buckets:
            if b.herm:
                h = b.dim // 2
                a = rng.standard_normal((b.count, h, h)) \
                    + 1j * rng.standard_normal((b.count, h, h))
                c = a @ np.conj(a.transpose(0, 2, 1)) / h + 0.3 * np.eye(h)
                s.append(np.block([[c.real, -c.imag], [c.imag, c.real]]))
            else:
                s.append(psd_interior(rng, b.count, b.dim))
        return l, q, s

    return cv(), cv()


def to_j(v):
    l, q, s = v
    return JCV(l=jnp.asarray(l), q=tuple(map(jnp.asarray, q)),
               s=tuple(map(jnp.asarray, s)))


def to_t(v):
    l, q, s = v
    return TCV(l=torch.as_tensor(l), q=tuple(map(torch.as_tensor, q)),
               s=tuple(map(torch.as_tensor, s)))


def scalings(name, seed=0):
    kw = LAYOUTS[name]
    lj, lt = JLayout(**kw), Layout(**kw)
    rng = np.random.default_rng(seed)
    (x, z) = random_pair(lt, rng)
    herm = tuple(b.herm for b in lt.s_buckets)
    Sj = jnt.compute_scaling(to_j(x), to_j(z), herm=herm)
    St = tnt.compute_scaling(to_t(x), to_t(z), herm=herm)
    return lt, rng, Sj, St


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_compute_scaling_invariants(name):
    _, _, Sj, St = scalings(name)
    for field in ("d_l", "lam_l", "q_wb", "q_eta2", "q_u", "q_uinv",
                  "q_lam"):
        a, b = getattr(Sj, field), getattr(St, field)
        for aj, bt in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            close(bt, aj)
    for rj, rt, lj_, lt_ in zip(Sj.s_r, St.s_r, Sj.s_lam, St.s_lam):
        rj = np.asarray(rj)
        close(rt @ rt.transpose(-1, -2), rj @ rj.transpose(0, 2, 1))
        close(torch.sort(lt_, dim=-1).values,
              np.sort(np.asarray(lj_), axis=-1))


# compositions that do not depend on the eigenvector frames of R
TRANSPORTS = {
    "H_apply": lambda nt, S, u: nt.H_apply(S, u),
    "W_W": lambda nt, S, u: nt.scale_v_to_x(S, nt.scale_z_to_v(S, u)),
    "W_Winv": lambda nt, S, u: nt.scale_v_to_x(S, nt.scale_x_to_v(S, u)),
    "W_laminv_W": lambda nt, S, u: nt.scale_v_to_x(
        S, nt.lam_inv_jmul(S, nt.scale_z_to_v(S, u))),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("fn", list(TRANSPORTS))
def test_scaled_transports(name, fn):
    lt, rng, Sj, St = scalings(name, seed=1)
    u = ((rng.standard_normal(lt.l),
          [rng.standard_normal((b.count, b.dim)) for b in lt.q_buckets],
          [sym(rng, b.count, b.dim) for b in lt.s_buckets]))
    oj = TRANSPORTS[fn](jnt, Sj, to_j(u))
    ot = TRANSPORTS[fn](tnt, St, to_t(u))
    for a, b in zip([oj.l, *oj.q, *oj.s], [ot.l, *ot.q, *ot.s]):
        close(b, a, rtol=1e-10)


@pytest.mark.parametrize("which", ["scaled", "pair"])
def test_maxsteps(which):
    lt, rng, Sj, St = scalings("mixed", seed=2)
    d = ((rng.standard_normal(lt.l),
          [rng.standard_normal((b.count, b.dim)) for b in lt.q_buckets],
          [sym(rng, b.count, b.dim) for b in lt.s_buckets]))
    base, _ = random_pair(lt, rng)
    if which == "scaled":
        close(tnt.maxstep_scaled(St, to_t(d)),
              jnt.maxstep_scaled(Sj, to_j(d)), rtol=1e-10)
    else:
        for a, b in zip(tnt.maxstep_pair(to_t(base), to_t(d), to_t(base),
                                         to_t(d)),
                        jnt.maxstep_pair(to_j(base), to_j(d), to_j(base),
                                         to_j(d))):
            close(a, b, rtol=1e-10)


# -------------------------------------------------------------- wregion


def test_prod_spectrum():
    lt = Layout(l=4, q=(3, 5), s=(4, 6))
    rng = np.random.default_rng(21)
    x, z = random_pair(lt, rng)
    wj = np.asarray(jwr.prod_spectrum(to_j(x), to_j(z)))
    wt = twr.prod_spectrum(to_t(x), to_t(z)).numpy()
    # the PSD parts are eigenvalues: compare per bucket after sorting
    n_lq = lt.l + 2 * len(lt.q)
    close(torch.as_tensor(wt[:n_lq]), wj[:n_lq])
    off = n_lq
    for b in lt.s_buckets:
        k = b.count * b.dim
        close(torch.as_tensor(np.sort(wt[off:off + k].reshape(b.count, -1))),
              np.sort(wj[off:off + k].reshape(b.count, -1)))
        off += k


@pytest.mark.parametrize("theta", [0.25, 0.5, 1.0])
def test_iswnbr(theta):
    rng = np.random.default_rng(22)
    w = rng.random(40) ** 3 + 1e-3
    for a, b in zip(twr.iswnbr(torch.as_tensor(w), theta),
                    jwr.iswnbr(jnp.asarray(w), theta)):
        close(a, b)
    # batched rows agree with the one-row form
    W = rng.random((3, 40)) + 0.01
    d_b = twr.iswnbr(torch.as_tensor(W), theta)[0]
    for i in range(3):
        close(d_b[i], twr.iswnbr(torch.as_tensor(W[i]), theta)[0])


def test_widelen_batched():
    lt = Layout(l=4, q=(3, 5), s=(4, 6))
    rng = np.random.default_rng(23)
    S_lam_l = rng.random(lt.l) + 0.5
    lam = (S_lam_l, [soc_interior(rng, b.count, b.dim)
                     for b in lt.q_buckets],
           [np.einsum("ij,ni->nij", np.eye(b.dim),
                      rng.random((b.count, b.dim)) + 0.5)
            for b in lt.s_buckets])
    dxs = (rng.standard_normal(lt.l),
           [rng.standard_normal((b.count, b.dim)) for b in lt.q_buckets],
           [sym(rng, b.count, b.dim) for b in lt.s_buckets])
    dzs = (rng.standard_normal(lt.l),
           [rng.standard_normal((b.count, b.dim)) for b in lt.q_buckets],
           [sym(rng, b.count, b.dim) for b in lt.s_buckets])
    args = (1.0, -0.3, 0.8, 0.2, 0.9)
    tj, dj = jwr.widelen_batched(to_j(lam), to_j(dxs), to_j(dzs),
                                 *map(jnp.asarray, args), 0.25, 0.5,
                                 fullt=jnp.asarray(2.0))
    tt, dt = twr.widelen_batched(to_t(lam), to_t(dxs), to_t(dzs),
                                 *(torch.tensor(a, dtype=torch.float64)
                                   for a in args), 0.25, 0.5,
                                 fullt=torch.tensor(2.0, dtype=torch.float64))
    close(dt, dj, rtol=1e-10)
    close(tt, tj)
