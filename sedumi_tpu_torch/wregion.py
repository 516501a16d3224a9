"""Sturm-Zhang wide-region neighborhood: proximity, product spectra and a
batched neighborhood line search.

Counterpart of the reference's wregion.py (reference analogs: iswnbr.c
getdelta, widelen.m, psdfactor+psdscale+psdeig).
"""

from __future__ import annotations

import numpy as np
import torch

from . import jordan as jd
from .linalg_ops import cholesky, eigvalsh_multi
from .structs import ConeVec, cv_map


def prod_spectrum(x: ConeVec, z: ConeVec) -> torch.Tensor:
    """Concatenated spectral values of P(x)^{1/2} z over all cones.

    LP: x_i z_i.  SOC: spectra of P(sqrt(x)) z.  PSD: eig(U' Z U) with
    X = U U'.  Leading batch dimensions (those of x.l beyond its last) are
    kept: the result is [..., num_eigs]."""
    lead = tuple(x.l.shape[:-1])
    parts = [x.l * z.l]
    for xq, zq in zip(x.q, z.q):
        w = jd.q_quad_rep_apply(jd.q_sqrt(xq), zq)
        parts.append(jd.q_eig(w))
    m_list = []
    for xs, zs in zip(x.s, z.s):
        u = cholesky(xs)
        m_list.append(u.transpose(-1, -2) @ zs @ u)
    parts += eigvalsh_multi(m_list)
    return torch.cat([p.reshape(lead + (-1,)) for p in parts], dim=-1)


def iswnbr(w: torch.Tensor, theta: float):
    """(delta, h, alpha) of the wide-region proximity (iswnbr.c:97-210)
    for w [..., n] (squared v-space spectral values), vectorized: one sort
    + cumulative sums; the water-filling index k = |T| satisfies
    ws[k-1] < h_k^2 <= ws[k] with h_k^2 = suffix_k / (r - k)."""
    n = w.shape[-1]
    dt, dev = w.dtype, w.device
    lead = tuple(w.shape[:-1])
    r = n / theta**2
    gap = torch.sum(w, dim=-1)
    ws = torch.sort(w, dim=-1).values
    vs = torch.sqrt(torch.clamp_min(ws, 0.0))
    z1 = torch.zeros(lead + (1,), dtype=dt, device=dev)
    suf = torch.cat([torch.flip(torch.cumsum(torch.flip(ws, [-1]), -1),
                                [-1]), z1], dim=-1)
    pref_w = torch.cat([z1, torch.cumsum(ws, -1)], dim=-1)
    pref_v = torch.cat([z1, torch.cumsum(vs, -1)], dim=-1)
    k_arr = torch.arange(n + 1, dtype=dt, device=dev)
    h2 = suf / (r - k_arr)
    ws_pad_lo = torch.cat([torch.full(lead + (1,), -np.inf, dtype=dt,
                                      device=dev), ws], dim=-1)
    ws_pad_hi = torch.cat([ws, torch.full(lead + (1,), np.inf, dtype=dt,
                                          device=dev)], dim=-1)
    valid = (ws_pad_lo < h2) & (ws_pad_hi >= h2)
    # first valid k (0 if none), as jnp.argmax on booleans
    k = torch.argmax(valid.to(torch.int8), dim=-1, keepdim=True)
    h2k = torch.gather(h2, -1, k)[..., 0]
    h = torch.sqrt(h2k)
    kf = k[..., 0].to(dt)
    sumdifw = kf * h2k - torch.gather(pref_w, -1, k)[..., 0]
    sumdifv = kf * h - torch.gather(pref_v, -1, k)[..., 0]
    alpha = sumdifv / (r * h)
    delta_sqr = alpha * (2.0 - alpha) - (1.0 - alpha) ** 2 * sumdifw / gap
    delta = torch.sqrt(torch.clamp_min(r * delta_sqr, 0.0))
    bad = torch.amin(w, dim=-1) <= 0.0
    delta = torch.where(bad, torch.full_like(delta, np.inf), delta)
    return delta, h, alpha


# widelen's trial fractions: the reference's geometric grid of 8,
# extended by two deeper candidates (wregion.widelen_batched)
_FRACS = np.concatenate([np.geomspace(1.0, 0.05, 8), [0.02, 0.01]])


def widelen_batched(lam: ConeVec, dxs: ConeVec, dzs: ConeVec,
                    tau, dtau, kappa, dkappa, t_max, theta: float,
                    beta: float, zbase: ConeVec | None = None, fullt=None):
    """Largest trial step t in (0, t_max] keeping the iterate in the wide
    region (delta <= beta), over one grid of candidates (widelen.m); below
    fullt/10 the acceptance relaxes to delta < 1 (widelen.m:68).  Falls
    back to the candidate with the smallest measured delta when every
    trial leaves the region.  Returns (t, deltas)."""
    if zbase is None:
        zbase = lam
    ts = torch.as_tensor(_FRACS, dtype=t_max.dtype, device=t_max.device) \
        * t_max

    # all trials in one batch: leading dimension = trial
    def trial(a, d):
        return a[None] + ts.reshape((-1,) + (1,) * a.ndim) * d[None]

    w = prod_spectrum(cv_map(trial, lam, dxs), cv_map(trial, zbase, dzs))
    wtk = (tau + ts * dtau) * (kappa + ts * dkappa)
    deltas = iswnbr(torch.cat([w, wtk[:, None]], dim=-1), theta)[0]
    ok = deltas <= beta
    if fullt is not None:
        ok = ok | ((ts < 0.1 * fullt) & (deltas < 1.0))
    idx = torch.argmax(ok.to(torch.int8))
    t = torch.where(torch.any(ok), ts[idx], ts[_nan_argmin(deltas)])
    return t, deltas


def _nan_argmin(v: torch.Tensor) -> torch.Tensor:
    """argmin with numpy/JAX NaN semantics: the first NaN wins."""
    nan = torch.isnan(v)
    return torch.where(torch.any(nan), torch.argmax(nan.to(torch.int8)),
                       torch.argmin(torch.where(nan, 0.0, v)))
