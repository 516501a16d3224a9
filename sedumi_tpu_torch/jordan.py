"""Batched Jordan-algebra ops for the three symmetric-cone families.

Counterpart of the reference's jordan.py (reference analogs: psdeig.m,
psdjmul.m, psdinvjmul.c, qjmul.m, qinvjmul.m, tdet.m, maxstep.m); every op
acts on a whole bucket of same-size blocks at once.

* LP part: [n], elementwise.
* Lorentz part: [n, d], cone {x : x[0] >= ||x[1:]||}; Jordan product
  x o y = (x.y ; x0*ybar + y0*xbar); eigenvalues x0 -+ ||xbar||.
* PSD part: [n, d, d] symmetric; Jordan product (XY+YX)/2.
"""

from __future__ import annotations

import torch

from .linalg_ops import eigh as _eigh_impl, eigvalsh as _eigvalsh_impl

_INF = float("inf")


def _inf_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), _INF, dtype=x.dtype, device=x.device)


def _j(x: torch.Tensor) -> torch.Tensor:
    """J x with J = diag(1, -1, .., -1)."""
    return torch.cat([x[..., :1], -x[..., 1:]], dim=-1)


# ---------------------------------------------------------------------------
# Lorentz (second-order cone) family -- batched over [n, d]
# ---------------------------------------------------------------------------


def q_jdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x' J y; q_jdot(x, x) = det (reference tdet.m)."""
    return x[..., 0] * y[..., 0] - torch.sum(x[..., 1:] * y[..., 1:], dim=-1)


def q_tdet(x: torch.Tensor) -> torch.Tensor:
    return q_jdot(x, x)


def q_norm_bar(x: torch.Tensor) -> torch.Tensor:
    """||x[1:]|| per cone."""
    return torch.sqrt(torch.sum(x[..., 1:] ** 2, dim=-1))


def q_eig(x: torch.Tensor) -> torch.Tensor:
    """Eigenvalues [n, 2] = (x0 - ||xbar||, x0 + ||xbar||)."""
    nb = q_norm_bar(x)
    return torch.stack([x[..., 0] - nb, x[..., 0] + nb], dim=-1)


def q_jmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Jordan (arrow) product x o y (reference: qjmul.m)."""
    head = torch.sum(x * y, dim=-1)
    tail = x[..., :1] * y[..., 1:] + y[..., :1] * x[..., 1:]
    return torch.cat([head[..., None], tail], dim=-1)


def q_inv(x: torch.Tensor) -> torch.Tensor:
    """Jordan inverse: x^{-1} = Jx / det(x)."""
    return _j(x) / q_jdot(x, x)[..., None]


def q_inv_jmul(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve x o u = r (reference: qinvjmul.m), arrow-matrix closed form:
      u0   = (x0 r0 - xbar.rbar) / det
      ubar = (-r0 xbar + (det/x0) rbar + (xbar.rbar/x0) xbar) / det
    """
    x0 = x[..., 0]
    xb = x[..., 1:]
    r0 = r[..., 0]
    rb = r[..., 1:]
    det = q_jdot(x, x)
    xr = torch.sum(xb * rb, dim=-1)
    u0 = (x0 * r0 - xr) / det
    ub = (-r0[..., None] * xb + (det / x0)[..., None] * rb
          + (xr / x0)[..., None] * xb) / det[..., None]
    return torch.cat([u0[..., None], ub], dim=-1)


def q_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Spectral square root of x in int(Q)."""
    lam = q_eig(x)
    sm, sp = torch.sqrt(lam[..., 0]), torch.sqrt(lam[..., 1])
    nb = q_norm_bar(x)
    head = 0.5 * (sp + sm)
    # xbar/||xbar|| * (sp-sm)/2 ; safe when ||xbar|| = 0 (then sp=sm).
    pos = nb > 0
    scale = torch.where(pos, 0.5 * (sp - sm) / torch.where(pos, nb, 1.0),
                        0.0)
    return torch.cat([head[..., None], scale[..., None] * x[..., 1:]], dim=-1)


def q_quad_rep_apply(u: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """P(u) z = 2 u (u'z) - (u'Ju) Jz."""
    uz = torch.sum(u * z, dim=-1)
    uju = q_jdot(u, u)
    return 2.0 * u * uz[..., None] - uju[..., None] * _j(z)


def q_remap(x: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Rebuild a Lorentz vector from new spectral values [..., 2] (in
    q_eig's (lam-, lam+) order) on x's own frame."""
    nb = q_norm_bar(x)
    head = 0.5 * (vals[..., 0] + vals[..., 1])
    pos = nb > 0
    scale = torch.where(pos, 0.5 * (vals[..., 1] - vals[..., 0])
                        / torch.where(pos, nb, 1.0), 0.0)
    return torch.cat([head[..., None], scale[..., None] * x[..., 1:]], dim=-1)


def q_maxstep(x: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Per-cone sup {a >= 0 : x + t dx in Q for all t in [0, a]}, x in
    int(Q); +inf where unbounded (reference maxstep.m:48-58)."""
    big = _inf_like(x)
    a_head = torch.where(dx[..., 0] < 0, -x[..., 0] / dx[..., 0], big)
    # det(x + a dx) = a2 a^2 + 2 a1 a + a0 >= 0 with a0 > 0
    a2 = q_jdot(dx, dx)
    a1 = q_jdot(x, dx)
    a0 = q_jdot(x, x)
    disc = a1 * a1 - a2 * a0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    denom = -a1 + sq
    root_stable = torch.where(denom > 0, a0 / denom, big)
    has_root = disc >= 0
    no_pos = torch.logical_or(~has_root, (a1 >= 0) & (a2 >= 0))
    a_det = torch.where(no_pos, big, torch.clamp_min(root_stable, 0.0))
    return torch.minimum(a_head, a_det)


# ---------------------------------------------------------------------------
# PSD family -- batched over [n, d, d]
# ---------------------------------------------------------------------------


def s_eig(x: torch.Tensor) -> torch.Tensor:
    """Batched eigenvalues of symmetric blocks (reference psdeig.m); in
    no particular order under the Jacobi solver."""
    return _eigvalsh_impl(x)


def s_eigh(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _eigh_impl(x)


def s_jmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(XY + YX)/2 (reference psdjmul.m)."""
    xy = torch.matmul(x, y)
    return 0.5 * (xy + xy.transpose(-1, -2))


def s_inv_jmul_diag(lam: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve diag(lam) o U = R: U_ij = 2 R_ij / (lam_i + lam_j)."""
    return 2.0 * r / (lam[..., :, None] + lam[..., None, :])


def s_congr(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R' X R batched (reference psdscale.m)."""
    return r.transpose(-1, -2) @ x @ r


def s_congr_t(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R X R' batched."""
    return r @ x @ r.transpose(-1, -2)


def s_maxstep_scaled(lam: torch.Tensor, dxs: torch.Tensor) -> torch.Tensor:
    """Per-block sup step for Lam + t dXs >= 0, Lam = diag(lam) > 0:
    1 / max(0, -lambda_min(Lam^-1/2 dXs Lam^-1/2)) (maxstep.m:62-66)."""
    isq = 1.0 / torch.sqrt(lam)
    m = dxs * isq[..., :, None] * isq[..., None, :]
    lmin = torch.amin(_eigvalsh_impl(m), dim=-1)
    tiny = torch.finfo(lam.dtype).tiny
    return torch.where(lmin < 0, -1.0 / torch.clamp_max(lmin, -tiny),
                       torch.full_like(lmin, _INF))


# ---------------------------------------------------------------------------
# LP family -- elementwise [n]
# ---------------------------------------------------------------------------


def l_maxstep(x: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """sup step for x + t dx >= 0 elementwise, min over the batch."""
    big = _inf_like(x)
    if not x.numel():
        return big
    return torch.min(torch.where(dx < 0, -x / dx, big))
