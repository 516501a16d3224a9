"""The order of the Schur-panel kernels K14 and K15, on the CPU.

K14 (one block column of the panel factor) and K15 (the panel
substitution steps) run only on the card; here their order of operations,
emulated in plain torch (tests/panel_emulation.py), is held against the
port's plain versions (parallel.panels.panel_chol_plain, trisolve_*_plain)
and, once, against the reference's dist_cholesky and _dist_trisolve.
Inputs are chip_smoke.py's (a Jacobi-scaled SPD matrix of cond ~1e6 and
every block column as dist_cholesky hands it to K14), at small sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import panel_emulation as pe
from chip_smoke import PANEL_TOL, panel_chain, panel_columns, panel_spd
from sedumi_tpu.parallel import make_mesh as jmake_mesh
from sedumi_tpu.parallel import panels as jpanels
from sedumi_tpu_torch.parallel import panels as tpanels

# (bs, mp): the widths _bs_for yields and one that is not a power of two
# (a short last panel); mp gives two panels of several blocks, and (32,
# 256) a forward product over two column groups and a contribution over
# two row groups
CASES = [(4, 32), (16, 64), (32, 256), (48, 96), (128, 256)]


def _case(bs, mp):
    gen = torch.Generator().manual_seed(bs + mp)
    M = panel_spd(mp, gen, "cpu")
    Cs, L = panel_columns(M, bs)
    b = torch.randn(mp, generator=gen, dtype=torch.float64)
    return M, Cs, L, b


@pytest.mark.parametrize("bs,mp", CASES)
def test_chol_column_order_matches_plain(bs, mp):
    """K14's order (a triangular solve against Ljj) on every block column
    against the plain version (a product with the explicit inverse, as
    the reference forms it): the two round apart by about cond(Ljj) eps
    of max|L|, held to chip_smoke.PANEL_TOL (1e-12), with the zero blocks
    above exactly 0 and Ljj's upper triangle exactly 0."""
    _, Cs, L, _ = _case(bs, mp)
    lmax = float(L.abs().max())
    for j, C in enumerate(Cs):
        got = pe.chol_column(C, j)
        want = tpanels.panel_chol_plain(C, j)
        assert float((got - want).abs().max()) <= PANEL_TOL * lmax, j
        assert torch.all(got[:j] == 0) and torch.all(torch.triu(got[j], 1)
                                                      == 0)


@pytest.mark.parametrize("bs,mp", CASES)
def test_substitution_order_matches_plain(bs, mp):
    """K15's order, step by step and in both substitutions over two
    panels, against the plain steps (library products and
    solve_triangular, which sum in other orders): within PANEL_TOL of
    max|x|, and L L' x = b to 1e-8."""
    M, _, L, b = _case(bs, mp)
    nb = mp // bs
    x_e = pe.dist_solve(L, b, bs, 2)
    x_p = panel_chain(L, b, bs, 2, tpanels.trisolve_fwd_plain,
                      tpanels.trisolve_bwd_contrib_plain,
                      tpanels.trisolve_bwd_solve_plain)
    xmax = float(x_p.abs().max())
    assert float((x_e - x_p).abs().max()) <= PANEL_TOL * xmax
    assert float((M @ x_e - b).abs().max()) <= 1e-8 * float(b.abs().max())
    # each step on its own, on the same inputs
    j = nb - 1
    row, bj = L[j * bs:], b[j * bs:]
    x = torch.cat([x_p[:j * bs], torch.zeros(bs, dtype=L.dtype)])
    assert float((pe.fwd_step(row, x, bj, j)
                  - tpanels.trisolve_fwd_plain(row, x, bj, j)).abs().max()) \
        <= PANEL_TOL * xmax
    nb_loc = nb // 2
    L3 = L[nb_loc * bs:]
    for jj in (0, nb_loc - 1, nb_loc, nb - 1):
        c_e = pe.bwd_contrib(L3, x_p, bs, nb_loc, jj)
        c_p = tpanels.trisolve_bwd_contrib_plain(L3, x_p, bs, nb_loc, jj)
        assert float((c_e - c_p).abs().max()) <= PANEL_TOL * max(
            1.0, float(c_p.abs().max())), jj
    # no local row below the last block: zero
    assert torch.equal(pe.bwd_contrib(L3, x_p, bs, nb_loc, nb - 1),
                       torch.zeros(bs, dtype=L.dtype))
    Ljj = L[:bs, :bs]
    assert float((pe.bwd_solve(Ljj, b[:bs], x_p[:bs])
                  - tpanels.trisolve_bwd_solve_plain(Ljj, b[:bs], x_p[:bs]))
                 .abs().max()) <= PANEL_TOL * xmax


def test_order_matches_reference_factor_and_solves():
    """The emulated factor (K14 a column, dist_cholesky's trailing update
    in torch) and both substitutions (K15's steps over two panels) against
    the reference's dist_cholesky and _dist_trisolve on a two-device mesh,
    bs 32, mp 128: within cond * m * eps of max|L| (1e-10, as
    test_torch_panels holds the port's factor) and of max|x|."""
    bs, mp = 32, 128
    M, _, _, b = _case(bs, mp)
    mesh = jmake_mesh(2)
    L_ref = jpanels.dist_cholesky(jnp.asarray(M.numpy()), mesh, "blocks", bs)
    y = jpanels._dist_trisolve(L_ref, jnp.asarray(b.numpy()), mesh,
                               "blocks", bs, lower=True)
    x_ref = np.asarray(jpanels._dist_trisolve(L_ref, y, mesh, "blocks", bs,
                                              lower=False))
    L_ref = np.asarray(L_ref)
    L = pe.dist_cholesky(M, bs)
    assert np.abs(L.numpy() - L_ref).max() <= 1e-10 * np.abs(L_ref).max()
    assert torch.all(torch.triu(L, 1) == 0)
    x = pe.dist_solve(L, b, bs, 2).numpy()
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()


@pytest.mark.parametrize("bs,where", [(32, 0), (64, 40), (48, 47)])
def test_non_pd_block_gives_nan_from_it_on(bs, where):
    """A pivot that is not in (0, inf), in the first panel, in a later one
    or in the short last panel: NaN from block j on and 0 above, in the
    emulation as in the plain version."""
    nb, j = 4, 2
    _, Cs, _, _ = _case(bs, nb * bs)
    C = Cs[j].clone()
    C[j, where, where] = -1.0
    got = pe.chol_column(C, j)
    want = tpanels.panel_chol_plain(C, j)
    assert torch.all(torch.isnan(got[j:])) and torch.all(torch.isnan(
        want[j:]))
    assert torch.all(got[:j] == 0) and torch.all(want[:j] == 0)
