"""The blocked order of the tile kernels K8 and K10, on the CPU.

K8 (tile factor) and K10 (tile solve) run only on the card; here their
order of operations, emulated in plain torch (tests/tile_emulation.py),
is held against the port's plain versions (sparse_chol.tile_factor_plain,
tile_solve_plain) and the reference's factor_tiles_ur / solve_tiles_ur on
LP-like plans (many short columns, wide levels) and chain-like plans (a
dense SDP-like pattern: one column per level) at B = 16, 32 and 128, and
K10's flattened level arrays against level_maps entry for entry.  K9's
work list (sparse_chol.update_chunks) covers each destination's pairs
once, in plan order, and its chunked sums (tile_emulation.tile_update)
stay within K9's bound of the plain update.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tile_emulation as emu
from sedumi_tpu import sparse_chol as jsc
from sedumi_tpu_torch import sparse_chol as tsc

CASES = [("lp", 16), ("lp", 32), ("lp", 128),
         ("chain", 16), ("chain", 32), ("chain", 128)]


def lp_like(n, seed):
    """A A' + (n/2) I for a random sparse A with 1.5 nonzeros per column
    (tests/test_torch_cuda.py's ada_matrix)."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, 2 * n, density=1.5 / n, random_state=rng, format="csc")
    return sp.csc_matrix(A @ A.T + sp.identity(n) * n * 0.5)


def chain_like(n, seed):
    """G G' / n + I with G dense: every tile filled, one column a level."""
    G = np.random.default_rng(seed).standard_normal((n, n))
    return sp.csc_matrix(G @ G.T / n + np.eye(n))


def plan_case(kind, B, seed=7):
    """(matrix, SparseCholesky on the CPU) of a case; the LP plans have
    several columns in their first level, the chains one per level."""
    if kind == "lp":
        M = lp_like({16: 300, 32: 600, 128: 3000}[B], seed)
    else:
        M = chain_like(B * {16: 8, 32: 6, 128: 4}[B] - 5, seed)
    f = tsc.SparseCholesky(M, B=B, device="cpu")
    if kind == "lp":
        assert f.levels[0]["cols"].numel() >= 3
    else:
        assert all(lv["cols"].numel() == 1 for lv in f.levels)
    return M, f


def _ref_solve(pl, L, rhs):
    return np.asarray(jax.jit(partial(
        jsc.solve_tiles_ur, lv_lists=pl.lv_lists, ntc=pl.ntc))(
        jnp.asarray(L), jnp.asarray(rhs), jnp.asarray(pl.dslot),
        jnp.asarray(pl.oslot), jnp.asarray(pl.omask), jnp.asarray(pl.orow)))


def _ref_factor(pl, st, reg=0.0):
    fac = jax.jit(partial(jsc.factor_tiles_ur, lv_lists=pl.lv_lists))
    return np.asarray(fac(
        jnp.asarray(st), jnp.asarray(pl.dslot), jnp.asarray(pl.oslot),
        jnp.asarray(pl.omask), jnp.asarray(pl.pa), jnp.asarray(pl.pb),
        jnp.asarray(pl.pdst), jnp.asarray(pl.pmask), reg=jnp.asarray(reg)))


@pytest.mark.parametrize("kind,B", CASES)
def test_flat_arrays_match_level_maps(kind, B):
    """flatten_levels' arrays give back every level's maps entry for
    entry: the level offsets cut cols/dslot, off_slot/off_row and fs_row;
    col_off and fs_ptr are the levels' off_ptr and fs_ptr shifted."""
    _, f = plan_case(kind, B)
    fl = {k: v.numpy() for k, v in f.levels.flat.items()}
    assert set(tsc.FLAT_KEYS) | {"bar"} == set(fl)
    assert fl["bar"].tolist() == [0, 0]
    for l, lv in enumerate(f.plan.levels):
        c0, c1 = fl["lev_cols"][l:l + 2]
        o0, o1 = fl["lev_off"][l:l + 2]
        f0, f1 = fl["lev_fs"][l:l + 2]
        np.testing.assert_array_equal(fl["cols"][c0:c1], lv["cols"])
        np.testing.assert_array_equal(fl["dslot"][c0:c1], lv["dslot"])
        np.testing.assert_array_equal(fl["col_off"][c0:c1 + 1] - o0,
                                      lv["off_ptr"])
        np.testing.assert_array_equal(fl["off_slot"][o0:o1], lv["off_slot"])
        np.testing.assert_array_equal(fl["off_row"][o0:o1], lv["off_row"])
        np.testing.assert_array_equal(fl["fs_row"][f0:f1], lv["fs_row"])
        np.testing.assert_array_equal(fl["fs_ptr"][f0:f1 + 1] - o0,
                                      lv["fs_ptr"])
        np.testing.assert_array_equal(fl["fs_slot"][o0:o1], lv["fs_slot"])
        np.testing.assert_array_equal(fl["fs_col"][o0:o1], lv["fs_col"])
    assert fl["lev_cols"][-1] == f.plan.ntc


def test_update_chunks_split_heavy_destinations():
    """A destination with more pairs than the level's mean is cut into
    chunks of at most ceil(pairs / destinations), in plan order; its
    chunks take consecutive scratch slots."""
    got = tsc.update_chunks(np.array([0, 1, 6, 7, 8]))
    assert {k: v.tolist() for k, v in got.items()} == dict(
        chunk_ptr=[0, 1, 3, 5, 6, 7, 8], chunk_dst=[0, 1, 1, 1, 2, 3],
        dst_chunk=[0, 1, 4, 5, 6], dst_part=[-1, 0, -1, -1],
        part_chunk=[1, 2, 3])
    empty = tsc.update_chunks(np.array([0]))
    assert [v.tolist() for v in empty.values()] == [[0], [], [0], [], []]


@pytest.mark.parametrize("kind,B", CASES)
def test_update_work_list_covers_pairs_in_order(kind, B):
    """Every level's chunks cover [0, pairs) in order, each inside one
    destination's CSR range and at most ceil(pairs / destinations) long;
    the split destinations' slots list their chunks in chunk order; and
    the chunked update (K9's order of sums, tile_emulation.tile_update)
    lands within K9's bound 2 (B + P + 1) eps (|D| + sum |A| |B|') of
    tile_update_plain, level by level through the factor."""
    M, f = plan_case(kind, B)
    st = f.storage(M)
    eps = float(np.finfo(np.float64).eps)
    for lv, lvt in zip(f.plan.levels, f.levels):
        ptr, cptr = lv["pair_ptr"], lv["chunk_ptr"]
        nd = lv["pair_dst"].size
        per = max(1, -(-int(ptr[-1]) // max(nd, 1)))
        assert cptr[0] == 0 and cptr[-1] == ptr[-1]
        assert np.all(np.diff(cptr) >= 1) and np.all(np.diff(cptr) <= per)
        dch = lv["dst_chunk"]
        np.testing.assert_array_equal(cptr[dch], ptr)
        np.testing.assert_array_equal(
            lv["chunk_dst"], np.repeat(np.arange(nd), np.diff(dch)))
        split = np.diff(dch) > 1
        np.testing.assert_array_equal(lv["dst_part"] >= 0, split)
        slots = [lv["part_chunk"][s:s + n] for s, n in
                 zip(lv["dst_part"][split], np.diff(dch)[split])]
        want = [np.arange(dch[d], dch[d + 1]) for d in np.nonzero(split)[0]]
        assert all(np.array_equal(g, w) for g, w in zip(slots, want))
        assert lv["part_chunk"].size == sum(w.size for w in want)
        assert lvt["upd_ticket"].tolist() == [0] * (
            tsc.UPDATE_MAX_SUB * nd)
        tsc.tile_factor_plain(st, lvt, 0.0)
        if not nd:
            continue
        dst = lvt["pair_dst"]
        didx = torch.repeat_interleave(torch.arange(nd),
                                       torch.diff(lvt["pair_ptr"]))
        bound = st[dst].abs().index_add_(
            0, didx, st[lvt["pair_a"]].abs() @ st[lvt["pair_b"]].abs().mT)
        c = 2.0 * (B + float(np.diff(ptr).max()) + 1.0)
        ref = st.clone()
        emu.tile_update(st, lvt)
        tsc.tile_update_plain(ref, lvt)
        assert bool(torch.all((st[dst] - ref[dst]).abs()
                              <= c * eps * bound))


def test_flatten_refuses_maps_that_do_not_fit():
    _, f = plan_case("lp", 16)
    levels = [dict(lv) for lv in f.plan.levels]
    levels[1]["fs_ptr"] = levels[1]["fs_ptr"][:-1]
    with pytest.raises(ValueError):
        tsc.flatten_levels(levels)


@pytest.mark.parametrize("kind,B", CASES)
def test_blocked_solve_matches_plain_and_reference(kind, B):
    """K10's order (panel-blocked substitutions, the scatter's lane tree,
    the backward partials split over eight warps and reduced in order,
    from the flattened arrays) against tile_solve_plain and the
    reference's solve_tiles_ur on the same factor: within 1e-12 of
    max|x| (cond(M) < 1e2 here; the three orders round differently)."""
    M, f = plan_case(kind, B)
    L = f.factor(M)
    rhs = np.random.default_rng(B).standard_normal(f.plan.n)
    x_emu = emu.tile_solve(L, torch.as_tensor(rhs), f.levels.flat).numpy()
    x_plain = tsc.tile_solve_plain(L, torch.as_tensor(rhs), f.levels).numpy()
    x_ref = _ref_solve(f.plan, L.numpy(), rhs)
    scale = np.abs(x_plain).max()
    np.testing.assert_allclose(x_emu, x_plain, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(x_emu, x_ref, rtol=0, atol=1e-12 * scale)
    x = x_emu[: M.shape[0]][np.argsort(f.plan.perm)]
    b = rhs[: M.shape[0]][np.argsort(f.plan.perm)]
    assert np.abs(M @ x - b).max() <= 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("kind,B", [("lp", 16), ("lp", 32), ("chain", 32),
                                    ("chain", 128)])
def test_blocked_factor_matches_plain_and_reference(kind, B):
    """K8's order (blocked Cholesky of each diagonal tile, blocked TRSM of
    the off tiles) level by level, with the plain K9 between levels:
    the rungs equal the plain version's, and each level's tiles agree with
    tile_factor_plain from the same storage, and the whole factor with
    the reference's factor_tiles_ur, within 1e-12 of max|L|."""
    M, f = plan_case(kind, B)
    st = f.storage(M)
    L_ref = _ref_factor(f.plan, st.numpy().copy())
    for lv in f.levels:
        ref = st.clone()
        rungs = emu.tile_factor(st, lv, 0.0)
        assert torch.equal(rungs, tsc.tile_factor_plain(ref, lv, 0.0))
        slots = torch.cat([lv["dslot"], lv["off_slot"]])
        scale = float(ref[slots].abs().max())
        assert float((st[slots] - ref[slots]).abs().max()) <= 1e-12 * scale
        tsc.tile_update_plain(st, lv)
    pl = f.plan
    for j in range(pl.ntc):
        d = pl.dslot[j]
        np.testing.assert_allclose(np.tril(st[d].numpy()), np.tril(L_ref[d]),
                                   rtol=0, atol=1e-12 * np.abs(L_ref).max())
        for s in pl.oslot[j][pl.omask[j]]:
            np.testing.assert_allclose(st[s].numpy(), L_ref[s], rtol=0,
                                       atol=1e-12 * np.abs(L_ref).max())


def rung_tile(kind, B, seed=0):
    """A B x B SPD tile, or one built to fail: 'first' fails the lifted
    factor at pivot 3 only, 'late' at pivot 70 (the third panel at B =
    128), 'both' fails both rungs."""
    G = np.random.default_rng(seed).standard_normal((B, B))
    D = G @ G.T / B + np.eye(B)
    if kind == "first":
        D[3, 3] = -0.5
    elif kind == "late":
        D[70, 70] = -0.5
    elif kind == "both":
        D[5, 4] = D[4, 5] = 50.0
    return D


@pytest.mark.parametrize("kind,rung", [("spd", 0), ("first", 1),
                                       ("late", 1), ("both", 2)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_blocked_factor_rungs(kind, rung, dtype):
    """K8's blocked factor of one 128 x 128 diagonal tile takes the plain
    version's and the reference's rung (a failure in the third panel
    included) and its off tile's TRSM follows.  f64: rungs 0-1 within
    1e-13 of max|L| of the reference, the rung-2 tile bit for bit; f32:
    the rung-2 diagonal within 1 ulp of the plain version's (torch's CPU
    sqrt may miss by one) and rungs 0-1 within 1e-5."""
    B = 128
    D = rung_tile(kind, B)
    T = np.random.default_rng(1).standard_normal((B, B))
    st = torch.as_tensor(np.stack([np.tril(D), T]), dtype=dtype)
    lv = {"dslot": torch.tensor([0]), "off_slot": torch.tensor([1]),
          "off_dslot": torch.tensor([0])}
    ref = st.clone()
    assert emu.tile_factor(st, lv, 0.0).tolist() == [rung]
    assert tsc.tile_factor_plain(ref, lv, 0.0).tolist() == [rung]
    scale = float(ref.abs().max())
    if dtype == torch.float32:
        if rung == 2:
            np.testing.assert_array_max_ulp(st[0].numpy(), ref[0].numpy(),
                                            maxulp=1)
        else:
            assert float((st - ref).abs().max()) <= 1e-5 * scale
        return
    # the reference on a one-column plan holding the same diagonal tile
    f = tsc.SparseCholesky(sp.csc_matrix(np.ones((B, B))), B=B, device="cpu")
    one = np.zeros((f.plan.nslot, B, B))
    one[f.plan.dslot[0]] = np.tril(D)
    L_j = _ref_factor(f.plan, one)[f.plan.dslot[0]]
    if rung == 2:
        np.testing.assert_array_equal(st[0].numpy(), L_j)
    else:
        np.testing.assert_allclose(st[0].numpy(), L_j, rtol=0,
                                   atol=1e-13 * np.abs(L_j).max())
    assert float((st - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("B", [48, 128])
def test_blocking_changes_no_bit_of_the_factor(B, monkeypatch):
    """Every entry takes its products one at a time in k order, so the
    factor is the same bit for bit at any panel width; K8's 32 against
    one panel as wide as the tile (B = 48: panels of 32 and 16)."""
    D = torch.as_tensor(np.tril(rung_tile("spd", B, seed=B)))
    T = torch.as_tensor(np.random.default_rng(B).standard_normal((40, B)))
    got = emu.diag_factor(D, 0.0, 1e-12)
    X = emu.off_solve(T, got[0])
    monkeypatch.setattr(emu, "PANEL", B)
    want = emu.diag_factor(D, 0.0, 1e-12)
    assert got[1] == want[1] == 0
    assert torch.equal(got[0], want[0])
    assert torch.equal(X, emu.off_solve(T, want[0]))
