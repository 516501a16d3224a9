"""K3's plan and schedule on the CPU (csrc/ldl_masked.cu runs only on the
card).

* chol.ldl_plan: the warp, shared and device variants on both sides of
  each edge, in f64 and f32.
* tests/ldl_emulation.py (the kernel's left-looking schedule, warp by warp,
  and its max|col| rule) bit for bit ldl_masked_plain on the `indefinite`
  matrices at the path's orders 3, 12, 60, 124 and 174, and on adversarial
  columns: NaN entries and pivots, +inf pivots, subnormal, zero and
  cancelled pivots, every pivot skipped, skip_pivots=False.
* ldl_masked on a CPU tensor is ldl_masked_plain, and once against the JAX
  package's chol.ldl_masked (rtol 1e-12, masks equal, as
  tests/test_torch_kernels.py holds the plain version).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldl_emulation as emu
from sedumi_tpu import chol as jchol
from sedumi_tpu_torch import chol, kernels

F64, F32 = torch.float64, torch.float32


def bits(a):
    a = np.ascontiguousarray(a)
    if a.dtype == bool:
        return a
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def same(got, want) -> bool:
    """Bit for bit, but where both are NaN (payloads are the machine's)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == bool:
        return np.array_equal(got, want)
    nan = np.isnan(got)
    return np.array_equal(nan, np.isnan(want)) and np.array_equal(
        bits(got)[~nan], bits(want)[~nan])


def emulation_is_plain(M, **kw):
    """The emulation with ldl_plan's warps bit for bit the plain version;
    returns the plain factor."""
    Mt = torch.as_tensor(M)
    variant, blocks, warps = chol.ldl_plan(M.shape[0], Mt.dtype)
    fp = chol.ldl_masked_plain(Mt, **kw)
    fe = emu.ldl(M, nw=blocks * warps, **kw)
    for got, want in zip(fe, fp):
        assert same(got, want.numpy())
    return fp


@pytest.mark.parametrize("dtype,edge", [(F64, 240), (F32, 340)])
def test_ldl_plan_edges(dtype, edge):
    """One warp up to 32 rows, one block while the packed triangle fits
    the 227 KB of shared memory, a grid over device memory beyond; each
    plan within the card's limits."""
    assert chol.ldl_plan(1, dtype) == ("warp", 1, 1)
    assert chol.ldl_plan(32, dtype) == ("warp", 1, 1)
    for m in (33, edge):
        variant, blocks, warps = chol.ldl_plan(m, dtype)
        assert (variant, blocks) == ("shared", 1) and 1 <= warps <= 32
    assert chol.ldl_smem_bytes(edge, dtype) <= chol.SMEM_MAX
    assert chol.ldl_smem_bytes(edge + 1, dtype) > chol.SMEM_MAX
    size = 8 if dtype == F64 else 4
    for m in (edge + 1, 666, 5000):
        variant, blocks, warps = chol.ldl_plan(m, dtype)
        assert variant == "device" and 1 <= blocks <= chol.NUM_SMS
        assert warps * m * size <= chol.SMEM_MAX     # the column buffers
    assert chol.ldl_plan(5000, dtype, sms=16)[1] == 16
    with pytest.raises(ValueError):
        chol.ldl_plan(0, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m", [3, 12, 60, 124, 174])
def test_emulation_is_plain_bit_for_bit(m, dtype):
    fp = emulation_is_plain(emu.indefinite(m, 3).astype(dtype))
    if m >= 12:
        assert bool(fp.skip.any()) and bool((fp.diagadd > 0).any())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", emu.CASES)
def test_adversarial_columns(case, dtype):
    """The emulation's schedule and max|col| rule give the plain version's
    bits on columns built to break them."""
    M, kw = emu.adversarial(case, dtype)
    fp = emulation_is_plain(M, **kw)
    skip, d = fp.skip.numpy(), fp.d.numpy()
    if case == "all_skipped":
        assert skip[:-1].all() and not skip[-1]
    if case in ("no_skip", "cancelled"):
        assert not skip.any()
    if case == "cancelled":
        assert (fp.diagadd.numpy() > 0).sum() >= 8
    if case.startswith("nan"):
        assert np.isnan(fp.L.numpy()).any()
    if case == "subnormal_pivot":
        sub = np.abs(d[np.isfinite(d)])
        assert ((sub > 0) & (sub < np.finfo(dtype).tiny)).any()
    if case == "zero_pivot":
        assert (d == 0).any()


def test_cpu_wrapper_is_plain_and_counts_nothing():
    """On a CPU tensor ldl_masked runs ldl_masked_plain and launches
    nothing."""
    kernels.reset_launch_counts()
    M = torch.as_tensor(emu.indefinite(60, 2))
    f, fp = chol.ldl_masked(M), chol.ldl_masked_plain(M)
    for a, b in zip(f, fp):
        assert same(a.numpy(), b.numpy())
    assert not any(kernels.LAUNCHES.values())
    assert not kernels.VARIANT_LAUNCHES


def test_emulation_against_reference():
    """The emulation at the path's arch0 order against the JAX package's
    ldl_masked: masks equal, L, d and diagadd within rtol 1e-12."""
    M = emu.indefinite(174, 3)
    fj = jchol.ldl_masked(jnp.asarray(M))
    L, d, skip, diagadd = emu.ldl(M, nw=chol.ldl_plan(174, F64)[2])
    np.testing.assert_array_equal(skip, np.asarray(fj.skip))
    np.testing.assert_array_equal(diagadd > 0, np.asarray(fj.diagadd) > 0)
    for a, b in ((L, fj.L), (d, fj.d), (diagadd, fj.diagadd)):
        b = np.asarray(b)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin)
        scale = np.abs(b[fin]).max()
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12,
                                   atol=1e-12 * scale)
