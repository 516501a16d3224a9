"""The configurations' generator: shapes, one instance per seed, and the
SDPLIB instances' seeded transform keeping the problem."""

from __future__ import annotations

import numpy as np
import pytest

from conebench import spec
from conebench.generators import sdplib_mat
from conebench.instance import make_pool, rng_for

BIG_SEED = 2**31 + 987654321


def _config(name):
    return spec.load_json(spec.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", ["sdplib-control07", "sdplib-arch0"])
def test_pool_shapes_and_determinism(name):
    config = _config(name)
    pool, warm = make_pool(config, BIG_SEED, 3)
    again, _ = make_pool(config, BIG_SEED, 3)
    others = [make_pool(config, BIG_SEED + k, 3)[0] for k in (1, 2, 3)]
    for inst in pool + [warm]:
        n = sum(d * d for d in config["s"]) + config["l"] + sum(config["q"])
        assert inst.At.shape == (n, config["m"])
        assert inst.b.shape == (config["m"],) and inst.c.shape == (n,)
        assert inst.shapes == {k: config[k] for k in ("m", "l", "q", "s")}
    for a, b in zip(pool, again):
        assert (a.At != b.At).nnz == 0
        assert np.array_equal(a.b, b.b) and np.array_equal(a.c, b.c)
    # another seed, the same three problems; some seed orders them anew
    assert all({a.b.tobytes() for a in pool} == {b.b.tobytes() for b in o}
               for o in others)
    assert any([a.b.tobytes() for a in pool] != [b.b.tobytes() for b in o]
               for o in others)
    assert not np.array_equal(pool[0].c, pool[1].c) \
        or not np.array_equal(pool[0].b, pool[1].b)


@pytest.mark.parametrize("name", ["sdplib-control07", "sdplib-arch0"])
def test_sdplib_transform_keeps_the_problem(name):
    config = _config(name)
    base = sdplib_mat.load(config)
    rng = np.random.default_rng(3)
    x = rng.normal(size=base["At"].shape[0])
    y = rng.normal(size=base["At"].shape[1])
    for index in range(3):
        draws = (rng_for(11, index), rng_for(BIG_SEED, index))
        perm, scale = sdplib_mat.transform(base, *draws)
        draws = (rng_for(11, index), rng_for(BIG_SEED, index))
        inst = sdplib_mat.make(base, *draws)
        assert np.all((scale >= 0.5) & (scale <= 2.0))
        assert np.array_equal(np.sort(perm), np.arange(config["m"]))
        # a residual maps row by row, so a feasible x stays feasible
        r = base["At"].T @ x - base["b"]
        assert np.allclose(inst.At.T @ x - inst.b, r[perm] * scale,
                           rtol=1e-12, atol=1e-12)
        # the same objective, and a dual point maps to one with the same
        # slack and the same value
        assert np.array_equal(inst.c, base["c"])
        y_new = y[perm] / scale
        assert np.allclose(inst.At @ y_new, base["At"][:, perm] @ y[perm])
        assert np.isclose(inst.b @ y_new, base["b"][perm] @ y[perm])


def test_data_file_is_checked():
    config = {**_config("sdplib-control07"), "data_sha256": "0" * 64}
    with pytest.raises(ValueError, match="sha256"):
        sdplib_mat.load(config)


def test_seeds_get_the_same_work_in_another_order():
    """The pool holds the same problems for every seed, each with its
    constraints in the same order; the seed draws the order in which they
    are solved."""
    for name in ("sdplib-control07", "sdplib-arch0"):
        config = _config(name)
        a, warm_a = make_pool(config, BIG_SEED, 8)
        b, warm_b = make_pool(config, BIG_SEED + 99, 8)
        key = {x.b.tobytes(): x for x in a}
        assert len(key) == 8 and set(key) == {y.b.tobytes() for y in b}
        for y in b:
            x = key[y.b.tobytes()]
            assert (x.At != y.At).nnz == 0 and np.array_equal(x.c, y.c)
        assert [x.b.tobytes() for x in a] != [y.b.tobytes() for y in b]
        assert (warm_a.At != warm_b.At).nnz == 0
        assert np.array_equal(warm_a.b, warm_b.b)
