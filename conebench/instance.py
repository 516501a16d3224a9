"""One problem instance in SeDuMi's form, and the seeded draws of a pool."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class Instance:
    """min c'x s.t. At'x = b, x in K (At is n x m, SeDuMi's orientation)."""

    At: sp.csc_matrix
    b: np.ndarray
    c: np.ndarray
    K: dict
    # {"m": constraints, "l": LP cones, "q": [SOC orders], "s": [PSD orders]}
    shapes: dict


def shapes_of(At, K: dict) -> dict:
    return {"m": int(At.shape[1]), "l": int(K.get("l", 0)),
            "q": [int(v) for v in K.get("q", [])],
            "s": [int(v) for v in K.get("s", [])]}


def rng_for(seed: int, *index: int) -> np.random.Generator:
    """The generator of draw `index` from `seed` (any whole number: it is
    taken modulo 2**64)."""
    return np.random.default_rng([int(seed) % 2**64, *map(int, index)])


def generator(config: dict):
    """The module generators/<config["generator"]>.py, which defines
    load(config) -> base data and make(base, problem_rng, order_rng) ->
    Instance."""
    return importlib.import_module(
        f"conebench.generators.{config['generator']}")


def make_pool(config: dict, seed: int, size: int) -> tuple[list, Instance]:
    """`size` instances in an order drawn from `seed`, and one more of the
    same shapes (index `size`, not in the pool) for the warm-up solve.
    Problem i of the configuration's fixed set, the order of its
    constraints or vertices included, is drawn from its "instance_seed"
    alone: every seed gets the same problems, solved in another order.
    (Under dtype 'mixed' a constraint order moves a solve's iterations by
    up to 1.7x, so an order drawn from the seed would change the work.)"""
    gen = generator(config)
    base = gen.load(config)
    fixed = config["instance_seed"]
    made = [gen.make(base, rng_for(fixed, i), rng_for(fixed, i, 1))
            for i in range(size + 1)]
    order = rng_for(seed, 0).permutation(size)
    return [made[i] for i in order], made[size]
