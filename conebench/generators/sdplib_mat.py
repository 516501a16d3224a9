"""A published instance in SeDuMi's .mat form (At, b, c, K), made
equivalent: each pair (row of A, entry of b) is scaled by a factor drawn
log-uniformly from the configuration's "row_scale" range (the problem),
and the constraints are put in a drawn order.  The feasible set, the
objective and the optimum are those of the published instance; a dual
solution maps back by y[perm] = y' * scale."""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import scipy.sparse as sp
from scipy.io import loadmat

from conebench.instance import Instance, shapes_of

BENCH = Path(__file__).resolve().parents[1]


def load(config: dict) -> dict:
    path = BENCH / config["data"]
    raw = path.read_bytes()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != config["data_sha256"]:
        raise ValueError(f"{path} has sha256 {digest}, the configuration "
                         f"states {config['data_sha256']}")
    d = loadmat(path)
    K = {}
    for f in d["K"].dtype.names:
        v = np.asarray(d["K"][f][0, 0]).ravel().astype(int)
        K[f] = int(v[0]) if f == "l" else [int(t) for t in v if t > 0]
    K = {k: v for k, v in K.items() if v}
    At = sp.csc_matrix(d["At"], dtype=np.float64)
    b = np.asarray(d["b"].todense() if sp.issparse(d["b"]) else d["b"],
                   np.float64).ravel()
    c = np.asarray(d["c"].todense() if sp.issparse(d["c"]) else d["c"],
                   np.float64).ravel()
    shapes = shapes_of(At, K)
    want = {k: config[k] for k in ("m", "l", "q", "s")}
    if shapes != want or At.shape[0] != config["n"]:
        raise ValueError(f"{path}: shapes {shapes}, n {At.shape[0]}; the "
                         f"configuration states {want}, n {config['n']}")
    return {"At": At, "b": b, "c": c, "K": K, "shapes": shapes,
            "row_scale": config["row_scale"]}


def transform(base: dict, problem_rng: np.random.Generator,
              order_rng: np.random.Generator):
    """(perm, scale): constraint i of the instance is constraint perm[i]
    of the published one, times scale[i]."""
    m = base["At"].shape[1]
    lo, hi = base["row_scale"]
    scale = np.exp(problem_rng.uniform(np.log(lo), np.log(hi), m))
    perm = order_rng.permutation(m)
    return perm, scale[perm]


def make(base: dict, problem_rng: np.random.Generator,
         order_rng: np.random.Generator) -> Instance:
    perm, scale = transform(base, problem_rng, order_rng)
    At = sp.csc_matrix(base["At"][:, perm] @ sp.diags(scale))
    return Instance(At=At, b=base["b"][perm] * scale, c=base["c"].copy(),
                    K=dict(base["K"]), shapes=dict(base["shapes"]))
