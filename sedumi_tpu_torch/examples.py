"""Loader for the six reference example problems + known optimal values.

Reference: examples/*.mat and examples/test_sedumi.m:22-31 — the bundled
correctness gate of the reference (objective parity to rel-err 1e-6).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp

# all six reference examples are vendored in-repo (examples/*.mat);
# SEDUMI_EXAMPLES_DIR overrides the lookup directory if set
_VENDORED_DIR = os.path.join(os.path.dirname(__file__), "..", "examples")
EXAMPLES_DIR = os.environ.get("SEDUMI_EXAMPLES_DIR", _VENDORED_DIR)

# name -> known optimal value (test_sedumi.m:22-31, examples/README.md)
KNOWN_OPTIMA = {
    "arch0": -5.665170e-01,
    "control07": -2.062510e01,
    "nb": -5.070309e-02,
    "OH_2Pi_STO-6GN9r12g1T2": 7.946708e01,
    "trto3": -1.279999e04,
    "quantum": -0.75395345,
}


class ExampleProblem(NamedTuple):
    name: str
    At: sp.spmatrix          # n x m (SeDuMi transpose convention)
    b: np.ndarray
    c: np.ndarray
    K: dict
    optval: float


def load_example(name: str) -> ExampleProblem:
    from scipy.io import loadmat

    path = os.path.join(EXAMPLES_DIR, name + ".mat")
    if not os.path.exists(path):
        path = os.path.join(_VENDORED_DIR, name + ".mat")
    d = loadmat(path)
    K_struct = d["K"]
    K = {}
    for f in K_struct.dtype.names:
        K[f] = np.asarray(K_struct[f][0, 0]).ravel()
    At = d["At"]
    if not sp.issparse(At):
        At = sp.csc_matrix(At.astype(np.complex128 if np.iscomplexobj(At) else np.float64))
    else:
        At = At.astype(np.float64) if not np.iscomplexobj(At.data) else At
    b = d["b"]
    b = np.asarray(b.todense() if sp.issparse(b) else b).ravel().astype(np.float64)
    c = d["c"]
    c = np.asarray(c.todense() if sp.issparse(c) else c).ravel()
    c = c.astype(np.complex128 if np.iscomplexobj(c) else np.float64)
    return ExampleProblem(name=name, At=At, b=b, c=c, K=K, optval=KNOWN_OPTIMA[name])
