"""Shared pieces of the benchmark's CPU tests: a tiny cell of the real
files that runs the harness on the CPU.  Its data is a 6 x 4 toroidal
grid's max-cut relaxation (24 vertices, weights +-1) in SeDuMi's .mat
form, read by the cell's own generator."""

from __future__ import annotations

import atexit
import hashlib
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.io import savemat

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

_TINY: dict = {}


def _tiny_mat(rows: int, cols: int) -> dict:
    """Write the grid's max-cut SDP (min -<L/4, X>, diag(X) = 1, X psd)
    once a session; the configuration keys that describe it."""
    key = (rows, cols)
    if key not in _TINY:
        n = rows * cols
        idx = np.arange(n).reshape(rows, cols)
        i = np.concatenate([idx.ravel(), idx.ravel()])
        j = np.concatenate([np.roll(idx, -1, 1).ravel(),
                            np.roll(idx, -1, 0).ravel()])
        w = np.random.default_rng(5).choice([-1.0, 1.0], size=len(i))
        W = sp.coo_matrix((np.r_[w, w], (np.r_[i, j], np.r_[j, i])),
                          shape=(n, n)).toarray()
        L = np.diag(W.sum(1)) - W
        At = sp.csc_matrix((np.ones(n), (np.arange(n) * (n + 1),
                                         np.arange(n))), shape=(n * n, n))
        folder = tempfile.mkdtemp(prefix="conebench-tiny-")
        atexit.register(shutil.rmtree, folder, True)
        path = Path(folder) / f"torus{rows}x{cols}.mat"
        savemat(path, {"At": At, "b": np.ones((n, 1)),
                       "c": (-L / 4.0).reshape(-1, 1, order="F"),
                       "K": {"l": np.array([[0]]), "s": np.array([[n]])}})
        _TINY[key] = {"data": str(path), "data_sha256": hashlib.sha256(
            path.read_bytes()).hexdigest(), "n": n * n, "m": n, "l": 0,
            "q": [], "s": [n]}
    return _TINY[key]


def tiny_cell(name: str, grid=(6, 4), pool: int = 2) -> dict:
    """The cell `name` of BENCHMARK.json, its configuration's data swapped
    for the tiny grid's."""
    from conebench import spec

    cell = spec.cell(name)
    cell["config"] = {**cell["config"], **_tiny_mat(*grid)}
    cell["traffic"] = {**cell["traffic"], "pool": pool, "trace_seconds": 0.1}
    return cell


@pytest.fixture
def lines():
    """A log that keeps the harness's standard-error lines."""
    out: list[str] = []
    return out
