"""ctypes bindings for the host symbolic engine (csrc/host_engine.cc).

Counterpart of the reference's native.py.  The library provides the
sparse-symbolic analysis of the tile planner: AMD ordering (ordmmd.c
role), elimination tree / postorder / column counts / symbolic Cholesky
pattern (symfct.c role), supernode partition (cholsplit.c role) and the
elimination-tree level schedule.

The source is the port's own copy of the reference's host engine.  g++
builds it with the reference's flags into sedumi_tpu_torch/_build/ under
a content-hash name, at first use (never at import).  There is no
fallback: if the build or the load fails this raises, because another
ordering would give another fill, another factor and other iterates.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import scipy.sparse as sp

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "host_engine.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]

_LIB = None


def lib_path() -> Path:
    text = SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
    tag = hashlib.sha1(text).hexdigest()[:12]
    return BUILD_DIR / f"host_engine_{tag}.so"


def build() -> Path:
    """Compile the host engine if its library is missing; raise with the
    compiler's output if g++ fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.sed_etree.argtypes = [ctypes.c_int32, i64p, i32p, i32p]
        lib.sed_postorder.argtypes = [ctypes.c_int32, i32p, i32p]
        lib.sed_colcounts.argtypes = [ctypes.c_int32, i64p, i32p, i32p,
                                      i32p]
        lib.sed_supernodes.argtypes = [ctypes.c_int32, i32p, i32p,
                                       ctypes.c_int32, i32p, i32p]
        lib.sed_levels.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
        lib.sed_symbolic.argtypes = [ctypes.c_int32, i64p, i32p, i32p, i64p,
                                     i32p]
        lib.sed_symbolic.restype = ctypes.c_int64
        lib.sed_amd.argtypes = [ctypes.c_int32, i64p, i32p, i32p]
        _LIB = lib
    return _LIB


def _csc_pattern(A) -> tuple[np.ndarray, np.ndarray, int]:
    """(colptr int64, rowind int32, n) of the symmetrized pattern."""
    A = sp.csc_matrix(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"pattern must be square, got {A.shape}")
    S = (A + A.T).tocsc()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), n


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def amd_order(A) -> np.ndarray:
    """Fill-reducing permutation (new->old) by approximate minimum
    degree."""
    colptr, rowind, n = _csc_pattern(A)
    if n == 0:
        return np.zeros(0, np.int64)
    perm = np.zeros(n, np.int32)
    _lib().sed_amd(n, _ptr(colptr, ctypes.c_int64),
                   _ptr(rowind, ctypes.c_int32), _ptr(perm, ctypes.c_int32))
    return perm.astype(np.int64)


def etree(A) -> np.ndarray:
    """Elimination tree parents (-1 for roots) of the pattern of A."""
    colptr, rowind, n = _csc_pattern(A)
    parent = np.full(n, -1, np.int32)
    if n:
        _lib().sed_etree(n, _ptr(colptr, ctypes.c_int64),
                         _ptr(rowind, ctypes.c_int32),
                         _ptr(parent, ctypes.c_int32))
    return parent.astype(np.int64)


def postorder(parent: np.ndarray) -> np.ndarray:
    n = parent.size
    if n == 0:
        return np.zeros(0, np.int64)
    par = _i32(parent)
    post = np.zeros(n, np.int32)
    _lib().sed_postorder(n, _ptr(par, ctypes.c_int32),
                         _ptr(post, ctypes.c_int32))
    return post.astype(np.int64)


def col_counts(A, parent: np.ndarray) -> np.ndarray:
    """Column counts of L (incl. diagonal)."""
    colptr, rowind, n = _csc_pattern(A)
    if n == 0:
        return np.zeros(0, np.int64)
    par = _i32(parent)
    counts = np.zeros(n, np.int32)
    _lib().sed_colcounts(n, _ptr(colptr, ctypes.c_int64),
                         _ptr(rowind, ctypes.c_int32),
                         _ptr(par, ctypes.c_int32),
                         _ptr(counts, ctypes.c_int32))
    return counts.astype(np.int64)


def supernodes(parent: np.ndarray, counts: np.ndarray,
               maxwidth: int = 0) -> np.ndarray:
    """snode[j] = supernode id of column j (fundamental supernodes split to
    maxwidth columns; 0 = unlimited)."""
    n = parent.size
    if n == 0:
        return np.zeros(0, np.int64)
    par, cnt = _i32(parent), _i32(counts)
    snode = np.zeros(n, np.int32)
    ns = np.zeros(1, np.int32)
    _lib().sed_supernodes(n, _ptr(par, ctypes.c_int32),
                          _ptr(cnt, ctypes.c_int32), maxwidth,
                          _ptr(snode, ctypes.c_int32),
                          _ptr(ns, ctypes.c_int32))
    return snode.astype(np.int64)


def levels(parent: np.ndarray) -> np.ndarray:
    """Elimination-tree level of each column (leaves = 0)."""
    n = parent.size
    if n == 0:
        return np.zeros(0, np.int64)
    par = _i32(parent)
    lev = np.zeros(n, np.int32)
    nl = np.zeros(1, np.int32)
    _lib().sed_levels(n, _ptr(par, ctypes.c_int32),
                      _ptr(lev, ctypes.c_int32), _ptr(nl, ctypes.c_int32))
    return lev.astype(np.int64)


def symbolic_pattern(A, parent: np.ndarray) -> sp.csc_matrix:
    """Boolean lower-triangular pattern of the Cholesky factor of A."""
    colptr, rowind, n = _csc_pattern(A)
    if n == 0:
        return sp.csc_matrix((0, 0))
    lib = _lib()
    par = _i32(parent)
    lcolptr = np.zeros(n + 1, np.int64)
    nnz = lib.sed_symbolic(n, _ptr(colptr, ctypes.c_int64),
                           _ptr(rowind, ctypes.c_int32),
                           _ptr(par, ctypes.c_int32),
                           _ptr(lcolptr, ctypes.c_int64), None)
    lrowind = np.zeros(int(nnz), np.int32)
    lib.sed_symbolic(n, _ptr(colptr, ctypes.c_int64),
                     _ptr(rowind, ctypes.c_int32), _ptr(par, ctypes.c_int32),
                     _ptr(lcolptr, ctypes.c_int64),
                     _ptr(lrowind, ctypes.c_int32))
    return sp.csc_matrix(
        (np.ones(lrowind.size, np.int8), lrowind, lcolptr), shape=(n, n))
