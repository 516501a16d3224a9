"""Build, load and count the hand-written CUDA kernels of the port.

Each source in csrc/ is compiled by nvcc for sm_90a into its own shared
library with a plain C interface (one nvcc process per source, all started
together) under sedumi_tpu_torch/_build/, at first use, and loaded with
ctypes.  Pointers and the current stream are passed as integers; each
launch function returns cudaGetLastError(), and a non-zero code raises.
Nothing here runs at import: the CPU tests import every module.

LAUNCHES counts, per kernel wrapper, the calls that launched the kernel
(never the plain-PyTorch twin), so a run can show that the main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC"]

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
# A, V, schedule, ratio, done, sweeps run; batch, groups, n, sweeps,
# vectors; eps; variant, cluster size
_JACOBI_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _I, _I, _P]
# source file -> {C launch function: argtypes}
SOURCES = {
    "dd_residual.cu": {
        "dd_matvec_residual_launch": [_P, _LL, _P, _P, _P, _P, _I, _I, _I,
                                      _P],
        "dd_matvec_residual_f32_launch": [_P, _LL, _P, _P, _P, _P, _I, _I,
                                          _I, _P]},
    "psd_coo.cu": {
        "psd_schur_launch": [_P] * 8 + [_I, _P, _P, _P, _P] + [_I] * 4
        + [_P],
        "psd_schur_f32_launch": [_P] * 8 + [_I, _P, _P, _P, _P] + [_I] * 4
        + [_P],
        "psd_pair_launch": [_P] * 9 + [_LL, _I, _I, _P],
        "psd_pair_f32_launch": [_P] * 9 + [_LL, _I, _I, _P]},
    "ldl_masked.cu": {
        "ldl_masked_launch": [_P, _LL] + [_P] * 6 + [_I, _D, _D, _D]
        + [_I] * 4 + [_P],
        "ldl_masked_f32_launch": [_P, _LL] + [_P] * 6 + [_I, _D, _D, _D]
        + [_I] * 4 + [_P]},
    "dd_split.cu": {
        "ozaki_split_launch": [_P, _LL, _I, _I, _I, _I, _P, _P, _P, _P]},
    "dd_elem.cu": {
        "dd_accumulate_launch": [_P, _P, _P, _LL, _I, _P],
        "dd_add_launch": [_P, _P, _P, _P, _I, _P, _P, _LL, _P],
        "two_prod_cols_launch": [_P, _P, _I, _P, _P, _LL, _P]},
    "dd_gemv.cu": {
        "dd_gemv_launch": [_P, _P, _LL, _LL, _P, _P, _I, _I, _P, _P, _P],
        "dd_chol_solve_launch": [_P, _P, _LL, _P, _P, _P, _P, _I, _I,
                                 _P, _P, _P]},
    "dd_chol.cu": {
        "dd_panel_chol_launch": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                                 _P]},
    "tile_chol.cu": {
        "tile_diag_launch": [_P, _P, _P, _I, _I, _D, _D, _P],
        "tile_off_launch": [_P, _P, _P, _I, _I, _P],
        "tile_diag_f32_launch": [_P, _P, _P, _I, _I, _D, _D, _P],
        "tile_off_f32_launch": [_P, _P, _P, _I, _I, _P]},
    "tile_update.cu": {
        "tile_update_launch": [_P] * 10 + [_I, _I, _P],
        "tile_update_f32_launch": [_P] * 10 + [_I, _I, _P]},
    "tile_solve.cu": {
        "tile_solve_fwd_launch": [_P] * 11 + [_I, _I, _I, _P],
        "tile_solve_bwd_launch": [_P] * 11 + [_I, _I, _I, _P],
        "tile_solve_fwd_f32_launch": [_P] * 11 + [_I, _I, _I, _P],
        "tile_solve_bwd_f32_launch": [_P] * 11 + [_I, _I, _I, _P]},
    "df_gemv.cu": {
        "df_matvec_launch": [_P, _P, _LL] + [_P] * 6 + [_I] * 4 + [_P],
        "df_vecmat_launch": [_P] * 4 + [_LL] + [_P] * 4 + [_I] * 4 + [_P]},
    "jacobi_eigh.cu": {
        "jacobi_eigh_f64_launch": _JACOBI_ARGS,
        "jacobi_eigh_f32_launch": _JACOBI_ARGS},
    "jacobi_herm.cu": {
        "jacobi_herm_c128_launch": _JACOBI_ARGS,
        "jacobi_herm_c64_launch": _JACOBI_ARGS},
    "panel_chol.cu": {
        "panel_chol_launch": [_P, _P, _I, _I, _I, _P],
        "panel_chol_launch_f32": [_P, _P, _I, _I, _I, _P]},
    "panel_solve.cu": {
        "panel_fwd_step_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "panel_bwd_contrib_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _P],
        "panel_bwd_solve_launch": [_P, _P, _P, _P, _I, _P],
        "panel_fwd_step_launch_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "panel_bwd_contrib_launch_f32": [_P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _P],
        "panel_bwd_solve_launch_f32": [_P, _P, _P, _P, _I, _P]},
}

# K1-K3, K8-K10, K12-K15 count their builds apart (the *_f32 and *_c64
# names)
LAUNCHES = {"dd_matvec_residual": 0, "psd_contrib_coo": 0, "ldl_masked": 0,
            "ozaki_split": 0, "dd_accumulate": 0, "dd_gemv": 0,
            "dd_chol_solve": 0,
            "dd_panel_chol": 0, "tile_factor": 0, "tile_update": 0,
            "tile_solve": 0, "tile_factor_f32": 0, "tile_update_f32": 0,
            "tile_solve_f32": 0, "dd_matvec_residual_f32": 0,
            "psd_contrib_coo_f32": 0, "ldl_masked_f32": 0, "df_matvec": 0,
            "df_vecmat": 0, "jacobi_eigh": 0, "jacobi_eigh_f32": 0,
            "jacobi_eigh_herm": 0, "jacobi_eigh_herm_c64": 0,
            "dist_panel_chol": 0, "dist_trisolve_fwd": 0,
            "dist_trisolve_bwd_contrib": 0, "dist_trisolve_bwd_solve": 0,
            "dist_panel_chol_f32": 0, "dist_trisolve_fwd_f32": 0,
            "dist_trisolve_bwd_contrib_f32": 0,
            "dist_trisolve_bwd_solve_f32": 0}

# launches per variant and order of K12 and K13 (lax_eigh.variant_key),
# per shape of K2 and K4 ("name@shape", count) and per variant and order
# of K3 ("name:variant@m"), beside LAUNCHES
VARIANT_LAUNCHES: dict[str, int] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
# C launch function name -> its ctypes function, bound once
_FNS: dict = {}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    VARIANT_LAUNCHES.clear()


def count(name: str, shape: str, variant: str | None = None) -> None:
    """One launch of kernel `name` at `shape` (LAUNCHES and
    VARIANT_LAUNCHES["name@shape"], or "name:variant@shape")."""
    LAUNCHES[name] += 1
    key = f"{name}:{variant}@{shape}" if variant else f"{name}@{shape}"
    VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str) -> Path:
    """The library's path, keyed by its source, the shared headers and
    the flags."""
    text = (SRC_DIR / src).read_bytes() + " ".join(NVCC_FLAGS).encode()
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        text += hdr.read_bytes()
    tag = hashlib.sha1(text).hexdigest()[:12]
    return BUILD_DIR / f"{Path(src).stem}_{tag}.so"


def build_all(sources=None) -> dict[str, float]:
    """Compile every missing library, one nvcc per source in parallel.
    Returns {source: seconds} of the builds that ran; raises with the
    compiler's output if any build fails."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in (sources or SOURCES) if not _lib_path(s).exists()]
    procs = {}
    t0 = time.time()
    for src in todo:
        out = _lib_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), tmp, out)
    times, errors = {}, []
    for src, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        times[src] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def _lib(src: str) -> ctypes.CDLL:
    lib = _LIBS.get(src)
    if lib is None:
        path = _lib_path(src)
        if not path.exists():
            build_all([src])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SOURCES[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[src] = lib
    return lib


def bound(src: str, fn: str):
    """The C launch function `fn` of `src`, loaded and bound once."""
    f = _FNS.get(fn)
    if f is None:
        f = _FNS[fn] = getattr(_lib(src), fn)
    return f


def raw_stream() -> int:
    """The current CUDA stream of the current device, as an integer,
    without building a torch.cuda.Stream (CUDA builds of torch only)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(src: str, fn: str, *args) -> None:
    """Call a C launch function on the current CUDA stream; raise if the
    launch was refused."""
    code = bound(src, fn)(*args, raw_stream())
    if code != 0:
        raise RuntimeError(f"CUDA launch {fn} failed with error {code}")


def check_cuda(*tensors: torch.Tensor, dtype=None,
               contiguous: bool = True) -> None:
    """Device/type/contiguity checks before pointers go to a kernel."""
    for t in tensors:
        if not t.is_cuda or (contiguous and not t.is_contiguous()):
            raise ValueError("kernel arguments must be contiguous CUDA "
                             "tensors")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"kernel argument has dtype {t.dtype}, "
                             f"expected {dtype}")
