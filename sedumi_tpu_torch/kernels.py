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
# source file -> {C launch function: argtypes}
SOURCES = {
    "dd_residual.cu": {
        "dd_matvec_residual_launch": [_P, _P, _P, _P, _I, _I, _P],
        "dd_matvec_residual_f32_launch": [_P, _P, _P, _P, _I, _I, _P]},
    "psd_coo.cu": {
        "psd_coo_outer_launch": [_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _P],
        "psd_coo_gather_launch": [_P, _P, _P, _P, _P, _I, _LL, _P],
        "psd_coo_outer_f32_launch": [_P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _P],
        "psd_coo_gather_f32_launch": [_P, _P, _P, _P, _P, _I, _LL, _P]},
    "ldl_masked.cu": {
        "ldl_masked_launch": [_P, _P, _P, _P, _P, _P, _P, _I,
                              _D, _D, _D, _I, _P],
        "ldl_masked_f32_launch": [_P, _P, _P, _P, _P, _P, _P, _I,
                                  _D, _D, _D, _I, _P]},
    "dd_split.cu": {
        "ozaki_split_launch": [_P, _LL, _I, _I, _I, _I, _P, _P, _P, _P]},
    "dd_elem.cu": {
        "dd_accumulate_launch": [_P, _P, _P, _LL, _I, _P],
        "dd_add_launch": [_P, _P, _P, _P, _I, _P, _P, _LL, _P],
        "two_prod_cols_launch": [_P, _P, _I, _P, _P, _LL, _P]},
    "dd_gemv.cu": {
        "dd_gemv_launch": [_P, _P, _LL, _LL, _P, _P, _I, _I, _P, _P, _P]},
    "dd_chol.cu": {
        "dd_panel_chol_launch": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P]},
    "tile_chol.cu": {
        "tile_diag_launch": [_P, _P, _P, _I, _I, _D, _D, _P],
        "tile_off_launch": [_P, _P, _P, _I, _I, _P]},
    "tile_update.cu": {
        "tile_update_launch": [_P, _P, _P, _P, _P, _I, _I, _P]},
    "tile_solve.cu": {
        "tile_fwd_diag_launch": [_P, _P, _P, _P, _I, _I, _P],
        "tile_fwd_scatter_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        "tile_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P]},
    "df_gemv.cu": {
        "df_matvec_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        "df_vecmat_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P]},
}

# K1-K3 count their f64 and f32 builds apart (the *_f32 names)
LAUNCHES = {"dd_matvec_residual": 0, "psd_contrib_coo": 0, "ldl_masked": 0,
            "ozaki_split": 0, "dd_accumulate": 0, "dd_gemv": 0,
            "dd_panel_chol": 0, "tile_factor": 0, "tile_update": 0,
            "tile_solve": 0, "dd_matvec_residual_f32": 0,
            "psd_contrib_coo_f32": 0, "ldl_masked_f32": 0, "df_matvec": 0,
            "df_vecmat": 0}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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
    text = (SRC_DIR / src).read_bytes() + " ".join(NVCC_FLAGS).encode()
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


def launch(src: str, fn: str, *args) -> None:
    """Call a C launch function on the current CUDA stream; raise if the
    launch was refused."""
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(_lib(src), fn)(*args, stream)
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
