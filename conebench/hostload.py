"""The host load of a run: one process, and at most HOST_THREADS threads
in the BLAS and OpenMP pools of numpy, scipy and torch.  On a card's
machine that shares its cores with other work, a solve's host parts
(pretransfo, the IPM loop's control, the terminal refinement in NumPy)
spread less with four threads than with all eight.  Call before numpy or
torch is imported."""

import os

HOST_THREADS = 4
_POOLS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def limit_threads() -> None:
    for var in _POOLS:
        os.environ[var] = str(HOST_THREADS)
