"""Run a function on n ranks of a local process group (SPMD).

run_spmd(fn, nprocs, args) spawns nprocs processes (start method spawn),
joins them into one process group on tcp://127.0.0.1 and calls
fn(rank, *args) in each; it returns every rank's result (tensors turned
into numpy arrays) and re-raises any rank's failure in the caller.  The
backend is gloo on the CPU or when ranks share a card (NCCL refuses two
ranks on one card), NCCL when each rank has a card of its own.  Gloo
binds to the loopback interface (GLOO_SOCKET_IFNAME=lo) instead of
discovering one.

Every rank's process group gets a timeout, and the caller kills all ranks
when any overruns timeout_s, so a collective that hangs cannot outlive the
call.  fn must be importable by the spawned ranks (a module-level function
of this package: parallel.entry holds the ones the tests and chip_smoke.py
run), so a rank never imports a test module.

The same code runs under torchrun: there the caller initializes the
process group itself and calls sedumi() with pars.mesh_shape on each rank.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_numpy(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _rank_main(rank, nprocs, init_method, backend, device, timeout_s, fn,
               args, out):
    try:
        import torch
        import torch.distributed as dist

        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
        if device != "cpu":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=nprocs,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            res = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, _to_numpy(res)))
    except Exception:
        out.put((rank, False, traceback.format_exc()))


def run_spmd(fn, nprocs: int, args=(), device: str = "cuda", backend=None,
             timeout_s: float = 600.0) -> list:
    """fn(rank, *args) on nprocs ranks; the list of their results.

    device 'cuda' puts rank r on card r % device_count (all on cuda:0 on a
    one-card machine) and gives each rank an equal share of the host's
    cores for its host BLAS and torch threads; 'cpu' runs the ranks on the
    CPU with one thread each.  backend None picks gloo on the CPU or when
    there are fewer cards than ranks, NCCL (with gloo for CPU tensors)
    otherwise."""
    threads = 1
    if device != "cpu":
        import torch

        threads = max(1, (os.cpu_count() or 1) // nprocs)
        if backend is None and torch.cuda.device_count() >= nprocs:
            backend = "cpu:gloo,cuda:nccl"
    backend = backend or "gloo"
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, init_method, backend, device,
                               timeout_s, fn, tuple(args), out))
             for r in range(nprocs)]
    # the ranks read their thread counts from the environment they are
    # spawned with (numpy's BLAS fixes its pool when it is imported)
    pool = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in pool}
    results: dict = {}
    try:
        os.environ.update({k: str(threads) for k in pool})
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.time() + timeout_s
        while len(results) < nprocs:
            left = deadline - time.time()
            if left <= 0:
                late = sorted(set(range(nprocs)) - set(results))
                raise TimeoutError(f"run_spmd: ranks {late} did not finish "
                                   f"in {timeout_s:.0f} s")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"run_spmd: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"run_spmd: rank {rank} failed:\n{val}")
            results[rank] = val
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
    return [results[r] for r in range(nprocs)]
