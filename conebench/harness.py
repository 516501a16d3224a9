"""Run one cell once: set-up, the measured window, the traced solves
(with --trace 1), then the reference's judgement.

The window is a closed loop with one client: it solves the pool's
instances in turn with sedumi_tpu_torch.sedumi(At, b, c, K, pars), each
as soon as the last returns; no solve starts once `seconds` have passed,
and the window ends when the solve then running returns.  solve_s is the
window's wall over the solves that returned a right answer.
"""

from __future__ import annotations

import importlib
import sys
import time

from conebench import devtrace
from conebench.certify import judge_all, within
from conebench.instance import make_pool

FORBIDDEN = ("jax", "jaxlib", "flax", "sedumi_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (sedumi_tpu_torch is another name)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def _solve(inst, pars: dict, device: str) -> dict:
    """One call of the program; {"x", "y", "info"} or {"error"}."""
    import sedumi_tpu_torch

    try:
        x, y, info = sedumi_tpu_torch.sedumi(inst.At, inst.b, inst.c,
                                             inst.K, dict(pars),
                                             device=device)
    except Exception as exc:   # a solve that raises gives no answer
        return {"inst": inst, "error": f"{type(exc).__name__}: {exc}"}
    return {"inst": inst, "x": x, "y": y, "info": info}


def _card(device: str) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def _peaks(kind: str) -> dict | None:
    from conebench.spec import BENCH, load_json

    for card, row in load_json(BENCH / "peaks.json")["cards"].items():
        if card in kind:
            return row
    return None


def _traced(insts, pars: dict, device: str,
            seconds: float) -> tuple[list, dict]:
    """Solve `insts` in turn under torch.profiler (CUPTI on the card), in
    one range named "window", starting none after `seconds` (at least
    one); the solves, and devtrace.summarize's reduction."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    solves = []
    with profile(activities=acts) as prof:
        with record_function("window"):
            t0 = time.perf_counter()
            for inst in insts:
                if solves and time.perf_counter() - t0 >= seconds:
                    break
                with record_function("solve"):
                    solves.append(_solve(inst, pars, device))
            _sync(device)
    return solves, devtrace.summarize(devtrace.from_kineto(prof),
                                      "window")


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             setup_parts: dict | None = None, log=None,
             note=None) -> dict:
    """One run of `cell` (spec.cell's dict).  Returns the result line's
    object; `log` takes lines for standard error, and `note()` gives one
    more, logged after the window, before the checks."""
    log = log or (lambda line: print(line, file=sys.stderr))
    t_start = time.perf_counter() if t_start is None else t_start
    parts = dict(setup_parts or {})
    traffic, config = cell["traffic"], cell["config"]
    pars = dict(traffic["pars"])

    t0 = time.perf_counter()
    pool, warm_inst = make_pool(config, seed, traffic["pool"])
    parts["pool_s"] = time.perf_counter() - t0
    # with --trace 1 the warm-up solve also carries pars.profile, whose
    # timings the roofline readers take (such a run reports no setup_s)
    t0 = time.perf_counter()
    warm = _solve(warm_inst, {**pars, "profile": 1} if trace else pars,
                  device)
    _sync(device)
    parts["warm_solve_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    if "error" in warm:
        log(f"warm-up solve failed: {warm['error']}")
    log("setup parts (s): " + " ".join(f"{k} {v:.4f}"
                                       for k, v in parts.items()))

    from sedumi_tpu_torch import kernels

    kernels.reset_launch_counts()
    window, ends = [], []
    t_w0 = time.perf_counter()
    while time.perf_counter() - t_w0 < seconds:
        window.append(_solve(pool[len(window) % len(pool)], pars, device))
        ends.append(time.perf_counter() - t_w0)
    _sync(device)
    wall = time.perf_counter() - t_w0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    log(f"kernel launches in the window: {launches}")
    log("solves in the window (s, iterations): " + " ".join(
        f"{b - a:.3f}/{s.get('info', {}).get('iter', '-')}"
        for a, b, s in zip([0.0] + ends, ends, window)))

    later, record_trace, profile = [], None, None
    if trace:
        insts = pool[len(window):] + pool[:len(window)]
        later, record_trace = _traced(insts, pars, device,
                                      traffic["trace_seconds"])
        if "info" in warm and "profile" in warm["info"]:
            phases = warm["info"].get("phases", {})
            profile = {"ms": warm["info"]["profile"],
                       "dtype": "float32" if "f32" in phases else "float64",
                       "shapes": warm_inst.shapes}
    card = _card(device)
    if note is not None:
        log(note())

    checks = cell["checks"]
    worst, readings = judge_all(window + later, checks)
    ok = [within(r, checks) for r in readings]
    n_window = len(window)
    failed = sum(1 for k in range(n_window) if not ok[k])
    right = [s for s, good in zip(window, ok) if good]
    correct = bool(readings) and all(ok)

    record = {"solves": [s["info"] for s in right], "profile": profile,
              "trace": record_trace, "peaks": _peaks(card["kind"])}
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            mod = importlib.import_module(f"conebench.metrics.{m['name']}")
            val = mod.read(record)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        wanted = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        if "solve_s" in wanted:
            metrics["solve_s"] = {"value": wall / max(len(right), 1),
                                  "unit": wanted["solve_s"]}
        metrics["setup_s"] = {"value": setup_s, "unit": wanted["setup_s"]}
    if record_trace is not None:
        card["busy_s"] = record_trace["busy_s"]
        card["window_s"] = record_trace["window_s"]

    for k, s in enumerate(window + later):
        if "error" in s:
            log(f"solve {k} raised: {s['error']}")
    log(f"window: {n_window} solves in {wall:.4f} s, {failed} failed; "
        f"{len(later)} solves after it")
    result = {"correct": correct, "attempted": n_window, "failed": failed,
              "metrics": metrics, "device": card}
    if record_trace is not None:
        result["breakdown"] = {"device_ops": record_trace["device_ops"],
                               "idle_gaps": record_trace["idle_gaps"]}
    result["checks"] = {k: {"value": worst[k], "limit": checks[k]["limit"]}
                        for k in checks}
    for k in checks:
        log(f"check {k} {worst[k]!r} limit {checks[k]['limit']!r} "
            f"{'ok' if worst[k] <= checks[k]['limit'] else 'FAILED'}")
    return result
