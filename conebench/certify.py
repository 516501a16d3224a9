"""How `correct` is decided: each solve's answer read by the reference
(reference/certificate.py) and by what the program said of it, every
number held to the cell's limit in checks/<cell>.json."""

from __future__ import annotations

import numpy as np

from conebench.reference import certificate


def judge(solve: dict) -> dict:
    """The numbers compared for one solve: no_answer (it raised),
    worst_err (the largest DIMACS error of its answer on the benchmark's
    data), numerr and infeasible (pinf + dinf, what the program said)."""
    if "error" in solve:
        return {"no_answer": 1, "worst_err": float("inf"), "numerr": 0,
                "infeasible": 0}
    inst, x, y = solve["inst"], solve["x"], solve["y"]
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        worst = float("inf")
    else:
        worst = certificate.worst(certificate.dimacs(inst.At, inst.b,
                                                     inst.c, inst.K, x, y))
    info = solve["info"]
    return {"no_answer": 0, "worst_err": worst,
            "numerr": int(info["numerr"]),
            "infeasible": int(info["pinf"]) + int(info["dinf"])}


def within(reading: dict, checks: dict) -> bool:
    return all(reading[k] <= checks[k]["limit"] for k in checks)


def judge_all(solves: list, checks: dict) -> tuple[dict, list]:
    """(the worst of each number over the solves, each solve's numbers)."""
    per_solve = [judge(s) for s in solves]
    worst = {k: max(r[k] for r in per_solve) if per_solve else None
             for k in checks}
    return worst, per_solve
