"""Seconds a solve spends outside the IPM loop before grading: pretransfo
and the pre-checks (timing[0]), then solve_internal's route, bundles,
starts and in-loop refinement probes (timing[1] less the iterations'
walls), mean per solve.  The best-iterate fallback makes the phases count
one iteration twice (info["iter"] counts it once); that iteration is
taken at the mean wall of the last phase, where best iterates lie."""

from conebench.record import phase_totals


def read(record: dict) -> float | None:
    vals = []
    for info in record["solves"]:
        iters, wall = phase_totals(info)
        phases = list((info.get("phases") or {}).values())
        if iters > info["iter"] and phases[-1]["iters"]:
            wall -= (iters - info["iter"]) * phases[-1]["wall_s"] \
                / phases[-1]["iters"]
        vals.append(info["timing"][0] + info["timing"][1] - wall)
    return sum(vals) / len(vals) if vals else None
