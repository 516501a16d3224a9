"""Milliseconds an IPM iteration, over all the window's solves: the
phases' summed walls over their summed iterations (the same records, so
an iteration the phases count twice cancels)."""

from conebench.record import phase_totals


def read(record: dict) -> float | None:
    iters = wall = 0.0
    for info in record["solves"]:
        i, w = phase_totals(info)
        iters += i
        wall += w
    return 1e3 * wall / iters if iters else None
