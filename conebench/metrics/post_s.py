"""Seconds of grading, the terminal refinement (refine.conic_refine) and
posttransfo: timing[2], mean per solve."""


def read(record: dict) -> float | None:
    vals = [info["timing"][2] for info in record["solves"]]
    return sum(vals) / len(vals) if vals else None
