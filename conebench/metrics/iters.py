"""IPM iterations a solve, info["iter"], mean per solve."""


def read(record: dict) -> float | None:
    vals = [info["iter"] for info in record["solves"]]
    return sum(vals) / len(vals) if vals else None
