"""Share of the traced solves' window in which no kernel, copy or set ran
on the card (torch.profiler's CUPTI trace)."""


def read(record: dict) -> float | None:
    tr = record["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
