"""What a run hands its per-layer metric readers: a plain dict.

  solves   the `info` of every window solve that returned an answer
  profile  {"ms": info["profile"], "dtype": "float64" | "float32",
           "shapes": Instance.shapes} of the solve run with pars.profile
           after the window, or None
  trace    {"busy_s": ..., "window_s": ...} of the traced solves, or None
  peaks    the card's row of peaks.json, or None off a known card

Each reader, metrics/<name>.py, defines read(record) -> float | None and
returns None where it finds nothing to read.
"""

from __future__ import annotations


def phase_totals(info: dict) -> tuple[int, float]:
    """(iterations, seconds) summed over info["phases"].  The best-iterate
    fallback appends a copy of an earlier iteration's record, so the sums
    may count one iteration twice; info["iter"] does not."""
    phases = info.get("phases") or {}
    return (sum(p["iters"] for p in phases.values()),
            sum(p["wall_s"] for p in phases.values()))


def roofline_pct(flops: float, nbytes: float, ms: float, dtype: str,
                 peaks: dict) -> float | None:
    """The least time the card could take, the larger of flops over the
    dtype's peak and bytes over the bandwidth, as a share of `ms`."""
    if not ms or ms <= 0 or peaks is None or dtype not in peaks["flops"]:
        return None
    least_s = max(flops / peaks["flops"][dtype],
                  nbytes / peaks["bytes_per_s"])
    return 100.0 * least_s / (ms * 1e-3)


ITEMSIZE = {"float64": 8, "float32": 4}
