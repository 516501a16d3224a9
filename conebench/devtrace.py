"""Reduce a profiler trace to the card's busy time, the device operations
that took most time, and the idle gaps by what the host was doing.

Events are plain tuples (kind, name, start_ns, end_ns, thread), kind one
of "device" (a kernel, copy or set on the card), "op" (a torch operator
on the host) or "range" (a record_function range of the benchmark), so
the reduction runs on any list; `from_kineto` makes that list from a
finished torch.profiler.profile.
"""

from __future__ import annotations

import numpy as np


def _kind(e, ranges) -> str | None:
    """"device", "op", "range" or None (skipped) for a kineto event: the
    card's events but the ranges' own device copies are device work, and
    the host's events are ranges by name and operators otherwise."""
    on_card = "CUDA" in str(e.device_type())
    if e.name().startswith("Activity Buffer"):    # the profiler's own
        return None
    if e.name() in ranges:
        return None if on_card else "range"
    return "device" if on_card else "op"


def from_kineto(prof, ranges=("window", "solve")) -> list[tuple]:
    """The events of a finished torch.profiler.profile, read from its
    kineto results without building FunctionEvents; `ranges` are the
    names of the benchmark's record_function ranges."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, ranges)
        if kind is None:
            continue
        start = int(e.start_ns())
        out.append((kind, e.name(), start, start + int(e.duration_ns()),
                    int(e.start_thread_id())))
    return out


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of [start, end) intervals, sorted by start."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    run_end = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > run_end[:-1]
    starts = iv[new, 0]
    ends = np.maximum.reduceat(iv[:, 1], np.flatnonzero(new))
    return np.stack([starts, ends], 1)


def _innermost(events: list[tuple], t: np.ndarray) -> list[str]:
    """For each time in t, the name of the innermost event (of properly
    nested events, as one thread's are) that contains it, or "": one sweep
    over the events and the sorted times."""
    events = sorted(events, key=lambda e: (e[2], -e[3]))
    order = np.argsort(t, kind="stable")
    out = [""] * len(t)
    stack: list[tuple] = []
    k = 0
    for q in order:
        tq = t[q]
        while k < len(events) and events[k][2] <= tq:
            while stack and stack[-1][3] <= events[k][2]:
                stack.pop()
            stack.append(events[k])
            k += 1
        while stack and stack[-1][3] <= tq:
            stack.pop()
        if stack:
            out[q] = stack[-1][1]
    return out


def summarize(events: list[tuple], window: str, top: int = 10) -> dict:
    """Busy and window seconds, and the breakdown, inside the first range
    named `window`: {"busy_s", "window_s", "device_ops", "idle_gaps"},
    the last two lists of [name, seconds] of at most `top` entries.  Each
    idle gap is labelled by the innermost range and torch op running on
    the window's thread at its midpoint, and gaps are summed by label."""
    win = [e for e in events if e[0] == "range" and e[1] == window]
    if not win:
        raise ValueError(f"the trace has no range named {window!r}")
    _, _, w0, w1, host = win[0]
    dev = [e for e in events if e[0] == "device" and e[3] > w0 and e[2] < w1]
    iv = np.array([[max(e[2], w0), min(e[3], w1)] for e in dev], np.int64)
    busy = _merge(iv.reshape(-1, 2))
    busy_ns = int(np.sum(busy[:, 1] - busy[:, 0])) if len(busy) else 0

    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e[1]] = by_name.get(e[1], 0.0) + (e[3] - e[2]) * 1e-9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    length = gaps[:, 1] - gaps[:, 0]
    mid = (gaps[:, 0] + gaps[:, 1]) // 2
    on_host = [e for e in events if e[4] == host and e[3] > w0 and e[2] < w1]
    rng_names = _innermost([e for e in on_host if e[0] == "range"
                            and e[1] != window], mid)
    op_names = _innermost([e for e in on_host if e[0] == "op"], mid)
    by_label: dict[str, float] = {}
    for gap, r, o in zip(length, rng_names, op_names):
        label = " > ".join((r or "no range", o or "no torch op"))
        by_label[label] = by_label.get(label, 0.0) + gap * 1e-9
    idle_gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_ns * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "device_ops": [[n, s] for n, s in device_ops],
            "idle_gaps": [[n, s] for n, s in idle_gaps]}
