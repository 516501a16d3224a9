"""Each per-layer reader on a recorded `info`, the roofline arithmetic and
the trace's reduction on a made-up trace."""

from __future__ import annotations

import importlib

import pytest

from conebench import devtrace, spec
from conebench.record import roofline_pct

H100 = spec.load_json(spec.BENCH / "peaks.json")["cards"]["H100"]

# two solves' info as sedumi() returns them (trimmed to what is read);
# the second took the best-iterate fallback: its phases count 23
# iterations for info["iter"] 22
INFOS = [
    {"iter": 20, "timing": [0.5, 3.0, 1.5],
     "phases": {"f64": {"iters": 15, "wall_s": 1.5},
                "dd64": {"iters": 5, "wall_s": 1.0}}},
    {"iter": 22, "timing": [0.3, 3.2, 1.0],
     "phases": {"f32": {"iters": 10, "wall_s": 0.5},
                "host64": {"iters": 8, "wall_s": 1.2},
                "dd64": {"iters": 5, "wall_s": 1.0}}},
]


def _record(**kw):
    rec = {"solves": INFOS, "profile": None, "trace": None, "peaks": H100}
    rec.update(kw)
    return rec


def _read(name, rec):
    return importlib.import_module(f"conebench.metrics.{name}").read(rec)


def test_every_per_layer_metric_has_a_reader():
    for m in spec.benchmark()["per_layer"]:
        assert callable(importlib.import_module(
            f"conebench.metrics.{m['name']}").read)


def test_solve_readers():
    rec = _record()
    # 0.5 + 3.0 - 2.5 ; 0.3 + 3.2 - (2.7 - 1.0 / 5)
    assert _read("front_s", rec) == pytest.approx((1.0 + 1.0) / 2)
    assert _read("post_s", rec) == pytest.approx(1.25)
    assert _read("iter_ms", rec) == pytest.approx(1e3 * 5.2 / 43)
    assert _read("iters", rec) == pytest.approx(21.0)
    empty = _record(solves=[])
    for name in ("front_s", "post_s", "iter_ms", "iters"):
        assert _read(name, empty) is None


def test_roofline_readers():
    prof = {"ms": {"nt_scaling_ms": 20.0, "chol_ms": 1.0},
            "dtype": "float64",
            "shapes": {"m": 800, "l": 0, "q": [], "s": [800]}}
    rec = _record(profile=prof)
    flops = (9 + 1 / 3 + 2) * 800.0 ** 3
    assert _read("nt_scaling_roofline", rec) == pytest.approx(
        100 * flops / 67e12 / 20e-3)
    # the factor of 800 is bound by its flops, in both dtypes
    assert _read("schur_factor_roofline", rec) == pytest.approx(
        100 * 800.0 ** 3 / 3 / 67e12 / 1e-3)
    f32 = _record(profile={**prof, "dtype": "float32"})
    assert _read("schur_factor_roofline", f32) == pytest.approx(
        _read("schur_factor_roofline", rec))
    # a small factor is bound by its bytes, which f32 halves
    small = {**prof, "shapes": {**prof["shapes"], "m": 100}}
    assert _read("schur_factor_roofline", _record(profile=small)) == \
        pytest.approx(100 * 100 * 101 * 8 / 3.35e12 / 1e-3)
    assert _read("schur_factor_roofline", _record(profile={
        **small, "dtype": "float32"})) == pytest.approx(
            100 * 100 * 101 * 4 / 3.35e12 / 1e-3)
    assert _read("nt_scaling_roofline", _record()) is None
    assert _read("schur_factor_roofline", _record(profile={
        **prof, "ms": {"nt_scaling_ms": 1.0, "prepare_ms": 2.0}})) is None
    assert _read("nt_scaling_roofline", _record(profile=prof,
                                                peaks=None)) is None
    assert roofline_pct(1.0, 1.0, 0.0, "float64", H100) is None


def test_idle_reader():
    rec = _record(trace={"busy_s": 1.0, "window_s": 4.0})
    assert _read("idle_pct", rec) == pytest.approx(75.0)
    assert _read("idle_pct", _record()) is None


def test_trace_reduction():
    ev = [("range", "window", 0, 1000, 1),
          ("range", "solve", 0, 1000, 1),
          ("op", "aten::mm", 100, 300, 1),
          ("op", "aten::_local_scalar_dense", 600, 900, 1),
          ("op", "aten::copy_", 650, 700, 1),
          ("op", "aten::other_thread", 0, 1000, 2),
          ("device", "gemm", 150, 250, 0),
          ("device", "gemm", 200, 400, 0),
          ("device", "potrf", 700, 800, 0),
          ("device", "late", 950, 1200, 0)]
    out = devtrace.summarize(ev, "window")
    assert out["window_s"] == pytest.approx(1000e-9)
    # busy: [150, 400) + [700, 800) + [950, 1000)
    assert out["busy_s"] == pytest.approx(400e-9)
    assert out["device_ops"][0] == ["gemm", pytest.approx(300e-9)]
    gaps = dict((k, v) for k, v in out["idle_gaps"])
    # [0, 150) mid 75: solve only; [400, 700) mid 550: solve;
    # [800, 950) mid 875: inside _local_scalar_dense
    assert gaps["solve > no torch op"] == pytest.approx((150 + 300) * 1e-9)
    assert gaps["solve > aten::_local_scalar_dense"] == pytest.approx(
        150e-9)
    with pytest.raises(ValueError):
        devtrace.summarize(ev, "missing")


def test_innermost_of_nested_events():
    import numpy as np

    ev = [("op", "outer", 0, 100, 1), ("op", "a", 10, 20, 1),
          ("op", "a.child", 12, 15, 1), ("op", "b", 30, 90, 1),
          ("op", "late", 95, 99, 1)]
    t = np.array([13, 16, 25, 50, 97, 120, 5])
    assert devtrace._innermost(ev, t) == ["a.child", "a", "outer", "b",
                                          "late", "", "outer"]
