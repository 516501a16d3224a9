"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units and limits, and a file for every name the harness looks up."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from conebench import spec

BENCH = spec.benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)|"
                   r"(_dim|_rank)$|expansion|per_tok")


def test_top_level_and_size():
    assert set(BENCH) == TOP
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x cells runs of run_seconds +
    # 60 s, 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_command_and_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (spec.ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    entries = BENCH[group]
    names = [e["name"] for e in entries]
    assert 1 <= len(entries) and len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer"):
            if k in e:
                assert LINE.match(e[k])
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_configs():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files) and len(files) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = spec.load_json(spec.ROOT / c["file"])
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)


def test_workloads():
    pairs = set()
    n4 = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        n4 += w["chips"] == 4
        cell = spec.cell(w["name"], BENCH)
        assert cell["traffic"]["name"] == w["traffic"]
        for k, v in cell["checks"].items():
            assert v["limit"] >= 0, k
        assert any(m["name"] == "solve_s" for m in cell["end_to_end"])
        assert cell["per_layer"]
    assert len(BENCH["workloads"]) <= 24
    assert n4 <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        importlib.import_module(f"conebench.metrics.{m['name']}")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_file_names_under_paths():
    for p in BENCH["paths"]:
        for f in (spec.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(spec.ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel


def test_result_line_is_json():
    json.dumps(BENCH)
