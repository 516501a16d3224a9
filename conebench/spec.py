"""Find a cell's files by the names in BENCHMARK.json.

A cell (an entry of "workloads") names a configuration, whose "file" is a
JSON object of sizes under configs/, and a traffic mix, traffic/<name>.json.
Its limits are checks/<cell>.json.  The per-layer metrics that apply to it
are those with no "workloads" key, or whose key lists it; each is read by
metrics/<name>.py.
"""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """{"workload", "config", "traffic", "checks", "per_layer",
    "end_to_end"} of the cell `name`."""
    bench = bench if bench is not None else benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    wl = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    config = load_json(ROOT / cfg_entry["file"])
    if config["name"] != wl["config"]:
        raise ValueError(f"{cfg_entry['file']} names {config['name']!r}")

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {
        "workload": wl,
        "config": config,
        "traffic": load_json(BENCH / "traffic" / f"{wl['traffic']}.json"),
        "checks": load_json(BENCH / "checks" / f"{name}.json"),
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
    }
