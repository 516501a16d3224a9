"""Per-layer metric readers, one module per metric of BENCHMARK.json's
per_layer list, each read(record) -> float | None (conebench.record)."""
