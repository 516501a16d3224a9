"""conebench: the benchmark of sedumi_tpu_torch on one NVIDIA H100.

`python3 conebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name in
BENCHMARK.json: configs/<config>.json (with generators/<kind>.py),
traffic/<traffic>.json, checks/<cell>.json and metrics/<metric>.py.
Nothing here imports jax or the JAX package; reference/ imports nothing
of the program either.
"""
