"""Instance generators, one module per kind, named by a configuration's
"generator" key.  Each defines load(config) -> base data and
make(base, rng) -> conebench.instance.Instance."""
