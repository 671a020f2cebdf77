"""The serving benchmark of `repro_torch` (see BENCHMARK.json at the root
of the repository).  `run.py` runs one cell once."""
