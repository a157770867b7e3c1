"""The benchmark of vtoonify_tpu_torch on NVIDIA H100 cards (BENCHMARK.json).

`run.py` runs one cell once; `control.py` takes the readings its output
limits are set from. Configurations, traffic mixes, limits, model families,
traffic drivers and per-layer metric readers are files found by name
(`manifest.py`)."""
