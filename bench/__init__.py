"""The benchmark of the PyTorch and CUDA port (``repro_torch``): cells,
traffic, metric readers and the plain reference, driven by
``BENCHMARK.json``.  Run one cell once with ``python3 -m bench.run``."""
