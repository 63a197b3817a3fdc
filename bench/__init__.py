"""Benchmark harness of the PyTorch/CUDA port (``repro_torch``): one cell of
``BENCHMARK.json`` a run, driven by the data files under this folder."""
