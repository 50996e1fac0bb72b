"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`run.py` runs one cell of `BENCHMARK.json` once.  Everything that belongs to
one configuration, traffic mix, metric, program reference or kind of
configuration is a file of its own, found by name (see README.md).
"""
