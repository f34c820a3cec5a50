"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an
H100: ``run.py`` runs one cell of ``BENCHMARK.json`` once."""
