"""Hand-written CUDA kernels for the coded-matmul main path.

Each kernel ships ``ops.py`` (the wrapper: the kernel on a CUDA tensor,
the plain version on a CPU tensor, a launch count) and ``ref.py`` (the
plain PyTorch version); the CUDA sources live in ``repro_torch/csrc`` and
are built by :mod:`._build`.
"""
from .coded_matmul.ops import (coded_matmul, worker_products,
                               worker_products_complex)
from .poly_encode.ops import poly_encode

__all__ = ["coded_matmul", "worker_products", "worker_products_complex",
           "poly_encode"]
