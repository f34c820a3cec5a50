"""Hand-written CUDA kernels of the port, one per TPU kernel of the
reference.

Each kernel ships ``ops.py`` (the wrapper: the kernel on a CUDA tensor,
the plain version on a CPU tensor, a launch count) and ``ref.py`` (the
plain PyTorch version); the CUDA sources live in ``repro_torch/csrc`` and
are built by :mod:`._build`.  ``coded_matmul`` and ``poly_encode`` carry
the coded-matmul serve; ``flash_attention`` and ``ssm_scan`` the language
model's prefill and, through their backward kernels, its training.
"""
from .coded_matmul.ops import (coded_matmul, worker_products,
                               worker_products_complex)
from .flash_attention.ops import flash_attention
from .poly_encode.ops import poly_encode
from .ssm_scan.ops import ssm_scan

__all__ = ["coded_matmul", "worker_products", "worker_products_complex",
           "poly_encode", "flash_attention", "ssm_scan"]
