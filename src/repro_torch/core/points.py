"""Evaluation-point sets used in the paper's experiments (§V-A).

* ``X_equal``   — equidistant small reals ``{ε n / N}``: the simple choice;
  real Vandermonde, condition number exponential in m.
* ``X_complex`` — equal-magnitude complex ``{ε e^{i2πn/N}}``: condition number
  only polynomial in m [22], at 4× per-worker real-multiply cost.
"""
from __future__ import annotations

import numpy as np

__all__ = ["x_equal", "x_complex"]


def x_equal(N: int, eps: float) -> np.ndarray:
    n = np.arange(1, N + 1, dtype=np.float64)
    return eps * n / N


def x_complex(N: int, eps: float) -> np.ndarray:
    n = np.arange(1, N + 1, dtype=np.float64)
    return eps * np.exp(2j * np.pi * n / N)
