"""Decode-side linear algebra: extraction weights (paper §II-C, §III, §IV).

Every decoder in the paper is *linear in the worker products*:  the master
fits the product polynomial's coefficients ``c`` from evaluations ``d``
(``V c ≈ d``) and then applies a linear functional ``a @ c`` (coefficient
extraction for MatDot-family codes; quadrature / anchor-point sums for
point-based codes).  Therefore

    estimate = a @ c = a @ pinv(V) @ d = w @ d,   w = pinv(V)^T a.

We exploit this for the TPU runtime: ``w`` is a tiny host-side solve and the
big decode is a single weighted reduction over worker products (see
``repro.runtime.coded``).  This module computes ``w`` in float64/complex128.
"""
from __future__ import annotations

import numpy as np

__all__ = ["extraction_weights", "extraction_weights_batch",
           "fit_coefficients", "condition_number"]


def extraction_weights(V: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Weights ``w`` with ``w @ d == a @ c_fit`` for the LS fit ``V c ≈ d``.

    * square ``V`` (m == p): ``w = solve(V^T, a)``.
    * overdetermined ``V`` (m > p, more evals than coefficients): the LS fit
      is ``c = V^+ d`` so ``w = (V^+)^T a = (V^T)^+ a`` — the *min-norm*
      solution of ``V^T w = a`` via lstsq.
    """
    V = np.asarray(V)
    a = np.asarray(a, dtype=V.dtype)
    m, p = V.shape
    if m < p:
        raise ValueError(f"underdetermined fit: {m} evals for {p} coefficients")
    if m == p:
        return np.linalg.solve(V.T, a)
    w, *_ = np.linalg.lstsq(V.T, a, rcond=None)
    return w


def extraction_weights_batch(V: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Stacked :func:`extraction_weights` over a batch of fits.

    ``V: (..., m, p)`` is a stack of (generalized) Vandermonde matrices —
    one per Monte-Carlo trace — and ``a`` is either a shared functional
    ``(p,)`` or a per-trace stack ``(..., p)``.  Returns ``w: (..., m)``
    with ``w[t] @ d[t] == a @ c_fit[t]`` for every trace ``t``, using one
    LAPACK-batched solve instead of a Python loop.  Per-trace results are
    identical to the scalar path (the same factorization runs per matrix).
    """
    V = np.asarray(V)
    *batch, m, p = V.shape
    a = np.asarray(a, dtype=V.dtype)
    if m < p:
        raise ValueError(f"underdetermined fit: {m} evals for {p} coefficients")
    Vt = np.swapaxes(V, -1, -2)                    # (..., p, m)
    if m == p:
        rhs = np.broadcast_to(a[..., :, None], tuple(batch) + (p, 1))
        return np.linalg.solve(Vt, rhs)[..., 0]
    # overdetermined: min-norm solution of V^T w = a via batched pinv
    return np.einsum("...mp,...p->...m", np.linalg.pinv(Vt), a)


def fit_coefficients(V: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Reference (gather-style) decode: fit ``c`` with ``V c ≈ d``.

    ``d`` may be matrix-valued: shape ``(m, ...)`` — flattened internally.
    Kept for tests / the paper-faithful master-decode path; the runtime path
    uses :func:`extraction_weights` instead.
    """
    V = np.asarray(V)
    d = np.asarray(d)
    m, p = V.shape
    flat = d.reshape(m, -1)
    if m == p:
        c = np.linalg.solve(V, flat)
    else:
        c, *_ = np.linalg.lstsq(V, flat, rcond=None)
    return c.reshape((p,) + d.shape[1:])


def condition_number(V: np.ndarray) -> float:
    """2-norm condition number — used by the numerics benchmarks (Fig. 2)."""
    return float(np.linalg.cond(np.asarray(V)))
