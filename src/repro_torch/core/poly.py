"""Polynomial bases used by the CDC schemes (paper §II-C, §IV).

Three bases appear in the paper:

* **monomial** ``1, x, x^2, ...`` — MatDot / ε-approx MatDot / group-wise SAC.
* **Chebyshev orthonormal** ``O_0 = T_0/sqrt(2), O_k = T_k`` w.r.t. the weight
  ``w(x) = 2/(pi sqrt(1-x^2))`` on (-1, 1) — OrthoMatDot codes [13].
* **Lagrange** ``L_k(x) = prod_{j!=k} (x-y_j)/(y_k-y_j)`` — Lagrange codes [11].

All basis math is host-side numpy in float64/complex128: these are tiny
``(N, K)`` matrices, and doing them in f64 keeps the *decode* numerics at
paper fidelity even when worker products run in f32/bf16 on the TPU path.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "monomial_eval", "chebyshev_T", "chebyshev_eval", "orthonormal_eval",
    "chebyshev_roots", "lagrange_eval", "Basis", "MonomialBasis",
    "ChebyshevBasis", "LagrangeBasis",
]


# ---------------------------------------------------------------------------
# raw evaluation helpers
# ---------------------------------------------------------------------------

def monomial_eval(x: np.ndarray, degrees) -> np.ndarray:
    """``V[..., i, j] = x[..., i] ** degrees[j]`` (batched over leading dims)."""
    x = np.asarray(x)
    degrees = np.asarray(degrees)
    return x[..., :, None] ** degrees


def chebyshev_T(x: np.ndarray, max_degree: int) -> np.ndarray:
    """First-kind Chebyshev ``T_0..T_max`` via the paper's recursion.

    ``T[i, j] = T_j(x_i)``; stable for |x| <= 1 (and valid polynomially for
    any x, though it grows fast outside [-1, 1]).
    """
    x = np.asarray(x)
    out = np.empty(x.shape + (max_degree + 1,), dtype=np.result_type(x, np.float64))
    out[..., 0] = 1.0
    if max_degree >= 1:
        out[..., 1] = x
    for k in range(1, max_degree):
        out[..., k + 1] = 2 * x * out[..., k] - out[..., k - 1]
    return out


def chebyshev_eval(x: np.ndarray, degrees) -> np.ndarray:
    """``V[i, j] = T_{degrees[j]}(x_i)``."""
    degrees = np.asarray(degrees)
    T = chebyshev_T(np.asarray(x), int(degrees.max()) if degrees.size else 0)
    return T[..., degrees]


def orthonormal_eval(x: np.ndarray, degrees) -> np.ndarray:
    """Orthonormal Chebyshev ``O_j``: ``O_0 = T_0/sqrt(2)``, ``O_j = T_j``.

    Orthonormal w.r.t. ``w(x) = 2/(pi sqrt(1 - x^2))`` — paper §II-C.
    """
    V = chebyshev_eval(x, degrees)
    degrees = np.asarray(degrees)
    scale = np.where(degrees == 0, 1.0 / np.sqrt(2.0), 1.0)
    return V * scale[None, :]


def chebyshev_roots(n: int) -> np.ndarray:
    """The n (distinct, real) roots of ``T_n`` — the η^{(n)} of the paper.

    ``η_k = cos((2k-1)π / (2n))``, k = 1..n, returned in increasing order.
    """
    k = np.arange(1, n + 1, dtype=np.float64)
    return np.sort(np.cos((2 * k - 1) * np.pi / (2 * n)))


def lagrange_eval(x: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """``V[i, k] = L_k(x_i)`` for the Lagrange basis anchored at ``anchors``.

    Numerically evaluated with the standard product formula; anchors are the
    paper's interpolation points ``y_1..y_K``.
    """
    x = np.asarray(x)
    y = np.asarray(anchors, dtype=np.float64)
    K = y.shape[0]
    V = np.ones(x.shape + (K,), dtype=np.result_type(x, np.float64))
    for k in range(K):
        for j in range(K):
            if j == k:
                continue
            V[..., k] *= (x - y[j]) / (y[k] - y[j])
    return V


# ---------------------------------------------------------------------------
# Basis objects — unify decode-side fitting across schemes
# ---------------------------------------------------------------------------

class Basis:
    """A polynomial basis the decoder can fit the product polynomial in.

    ``eval_matrix(x, p)`` returns the generalized Vandermonde ``V[i, j] =
    phi_j(x_i)`` for the first ``p`` basis functions; ``phi_j`` must have
    degree exactly ``j`` so a degree-(p-1) fit is well posed from ``p``
    distinct points.
    """

    name = "abstract"

    def eval_matrix(self, x: np.ndarray, p: int) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def cache_key(self) -> tuple:
        """Hashable identity — lets the batched engine group equivalent codes."""
        return (self.name,)


class MonomialBasis(Basis):
    """Monomial basis with optional column scaling.

    With evaluation points of magnitude ~ε (the SAC regime) the raw
    Vandermonde has columns decaying like ε^j and conditioning blows up.
    ``scale`` rescales x by ``s`` so columns are O(1): the fit then returns
    coefficients of ``(x/s)^j``, i.e. ``c_j * s^j`` — callers who extract
    coefficient ``j`` must divide by ``s^j`` (handled by the codes via
    :meth:`coeff_functional`).  ``scale=None`` reproduces the paper's raw
    solve (used by the ill-conditioning benchmarks).
    """

    name = "monomial"

    def __init__(self, scale: float | None = None):
        self.scale = scale

    def cache_key(self) -> tuple:
        return (self.name, self.scale)

    def eval_matrix(self, x: np.ndarray, p: int) -> np.ndarray:
        x = np.asarray(x)
        s = self.scale if self.scale else 1.0
        return monomial_eval(x / s, np.arange(p))

    def coeff_functional(self, degree: int, p: int) -> np.ndarray:
        """Vector ``a`` with ``a @ c_fit = coefficient of x^degree``."""
        s = self.scale if self.scale else 1.0
        a = np.zeros(p, dtype=np.float64)
        a[degree] = s ** (-degree)
        return a

    def point_functional(self, y_points: np.ndarray, weights: np.ndarray,
                         p: int) -> np.ndarray:
        """Vector ``a`` with ``a @ c_fit = sum_k weights_k * P(y_k)``."""
        s = self.scale if self.scale else 1.0
        Vy = monomial_eval(np.asarray(y_points) / s, np.arange(p))
        return np.asarray(weights) @ Vy


class ChebyshevBasis(Basis):
    """Plain first-kind Chebyshev decode basis (well conditioned on [-1,1])."""

    name = "chebyshev"

    def eval_matrix(self, x: np.ndarray, p: int) -> np.ndarray:
        return chebyshev_eval(x, np.arange(p))

    def point_functional(self, y_points: np.ndarray, weights: np.ndarray,
                         p: int) -> np.ndarray:
        Vy = chebyshev_eval(np.asarray(y_points), np.arange(p))
        return np.asarray(weights) @ Vy


class MappedChebyshevBasis(Basis):
    """Chebyshev basis affine-mapped to an interval [lo, hi].

    ``phi_j(x) = T_j((2x - lo - hi)/(hi - lo))`` — graded and well conditioned
    for decode fits whose evaluation points live on [lo, hi] (e.g. Lagrange
    codes anchored at 1..K).  Beyond-paper numerics improvement: the paper
    solves a raw real Vandermonde here (ill-conditioned, §II-C).
    """

    name = "mapped_chebyshev"

    def __init__(self, lo: float, hi: float):
        if hi <= lo:
            raise ValueError("need hi > lo")
        self.lo, self.hi = float(lo), float(hi)

    def cache_key(self) -> tuple:
        return (self.name, self.lo, self.hi)

    def _map(self, x):
        return (2.0 * np.asarray(x) - self.lo - self.hi) / (self.hi - self.lo)

    def eval_matrix(self, x: np.ndarray, p: int) -> np.ndarray:
        return chebyshev_eval(self._map(x), np.arange(p))

    def point_functional(self, y_points: np.ndarray, weights: np.ndarray,
                         p: int) -> np.ndarray:
        Vy = chebyshev_eval(self._map(y_points), np.arange(p))
        return np.asarray(weights) @ Vy


class LagrangeBasis(Basis):
    """Lagrange basis for *encoding*; decoding uses monomial/Chebyshev fits.

    Kept as a Basis for completeness (eval_matrix over the anchor set), but
    note L_k all have degree K-1, so it is *not* a graded basis and cannot be
    used for partial-degree fits.
    """

    name = "lagrange"

    def __init__(self, anchors: np.ndarray):
        self.anchors = np.asarray(anchors, dtype=np.float64)

    def cache_key(self) -> tuple:
        return (self.name, self.anchors.tobytes())

    def eval_matrix(self, x: np.ndarray, p: int) -> np.ndarray:
        if p != len(self.anchors):
            raise ValueError("Lagrange basis is not graded; p must equal K")
        return lagrange_eval(x, self.anchors)
