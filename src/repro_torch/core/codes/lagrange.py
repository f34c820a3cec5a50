"""Lagrange coded computing [11] applied to matrix multiplication (§II-C).

Encoding in the Lagrange basis anchored at ``y_1..y_K`` (``L̃_A(y_k) = A_k``);
decode fits the degree-(2K-2) product polynomial from any 2K-1 evaluations
(real Vandermonde in the paper; we default to a column-scaled monomial fit)
and post-decodes via ``AB = Σ_k P(y_k)`` (α_k = 1).  No resolution layers.
"""
from __future__ import annotations

import numpy as np

from ..poly import MappedChebyshevBasis, MonomialBasis, chebyshev_roots, lagrange_eval
from ..solve import extraction_weights
from .base import CDCCode, DecodeInfo

__all__ = ["LagrangeCode", "default_lagrange_points"]


def default_lagrange_points(N: int, anchors: np.ndarray) -> np.ndarray:
    """Chebyshev-distributed points over the anchor span (well conditioned,
    distinct from the anchors with overwhelming probability)."""
    lo = float(np.min(anchors)) - 0.5
    hi = float(np.max(anchors)) + 0.5
    return (lo + hi) / 2 + (hi - lo) / 2 * chebyshev_roots(N)


class LagrangeCode(CDCCode):
    name = "lagrange"

    def __init__(self, K: int, N: int, eval_points: np.ndarray | None = None,
                 anchors: np.ndarray | None = None, *,
                 column_scaling: bool = True):
        self.anchors = (np.arange(1, K + 1, dtype=np.float64)
                        if anchors is None else np.asarray(anchors, np.float64))
        if eval_points is None:
            eval_points = default_lagrange_points(N, self.anchors)
        super().__init__(K, N, eval_points)
        if N < 2 * K - 1:
            raise ValueError(f"Lagrange needs N >= 2K-1 = {2*K-1}")
        if column_scaling:
            # beyond-paper: decode in a Chebyshev basis mapped to the point
            # span instead of the paper's raw real Vandermonde (§II-C notes
            # Lagrange's Vandermonde interpolation "can again lead to an
            # ill-conditioned problem" — this fixes it).
            span = np.concatenate([np.real(eval_points), self.anchors])
            self.decode_basis = MappedChebyshevBasis(float(span.min()),
                                                     float(span.max()))
        else:
            self.decode_basis = MonomialBasis(scale=None)   # paper-faithful
        self.alphas = np.ones(K)

    def generator(self):
        V = lagrange_eval(self.eval_points, self.anchors)
        return V, V.copy()

    @property
    def recovery_threshold(self) -> int:
        return 2 * self.K - 1

    def estimate_weights(self, completed: np.ndarray, m: int):
        R = self.recovery_threshold
        if m < R:
            return None
        xs = self.eval_points[completed][:R]
        V = self.decode_basis.eval_matrix(xs, R)
        a = self.decode_basis.point_functional(self.anchors, self.alphas, R)
        w = extraction_weights(V, a)
        return w, DecodeInfo(exact=True, m_pairs=self.K)

    def estimate_weights_batch(self, orders: np.ndarray, m: int):
        if m < self.recovery_threshold:
            return None
        return self._point_decode_batch(orders)

    def _extra_key(self) -> tuple:
        return (self.anchors.tobytes(),) + self.decode_basis.cache_key()

    def anchor_products(self, A_blocks, B_blocks) -> np.ndarray:
        """``L̃_A(y_k) L̃_B(y_k) = A_k B_k`` — (K, Nx, Ny)."""
        return np.einsum("kij,kjl->kil", np.asarray(A_blocks),
                         np.asarray(B_blocks))
