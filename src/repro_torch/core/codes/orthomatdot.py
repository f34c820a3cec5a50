"""OrthoMatDot codes [13] (paper §II-C).

Encoding in the orthonormal Chebyshev basis ``O_0 = T_0/√2, O_k = T_k``
(orthonormal for ``w(x) = 2/(π√(1-x²))`` on (-1,1)); workers evaluate at the
roots of ``T_N``, giving a well-conditioned Chebyshev-Vandermonde decode.
Point-based post-decoding: with ``η^{(K)}`` the roots of ``T_K``,

    AB = Σ_k (2/K) · P(η_k^{(K)}),     P = Õ_A · Õ_B  (degree 2K-2),

by Gauss-Chebyshev quadrature (exact for degree ≤ 2K-1) + orthonormality.
No resolution layers (Table I) — layer-wise SAC adds them (layer_sac.py).
"""
from __future__ import annotations

import numpy as np

from ..poly import ChebyshevBasis, chebyshev_roots, orthonormal_eval
from ..solve import extraction_weights
from .base import CDCCode, DecodeInfo

__all__ = ["OrthoMatDotCode"]


class OrthoMatDotCode(CDCCode):
    name = "orthomatdot"

    def __init__(self, K: int, N: int, eval_points: np.ndarray | None = None):
        if eval_points is None:
            eval_points = chebyshev_roots(N)   # the paper's choice x_n = η_n^{(N)}
        super().__init__(K, N, eval_points)
        if N < 2 * K - 1:
            raise ValueError(f"OrthoMatDot needs N >= 2K-1 = {2*K-1}")
        self.decode_basis = ChebyshevBasis()
        self.anchors = chebyshev_roots(K)      # η^{(K)} quadrature nodes
        self.alphas = np.full(K, 2.0 / K)

    def generator(self):
        V = orthonormal_eval(self.eval_points, np.arange(self.K))
        return V, V.copy()

    @property
    def recovery_threshold(self) -> int:
        return 2 * self.K - 1

    def estimate_weights(self, completed: np.ndarray, m: int):
        R = self.recovery_threshold
        if m < R:
            return None
        xs = self.eval_points[completed][:R]
        V = self.decode_basis.eval_matrix(xs, R)      # T_0..T_{2K-2} at xs
        a = self.decode_basis.point_functional(self.anchors, self.alphas, R)
        w = extraction_weights(V, a)
        return w, DecodeInfo(exact=True, m_pairs=self.K)

    def estimate_weights_batch(self, orders: np.ndarray, m: int):
        if m < self.recovery_threshold:
            return None
        return self._point_decode_batch(orders)

    def anchor_products(self, A_blocks, B_blocks) -> np.ndarray:
        """``S̃_A(y_k) S̃_B(y_k)`` at the quadrature anchors — (K, Nx, Ny)."""
        Vy = orthonormal_eval(self.anchors, np.arange(self.K))
        EA = np.einsum("nk,kij->nij", Vy, np.asarray(A_blocks))
        EB = np.einsum("nk,kij->nij", Vy, np.asarray(B_blocks))
        return np.einsum("nij,njl->nil", EA, EB)
