"""MatDot codes [5] and ε-approximate MatDot codes [20] (paper §II-C).

MatDot: ``Â(x) = Σ_k A_k x^{k-1}``, ``B̂(x) = Σ_k B_k x^{K-k}``; the product
polynomial has degree 2K-2 and its coefficient of ``x^{K-1}`` is ``AB``.
Exact recovery from any ``R = 2K-1`` finishers; no resolution layers.

ε-approximate MatDot adds the single approximate layer of [20]: with only
``m = K`` finishers and sufficiently small evaluation points, the residual
polynomial ``P̂`` (all terms below ``x^K``) is interpolated from the K
evaluations and its leading coefficient ≈ AB.  Per the paper's Fig. 3a the
estimate does **not** improve for K < m < 2K-1 (the scheme keeps using its
single layer) — improving there is exactly what group-wise SAC adds.
"""
from __future__ import annotations

import numpy as np

from ..poly import MonomialBasis, monomial_eval
from ..solve import extraction_weights, extraction_weights_batch
from .base import CDCCode, DecodeInfo

__all__ = ["MatDotCode", "EpsApproxMatDotCode"]


class MatDotCode(CDCCode):
    name = "matdot"

    def __init__(self, K: int, N: int, eval_points: np.ndarray, *,
                 column_scaling: bool = True):
        super().__init__(K, N, eval_points)
        if N < 2 * K - 1:
            raise ValueError(f"MatDot needs N >= 2K-1 = {2*K-1}, got N={N}")
        scale = float(np.max(np.abs(eval_points))) if column_scaling else None
        self.decode_basis = MonomialBasis(scale=scale)

    # A-side degree of block k is k; B-side degree is K-1-k.
    def generator(self):
        x = self.eval_points
        degs = np.arange(self.K)
        G_A = monomial_eval(x, degs)
        G_B = monomial_eval(x, self.K - 1 - degs)
        return G_A, G_B

    @property
    def recovery_threshold(self) -> int:
        return 2 * self.K - 1

    def _coeff_weights(self, xs: np.ndarray, p: int, target_degrees) -> np.ndarray:
        """Fit a degree-(p-1) polynomial at ``xs[:p]`` (square solve) and
        extract the sum of the ``target_degrees`` coefficients."""
        V = self.decode_basis.eval_matrix(xs[:p], p)
        a = np.zeros(p, dtype=np.float64)
        for d in target_degrees:
            a = a + self.decode_basis.coeff_functional(d, p)
        return extraction_weights(V, a)

    def _coeff_weights_batch(self, xs: np.ndarray, p: int,
                             target_degrees) -> np.ndarray:
        """Stacked :meth:`_coeff_weights` over ``xs: (T, >=p)`` traces."""
        V = self.decode_basis.eval_matrix(xs[:, :p], p)
        a = np.zeros(p, dtype=np.float64)
        for d in target_degrees:
            a = a + self.decode_basis.coeff_functional(d, p)
        return extraction_weights_batch(V, a)

    def estimate_weights(self, completed: np.ndarray, m: int):
        R = self.recovery_threshold
        if m < R:
            return None
        xs = self.eval_points[completed]
        w = self._coeff_weights(xs, R, [self.K - 1])
        return w, DecodeInfo(exact=True, m_pairs=self.K)

    def estimate_weights_batch(self, orders: np.ndarray, m: int):
        R = self.recovery_threshold
        if m < R:
            return None
        orders = np.asarray(orders)
        xs = self.eval_points[orders[:, :R]]
        w = self._coeff_weights_batch(xs, R, [self.K - 1])
        return self._scatter_weights(orders, w), \
            DecodeInfo(exact=True, m_pairs=self.K)

    def _extra_key(self) -> tuple:
        return self.decode_basis.cache_key()


class EpsApproxMatDotCode(MatDotCode):
    name = "eps_matdot"

    @property
    def first_threshold(self) -> int:
        return self.K            # R_{εAMD,1} = K (Table I)

    @property
    def n_layers(self) -> int:
        return 1                 # single resolution layer [20]

    def decode_support(self, m: int) -> int:
        # the single approximate layer reads only the first K completions
        if m < self.recovery_threshold:
            return min(m, self.K)
        return self.recovery_threshold

    def decode_update(self, m: int) -> str:
        # weights change only when the layer appears (m = K) and at exact
        # recovery (m = R); in between the estimate is frozen ([20], Fig. 3a)
        if m == self.K or m == self.recovery_threshold:
            return "resolve"
        return "none"

    def estimate_weights(self, completed: np.ndarray, m: int):
        K, R = self.K, self.recovery_threshold
        if m < K:
            return None
        xs = self.eval_points[completed]
        if m >= R:
            w = self._coeff_weights(xs, R, [K - 1])
            return w, DecodeInfo(exact=True, m_pairs=K)
        # the single ε-approximate layer: degree-(K-1) residual fit from the
        # first K completions (flat for K <= m < 2K-1 — see module docstring)
        w = self._coeff_weights(xs, K, [K - 1])
        return w, DecodeInfo(exact=False, m_pairs=K, layer=1)

    def estimate_weights_batch(self, orders: np.ndarray, m: int):
        K, R = self.K, self.recovery_threshold
        if m < K:
            return None
        orders = np.asarray(orders)
        if m >= R:
            xs = self.eval_points[orders[:, :R]]
            w = self._coeff_weights_batch(xs, R, [K - 1])
            return self._scatter_weights(orders, w), \
                DecodeInfo(exact=True, m_pairs=K)
        xs = self.eval_points[orders[:, :K]]
        w = self._coeff_weights_batch(xs, K, [K - 1])
        return self._scatter_weights(orders, w), \
            DecodeInfo(exact=False, m_pairs=K, layer=1)

    def ideal_estimate(self, order, m, A_blocks, B_blocks,
                       beta_mode: str = "one", oracle=None):
        # the layer recovers the *full* sum (all K pairs) up to truncation, so
        # the analytic best approximation is exact C for every m >= K.
        if m >= self.K:
            return np.einsum("kij,kjl->il", np.asarray(A_blocks),
                             np.asarray(B_blocks))
        return None

    def ideal_weights_batch(self, orders, m, beta_mode: str = "one",
                            oracle=None):
        if m >= self.K:
            return np.ones(1)
        return None
