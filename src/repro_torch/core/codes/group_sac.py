"""Group-wise successive approximation coding (paper §III).

The K ``(A_k, B_k)`` pairs are uniformly shuffled and split into D groups of
sizes ``K_1..K_D``.  Define the doubling cumulative ``S_0 = 0,
S_d = 2 S_{d-1} + K_d`` (so ``S_d = Σ_{i<=d} 2^{d-i} K_i``, the paper's
group-d first-layer threshold ``R_{G-SAC, l_{d,1}}``).  Group d's blocks are
placed at degree offset ``S_{d-1}`` on both the A side (ascending) and the B
side (descending), which puts the group's partial sum
``Σ_{k∈group d} A_k B_k`` — *uncontaminated by cross terms* — at coefficient
``x^{S_d - 1}`` of the product polynomial (verified symbolically in
``tests/test_group_sac.py``).

* recovery threshold   ``R = S_D + K_D - 1``  (= 2K-1 iff D <= 2, App. E)
* first estimate at    ``m = K_1``
* resolution layer l has threshold ``K_1 + l - 1``; big accuracy jumps when a
  group completes (m crosses some S_d), small gains otherwise.

Decoding at m finishers fits a degree-(m-1) polynomial (in the column-scaled
monomial basis by default) and sums the coefficients ``x^{S_d - 1}`` of every
completed group; Thm. 1's β (with ``m_l`` = recovered pair count) rescales.
"""
from __future__ import annotations

import numpy as np

from ..beta import group_beta
from ..poly import MonomialBasis, monomial_eval
from ..solve import extraction_weights, extraction_weights_batch
from .base import CDCCode, DecodeInfo

__all__ = ["GroupSACCode", "group_thresholds"]


def group_thresholds(group_sizes) -> tuple[np.ndarray, np.ndarray, int]:
    """``(S_d array, degree offsets per group, recovery threshold)``."""
    sizes = np.asarray(group_sizes, dtype=np.int64)
    D = len(sizes)
    S = np.zeros(D + 1, dtype=np.int64)
    for d in range(D):
        S[d + 1] = 2 * S[d] + sizes[d]
    offsets = S[:-1].copy()           # group d starts at degree S_{d-1}
    R = int(S[D] + sizes[D - 1] - 1)  # = deg(product) + 1
    return S[1:], offsets, R


class GroupSACCode(CDCCode):
    name = "group_sac"

    def __init__(self, K: int, N: int, eval_points: np.ndarray,
                 group_sizes, *, permutation: np.ndarray | None = None,
                 rng: np.random.Generator | None = None,
                 column_scaling: bool = True):
        super().__init__(K, N, eval_points)
        sizes = np.asarray(group_sizes, dtype=np.int64)
        if sizes.sum() != K or np.any(sizes <= 0):
            raise ValueError(f"group sizes {group_sizes} must be positive and sum to K={K}")
        self.group_sizes = sizes
        self.S, self.offsets, self._R = group_thresholds(sizes)
        if N < self._R:
            raise ValueError(f"G-SAC with groups {list(sizes)} needs N >= {self._R}")
        if permutation is None:
            permutation = (rng.permutation(K) if rng is not None
                           else np.arange(K))
        self.permutation = np.asarray(permutation)
        scale = float(np.max(np.abs(eval_points))) if column_scaling else None
        self.decode_basis = MonomialBasis(scale=scale)
        # shuffled position p -> (group d, within-group index k)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        self._group_of = np.searchsorted(bounds, np.arange(K), side="right") - 1
        self._pos_in_group = np.arange(K) - bounds[self._group_of]

    # ---------------------------------------------------------------- encode
    def degrees(self) -> tuple[np.ndarray, np.ndarray]:
        """Per *shuffled position* p: (A-side degree, B-side degree)."""
        d = self._group_of
        k = self._pos_in_group
        deg_A = self.offsets[d] + k
        deg_B = self.offsets[d] + (self.group_sizes[d] - 1 - k)
        return deg_A, deg_B

    def generator(self):
        deg_A, deg_B = self.degrees()
        x = self.eval_points
        # column = ORIGINAL block index: G[:, perm[p]] gets position p's degree
        G_A = np.empty((self.N, self.K), dtype=np.result_type(x, np.float64))
        G_B = np.empty_like(G_A)
        G_A[:, self.permutation] = monomial_eval(x, deg_A)
        G_B[:, self.permutation] = monomial_eval(x, deg_B)
        return G_A, G_B

    # ------------------------------------------------------------ thresholds
    @property
    def recovery_threshold(self) -> int:
        return self._R

    @property
    def first_threshold(self) -> int:
        return int(self.group_sizes[0])

    def available_groups(self, m: int) -> np.ndarray:
        return np.nonzero(self.S <= m)[0]

    # ---------------------------------------------------------------- decode
    def estimate_weights(self, completed: np.ndarray, m: int):
        if m < self.first_threshold:
            return None
        R = self._R
        exact = m >= R
        p = R if exact else m
        xs = self.eval_points[completed][:p]
        avail = np.arange(len(self.S)) if exact else self.available_groups(m)
        targets = [int(self.S[d] - 1) for d in avail]
        V = self.decode_basis.eval_matrix(xs, p)
        a = np.zeros(p, dtype=np.float64)
        for t in targets:
            a = a + self.decode_basis.coeff_functional(t, p)
        w = extraction_weights(V, a)
        m_pairs = int(self.group_sizes[avail].sum())
        layer = None if exact else m - self.first_threshold + 1
        return w, DecodeInfo(exact=exact, m_pairs=m_pairs, layer=layer,
                             extra={"groups": avail})

    def estimate_weights_batch(self, orders: np.ndarray, m: int):
        if m < self.first_threshold:
            return None
        R = self._R
        exact = m >= R
        p = R if exact else m
        orders = np.asarray(orders)
        xs = self.eval_points[orders[:, :p]]
        avail = np.arange(len(self.S)) if exact else self.available_groups(m)
        V = self.decode_basis.eval_matrix(xs, p)
        a = np.zeros(p, dtype=np.float64)
        for d in avail:
            a = a + self.decode_basis.coeff_functional(int(self.S[d] - 1), p)
        w = extraction_weights_batch(V, a)
        m_pairs = int(self.group_sizes[avail].sum())
        layer = None if exact else m - self.first_threshold + 1
        return self._scatter_weights(orders, w), \
            DecodeInfo(exact=exact, m_pairs=m_pairs, layer=layer,
                       extra={"groups": avail})

    def beta(self, info: DecodeInfo, m: int, mode: str = "one",
             oracle: dict | None = None) -> float:
        if info.exact or info.m_pairs >= self.K:
            return 1.0
        products = None
        if oracle is not None:
            products = oracle.get("block_products")
        return group_beta(mode, info.m_pairs, self.K, products)

    # ------------------------------------------------- analytic (ideal) path
    def ideal_estimate(self, order, m, A_blocks, B_blocks,
                       beta_mode: str = "one", oracle: dict | None = None):
        """Paper's C_l: β × (sum of the completed groups' true partial sums)."""
        if m < self.first_threshold:
            return None
        A_blocks = np.asarray(A_blocks)
        B_blocks = np.asarray(B_blocks)
        if m >= self._R:
            return np.einsum("kij,kjl->il", A_blocks, B_blocks)
        avail = self.available_groups(m)
        sel = np.isin(self._group_of, avail)          # shuffled positions
        orig = self.permutation[sel]                  # original block ids
        part = np.einsum("kij,kjl->il", A_blocks[orig], B_blocks[orig])
        m_pairs = int(sel.sum())
        b = self.beta(DecodeInfo(exact=False, m_pairs=m_pairs), m,
                      beta_mode, oracle)
        return b * part

    def ideal_basis(self, A_blocks, B_blocks, oracle: dict | None = None):
        """Per-group true partial sums plus exact C — ``(D + 1, Nx, Ny)``.

        Reuses the oracle's precomputed ``A_k B_k`` stack when present (the
        engine shares it problem-wide) so per-shuffle instances don't redo
        block matmuls.
        """
        bp = oracle.get("block_products") if oracle else None
        if bp is None:
            A_blocks = np.asarray(A_blocks)
            B_blocks = np.asarray(B_blocks)
            bp = np.einsum("kij,kjl->kil", A_blocks, B_blocks)
        bp = np.asarray(bp)
        parts = [bp[self.permutation[self._group_of == d]].sum(axis=0)
                 for d in range(len(self.group_sizes))]
        parts.append(bp.sum(axis=0))
        return np.stack(parts)

    def ideal_weights_batch(self, orders, m, beta_mode: str = "one",
                            oracle: dict | None = None):
        if m < self.first_threshold:
            return None
        D = len(self.group_sizes)
        w = np.zeros(D + 1)
        if m >= self._R:
            w[D] = 1.0
            return w
        avail = self.available_groups(m)
        m_pairs = int(self.group_sizes[avail].sum())
        b = self.beta(DecodeInfo(exact=False, m_pairs=m_pairs), m,
                      beta_mode, oracle)
        w[avail] = b
        return w

    def _extra_key(self) -> tuple:
        return (self.group_sizes.tobytes(), self.permutation.tobytes()) \
            + self.decode_basis.cache_key()
