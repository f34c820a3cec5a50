"""Optimal rescaling β (paper Theorems 1 & 2, Remarks 3-5).

The SAC estimate at a partial-completion state is ``β · C_m`` where ``C_m``
sums only the recovered pieces.  Thm. 1 (group-wise) and Thm. 2 (layer-wise)
give the β minimizing the expected squared error under a uniformly random
completion order.  The optimal β needs the moments ``M1/M2`` (or
``M̃_i/M̃_{i,j}``) of the *unknown* products, so the paper also gives regime
approximations (Remark 4 / Example 4):

* ``"one"``      — β = 1           (uncorrelated, zero-mean blocks; Case 1)
* ``"unbiased"`` — β = K / m       (makes βC_l unbiased, eq. (10))
* ``"case2"``    — β = (K-1)/(m-1) (strongly correlated blocks; Case 2)
* ``"oracle"``   — exact Thm-1/Thm-2 optimum from the true block products
* ``"eq5"``      — Thm-2 Case-2 closed form for equal cluster sizes.

NOTE on eq. (5): the paper prints β* ≈ (γ_i+γ_j)/(2γ_{i,j}) but then displays
the combinatorial fraction *inverted* (the printed expression is < 1, while
the correct limit of (4) with M̃_{i,j} ≫ M̃_i is γ_i/γ_{i,j} > 1 — consistent
with β = 7/4 > 1 used for G-SAC in Fig. 3b).  We implement the correct
γ_i/γ_{i,j}; `EXPERIMENTS.md §Paper-validation` records the discrepancy.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "thm1_moments", "thm1_beta", "group_beta",
    "thm2_gammas", "thm2_beta", "layer_beta", "eq5_beta",
]


# ---------------------------------------------------------------------------
# Theorem 1 (group-wise SAC)
# ---------------------------------------------------------------------------

def thm1_moments(products: np.ndarray) -> tuple[float, float]:
    """``M1 = Σ‖A_iB_i‖_F²``, ``M2 = Σ_{i<j} Tr((A_iB_i)^T A_jB_j)``.

    ``products``: (K, Nx, Ny) stack of the true block outer products.
    """
    K = products.shape[0]
    flat = np.asarray(products).reshape(K, -1)
    G = flat @ flat.conj().T                    # Gram matrix of the products
    M1 = float(np.real(np.trace(G)))
    M2 = float(np.real(G.sum() - np.trace(G)) / 2.0)
    return M1, M2


def thm1_beta(M1: float, M2: float, m: int, K: int) -> float:
    """Eq. (1): β* = (M1 + 2 M2) / (M1 + 2 (m-1)/(K-1) M2)."""
    denom = M1 + 2.0 * (m - 1) / (K - 1) * M2
    if denom == 0.0:
        return 1.0
    return (M1 + 2.0 * M2) / denom


def group_beta(mode: str, m: int, K: int,
               products: np.ndarray | None = None) -> float:
    """β for group-wise SAC with ``m`` = number of recovered pairs (m_l)."""
    if m >= K:
        return 1.0                               # full sum recovered — Thm 1 gives 1
    if mode == "one":
        return 1.0
    if mode == "unbiased":
        return K / m
    if mode == "case2":
        return (K - 1) / (m - 1) if m > 1 else float(K)
    if mode == "oracle":
        if products is None:
            raise ValueError("oracle β needs the true block products")
        M1, M2 = thm1_moments(products)
        return thm1_beta(M1, M2, m, K)
    raise ValueError(f"unknown β mode {mode!r}")


# ---------------------------------------------------------------------------
# Theorem 2 (layer-wise SAC)
# ---------------------------------------------------------------------------

def _comb(n: int, k: int) -> float:
    if k < 0 or k > n:
        return 0.0
    return float(math.comb(n, k))


def thm2_gammas(N: int, m: int, n_sizes: np.ndarray):
    """``γ_i = P(cluster i hit)``, ``γ_{i,j} = P(clusters i and j both hit)``.

    Hit = at least one of the cluster's ``n_i`` workers is among the ``m``
    fastest of ``N`` (uniform order).  Hypergeometric inclusion-exclusion.
    """
    n_sizes = np.asarray(n_sizes, dtype=np.int64)
    K = len(n_sizes)
    total = _comb(N, m)
    gamma = np.array([1.0 - _comb(N - int(n), m) / total for n in n_sizes])
    gamma_pair = np.zeros((K, K))
    for i in range(K):
        for j in range(K):
            ni, nj = int(n_sizes[i]), int(n_sizes[j])
            if i == j:
                gamma_pair[i, j] = gamma[i]
                continue
            gamma_pair[i, j] = (total - _comb(N - ni, m) - _comb(N - nj, m)
                                + _comb(N - ni - nj, m)) / total
    return gamma, gamma_pair


def thm2_beta(anchor_products: np.ndarray, alphas: np.ndarray,
              N: int, m: int, n_sizes: np.ndarray) -> float:
    """Eq. (4) with the M̃ moments computed from the anchor products.

    ``anchor_products``: (K, Nx, Ny) stack of ``S̃_A(y_k) S̃_B(y_k)``.
    """
    K = anchor_products.shape[0]
    flat = np.asarray(anchor_products).reshape(K, -1)
    alphas = np.asarray(alphas, dtype=np.float64)
    G = np.real((flat @ flat.conj().T)) * np.outer(alphas, alphas)  # M̃ matrix
    gamma, gamma_pair = thm2_gammas(N, m, n_sizes)
    Mi = np.diag(G)
    num = float(np.sum(Mi * gamma))
    den = float(np.sum(Mi * gamma))
    for i in range(K):
        for j in range(i + 1, K):
            num += G[i, j] * (gamma[i] + gamma[j])
            den += 2.0 * G[i, j] * gamma_pair[i, j]
    if den == 0.0:
        return 1.0
    return num / den


def eq5_beta(N: int, m: int, K: int) -> float:
    """Thm-2 Case-2 closed form (equal clusters n = N/K): β = γ_i / γ_{i,j}.

    See the module docstring re: the sign/orientation typo in the paper's
    printed eq. (5).
    """
    n = N // K
    total = _comb(N, m)
    gi = total - _comb(N - n, m)
    gij = total - 2.0 * _comb(N - n, m) + _comb(N - 2 * n, m)
    if gij == 0.0:
        return 1.0
    return gi / gij


def layer_beta(mode: str, N: int, m: int, n_sizes: np.ndarray,
               alphas: np.ndarray | None = None,
               anchor_products: np.ndarray | None = None) -> float:
    """β for layer-wise SAC at ``m`` completed workers."""
    K = len(n_sizes)
    if mode == "one":
        return 1.0
    if mode == "eq5":
        return eq5_beta(N, m, K)
    if mode == "oracle":
        if anchor_products is None or alphas is None:
            raise ValueError("oracle β needs anchor products and alphas")
        return thm2_beta(anchor_products, alphas, N, m, np.asarray(n_sizes))
    raise ValueError(f"unknown β mode {mode!r}")
