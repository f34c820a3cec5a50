"""Layer-wise successive approximation coding (paper §IV).

Applies SAC to *point-based* CDC (OrthoMatDot / Lagrange).  Keep the encoding
polynomials, but cluster the N evaluation points ε-close to the K
post-decoding interpolation anchors ``y_k`` (``n_k`` points per anchor,
``Σ n_k = N``).  Then every completed worker in cluster k is an ε-accurate
evaluation of ``S̃_A(y_k) S̃_B(y_k)`` and the anytime estimate (eq. (2)) is

    C̃_m = Σ_k α_k · mean_i { P(z_{k,i}) : worker (k,i) finished },

one resolution layer per completed worker (L = 2K-2), first estimate at
m = 1.  β from Thm. 2 ("oracle", "eq5" closed form, or 1).  Exact recovery at
m = 2K-1 via a full fit at the (clustered — hence worse-conditioned, as the
paper notes) completed points, then the usual point-based post-decode.
"""
from __future__ import annotations

import numpy as np

from ..beta import layer_beta
from ..poly import (ChebyshevBasis, MappedChebyshevBasis, MonomialBasis,
                    chebyshev_roots, lagrange_eval, orthonormal_eval)
from ..solve import extraction_weights
from .base import CDCCode, DecodeInfo

__all__ = ["LayerSACCode", "clustered_points"]


def clustered_points(anchors: np.ndarray, n_sizes, eps: float) -> tuple[np.ndarray, np.ndarray]:
    """ε-close clusters: for anchor k, ``n_k`` distinct points within ±ε.

    Returns ``(points (N,), cluster (N,))`` with ``cluster[n]`` = anchor index
    of worker n.  Offsets are symmetric in (-ε, ε]: ``ε (2i - n_k + 1)/n_k``.
    """
    pts, cl = [], []
    for k, n_k in enumerate(np.asarray(n_sizes, dtype=np.int64)):
        i = np.arange(n_k, dtype=np.float64)
        offs = eps * (2 * i - n_k + 1) / max(int(n_k), 1)
        pts.append(anchors[k] + offs)
        cl.append(np.full(int(n_k), k, dtype=np.int64))
    return np.concatenate(pts), np.concatenate(cl)


class LayerSACCode(CDCCode):
    """Layer-wise SAC over an OrthoMatDot or Lagrange base code."""

    def __init__(self, K: int, N: int, *, base: str = "ortho",
                 n_sizes=None, eps: float = 1e-2,
                 anchors: np.ndarray | None = None,
                 column_scaling: bool = True):
        if n_sizes is None:
            if N % K != 0:
                raise ValueError("give n_sizes explicitly when K does not divide N")
            n_sizes = np.full(K, N // K, dtype=np.int64)
        n_sizes = np.asarray(n_sizes, dtype=np.int64)
        if n_sizes.sum() != N or np.any(n_sizes <= 0):
            raise ValueError("cluster sizes must be positive and sum to N")
        if base == "ortho":
            self.anchors = chebyshev_roots(K) if anchors is None else np.asarray(anchors)
            self.alphas = np.full(K, 2.0 / K)
            self.decode_basis = ChebyshevBasis()
        elif base == "lagrange":
            self.anchors = (np.arange(1, K + 1, dtype=np.float64)
                            if anchors is None else np.asarray(anchors, np.float64))
            self.alphas = np.ones(K)
            self.decode_basis = None     # set after points known (needs scale)
        else:
            raise ValueError(f"unknown base {base!r}")
        self.base = base
        self.n_sizes = n_sizes
        self.eps = float(eps)
        points, cluster = clustered_points(self.anchors, n_sizes, eps)
        super().__init__(K, N, points)
        self.cluster = cluster
        self.name = f"layer_sac_{base}"
        if base == "lagrange":
            if column_scaling:
                span = np.concatenate([points, self.anchors])
                self.decode_basis = MappedChebyshevBasis(float(span.min()) - 1e-9,
                                                         float(span.max()) + 1e-9)
            else:
                self.decode_basis = MonomialBasis(scale=None)  # paper-faithful

    # ---------------------------------------------------------------- encode
    def generator(self):
        if self.base == "ortho":
            V = orthonormal_eval(self.eval_points, np.arange(self.K))
        else:
            V = lagrange_eval(self.eval_points, self.anchors)
        return V, V.copy()

    # ------------------------------------------------------------ thresholds
    @property
    def recovery_threshold(self) -> int:
        return 2 * self.K - 1

    @property
    def first_threshold(self) -> int:
        return 1                                   # R_{L-SAC,1} = 1

    def decode_update(self, m: int) -> str:
        R = self.recovery_threshold
        if m > R:
            return "none"
        if m == R:
            return "resolve"
        return "rank1"          # eq. (2): one product enters one cluster mean

    def cluster_structure(self):
        return self.cluster, self.alphas

    # ---------------------------------------------------------------- decode
    def estimate_weights(self, completed: np.ndarray, m: int):
        if m < 1:                    # below R_{L-SAC,1}: no completions, no
            return None              # estimate (not an empty weighted sum)
        R = self.recovery_threshold
        if m >= R:
            xs = self.eval_points[completed][:R]
            V = self.decode_basis.eval_matrix(xs, R)
            a = self.decode_basis.point_functional(self.anchors, self.alphas, R)
            w = extraction_weights(V, a)
            return w, DecodeInfo(exact=True, m_pairs=self.K)
        # eq. (2): cluster-averaged anytime estimate — a pure weighted sum.
        ks = self.cluster[completed[:m]]
        counts = np.bincount(ks, minlength=self.K)
        w = self.alphas[ks] / counts[ks]
        hit = counts > 0
        return w, DecodeInfo(exact=False, m_pairs=int(hit.sum()),
                             layer=m, extra={"hit": hit})

    def _hit_counts(self, orders: np.ndarray, m: int) -> np.ndarray:
        """Per-trace cluster completion counts ``(T, K)``."""
        ks = self.cluster[np.asarray(orders)[:, :m]]
        T = ks.shape[0]
        counts = np.zeros((T, self.K), dtype=np.int64)
        np.add.at(counts, (np.repeat(np.arange(T), m), ks.ravel()), 1)
        return counts

    def estimate_weights_batch(self, orders: np.ndarray, m: int):
        if m < 1:
            return None
        orders = np.asarray(orders)
        if m >= self.recovery_threshold:
            return self._point_decode_batch(orders)
        # eq. (2) batched: per-trace cluster-averaged weights
        ks = self.cluster[orders[:, :m]]
        counts = self._hit_counts(orders, m)
        rows = np.arange(orders.shape[0])[:, None]
        w = self.alphas[ks] / counts[rows, ks]
        hits = counts > 0
        return self._scatter_weights(orders, w), \
            DecodeInfo(exact=False, m_pairs=int(hits[0].sum()), layer=m,
                       extra={"hit": hits[0], "hits": hits})

    def beta(self, info: DecodeInfo, m: int, mode: str = "one",
             oracle: dict | None = None) -> float:
        if info.exact:
            return 1.0
        anchor_products = oracle.get("anchor_products") if oracle else None
        return layer_beta(mode, self.N, m, self.n_sizes,
                          alphas=self.alphas, anchor_products=anchor_products)

    # ------------------------------------------------- analytic (ideal) path
    def anchor_products(self, A_blocks, B_blocks) -> np.ndarray:
        """``S̃_A(y_k) S̃_B(y_k)`` — (K, Nx, Ny)."""
        if self.base == "ortho":
            Vy = orthonormal_eval(self.anchors, np.arange(self.K))
            EA = np.einsum("nk,kij->nij", Vy, np.asarray(A_blocks))
            EB = np.einsum("nk,kij->nij", Vy, np.asarray(B_blocks))
            return np.einsum("nij,njl->nil", EA, EB)
        return np.einsum("kij,kjl->kil", np.asarray(A_blocks),
                         np.asarray(B_blocks))

    def oracle_context(self, A_blocks, B_blocks, *,
                       block_products=None) -> dict:
        ctx = super().oracle_context(A_blocks, B_blocks,
                                     block_products=block_products)
        ctx["anchor_products"] = self.anchor_products(A_blocks, B_blocks)
        return ctx

    def ideal_estimate(self, order, m, A_blocks, B_blocks,
                       beta_mode: str = "one", oracle: dict | None = None):
        """Eq. (3): ``C_m = β Σ_k α_k S̃_A(y_k)S̃_B(y_k) 1{m_k>0}``."""
        if m >= self.recovery_threshold:
            return np.einsum("kij,kjl->il", np.asarray(A_blocks),
                             np.asarray(B_blocks))
        if oracle is not None and "anchor_products" in oracle:
            ap = oracle["anchor_products"]
        else:
            ap = self.anchor_products(A_blocks, B_blocks)
        ks = self.cluster[np.asarray(order)[:m]]
        hit = np.bincount(ks, minlength=self.K) > 0
        est = np.einsum("k,kij->ij", self.alphas * hit, ap)
        info = DecodeInfo(exact=False, m_pairs=int(hit.sum()), layer=m,
                          extra={"hit": hit})
        return self.beta(info, m, beta_mode,
                         oracle or {"anchor_products": ap}) * est

    def ideal_basis(self, A_blocks, B_blocks, oracle: dict | None = None):
        """Anchor products plus exact C — ``(K + 1, Nx, Ny)``."""
        if oracle is not None and "anchor_products" in oracle:
            ap = oracle["anchor_products"]
        else:
            ap = self.anchor_products(A_blocks, B_blocks)
        C = np.einsum("kij,kjl->il", np.asarray(A_blocks),
                      np.asarray(B_blocks))
        return np.concatenate([np.asarray(ap), C[None]])

    def ideal_weights_batch(self, orders, m, beta_mode: str = "one",
                            oracle: dict | None = None):
        K = self.K
        if m >= self.recovery_threshold:
            w = np.zeros(K + 1)
            w[K] = 1.0
            return w
        hits = self._hit_counts(orders, m) > 0
        info = DecodeInfo(exact=False, m_pairs=int(hits[0].sum()), layer=m)
        b = self.beta(info, m, beta_mode, oracle)
        W = np.zeros((hits.shape[0], K + 1))
        W[:, :K] = b * (self.alphas * hits)
        return W

    def _extra_key(self) -> tuple:
        return (self.base, self.eps, self.n_sizes.tobytes(),
                self.anchors.tobytes()) + self.decode_basis.cache_key()
