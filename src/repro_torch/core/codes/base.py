"""Base class for polynomial CDC codes (paper §II).

A code is specified by its encoding generator matrices ``G_A, G_B: (N, K)``
(worker n's encoded operands are ``E_A[n] = Σ_k G_A[n,k] A_k`` etc.), its
evaluation points, and its decode rule.  The decode rule is *always* exposed
as extraction weights over completed worker products (see
``repro.core.solve``), which is what lets the distributed runtime fold the
decode into a weighted collective.

Estimate protocol: ``estimate_weights(completed, m)`` returns ``(w, info)``
with ``w: (m,)`` such that the **pre-β** estimate is
``Σ_i w_i · P_{completed[i]}``; ``info`` carries whatever the β rule needs
(recovered-pair count for Thm. 1, hit clusters for Thm. 2).  Returns ``None``
below the code's first threshold.

Batched protocol (Monte-Carlo engine): ``estimate_weights_batch(orders, m)``
takes a whole stack of completion orders ``(trials, N)`` and returns the
*scattered* pre-β weight matrix ``W: (trials, N)`` (zero for stragglers) in
one stacked Vandermonde solve, plus one :class:`DecodeInfo` (whether an
estimate exists at m, and which β inputs apply, are order-independent for
every code here, so a single info covers the batch; per-trace detail such as
hit clusters rides in ``info.extra``).  ``ideal_basis`` /
``ideal_weights_batch`` expose the analytic path the same way: every ideal
estimate is a linear combination of a small per-code stack of matrices
(group partial sums, anchor products, exact C), so the engine evaluates all
trials × m with einsums over one precomputed basis.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..partition import block_outer_products, split_contraction
from ..solve import extraction_weights_batch

__all__ = ["CDCCode", "DecodeInfo"]


@dataclass
class DecodeInfo:
    """Metadata accompanying a set of decode weights."""

    exact: bool                    # True iff m >= recovery threshold
    m_pairs: int                   # recovered-pair count (Thm-1 m_l); K if exact
    layer: int | None = None       # resolution-layer index (1-based), if defined
    extra: dict[str, Any] = field(default_factory=dict)


class CDCCode:
    """Abstract polynomial CDC code for ``C = Σ_k A_k B_k``."""

    name: str = "abstract"

    def __init__(self, K: int, N: int, eval_points: np.ndarray):
        if N < 1 or K < 1:
            raise ValueError("need N >= 1 and K >= 1")
        eval_points = np.asarray(eval_points)
        if eval_points.shape != (N,):
            raise ValueError(f"need {N} evaluation points, got {eval_points.shape}")
        if len(np.unique(eval_points)) != N:
            raise ValueError("evaluation points must be distinct")
        self.K = K
        self.N = N
        self.eval_points = eval_points

    # ---------------------------------------------------------------- encode
    def generator(self) -> tuple[np.ndarray, np.ndarray]:
        """``(G_A, G_B)`` each of shape ``(N, K)``."""
        raise NotImplementedError

    def encode(self, A_blocks, B_blocks):
        """Encoded per-worker operands ``(E_A: (N,Nx,bz), E_B: (N,bz,Ny))``."""
        G_A, G_B = self.generator()
        E_A = np.einsum("nk,kij->nij", G_A, np.asarray(A_blocks))
        E_B = np.einsum("nk,kij->nij", G_B, np.asarray(B_blocks))
        return E_A, E_B

    @staticmethod
    def worker_products(E_A, E_B):
        """Every worker's task: one encoded matmul.  (N, Nx, Ny)."""
        return np.einsum("nij,njl->nil", E_A, E_B)

    def run_workers(self, A, B):
        """Convenience: split → encode → all worker products."""
        A_blocks, B_blocks = split_contraction(A, B, self.K)
        E_A, E_B = self.encode(A_blocks, B_blocks)
        return self.worker_products(E_A, E_B)

    # ------------------------------------------------------------ thresholds
    @property
    def recovery_threshold(self) -> int:
        raise NotImplementedError

    @property
    def first_threshold(self) -> int:
        """Smallest m producing any estimate (= recovery threshold if no layers)."""
        return self.recovery_threshold

    @property
    def n_layers(self) -> int:
        """Number of resolution layers strictly before exact recovery."""
        return max(0, self.recovery_threshold - self.first_threshold)

    # ---------------------------------------------------------------- decode
    def estimate_weights(self, completed: np.ndarray, m: int):
        """Weights over the first ``m`` completed workers, or ``None``."""
        raise NotImplementedError

    # --------------------------------------------------------- batched decode
    def _scatter_weights(self, orders: np.ndarray, w: np.ndarray) -> np.ndarray:
        """Scatter per-trace weights ``(T, p)`` over worker index → ``(T, N)``."""
        orders = np.asarray(orders)
        T, p = w.shape
        W = np.zeros((T, self.N), dtype=w.dtype)
        W[np.arange(T)[:, None], orders[:, :p]] = w
        return W

    def estimate_weights_batch(self, orders: np.ndarray, m: int):
        """Scattered pre-β weights for a stack of completion orders.

        ``orders: (T, N)`` → ``(W: (T, N), info)`` or ``None`` below the
        first threshold.  Base implementation loops over
        :meth:`estimate_weights`; subclasses replace it with one stacked
        extraction solve (identical per-trace results, no Python loop).

        Decodability at a given ``m`` must be completion-order-independent
        (true for every code in this repo — thresholds depend on counts, not
        on which workers finished).  A subclass violating that must override
        this method; the fallback raises rather than silently averaging a
        partially-decodable batch.
        """
        orders = np.asarray(orders)
        res = [self.estimate_weights(o[:m], m) for o in orders]
        missing = [r is None for r in res]
        if all(missing):
            return None
        if any(missing):
            raise NotImplementedError(
                f"{type(self).__name__}: decodability at m={m} varies with "
                "completion order; override estimate_weights_batch")
        info = res[0][1]
        return self._scatter_weights(orders, np.stack([r[0] for r in res])), \
            info

    def _point_decode_batch(self, orders: np.ndarray):
        """Stacked exact decode for point-based codes (OrthoMatDot/Lagrange/
        L-SAC): fit at the first R completions, extract the anchor-point sum.

        Requires ``decode_basis``, ``anchors`` and ``alphas`` attributes.
        """
        R = self.recovery_threshold
        orders = np.asarray(orders)
        xs = self.eval_points[orders[:, :R]]
        V = self.decode_basis.eval_matrix(xs, R)
        a = self.decode_basis.point_functional(self.anchors, self.alphas, R)
        w = extraction_weights_batch(V, a)
        return self._scatter_weights(orders, w), \
            DecodeInfo(exact=True, m_pairs=self.K)

    # ------------------------------------------------- batched analytic path
    def ideal_basis(self, A_blocks, B_blocks, oracle: dict | None = None):
        """Stack ``(Q, Nx, Ny)`` every ideal estimate is a linear combo of.

        Default: the single matrix ``C`` (exact recovery is the only ideal
        estimate codes without resolution layers produce).
        """
        C = np.einsum("kij,kjl->il", np.asarray(A_blocks), np.asarray(B_blocks))
        return C[None]

    def ideal_weights_batch(self, orders: np.ndarray, m: int,
                            beta_mode: str = "one",
                            oracle: dict | None = None):
        """β-scaled weights over :meth:`ideal_basis` rows for a trace stack.

        Returns ``(Q,)`` when the combination is trace-independent,
        ``(T, Q)`` when it varies per trace (layer-wise SAC hit patterns),
        or ``None`` where no analytic estimate exists.
        """
        if m >= self.recovery_threshold:
            return np.ones(1)
        return None

    # ------------------------------------------------- streaming-decode hooks
    def decode_support(self, m: int) -> int:
        """Completions the decode at state ``m`` actually reads.

        The estimate at ``m`` is a function of the first ``decode_support(m)``
        completions only (``= min(m, R)`` for plain polynomial fits; K for
        ε-approximate MatDot's frozen layer).  The serving runtime keys its
        decode-weight cache on exactly this prefix.
        """
        return min(m, self.recovery_threshold)

    def decode_update(self, m: int) -> str:
        """How the serving estimate changes when completion ``m`` arrives.

        * ``"none"``    — estimate identical to state ``m-1`` (below the first
          threshold, past the recovery threshold, or a frozen layer whose
          weights ignore the new arrival).
        * ``"rank1"``   — a structured O(1) update exists (cluster-mean codes:
          the new product enters one cluster average; everything else is a
          scalar rescale).  Codes returning this must also implement
          :meth:`cluster_structure`.
        * ``"resolve"`` — the extraction weights must be re-solved (a
          resolution-layer boundary).

        The incremental serving decoder (``repro.serving``) dispatches on
        this; the default is a full re-solve at every state in
        ``[first_threshold, R]`` and no work outside it.
        """
        if m < self.first_threshold or m > self.recovery_threshold:
            return "none"
        return "resolve"

    def cluster_structure(self) -> tuple[np.ndarray, np.ndarray] | None:
        """``(cluster, alphas)`` for cluster-mean codes, else ``None``.

        ``cluster[n]`` is worker n's anchor index and the pre-β estimate is
        ``Σ_k alphas[k] · mean{P_n : n ∈ cluster k, n completed}`` — the form
        that admits O(1) per-completion ("rank-1") updates.
        """
        return None

    # ------------------------------------------------------------- identity
    def cache_key(self) -> tuple:
        """Hashable decode identity: trials whose codes share a key produce
        identical worker products and decode weights, so the batched engine
        can group them (``average_curves`` resamples the code per trial)."""
        return ((type(self).__name__, self.K, self.N,
                 self.eval_points.tobytes()) + self._extra_key())

    def _extra_key(self) -> tuple:
        return ()

    def beta(self, info: DecodeInfo, m: int, mode: str = "one",
             oracle: dict | None = None) -> float:
        """β rule for this code family; overridden by SAC codes."""
        return 1.0

    def decode(self, products: np.ndarray, order: np.ndarray, m: int,
               beta_mode: str = "one", oracle: dict | None = None):
        """Estimate of ``A @ B`` from the ``m`` fastest workers (or ``None``).

        ``products``: (N, Nx, Ny) all worker products (only the completed
        entries are read); ``order``: completion order.
        """
        completed = np.asarray(order)[:m]
        res = self.estimate_weights(completed, m)
        if res is None:
            return None
        w, info = res
        est = np.einsum("m,mij->ij", w, np.asarray(products)[completed[:len(w)]])
        b = self.beta(info, m, beta_mode, oracle)
        est = b * est
        return np.real(est) if np.iscomplexobj(est) else est

    # ------------------------------------------------- analytic (ideal) path
    def ideal_estimate(self, order: np.ndarray, m: int, A_blocks, B_blocks,
                       beta_mode: str = "one", oracle: dict | None = None):
        """The paper's ``C_m``: best analytically-derivable approximation.

        Infinite-precision limit of :meth:`decode` — no Vandermonde solve, no
        ε truncation.  Default: exact C at/above the recovery threshold.
        """
        if m >= self.recovery_threshold:
            return np.einsum("kij,kjl->il", np.asarray(A_blocks), np.asarray(B_blocks))
        return None

    # ------------------------------------------------------------- utilities
    def oracle_context(self, A_blocks, B_blocks, *,
                       block_products=None) -> dict:
        """Precomputed quantities the β oracle / ideal path may need.

        ``block_products`` lets the batched engine reuse the (code-independent)
        ``A_k @ B_k`` stack across the per-trial code instances of a sweep.
        """
        if block_products is None:
            block_products = block_outer_products(np.asarray(A_blocks),
                                                  np.asarray(B_blocks))
        return {"block_products": block_products}

    def __repr__(self):
        return (f"{type(self).__name__}(K={self.K}, N={self.N}, "
                f"R={self.recovery_threshold}, first={self.first_threshold})")
