"""End-to-end simulation of a coded job (paper §V protocol).

Encodes, computes all worker products, realizes completion orders, and for
every m reports the paper's three error measures (Def. 4 + §V-A, eq. (6)):

* approximation error  ``‖C - C_m‖²_F / ‖C‖²_F``   (analytic best at m)
* computation error    ``‖C_m - C̃_m‖²_F / ‖C‖²_F`` (finite precision + ε)
* total error          ``‖C - C̃_m‖²_F / ‖C‖²_F``

All in float64 numpy — the paper's setting ("double-precision ... machine
epsilon ≈ 2.22e-16").

Batched Monte-Carlo engine
--------------------------

:class:`SimulationEngine` is the hot path: it computes the worker products
**once per code instance**, solves all per-trace extraction weights in
stacked LAPACK calls (``estimate_weights_batch``), and evaluates the per-m
errors for a whole ``(trials, N)`` stack of completion orders with einsums.
Two error-evaluation strategies are available via ``norms=``:

* ``"exact"`` (default) — materialize the batched estimates and take
  Frobenius norms of explicit differences.  Reproduces the legacy per-trial
  loop to float64 rounding: ≤1e-10 relative wherever the curve is resolvable
  in f64 (pinned by ``tests/test_engine.py``).  Caveat: for ill-conditioned
  decodes (e.g. G-SAC with deep key degrees at small |x|) the resolvable
  floor is itself κ-amplified — entries measuring the decode's own numerical
  noise agree with the legacy loop only in magnitude, not digit-for-digit
  (``benchmarks/engine_speedup.py`` gates those at 1%).
* ``"gram"`` — the Gram-matrix trick: precompute the pairwise inner products
  of the N worker products / K ideal-basis matrices once, then every error
  ``‖C − Σ_i w_i P_i‖²`` is a tiny quadratic form ``dᵀGd`` per (trace, m) —
  O((N+K)²) instead of O(Nx·Ny·N).  The method of choice for large
  (N, K, trials) scenario sweeps; its absolute noise floor is
  ``~ε·‖w‖²·max‖P‖²`` so curve entries below ~1e-12 of ``‖C‖²`` are not
  resolved (the ``"exact"`` mode resolves down to ~1e-30).

Backends: ``backend="numpy"`` (default, float64) or ``backend="torch"``
(the dense ``(T, M, ·)`` evaluation as batched float64 / complex128 tensor
products on ``device`` — the CUDA card unless ``device="cpu"``).  The torch
backend names its dtypes explicitly and changes no global torch setting.
Decode weights are always solved host-side in numpy float64 (tiny solves
on host, heavy reductions on device).

``run_trace`` / ``average_curves`` keep their legacy signatures as thin
wrappers over the engine; the original per-trial implementations survive as
``run_trace_reference`` / ``average_curves_reference`` for equivalence tests
and the ``benchmarks/engine_speedup.py`` micro-benchmark.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .codes.base import CDCCode
from .partition import block_outer_products, split_contraction
from .straggler import (CompletionBatch, CompletionTrace, simulate_completion,
                        simulate_completion_batch)

__all__ = ["ErrorCurves", "BatchErrorCurves", "ProblemContext",
           "SimulationEngine", "run_trace", "average_curves",
           "run_trace_reference", "average_curves_reference",
           "random_problem", "correlated_problem"]


@dataclass
class ErrorCurves:
    """Per-m error curves; nan where the scheme produces no estimate."""

    ms: np.ndarray
    total: np.ndarray
    approx: np.ndarray
    comp: np.ndarray

    @staticmethod
    def empty(N: int) -> "ErrorCurves":
        ms = np.arange(1, N + 1)
        nan = np.full(N, np.nan)
        return ErrorCurves(ms, nan.copy(), nan.copy(), nan.copy())


@dataclass
class BatchErrorCurves:
    """Stacked per-trace error curves: each array is ``(trials, len(ms))``."""

    ms: np.ndarray
    total: np.ndarray
    approx: np.ndarray
    comp: np.ndarray

    @property
    def trials(self) -> int:
        return self.total.shape[0]

    def trace_curves(self, t: int, N: int) -> ErrorCurves:
        """Row ``t`` scattered into a full-length legacy :class:`ErrorCurves`."""
        out = ErrorCurves.empty(N)
        idx = np.asarray(self.ms) - 1
        out.total[idx] = self.total[t]
        out.approx[idx] = self.approx[t]
        out.comp[idx] = self.comp[t]
        return out


@dataclass
class ProblemContext:
    """Code-independent precomputation shared across a sweep's engines."""

    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    norm: float
    K: int
    A_blocks: np.ndarray
    B_blocks: np.ndarray
    block_products: np.ndarray
    _cross: np.ndarray | None = None

    @staticmethod
    def build(A, B, K: int) -> "ProblemContext":
        A = np.asarray(A, dtype=np.float64)
        B = np.asarray(B, dtype=np.float64)
        C = A @ B
        A_blocks, B_blocks = split_contraction(A, B, K)
        return ProblemContext(
            A=A, B=B, C=C, norm=float(np.linalg.norm(C) ** 2), K=K,
            A_blocks=A_blocks, B_blocks=B_blocks,
            block_products=block_outer_products(A_blocks, B_blocks))

    def cross_products(self) -> np.ndarray:
        """All ``A_k @ B_l`` — ``(K, K, Nx, Ny)``, computed once and cached.

        Any code's worker products are generator contractions of this stack
        (``P_n = Σ_{k,l} G_A[n,k] G_B[n,l] A_k B_l``), which turns the
        per-shuffle product recomputation of G-SAC sweeps into a cheap
        einsum (``products="cross"``).
        """
        if self._cross is None:
            self._cross = np.einsum("kab,lbc->klac", self.A_blocks,
                                    self.B_blocks)
        return self._cross


class SimulationEngine:
    """Batched Monte-Carlo evaluation of one code's error curves.

    Worker products, the oracle context, and the ideal-estimate basis are
    computed once in ``__init__``; :meth:`run_batch` then evaluates any
    number of completion traces with stacked solves and einsum-based norms.
    """

    def __init__(self, code: CDCCode, A, B, *, beta_mode: str = "one",
                 backend: str = "numpy", norms: str = "exact",
                 products: str = "direct", device=None,
                 problem: ProblemContext | None = None):
        _check_modes(backend, norms)
        if products not in ("direct", "cross"):
            raise ValueError(f"unknown products mode {products!r}")
        self.code = code
        self.beta_mode = beta_mode
        self.backend = backend
        self.norms = norms
        # the evaluation device: resolved only for the torch backend
        self.device = resolve_device(device) if backend == "torch" else None
        if problem is None or problem.K != code.K:
            problem = ProblemContext.build(A, B, code.K)
        self.problem = problem
        self.oracle = code.oracle_context(
            problem.A_blocks, problem.B_blocks,
            block_products=problem.block_products)
        F = problem.C.size
        if products == "cross":
            cross = problem.cross_products().reshape(code.K, code.K, F)
            G_A, G_B = code.generator()
            self._P = np.einsum("nk,nl,klf->nf", G_A, G_B, cross)
        else:
            self._P = np.asarray(code.run_workers(problem.A,
                                                  problem.B)).reshape(code.N, F)
        self._Q = np.asarray(code.ideal_basis(
            problem.A_blocks, problem.B_blocks, self.oracle)).reshape(-1, F)
        self._Cf = problem.C.reshape(F)
        self._gram = None
        self._torch = None

    # ----------------------------------------------------------- public API
    def variant(self, *, backend: str | None = None,
                norms: str | None = None, device=None) -> "SimulationEngine":
        """This engine under another backend or norms mode, sharing its
        host-side state (worker products, oracle, ideal basis) instead of
        recomputing it."""
        out = copy.copy(self)
        out.backend = self.backend if backend is None else backend
        out.norms = self.norms if norms is None else norms
        _check_modes(out.backend, out.norms)
        out.device = resolve_device(device) if out.backend == "torch" \
            else None
        out._torch = None
        return out

    def run_batch(self, batch, ms=None) -> BatchErrorCurves:
        """Error curves for a stack of completion orders.

        ``batch``: a :class:`CompletionBatch` or a plain ``(trials, N)``
        integer array of completion orders.
        """
        orders, ms, weights = self._batch_weights(batch, ms)
        if self.backend == "torch":
            out = self._eval_torch(orders.shape[0], ms, weights)
        else:
            out = self._eval_numpy(orders.shape[0], ms, weights)
        return BatchErrorCurves(ms, *out)

    def rounding_bound(self, batch, ms=None) -> BatchErrorCurves:
        """First-order float64 rounding bound of each curve entry.

        How far :meth:`run_batch` may move on any summation order of its
        products (another BLAS, another device): with ``δ`` the bound on
        the estimate's rounding (``(N+4)·ε·Σ|w_n|·‖P_n‖``, and likewise for
        the ideal estimate over ``Q``), an entry ``r = ‖d‖²/‖C‖²`` moves by
        at most ``(2‖d‖δ + δ²)/‖C‖² + (F+3)·ε·r``; in ``gram`` mode a
        quadratic form ``dᵀGd`` moves by at most ``2·Ns·ε·|d|ᵀ|G||d|``.
        Two evaluations of one entry differ by at most twice the bound.
        """
        orders, ms, weights = self._batch_weights(batch, ms)
        T, eps, norm = orders.shape[0], np.finfo(np.float64).eps, \
            self.problem.norm
        cur = self.run_batch(orders, ms) if self.norms == "exact" else None
        shape = (T, len(ms))
        out = [np.full(shape, np.nan) for _ in range(3)]
        if self.norms == "gram":
            G, _ = self._gram_context()
            Ga, Ns = np.abs(G), G.shape[0]

            def quad(d):
                d = np.abs(d)
                return 2 * Ns * eps * np.einsum("ti,tj,ij->t", d, d, Ga) \
                    / norm

            for j, (W, iw) in enumerate(weights):
                _, u_est, u_id, u_c = self._embed(W, iw, T)
                if u_est is not None:
                    out[0][:, j] = quad(u_est - u_c)
                if u_id is not None:
                    out[1][:, j] = quad(u_id - u_c)
                if u_est is not None and u_id is not None:
                    out[2][:, j] = quad(u_id - u_est)
            return BatchErrorCurves(ms, *out)
        nP = np.linalg.norm(self._P, axis=1)
        nQ = np.linalg.norm(self._Q, axis=1)
        F, c = self._Cf.size, np.sqrt(norm)
        for j, (W, iw) in enumerate(weights):
            d_est = (self.code.N + 4) * eps * (np.abs(W) @ nP) / c \
                if W is not None else None
            d_id = (nQ.size + 4) * eps * (np.abs(np.atleast_2d(iw)) @ nQ) \
                / c if iw is not None else None
            for k, (a, b) in enumerate(((d_est, 0), (d_id, 0),
                                        (d_est, d_id))):
                if a is None or b is None:
                    continue
                delta = a + b
                r = np.abs((cur.total, cur.approx, cur.comp)[k][:, j])
                out[k][:, j] = 2 * np.sqrt(r) * delta + delta ** 2 \
                    + (F + 3) * eps * r
        return BatchErrorCurves(ms, *out)

    def _batch_weights(self, batch, ms):
        """``(orders, ms, [(est weights, ideal weights) per m])``."""
        orders = np.asarray(batch.orders if isinstance(batch, CompletionBatch)
                            else batch)
        if orders.ndim != 2 or orders.shape[1] != self.code.N:
            raise ValueError(f"need orders of shape (trials, {self.code.N})")
        ms = (np.arange(1, self.code.N + 1) if ms is None
              else np.asarray(ms, dtype=np.int64).ravel())
        # at/above the recovery threshold the decode reads only the first R
        # completions, so weights (and the estimates built from them) are
        # m-independent: solve once, share the object, and let the evaluators
        # reuse the computed columns by identity
        exact_cache = None
        weights = []
        for m in ms:
            if int(m) >= self.code.recovery_threshold:
                if exact_cache is None:
                    exact_cache = self._weights_for(orders, int(m))
                weights.append(exact_cache)
            else:
                weights.append(self._weights_for(orders, int(m)))
        return orders, ms, weights

    def run_trace(self, trace: CompletionTrace, ms=None) -> ErrorCurves:
        """Legacy single-trace entry point on the batched machinery."""
        cur = self.run_batch(trace.order[None, :], ms=ms)
        return cur.trace_curves(0, self.code.N)

    def average(self, batch, ms=None) -> ErrorCurves:
        """Trial-averaged full-length curves (paper protocol)."""
        cur = self.run_batch(batch, ms=ms)
        N = self.code.N
        acc = [np.zeros(N), np.zeros(N), np.zeros(N)]
        cnt = np.zeros(N, dtype=int)
        _accumulate(acc, cnt, cur)
        return _finalize_average(N, acc, cnt)

    def simulate(self, rng: np.random.Generator, trials: int, *,
                 completion_model: str = "uniform", ms=None,
                 **completion_kw) -> ErrorCurves:
        """Sample ``trials`` completion traces and average — one call."""
        batch = simulate_completion_batch(rng, self.code.N, trials,
                                          model=completion_model,
                                          **completion_kw)
        return self.average(batch, ms=ms)

    # ------------------------------------------------------- weight assembly
    def _weights_for(self, orders: np.ndarray, m: int):
        """Host-side per-m decode: (β-folded est weights, ideal weights)."""
        code = self.code
        est = code.estimate_weights_batch(orders, m)
        W = None
        if est is not None:
            W, info = est
            b = code.beta(info, m, self.beta_mode, self.oracle)
            W = b * W
        iw = code.ideal_weights_batch(orders, m, self.beta_mode, self.oracle)
        return W, iw

    # -------------------------------------------------------- numpy backend
    def _eval_numpy(self, T: int, ms, weights):
        shape = (T, len(ms))
        total = np.full(shape, np.nan)
        approx = np.full(shape, np.nan)
        comp = np.full(shape, np.nan)
        prev = None
        for j in range(len(ms)):
            W, iw = weights[j]
            if prev is not None and weights[j] is weights[prev]:
                total[:, j] = total[:, prev]                   # shared m>=R
                approx[:, j] = approx[:, prev]                 # weights: reuse
                comp[:, j] = comp[:, prev]
                continue
            prev = j
            if self.norms == "gram":
                self._eval_gram_col(W, iw, total, approx, comp, j)
                continue
            norm = self.problem.norm
            est = ideal = None
            if W is not None:
                est = np.real(W @ self._P)                     # (T, F)
                total[:, j] = np.einsum("tf,tf->t", self._Cf - est,
                                        self._Cf - est) / norm
            if iw is not None:
                ideal = np.atleast_2d(iw) @ self._Q            # (T or 1, F)
                d = self._Cf - ideal
                approx[:, j] = np.einsum("tf,tf->t", d, d) / norm
            if est is not None and ideal is not None:
                d = ideal - est
                comp[:, j] = np.einsum("tf,tf->t", d, d) / norm
        return total, approx, comp

    # ------------------------------------------------------------ gram mode
    def _gram_context(self):
        """Real Gram matrix over [Re P, Im P?, Q, C] — computed once."""
        if self._gram is None:
            rows = [np.real(self._P)]
            cplx = np.iscomplexobj(self._P)
            if cplx:
                rows.append(np.imag(self._P))
            rows.extend([self._Q, self._Cf[None]])
            S = np.concatenate(rows, axis=0)
            self._gram = (S @ S.T, cplx)
        return self._gram

    def _embed(self, W, iw, T: int):
        """Embed est / ideal / C weight vectors into the Gram basis."""
        G, cplx = self._gram_context()
        N, Qn = self.code.N, self._Q.shape[0]
        Ns = G.shape[0]
        u_c = np.zeros(Ns)
        u_c[-1] = 1.0
        u_est = u_id = None
        if W is not None:
            u_est = np.zeros((T, Ns))
            u_est[:, :N] = np.real(W)
            if cplx:
                u_est[:, N:2 * N] = -np.imag(W)
        if iw is not None:
            u_id = np.zeros((T, Ns))
            off = (2 * N if cplx else N)
            u_id[:, off:off + Qn] = np.atleast_2d(iw)
        return G, u_est, u_id, u_c

    def _eval_gram_col(self, W, iw, total, approx, comp, j):
        T = total.shape[0]
        G, u_est, u_id, u_c = self._embed(W, iw, T)
        norm = self.problem.norm

        def quad(d):
            return np.einsum("ti,tj,ij->t", d, d, G) / norm

        if u_est is not None:
            total[:, j] = quad(u_est - u_c)
        if u_id is not None:
            approx[:, j] = quad(u_id - u_c)
        if u_est is not None and u_id is not None:
            comp[:, j] = quad(u_id - u_est)

    # -------------------------------------------------------- torch backend
    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        """A host float64 / complex128 array on the evaluation device."""
        dtype = torch.complex128 if np.iscomplexobj(x) else torch.float64
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=self.device)

    def _torch_context(self):
        """Device constants + the trace-batched evaluator."""
        if self._torch is not None:
            return self._torch
        if self.norms == "gram":
            G, _ = self._gram_context()
            Gd = self._tensor(G)

            def quad(d):                                   # d: (T, M, Ns)
                return ((d @ Gd) * d).sum(-1)

            def per_trace(u_est, u_id, u_c):
                return (quad(u_est - u_c), quad(u_id - u_c),
                        quad(u_id - u_est))
        else:
            P = self._tensor(self._P)
            Q = self._tensor(self._Q)
            Cf = self._tensor(self._Cf)

            def per_trace(west, wid, _):
                est = west @ P                             # (T, M, F)
                if est.is_complex():
                    est = est.real
                ideal = wid @ Q                            # (T, M, F)
                return (((Cf - est) ** 2).sum(-1),
                        ((Cf - ideal) ** 2).sum(-1),
                        ((ideal - est) ** 2).sum(-1))

        self._torch = per_trace
        return self._torch

    def _eval_torch(self, T: int, ms, weights):
        """Dense (T, M, ·) weight tensors → one batched evaluation on
        ``self.device``."""
        M = len(ms)
        if self.norms == "gram":
            G, _ = self._gram_context()
            Ns = G.shape[0]
            U_est = np.zeros((T, M, Ns))
            U_id = np.zeros((T, M, Ns))
            est_mask = np.zeros(M, bool)
            id_mask = np.zeros(M, bool)
            u_c = None
            for j, (W, iw) in enumerate(weights):
                _, u_est, u_id, u_c = self._embed(W, iw, T)
                est_mask[j], id_mask[j] = W is not None, iw is not None
                if u_est is not None:
                    U_est[:, j] = u_est
                if u_id is not None:
                    U_id[:, j] = u_id
            args = (self._tensor(U_est), self._tensor(U_id),
                    self._tensor(u_c))
        else:
            cplx = np.iscomplexobj(self._P)
            West = np.zeros((T, M, self.code.N),
                            dtype=np.complex128 if cplx else np.float64)
            Wid = np.zeros((T, M, self._Q.shape[0]))
            est_mask = np.zeros(M, bool)
            id_mask = np.zeros(M, bool)
            for j, (W, iw) in enumerate(weights):
                est_mask[j], id_mask[j] = W is not None, iw is not None
                if W is not None:
                    West[:, j] = W
                if iw is not None:
                    Wid[:, j] = np.atleast_2d(iw)
            args = (self._tensor(West), self._tensor(Wid), None)
        raw = self._torch_context()(*args)
        total, approx, comp = (v.cpu().numpy().astype(np.float64)
                               / self.problem.norm for v in raw)
        total[:, ~est_mask] = np.nan
        approx[:, ~id_mask] = np.nan
        comp[:, ~(est_mask & id_mask)] = np.nan
        return total, approx, comp


def _check_modes(backend: str, norms: str) -> None:
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if norms not in ("exact", "gram"):
        raise ValueError(f"unknown norms mode {norms!r}")


# ---------------------------------------------------------------------------
# legacy-shaped wrappers (engine-backed)
# ---------------------------------------------------------------------------

def run_trace(code: CDCCode, A: np.ndarray, B: np.ndarray,
              trace: CompletionTrace, *, beta_mode: str = "one",
              ms=None, engine: SimulationEngine | None = None) -> ErrorCurves:
    """One realization: error curves for one completion order.

    Thin wrapper over :class:`SimulationEngine`; pass ``engine=`` to reuse a
    prebuilt engine (and its worker products) across traces.
    """
    if engine is None:
        engine = SimulationEngine(code, A, B, beta_mode=beta_mode)
    return engine.run_trace(trace, ms=ms)


def _accumulate(acc, cnt, cur: BatchErrorCurves) -> None:
    idx = np.asarray(cur.ms) - 1
    for j, arr in enumerate((cur.total, cur.approx, cur.comp)):
        ok = ~np.isnan(arr)
        acc[j][idx] += np.where(ok, arr, 0.0).sum(axis=0)
    cnt[idx] += (~np.isnan(cur.total)).sum(axis=0)


def _finalize_average(N, acc, cnt) -> ErrorCurves:
    def _avg(v):
        out = np.full(N, np.nan)
        nz = cnt > 0
        out[nz] = v[nz] / cnt[nz]
        return out

    return ErrorCurves(np.arange(1, N + 1), _avg(acc[0]), _avg(acc[1]),
                       _avg(acc[2]))


def average_curves(code_factory, A, B, *, trials: int = 100, seed: int = 0,
                   beta_mode: str = "one", completion_model: str = "uniform",
                   ms=None, backend: str = "numpy", norms: str = "exact",
                   products: str = "auto", device=None,
                   **completion_kw) -> ErrorCurves:
    """Paper protocol: average the curves over random permutations/shuffles.

    ``code_factory(rng)`` builds a (possibly freshly-shuffled) code per trial
    so both randomness sources — the pair permutation *and* the completion
    order — are resampled, as in §V.  Engine-backed: trials whose codes share
    a decode identity (``cache_key``) are stacked into one batched engine
    run, so deterministic factories collapse to a single engine while
    shuffled G-SAC codes amortize the problem-level precomputation.  RNG
    consumption order matches the legacy loop draw-for-draw.

    ``products="auto"`` switches to the cross-block-product fast path when
    the factory shuffles (many distinct code identities); pass ``"direct"``
    to force bit-compatible per-code worker products or ``"cross"`` to force
    the shared stack.
    """
    rng = np.random.default_rng(seed)
    codes, orders = [], []
    for _ in range(trials):
        code = code_factory(rng)
        trace = simulate_completion(rng, code.N, model=completion_model,
                                    **completion_kw)
        codes.append(code)
        orders.append(np.asarray(trace.order))
    N = codes[0].N
    groups: dict = {}
    for t, code in enumerate(codes):
        groups.setdefault(code.cache_key(), (code, []))[1].append(t)
    if products == "auto":
        products = "cross" if len(groups) > 4 else "direct"
    problem = ProblemContext.build(A, B, codes[0].K)
    acc = [np.zeros(N), np.zeros(N), np.zeros(N)]
    cnt = np.zeros(N, dtype=int)
    for code, idx in groups.values():
        engine = SimulationEngine(code, A, B, beta_mode=beta_mode,
                                  backend=backend, norms=norms,
                                  products=products, device=device,
                                  problem=problem)
        cur = engine.run_batch(np.stack([orders[t] for t in idx]), ms=ms)
        _accumulate(acc, cnt, cur)
    return _finalize_average(N, acc, cnt)


# ---------------------------------------------------------------------------
# reference (pre-engine) implementations — equivalence tests + speedup bench
# ---------------------------------------------------------------------------

def run_trace_reference(code: CDCCode, A: np.ndarray, B: np.ndarray,
                        trace: CompletionTrace, *, beta_mode: str = "one",
                        ms=None) -> ErrorCurves:
    """The seed repo's per-trial loop, kept verbatim as ground truth."""
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    C = A @ B
    norm = float(np.linalg.norm(C) ** 2)
    A_blocks, B_blocks = split_contraction(A, B, code.K)
    oracle = code.oracle_context(A_blocks, B_blocks)
    products = code.run_workers(A, B)
    out = ErrorCurves.empty(code.N)
    ms = out.ms if ms is None else np.asarray(ms)
    for m in ms:
        m = int(m)
        est = code.decode(products, trace.order, m, beta_mode, oracle)
        ideal = code.ideal_estimate(trace.order, m, A_blocks, B_blocks,
                                    beta_mode, oracle)
        i = m - 1
        if ideal is not None:
            out.approx[i] = np.linalg.norm(C - ideal) ** 2 / norm
        if est is not None:
            out.total[i] = np.linalg.norm(C - est) ** 2 / norm
        if est is not None and ideal is not None:
            out.comp[i] = np.linalg.norm(ideal - est) ** 2 / norm
    return out


def average_curves_reference(code_factory, A, B, *, trials: int = 100,
                             seed: int = 0, beta_mode: str = "one",
                             completion_model: str = "uniform", ms=None,
                             **completion_kw) -> ErrorCurves:
    """The seed repo's trial loop, kept verbatim as ground truth."""
    rng = np.random.default_rng(seed)
    acc = None
    N = None
    for _ in range(trials):
        code = code_factory(rng)
        N = code.N
        trace = simulate_completion(rng, code.N, model=completion_model,
                                    **completion_kw)
        cur = run_trace_reference(code, A, B, trace, beta_mode=beta_mode,
                                  ms=ms)
        if acc is None:
            acc = [np.zeros(N), np.zeros(N), np.zeros(N), np.zeros(N, int)]
        for j, arr in enumerate((cur.total, cur.approx, cur.comp)):
            ok = ~np.isnan(arr)
            acc[j][ok] += arr[ok]
        acc[3] += (~np.isnan(cur.total)).astype(int)
    ms_axis = np.arange(1, N + 1)

    def _avg(v, cnt):
        out = np.full(N, np.nan)
        nz = cnt > 0
        out[nz] = v[nz] / cnt[nz]
        return out

    return ErrorCurves(ms_axis, _avg(acc[0], acc[3]), _avg(acc[1], acc[3]),
                       _avg(acc[2], acc[3]))


# ---------------------------------------------------------------------------
# problem generators (paper §V)
# ---------------------------------------------------------------------------

def random_problem(rng: np.random.Generator, Nx: int = 100, Nz: int = 8000,
                   Ny: int = 100):
    """The paper's workload: i.i.d. N(0,1) entries, 100×8000 @ 8000×100."""
    A = rng.standard_normal((Nx, Nz))
    B = rng.standard_normal((Nz, Ny))
    return A, B


def correlated_problem(rng: np.random.Generator, lam: float, K: int,
                       Nx: int = 100, Nz: int = 8000, Ny: int = 100):
    """§V-B correlation model: ``A_i = λ A^(0) + A_i^(1)`` blockwise."""
    bz = Nz // K
    A0 = rng.standard_normal((Nx, bz))
    B0 = rng.standard_normal((bz, Ny))
    A = np.concatenate([lam * A0 + rng.standard_normal((Nx, bz))
                        for _ in range(K)], axis=1)
    B = np.concatenate([lam * B0 + rng.standard_normal((bz, Ny))
                        for _ in range(K)], axis=0)
    return A, B
