"""Incremental successive-refinement decoders, with the state on the device.

The reference keeps the ``(N, Nx, Ny)`` completion buffer and the running
sums in host numpy; here they live on the products' device, in
``promote_types(product, float64)`` (float64, or complex128 for complex
points), so a product never leaves the card between ``push`` and
``estimate``.  Decode weights are still solved on the host in float64 by the
code classes (tiny solves), moved to the device, and recombined there with
one torch einsum (:func:`recombine`).

:class:`IncrementalDecoder` maintains the running estimate event by event,
dispatching on the code's ``decode_update`` hook:

* ``"rank1"``   — cluster-mean codes below exact recovery: the new product
  enters one cluster average (two scaled adds of one ``Nx×Ny`` matrix).
* ``"none"``    — frozen regimes: the cached estimate is returned as-is.
* ``"resolve"`` — a resolution-layer boundary: one fresh solve + recombine,
  optionally skipped via the service-wide :class:`DecodeWeightCache`.

:class:`RecomputeDecoder` decodes from scratch at every call with the
*same* :func:`recombine`, so with a cold cache the incremental resolve path
is bit-identical to it inside the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..core.codes.base import CDCCode, DecodeInfo
from ..names import unknown_name
from .cache import DecodeWeightCache

__all__ = ["IncrementalDecoder", "RecomputeDecoder", "make_decoder",
           "recombine"]


def recombine(w: np.ndarray, stack: torch.Tensor) -> torch.Tensor:
    """``Σ_i w_i · stack[i]`` on the stack's device: host weights ``(p,)``
    against a ``(p, Nx, Ny)`` tensor, in their promoted dtype."""
    with obs.span("sync.recombine_weights"):  # a pageable upload: blocks
        wt = torch.as_tensor(np.asarray(w), device=stack.device)
    dt = torch.promote_types(wt.dtype, stack.dtype)
    return torch.einsum("m,mij->ij", wt.to(dt), stack.to(dt))


def _real(est: torch.Tensor) -> torch.Tensor:
    return est.real if est.is_complex() else est


class IncrementalDecoder:
    """Streaming decoder for one request: push products, read estimates.

    ``push(worker, product)`` ingests one completion; ``estimate()`` returns
    the current β-scaled estimate (or ``None`` below the first threshold).
    Each push copies the product into a completion-ordered device buffer,
    so every resolve is a contiguous ``buf[:p]`` recombine.
    """

    def __init__(self, code: CDCCode, *, beta_mode: str = "one",
                 oracle: dict | None = None,
                 cache: DecodeWeightCache | None = None):
        self.code = code
        self.beta_mode = beta_mode
        self.oracle = oracle
        self.cache = cache
        self._order = np.empty(code.N, dtype=np.int64)
        self._buf = None                 # (N, Nx, Ny) completion order
        self._m = 0
        cs = code.cluster_structure()
        self._cluster = self._alphas = self._csums = self._U = None
        self._counts = None
        if cs is not None:
            cluster, alphas = cs
            self._cluster = np.asarray(cluster)
            self._alphas = np.asarray(alphas, dtype=np.float64)
            self._counts = np.zeros(code.K, dtype=np.int64)
        self._resolved = None            # (pre-β estimate, info, weights)
        self._seen: set[int] = set()
        self.stats = {"push": 0, "rank1": 0, "resolve": 0, "reuse": 0,
                      "cache_hit": 0, "dup_ignored": 0}

    @property
    def m(self) -> int:
        """Completions ingested so far."""
        return self._m

    def push(self, worker: int, product: torch.Tensor) -> None:
        """Ingest worker ``worker``'s product as the next completion.

        Idempotent per worker: a duplicate completion is ignored.
        """
        if int(worker) in self._seen:
            self.stats["dup_ignored"] += 1
            return
        if self._m >= self.code.N:
            raise ValueError(f"all {self.code.N} workers already completed")
        self._seen.add(int(worker))
        if self._buf is None:
            dt = torch.promote_types(product.dtype, torch.float64)
            shape = tuple(product.shape)
            dev = product.device
            self._buf = torch.empty((self.code.N,) + shape, dtype=dt,
                                    device=dev)
            if self._cluster is not None:
                self._csums = torch.zeros((self.code.K,) + shape, dtype=dt,
                                          device=dev)
                self._U = torch.zeros(shape, dtype=dt, device=dev)
        self._order[self._m] = worker
        self._buf[self._m].copy_(product)
        self._m += 1
        self.stats["push"] += 1
        mode = self.code.decode_update(self._m)
        if mode == "rank1":
            self._rank1_update(int(worker), self._buf[self._m - 1])
            self.stats["rank1"] += 1
            self._resolved = None
        elif mode == "resolve":
            self._resolved = None        # boundary: cached solve is stale

    def _rank1_update(self, worker: int, product: torch.Tensor) -> None:
        """O(1) cluster-mean update of the pre-β running estimate:
        ``U += α_k P/(c_k+1) - α_k S_k / (c_k (c_k+1))``."""
        k = int(self._cluster[worker])
        c = int(self._counts[k])
        a = float(self._alphas[k])
        if c == 0:
            self._U += a * product
        else:
            self._U += (a / (c + 1.0)) * product \
                - (a / (c * (c + 1.0))) * self._csums[k]
        self._csums[k] += product
        self._counts[k] = c + 1

    def estimate(self) -> torch.Tensor | None:
        """Current β-scaled estimate of ``A @ B`` (``None`` below threshold)."""
        code, m = self.code, self._m
        if m < code.first_threshold:
            return None
        if self._cluster is not None and m < code.recovery_threshold:
            hit = self._counts > 0
            info = DecodeInfo(exact=False, m_pairs=int(hit.sum()), layer=m,
                              extra={"hit": hit})
            b = code.beta(info, m, self.beta_mode, self.oracle)
            return _real(b * self._U)
        if self._resolved is None:
            self._resolved = self._resolve(m)
        else:
            self.stats["reuse"] += 1
        pre, info, _ = self._resolved
        b = code.beta(info, m, self.beta_mode, self.oracle)
        return _real(b * pre)

    def _resolve(self, m: int):
        """Solve + recombine at a layer boundary (cache-aware)."""
        with obs.span("sac.decode.resolve"):
            code = self.code
            completed = self._order[:m]
            p = code.decode_support(m)
            key = None
            if self.cache is not None:
                key = DecodeWeightCache.key(code, completed[:p], p,
                                            self.beta_mode)
                hit = self.cache.get(key)
                if hit is not None:
                    w_full, info = hit
                    self.stats["cache_hit"] += 1
                    pre = recombine(w_full[completed[:p]], self._buf[:p])
                    return pre, info, w_full
            res = code.estimate_weights(completed, m)
            if res is None:                      # defensive; guarded above
                raise ValueError(f"no estimate at m={m} for {code.name}")
            w, info = res
            self.stats["resolve"] += 1
            pre = recombine(w, self._buf[:len(w)])
            w_full = np.zeros(code.N,
                              dtype=np.result_type(w.dtype, np.float64))
            w_full[completed[:len(w)]] = w
            if key is not None:
                self.cache.put(key, (w_full, info))
            return pre, info, w_full

    def weight_vector(self) -> np.ndarray | None:
        """β-folded scattered ``(N,)`` host decode weights at this state."""
        code, m = self.code, self._m
        if m < code.first_threshold:
            return None
        if self._cluster is not None and m < code.recovery_threshold:
            hit = self._counts > 0
            info = DecodeInfo(exact=False, m_pairs=int(hit.sum()), layer=m,
                              extra={"hit": hit})
            completed = self._order[:m]
            w_full = np.zeros(code.N)
            ks = self._cluster[completed]
            w_full[completed] = self._alphas[ks] / self._counts[ks]
        else:
            if self._resolved is None:
                self._resolved = self._resolve(m)
            _, info, w_full = self._resolved
        b = code.beta(info, m, self.beta_mode, self.oracle)
        return b * w_full


class RecomputeDecoder:
    """The per-tick-re-decode baseline: same API, from scratch every call.

    Products are kept by worker id; each ``estimate()`` solves the weights
    for the current completion prefix and recombines the gathered products
    with :func:`recombine` — the incremental resolve path's arithmetic.
    """

    def __init__(self, code: CDCCode, *, beta_mode: str = "one",
                 oracle: dict | None = None,
                 cache: DecodeWeightCache | None = None):
        self.code = code
        self.beta_mode = beta_mode
        self.oracle = oracle
        self._order = np.empty(code.N, dtype=np.int64)
        self._by_worker = None           # (N, Nx, Ny) by worker id
        self._m = 0
        self._seen: set[int] = set()
        self.stats = {"push": 0, "decode": 0, "dup_ignored": 0}

    @property
    def m(self) -> int:
        return self._m

    def push(self, worker: int, product: torch.Tensor) -> None:
        if int(worker) in self._seen:     # duplicate completion: idempotent
            self.stats["dup_ignored"] += 1
            return
        if self._m >= self.code.N:
            raise ValueError(f"all {self.code.N} workers already completed")
        self._seen.add(int(worker))
        if self._by_worker is None:
            dt = torch.promote_types(product.dtype, torch.float64)
            self._by_worker = torch.zeros((self.code.N,)
                                          + tuple(product.shape), dtype=dt,
                                          device=product.device)
        self._order[self._m] = worker
        self._by_worker[worker].copy_(product)
        self._m += 1
        self.stats["push"] += 1

    def estimate(self) -> torch.Tensor | None:
        if self._m < self.code.first_threshold:
            return None
        self.stats["decode"] += 1
        completed = self._order[:self._m]
        res = self.code.estimate_weights(completed, self._m)
        if res is None:
            return None
        w, info = res
        idx = torch.as_tensor(completed[:len(w)],
                              device=self._by_worker.device)
        est = recombine(w, self._by_worker[idx])
        b = self.code.beta(info, self._m, self.beta_mode, self.oracle)
        return _real(b * est)

    def weight_vector(self) -> np.ndarray | None:
        if self._m < self.code.first_threshold:
            return None
        res = self.code.estimate_weights(self._order[:self._m], self._m)
        if res is None:
            return None
        w, info = res
        b = self.code.beta(info, self._m, self.beta_mode, self.oracle)
        full = np.zeros(self.code.N, dtype=np.result_type(w.dtype,
                                                          np.float64))
        full[self._order[:len(w)]] = b * w
        return full


def make_decoder(kind: str, code: CDCCode, **kw):
    """``"incremental"`` or ``"recompute"`` — the serving A/B seam."""
    if kind == "incremental":
        return IncrementalDecoder(code, **kw)
    if kind == "recompute":
        kw.pop("cache", None)            # the baseline never caches
        return RecomputeDecoder(code, **kw)
    raise unknown_name("decoder kind", kind, ("incremental", "recompute"))
