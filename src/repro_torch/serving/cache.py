"""Decode-weight LRU cache for the serving runtime.

The scattered pre-β weight vector at a decode state is a pure function of
``(code identity, set of completions the decode reads, support size)`` —
completion *order* only permutes the solve, not its solution.  Requests that
hit the same straggler pattern therefore share one Vandermonde solve: the
cache stores ``(w_full, info)`` with ``w_full`` a host numpy vector indexed
by *worker id* (order-invariant) and β applied downstream.

Keys: ``(code.cache_key(), frozenset(completed), m, beta_mode)`` where
``completed`` is the ``decode_support(m)``-prefix the decode actually reads
and ``m`` its length.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..core.codes.base import CDCCode, DecodeInfo

__all__ = ["DecodeWeightCache"]


class DecodeWeightCache:
    """LRU map from decode state to ``(scattered pre-β weights, DecodeInfo)``.

    One instance is shared service-wide (all requests, all codes — the
    code's ``cache_key()`` disambiguates).  A hit skips the solve entirely.
    """

    def __init__(self, maxsize: int = 1024):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._od: OrderedDict[tuple, tuple[np.ndarray, DecodeInfo]] = \
            OrderedDict()

    @staticmethod
    def key(code: CDCCode, completed: np.ndarray, m: int,
            beta_mode: str) -> tuple:
        """The canonical key for a decode state.

        ``completed`` must be the support prefix the decode reads (length
        ``code.decode_support(m)``).
        """
        return (code.cache_key(),
                frozenset(int(n) for n in np.asarray(completed)),
                int(m), beta_mode)

    def get(self, key: tuple):
        hit = self._od.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._od.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key: tuple, value: tuple[np.ndarray, DecodeInfo]) -> None:
        self._od[key] = value
        self._od.move_to_end(key)
        while len(self._od) > self.maxsize:
            self._od.popitem(last=False)

    def __len__(self) -> int:
        return len(self._od)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"size": len(self), "maxsize": self.maxsize,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate}
