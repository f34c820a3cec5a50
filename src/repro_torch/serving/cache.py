"""Decode-weight LRU cache for the serving runtime.

The scattered pre-β weight vector at a decode state is a pure function of
``(code identity, set of completions the decode reads, support size)`` —
completion *order* only permutes the solve, not its solution.  Requests that
hit the same straggler pattern therefore share one Vandermonde solve: the
cache stores ``(w_full, info)`` with ``w_full`` indexed by *worker id*
(order-invariant) and β applied downstream (β can depend on the request's
data through the oracle, so it must not be baked into the cached value).

Keys follow the serving design: ``(code.cache_key(), frozenset(completed),
m, beta_mode)`` where ``completed`` is the ``decode_support(m)``-prefix the
decode actually reads and ``m`` its length — states that share weights share
keys (every m ≥ R maps to the same entry).

Per-request-class budgets (the ROADMAP open item): a high-rate request class
can monopolize a shared LRU and evict every other class's warm weights.
``class_budget`` / ``class_budgets`` give a :class:`RequestClass` its own
sub-LRU of bounded size; classes without a budget fall back to the shared
LRU.  :meth:`for_class` returns the class-scoped view the scheduler hands
to decoders — hits and misses are attributed per class either way, so the
serve report can show who is actually reusing solves.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..core.codes.base import CDCCode, DecodeInfo
from ..obs import Counter

__all__ = ["DecodeWeightCache"]


class DecodeWeightCache:
    """LRU map from decode state to ``(scattered pre-β weights, DecodeInfo)``.

    One instance is shared service-wide (all requests, all codes — the code's
    ``cache_key()`` disambiguates).  A hit skips the Vandermonde solve
    entirely; the weights are mathematically identical to a fresh solve and
    numerically within solver noise (~ε·κ(V)) of it when the hitting
    request's completion order differs from the one that populated the entry.

    ``class_budget`` gives *every* request class its own sub-LRU of that
    size; ``class_budgets`` (a ``{RequestClass: size}`` map) assigns them
    explicitly, with unlisted classes sharing the main LRU.  The shared
    ``maxsize`` bounds only the shared entries — total capacity is
    ``maxsize + sum(budgets in use)``.  ``track_classes`` enables per-class
    hit/miss attribution without any sub-budgets.
    """

    def __init__(self, maxsize: int = 1024, *, class_budget: int | None = None,
                 class_budgets: dict | None = None,
                 track_classes: bool = False, metrics=None):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        if class_budget is not None and class_budget < 1:
            raise ValueError("class_budget must be >= 1")
        self.maxsize = maxsize
        self.class_budget = class_budget
        self.class_budgets = dict(class_budgets or {})
        if any(b < 1 for b in self.class_budgets.values()):
            raise ValueError("every class budget must be >= 1")
        self.track_classes = bool(track_classes)
        # hit/miss live in obs counters: with a registry they surface as
        # ``cache.*`` in its snapshot, without one they are free-standing —
        # either way ``cache.hits`` stays a plain int for callers
        reg = metrics if (metrics is not None
                          and getattr(metrics, "enabled", False)) else None
        self._metrics = reg
        self._hits = reg.counter("cache.hits") if reg else Counter()
        self._misses = reg.counter("cache.misses") if reg else Counter()
        self._od: OrderedDict[tuple, tuple[np.ndarray, DecodeInfo]] = \
            OrderedDict()
        self._class_od: dict = {}          # cls -> its budgeted OrderedDict
        self._class_stats: dict = {}       # cls -> hit/miss Counter pair

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    # ----------------------------------------------------------- class views
    @property
    def wants_classes(self) -> bool:
        """Should the scheduler bother computing a request class per batch?"""
        return (self.track_classes or self.class_budget is not None
                or bool(self.class_budgets))

    def budget_for(self, cls) -> int | None:
        """The sub-LRU size of ``cls`` (``None``: shared-LRU fallback)."""
        if cls in self.class_budgets:
            return self.class_budgets[cls]
        return self.class_budget

    def for_class(self, cls) -> "DecodeWeightCache | _ClassCacheView":
        """A get/put view attributing traffic (and budget) to ``cls``.

        ``None`` (or a cache with no class features) returns the cache
        itself — the zero-overhead shared path the decoders always used.
        """
        if cls is None or not self.wants_classes:
            return self
        return _ClassCacheView(self, cls)

    # -------------------------------------------------------------- keyspace
    @staticmethod
    def key(code: CDCCode, completed: np.ndarray, m: int,
            beta_mode: str) -> tuple:
        """The canonical key for a decode state.

        ``completed`` must be the support prefix the decode reads (length
        ``code.decode_support(m)``) — the caller passes exactly what it will
        hand to the solve.
        """
        return (code.cache_key(),
                frozenset(int(n) for n in np.asarray(completed)),
                int(m), beta_mode)

    # ------------------------------------------------------------ operations
    def _stats_for(self, cls) -> dict:
        if cls not in self._class_stats:
            reg = self._metrics
            if reg is not None:
                label = getattr(cls, "label", lambda: str(cls))()
                pair = {"hits": reg.counter(f"cache.{label}.hits"),
                        "misses": reg.counter(f"cache.{label}.misses")}
            else:
                pair = {"hits": Counter(), "misses": Counter()}
            self._class_stats[cls] = pair
        return self._class_stats[cls]

    def _route(self, cls) -> OrderedDict:
        """The OrderedDict ``cls`` lives in (its sub-LRU or the shared one)."""
        if cls is None or self.budget_for(cls) is None:
            return self._od
        if cls not in self._class_od:
            self._class_od[cls] = OrderedDict()
        return self._class_od[cls]

    def _get(self, key: tuple, cls=None):
        od = self._route(cls)
        hit = od.get(key)
        st = self._stats_for(cls) if cls is not None else None
        if hit is None:
            self._misses.inc()
            if st is not None:
                st["misses"].inc()
            return None
        od.move_to_end(key)
        self._hits.inc()
        if st is not None:
            st["hits"].inc()
        return hit

    def _put(self, key: tuple, value: tuple[np.ndarray, DecodeInfo],
             cls=None) -> None:
        od = self._route(cls)
        cap = self.maxsize if od is self._od else self.budget_for(cls)
        od[key] = value
        od.move_to_end(key)
        while len(od) > cap:
            od.popitem(last=False)

    # back-compat shared-path surface (decoders without a class view)
    def get(self, key: tuple):
        return self._get(key, None)

    def put(self, key: tuple, value: tuple[np.ndarray, DecodeInfo]) -> None:
        self._put(key, value, None)

    # --------------------------------------------------------------- metrics
    def __len__(self) -> int:
        return len(self._od) + sum(len(od) for od in self._class_od.values())

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def class_stats(self) -> dict:
        """Per-class traffic: ``{class: {hits, misses, hit_rate, size,
        budget}}`` (``size``/``budget`` only for budgeted classes; shared
        fallback classes report ``budget: None``)."""
        out = {}
        for cls, st in self._class_stats.items():
            hits, misses = st["hits"].value, st["misses"].value
            total = hits + misses
            entry = {"hits": hits, "misses": misses,
                     "hit_rate": hits / total if total else 0.0,
                     "budget": self.budget_for(cls)}
            if cls in self._class_od:
                entry["size"] = len(self._class_od[cls])
            out[cls] = entry
        return out

    def stats(self) -> dict:
        out = {"size": len(self), "maxsize": self.maxsize,
               "hits": self.hits, "misses": self.misses,
               "hit_rate": self.hit_rate}
        if self._class_stats:
            out["classes"] = self.class_stats()
        return out


class _ClassCacheView:
    """Decoder-facing get/put bound to one request class."""

    __slots__ = ("_cache", "_cls")

    def __init__(self, cache: DecodeWeightCache, cls):
        self._cache = cache
        self._cls = cls

    def get(self, key: tuple):
        return self._cache._get(key, self._cls)

    def put(self, key: tuple, value) -> None:
        self._cache._put(key, value, self._cls)
