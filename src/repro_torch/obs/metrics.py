"""Metrics registry: named counters, gauges, histograms; cheap when off.

Design constraints (the serving event loop is the caller):

* **Off-the-hot-path when disabled.**  A disabled registry returns one
  shared no-op instrument for every name — recording costs a single
  attribute call and nothing allocates per event.  Call sites that would
  pay even to *compute* an observation (e.g. a ``perf_counter`` pair
  around the decode tick) can skip it entirely by checking
  :attr:`MetricsRegistry.enabled`.
* **No locks on the fast path.**  Instruments mutate plain attributes /
  preallocated bucket lists; CPython's atomic int ops are enough for the
  single-writer event loop (worker processes never touch the registry —
  they report timings on the result message instead).
* **One instrument per name.**  Repeated ``counter("pool.crashed")`` calls
  return the same object, so independent layers (pool, transport, backend)
  can share a registry without wiring instruments through constructors.

Snapshots serialize through :func:`repro_torch.ioutil.write_json_atomic` — the
same durable-artifact path every other JSON artifact in the repo uses.
"""
from __future__ import annotations

import bisect

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NULL_REGISTRY", "DEFAULT_BUCKETS"]

# seconds-scale latency buckets: micro-tick costs through multi-second TTAs
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0)


class Counter:
    """Monotone-up event count (negative ``inc`` allowed for the one
    reclassification case: re-queued shards un-count ``shards_lost``)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_value(self):
        return self.value


class Gauge:
    """Last-written level (queue depth, live operand handles)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def to_value(self):
        return self.value


class Histogram:
    """Bucketed distribution with preallocated counts (no per-observe
    allocation).  ``buckets`` are upper bounds; one overflow bucket is
    implicit.  The snapshot carries count/total/min/max plus the
    cumulative bucket counts, enough for p50/p99 estimates downstream."""

    __slots__ = ("buckets", "counts", "count", "total", "min", "max")
    kind = "histogram"

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def quantile(self, q: float) -> float | None:
        """Bucket-interpolated quantile estimate (``None`` when empty).

        Observations inside a bucket are assumed uniform: the target rank
        interpolates linearly between the bucket's bounds.  The first
        bucket's lower bound is the observed ``min`` (no negative-latency
        estimates) and the overflow bucket is pinned to ``[last bound,
        max]`` — so on data narrower than the grid the estimate collapses
        toward the true order statistics instead of a bucket edge.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = q * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            if cum + n >= rank:
                lo = self.buckets[i - 1] if i > 0 else self.min
                hi = self.buckets[i] if i < len(self.buckets) else self.max
                lo = max(lo, self.min) if self.min is not None else lo
                hi = min(hi, self.max) if self.max is not None else hi
                if hi < lo:
                    hi = lo
                frac = (rank - cum) / n
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            cum += n
        return self.max

    def to_value(self):
        return {"count": self.count, "total": self.total,
                "mean": self.total / self.count if self.count else 0.0,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99),
                "buckets": list(self.buckets), "counts": list(self.counts)}


class _NullInstrument:
    """The shared do-nothing instrument a disabled registry hands out."""

    __slots__ = ()
    kind = "null"
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL = _NullInstrument()


class MetricsRegistry:
    """Name → instrument map with a JSON snapshot.

    ``enabled=False`` (or the module-level :data:`NULL_REGISTRY`) makes
    every factory return the shared no-op instrument — call sites keep
    their instrument handles unconditionally and the disabled cost is one
    no-op method call per event.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._instruments: dict[str, object] = {}

    def _make(self, name: str, factory, kind: str):
        if not self.enabled:
            return _NULL
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = factory()
        elif inst.kind != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{inst.kind}, requested {kind}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._make(name, Counter, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._make(name, Gauge, "gauge")

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._make(name, lambda: Histogram(buckets), "histogram")

    def snapshot(self) -> dict:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            out[inst.kind + "s"][name] = inst.to_value()
        return out

    def save(self, path: str) -> str:
        """Atomic JSON snapshot (safe against mid-dump crashes)."""
        from ..ioutil import write_json_atomic
        return write_json_atomic(path, {"kind": "metrics-snapshot",
                                        **self.snapshot()}, indent=2)


NULL_REGISTRY = MetricsRegistry(enabled=False)
