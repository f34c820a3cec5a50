"""Ring-buffer time-series sampler over the metrics registry.

A registry snapshot answers "what were the totals when the run ended"; a live
serve needs "what was happening two minutes ago".  The sampler closes that
gap without a collection thread: the :class:`~repro_torch.serving.master
.MasterScheduler` event loop *ticks* it as events arrive, and the sampler
records a sample only when ``interval`` has elapsed on the serving clock —
one float compare per tick on the hot path, one dict copy per interval.

Clock discipline follows the runtime's: on modeled backends the tick
timestamps are the **virtual** serve clock (batch-local event times offset
by each batch's dispatch instant), so a simulated run produces the same
series every time and costs no wall time; on the cluster backend the same
offsets are wall-clock seconds, so the series *is* wall time.  The sampler
never reads a clock itself — whoever ticks it owns the timebase.

Each sample is ``(t, counters, gauges)`` — plain name→value dicts copied
from the registry's live instruments (histograms are skipped: their value
is a distribution, not a level; the exporter serves them from the
snapshot instead).  Counter *rates* are computed at read time by
differencing adjacent samples (:meth:`TimeSeriesSampler.series`), so the
hot path never divides.  The ring (``deque(maxlen=capacity)``) bounds
memory for arbitrarily long serves; :meth:`last` feeds the flight
recorder's pre-crash window.
"""
from __future__ import annotations

from collections import deque

__all__ = ["TimeSeriesSampler", "NULL_SAMPLER"]


class TimeSeriesSampler:
    """Periodic (t, counters, gauges) samples on the serving clock.

    ``interval`` is the minimum spacing between samples in serve-clock
    seconds; ``capacity`` bounds the ring.  ``tick(t)`` is the only hot-path
    entry point and costs one comparison when the interval has not elapsed.
    """

    enabled = True

    def __init__(self, registry, interval: float = 0.25,
                 capacity: int = 512):
        if interval <= 0:
            raise ValueError(f"sample interval must be > 0, got {interval}")
        if capacity < 1:
            raise ValueError(f"sampler capacity must be >= 1, got "
                             f"{capacity}")
        self.registry = registry
        self.interval = float(interval)
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._next_t: float | None = None     # first tick always samples
        self.n_samples = 0                    # lifetime count (ring evicts)

    def __len__(self) -> int:
        return len(self._ring)

    # ------------------------------------------------------------- hot path
    def tick(self, t: float) -> bool:
        """Record a sample if ``interval`` elapsed since the last one.

        ``t`` is the current serving-clock instant (virtual on modeled
        backends, wall seconds on the cluster).  Returns ``True`` when a
        sample was recorded.  Out-of-order ticks (a new batch's early event
        after a long straggler) are simply ignored until the clock passes
        the scheduled instant again.
        """
        if self._next_t is not None and t < self._next_t:
            return False
        counters: dict[str, float] = {}
        gauges: dict[str, float] = {}
        # live instrument reads, no locking: the single-writer event loop
        # is the caller, so values are never mid-update
        for name, inst in list(self.registry._instruments.items()):
            if inst.kind == "counter":
                counters[name] = inst.value
            elif inst.kind == "gauge":
                gauges[name] = inst.value
        self._ring.append((float(t), counters, gauges))
        self.n_samples += 1
        self._next_t = float(t) + self.interval
        return True

    # ------------------------------------------------------------ read side
    def samples(self) -> list[dict]:
        """The ring as ``[{"t", "counters", "gauges"}, ...]`` (oldest first)."""
        return [{"t": t, "counters": dict(c), "gauges": dict(g)}
                for t, c, g in self._ring]

    def last(self, n: int) -> list[dict]:
        """The newest ``n`` samples (for flight-recorder dumps)."""
        ring = list(self._ring)[-int(n):]
        return [{"t": t, "counters": dict(c), "gauges": dict(g)}
                for t, c, g in ring]

    def series(self) -> dict:
        """Column-oriented view with counter rates, for scrapes/dashboards.

        ``{"kind": "timeseries", "interval", "t": [...], "gauges":
        {name: [...]}, "counters": {name: [...]}, "rates": {name: [...]}}``
        — rates are per-second first differences of each counter column
        (``rates[name][i]`` covers ``(t[i-1], t[i]]``; index 0 is 0.0), so
        per-tenant goodput is simply ``rates["serve.slo_hit.<tenant>"]``.
        Missing early values (an instrument born mid-run) backfill as 0.
        """
        ring = list(self._ring)
        ts = [t for t, _, _ in ring]
        names_c: list[str] = []
        names_g: list[str] = []
        for _, c, g in ring:
            names_c.extend(k for k in c if k not in names_c)
            names_g.extend(k for k in g if k not in names_g)
        counters = {k: [float(c.get(k, 0)) for _, c, _ in ring]
                    for k in sorted(names_c)}
        gauges = {k: [float(g.get(k, 0)) for _, _, g in ring]
                  for k in sorted(names_g)}
        rates = {}
        for k, col in counters.items():
            r = [0.0]
            for i in range(1, len(col)):
                dt = ts[i] - ts[i - 1]
                r.append((col[i] - col[i - 1]) / dt if dt > 0 else 0.0)
            rates[k] = r
        return {"kind": "timeseries", "interval": self.interval,
                "samples": len(ring), "t": ts, "counters": counters,
                "gauges": gauges, "rates": rates}

    def save(self, path: str) -> str:
        from ..ioutil import write_json_atomic
        return write_json_atomic(path, self.series(), indent=2)


class _NullSampler:
    """Shared no-op sampler: the always-wired handle when sampling is off."""

    enabled = False
    interval = 0.0
    n_samples = 0

    def __len__(self) -> int:
        return 0

    def tick(self, t: float) -> bool:
        return False

    def samples(self) -> list:
        return []

    def last(self, n: int) -> list:
        return []

    def series(self) -> dict:
        return {"kind": "timeseries", "interval": 0.0, "samples": 0,
                "t": [], "counters": {}, "gauges": {}, "rates": {}}


NULL_SAMPLER = _NullSampler()
