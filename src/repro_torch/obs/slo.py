"""Per-tenant SLO error-budget and burn-rate tracking.

The scheduler counts `serve.slo_hit/miss.<tenant>` but never answers the paging
question: *is this tenant currently burning its error budget fast enough
to exhaust it?*  This module implements the standard multi-window
burn-rate alert (the 1x/6x pattern from the SRE workbook): with an
objective of, say, 90% of requests meeting their SLO, the error budget is
the allowed 10% miss fraction, and the *burn rate* over a window is

    burn = miss_fraction(window) / budget

so burn == 1.0 means "missing at exactly the sustainable rate" and
burn == 6.0 means "the whole budget gone in window/6".  An alert fires
only when **both** a long window and a short window (long/6) exceed the
threshold — the long window keeps a transient blip from paging, the
short window makes the alert *reset* quickly once the cause is fixed.
Hysteresis on clear (both windows below ``threshold * clear_frac``)
prevents flapping at the boundary.

The tracker is fed inline by the scheduler's existing `_slo_count`
call sites (one `observe()` per finished/dropped request, stamped with
the serving-clock time), so it follows the same virtual/wall clock
discipline as the sampler.  Alerts are appended to `.alerts`, stamped
into the Tracer as run-relative milestones, recorded in the flight
recorder, and exported as `slo.burn_*` gauges so the time-series sampler
picks the burn trajectory up for free.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from .flight import NULL_FLIGHT
from .metrics import NULL_REGISTRY
from .trace import NULL_TRACER

__all__ = ["BurnAlert", "BurnRateTracker", "NULL_BURN"]

# short window = long window / this factor (the "1x/6x" pattern)
SHORT_FACTOR = 6.0


@dataclass(frozen=True)
class BurnAlert:
    """One transition of a tenant's burn-rate alert state."""

    tenant: str
    t: float                  # serving-clock time of the transition
    kind: str                 # "fire" | "clear"
    burn_short: float
    burn_long: float
    budget_remaining: float   # fraction of long-window budget left (>= 0)

    def to_dict(self) -> dict:
        return {"tenant": self.tenant, "t": self.t, "kind": self.kind,
                "burn_short": self.burn_short, "burn_long": self.burn_long,
                "budget_remaining": self.budget_remaining}


class BurnRateTracker:
    """Multi-window per-tenant burn-rate alerting over SLO hit/miss events.

    ``objective`` is the target hit fraction (0.9 → 10% error budget);
    ``window`` is the long window in serving-clock seconds (short window
    is ``window / 6``); an alert fires when burn in *both* windows is
    >= ``threshold`` and clears when both drop below
    ``threshold * clear_frac``.
    """

    enabled = True

    def __init__(self, *, objective: float = 0.9, window: float = 30.0,
                 threshold: float = 1.0, clear_frac: float = 0.5,
                 min_events: int = 10, metrics=NULL_REGISTRY,
                 tracer=NULL_TRACER, flight=NULL_FLIGHT):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.window = float(window)
        self.window_short = self.window / SHORT_FACTOR
        self.threshold = float(threshold)
        self.clear_frac = float(clear_frac)
        # a lone miss is 100% miss fraction over any window; require a
        # minimum long-window sample before an alert may fire
        self.min_events = int(min_events)
        self.metrics = metrics
        self.tracer = tracer
        self.flight = flight
        self._events: dict[str, deque] = {}   # tenant -> deque[(t, hit)]
        self._firing: dict[str, bool] = {}
        self.alerts: list[BurnAlert] = []

    # ------------------------------------------------------------------ feed
    def observe(self, tenant: str, hit: bool, t: float) -> BurnAlert | None:
        """Record one request outcome at serving-clock time ``t``.

        Returns the :class:`BurnAlert` if this observation transitioned the
        tenant's alert state, else ``None``.
        """
        tenant = tenant or "default"
        ev = self._events.setdefault(tenant, deque())
        ev.append((float(t), bool(hit)))
        cutoff = t - self.window
        while ev and ev[0][0] < cutoff:
            ev.popleft()

        burn_long, remaining = self._burn(ev, t, self.window)
        burn_short, _ = self._burn(ev, t, self.window_short)

        self.metrics.gauge(f"slo.burn_long.{tenant}").set(burn_long)
        self.metrics.gauge(f"slo.burn_short.{tenant}").set(burn_short)
        self.metrics.gauge(f"slo.budget_remaining.{tenant}").set(remaining)

        firing = self._firing.get(tenant, False)
        if not firing and len(ev) >= self.min_events \
                and burn_long >= self.threshold \
                and burn_short >= self.threshold:
            return self._transition(tenant, t, "fire", burn_short,
                                    burn_long, remaining)
        clear_at = self.threshold * self.clear_frac
        if firing and burn_long < clear_at and burn_short < clear_at:
            return self._transition(tenant, t, "clear", burn_short,
                                    burn_long, remaining)
        return None

    def _burn(self, ev: deque, t: float, window: float):
        """(burn rate, budget fraction remaining) over the trailing window."""
        cutoff = t - window
        total = misses = 0
        for et, hit in ev:
            if et >= cutoff:
                total += 1
                if not hit:
                    misses += 1
        if total == 0:
            return 0.0, 1.0
        miss_frac = misses / total
        burn = miss_frac / self.budget
        return burn, max(0.0, 1.0 - burn)

    def _transition(self, tenant: str, t: float, kind: str,
                    burn_short: float, burn_long: float,
                    remaining: float) -> BurnAlert:
        self._firing[tenant] = kind == "fire"
        alert = BurnAlert(tenant=tenant, t=float(t), kind=kind,
                          burn_short=burn_short, burn_long=burn_long,
                          budget_remaining=remaining)
        self.alerts.append(alert)
        self.metrics.counter(f"slo.burn_alerts.{tenant}").inc()
        self.metrics.gauge(f"slo.burn_firing.{tenant}").set(
            1.0 if kind == "fire" else 0.0)
        # bid 0 anchors the milestone at the run origin, so ts == t
        self.tracer.milestone(0, f"burn-{kind}", t, tenant=tenant,
                              burn_short=round(burn_short, 4),
                              burn_long=round(burn_long, 4))
        self.flight.record("burn-alert", tenant=tenant, t=float(t),
                           transition=kind, burn_short=burn_short,
                           burn_long=burn_long)
        return alert

    # ------------------------------------------------------------ read side
    def firing(self) -> list[str]:
        """Tenants whose alert is currently in the fired state."""
        return sorted(t for t, f in self._firing.items() if f)

    def to_dict(self) -> dict:
        return {
            "kind": "burn-report",
            "objective": self.objective,
            "budget": self.budget,
            "window": self.window,
            "window_short": self.window_short,
            "threshold": self.threshold,
            "min_events": self.min_events,
            "firing": self.firing(),
            "n_alerts": len(self.alerts),
            "alerts": [a.to_dict() for a in self.alerts],
        }


class _NullBurnTracker:
    """Shared no-op tracker wired in when burn alerting is disabled."""

    enabled = False
    alerts: list = []

    def observe(self, tenant: str, hit: bool, t: float):
        return None

    def firing(self) -> list:
        return []

    def to_dict(self) -> dict:
        return {"kind": "burn-report", "firing": [], "n_alerts": 0,
                "alerts": []}


NULL_BURN = _NullBurnTracker()
