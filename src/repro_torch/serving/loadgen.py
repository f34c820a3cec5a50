"""Open-loop multi-tenant load generation for the serving runtime.

Closed-loop benchmarks (dispatch the next batch when the last resolves)
can never show queueing collapse — the arrival rate implicitly tracks the
service rate.  This module generates *open-loop* traffic: timestamped
arrivals drawn from a configurable process, split across tenants, each
tenant a :class:`TenantSpec` carrying its own request class (rows / inner
/ dtype), accuracy SLO (``target_error`` — the relative error at which the
anytime estimate is good enough) and latency SLO (``deadline`` seconds
from arrival).  :meth:`~repro_torch.serving.master.MasterScheduler.run_open`
consumes the workload, interleaving admissions with completions on the
merged event stream; :func:`summarize_load` turns the results into the
traffic-shaped metrics every perf PR should quote — per-tenant p99
time-to-target-accuracy and goodput (SLO hits per second) at a fixed
offered load.

Arrival processes (all deterministic given the generator):

* ``poisson`` — homogeneous Poisson: i.i.d. exponential gaps at ``rate``.
* ``bursty`` — a two-state MMPP (Markov-modulated Poisson): exponential
  dwells alternate between a quiet state and a burst state whose rate is
  ``burst`` times higher, with the *time-average* rate pinned to ``rate``
  — same offered load as ``poisson``, much heavier queue tails.
* ``trace`` — replay an explicit timestamp list (optionally rescaled to a
  target rate), for feeding recorded production arrival patterns through
  the same harness.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ioutil import write_json_atomic
from ..names import unknown_name

__all__ = ["ARRIVAL_PROCESSES", "TenantSpec", "OpenRequest",
           "poisson_arrivals", "bursty_arrivals", "trace_arrivals",
           "make_arrivals", "build_workload", "LoadReport", "run_load",
           "summarize_load"]

ARRIVAL_PROCESSES = ("poisson", "bursty", "trace")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's request class and SLOs.

    ``target_error`` is the accuracy SLO: the serving loop may stop
    refining a request once its relative error reaches it (``None``: serve
    to exactness).  ``deadline`` is the latency SLO in seconds from
    arrival (``None``: no latency SLO).  ``weight`` is the tenant's share
    of the total offered load.
    """

    name: str
    rows: int = 32
    inner: int = 128
    dtype: str = "float64"
    target_error: float | None = 1e-2
    deadline: float | None = 2.0
    weight: float = 1.0

    def __post_init__(self):
        if self.rows < 1 or self.inner < 1:
            raise ValueError(f"tenant {self.name!r}: rows/inner must be "
                             f">= 1, got {self.rows}x{self.inner}")
        if self.target_error is not None and self.target_error <= 0:
            raise ValueError(f"tenant {self.name!r}: target_error must be "
                             f"> 0, got {self.target_error}")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(f"tenant {self.name!r}: deadline must be > 0, "
                             f"got {self.deadline}")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0, "
                             f"got {self.weight}")


@dataclass(frozen=True)
class OpenRequest:
    """One timestamped arrival: operands plus the tenant that sent it."""

    arrival: float
    A: np.ndarray
    B: np.ndarray
    tenant: TenantSpec | None = None


# ---------------------------------------------------------------- arrivals
def poisson_arrivals(rng: np.random.Generator, rate: float,
                     horizon: float) -> np.ndarray:
    """Homogeneous Poisson arrival instants on ``[0, horizon)``."""
    _check_load(rate, horizon)
    ts = []
    t = rng.exponential(1.0 / rate)
    while t < horizon:
        ts.append(t)
        t += rng.exponential(1.0 / rate)
    return np.asarray(ts, dtype=np.float64)


def bursty_arrivals(rng: np.random.Generator, rate: float, horizon: float,
                    *, burst: float = 4.0,
                    dwell: float = 1.0) -> np.ndarray:
    """Two-state MMPP with time-average ``rate``.

    The chain alternates (exponential dwells of mean ``dwell``) between a
    quiet state at rate ``r0`` and a burst state at ``burst * r0``, with
    ``r0`` chosen so equal expected occupancy averages to ``rate`` — the
    offered load matches :func:`poisson_arrivals`, but arrivals clump.
    """
    _check_load(rate, horizon)
    if burst < 1.0:
        raise ValueError(f"burst factor must be >= 1, got {burst}")
    if dwell <= 0.0:
        raise ValueError(f"dwell must be > 0, got {dwell}")
    r0 = 2.0 * rate / (1.0 + burst)
    rates = (r0, burst * r0)
    ts: list[float] = []
    t0, state = 0.0, 0
    while t0 < horizon:
        end = min(t0 + rng.exponential(dwell), horizon)
        t = t0 + rng.exponential(1.0 / rates[state])
        while t < end:
            ts.append(t)
            t += rng.exponential(1.0 / rates[state])
        t0, state = end, 1 - state
    return np.asarray(ts, dtype=np.float64)


def trace_arrivals(rng: np.random.Generator, rate: float | None,
                   horizon: float | None, *, times) -> np.ndarray:
    """Replay an explicit arrival-instant list (sorted, origin-shifted).

    When ``rate`` is given the time axis is rescaled so the trace offers
    exactly that load; ``horizon`` (if given) then clips the tail.  The
    ``rng`` is unused — the signature matches the other processes so
    :func:`make_arrivals` can treat every process uniformly.
    """
    ts = np.sort(np.asarray(list(times), dtype=np.float64))
    if ts.size == 0:
        return ts
    ts = ts - ts[0]
    if rate is not None and ts.size > 1 and ts[-1] > 0:
        span = ts.size / float(rate)       # span carrying `size` arrivals
        ts = ts * (span / ts[-1])
    if horizon is not None:
        ts = ts[ts < horizon]
    return ts


_PROCESSES = {"poisson": poisson_arrivals, "bursty": bursty_arrivals,
              "trace": trace_arrivals}


def make_arrivals(process: str, rng: np.random.Generator, rate: float,
                  horizon: float, **kw) -> np.ndarray:
    """Arrival instants from a named process (see ``ARRIVAL_PROCESSES``)."""
    try:
        fn = _PROCESSES[process]
    except KeyError:
        raise unknown_name("arrival process", process,
                           ARRIVAL_PROCESSES) from None
    return fn(rng, rate, horizon, **kw)


def _check_load(rate: float, horizon: float) -> None:
    if rate <= 0:
        raise ValueError(f"offered rate must be > 0, got {rate}")
    if horizon <= 0:
        raise ValueError(f"horizon must be > 0, got {horizon}")


# ---------------------------------------------------------------- workload
def build_workload(tenants, *, rate: float, horizon: float,
                   process: str = "poisson", seed: int = 0,
                   operand_pool: int = 4,
                   process_kw: dict | None = None) -> list[OpenRequest]:
    """Timestamped multi-tenant workload at total offered load ``rate``.

    Each tenant draws its own arrival stream at ``rate * weight / Σweight``
    from an independent child generator (deterministic in ``seed``), plus a
    small pool of ``operand_pool`` operand pairs reused round-robin — the
    load harness measures queueing, not operand entropy, and the pool keeps
    workload construction O(pool) in memory per tenant.  Streams merge
    sorted by arrival instant (ties by tenant name: workload order must be
    deterministic for replays to be).
    """
    tenants = list(tenants)
    if not tenants:
        raise ValueError("need at least one tenant")
    if operand_pool < 1:
        raise ValueError(f"operand_pool must be >= 1, got {operand_pool}")
    total_w = sum(t.weight for t in tenants)
    reqs: list[OpenRequest] = []
    for idx, ten in enumerate(tenants):
        rng = np.random.default_rng([seed, idx])
        ts = make_arrivals(process, rng, rate * ten.weight / total_w,
                           horizon, **(process_kw or {}))
        dt = np.dtype(ten.dtype)
        pool = [(rng.standard_normal((ten.rows, ten.inner)).astype(dt),
                 rng.standard_normal((ten.inner, ten.rows)).astype(dt))
                for _ in range(operand_pool)]
        for j, t in enumerate(ts):
            A, B = pool[j % operand_pool]
            reqs.append(OpenRequest(float(t), A, B, tenant=ten))
    reqs.sort(key=lambda r: (r.arrival,
                             r.tenant.name if r.tenant else ""))
    return reqs


# ----------------------------------------------------------------- reports
@dataclass
class LoadReport:
    """Traffic-shaped serving metrics from one open-loop run.

    ``tenants`` maps tenant name → per-tenant stats (offered / served /
    shed / dropped counts, SLO hits and misses, goodput in SLO hits per
    second, p50/p99 time-to-target-accuracy).  TTAs censor at the
    request's sojourn when the target was never reached — a lower bound,
    so overload shows up as the queueing delay it is rather than vanishing
    from the percentile.
    """

    horizon: float
    offered: int
    served: int
    shed: int
    dropped: int
    p99_tta: float | None
    goodput: float
    tenants: dict = field(default_factory=dict)
    queue: dict = field(default_factory=dict)
    burn: dict | None = None   # BurnRateTracker.to_dict() when tracked

    def to_dict(self) -> dict:
        out = {"kind": "load-report", "horizon": self.horizon,
               "offered": self.offered, "served": self.served,
               "shed": self.shed, "dropped": self.dropped,
               "p99_tta": self.p99_tta, "goodput": self.goodput,
               "tenants": self.tenants, "queue": self.queue}
        if self.burn is not None:
            out["burn"] = self.burn
        return out

    def save(self, path: str) -> str:
        return write_json_atomic(path, self.to_dict(), indent=2)


def _tta_samples(results) -> list[float]:
    """Per-request TTA, censored at the sojourn when never reached."""
    out = []
    for res in results:
        if res.t_target is not None:
            out.append(res.t_target - res.arrival)
        elif res.t_done is not None:
            out.append(res.t_done - res.arrival)
    return out


def _pct(samples: list[float], q: float) -> float | None:
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


def summarize_load(sched, workload, results, *, horizon: float,
                   burn=None) -> LoadReport:
    """Aggregate one :meth:`MasterScheduler.run_open` pass into a report."""
    horizon = float(horizon)
    if horizon <= 0:
        raise ValueError(f"horizon must be > 0, got {horizon}")
    by_tenant: dict[str, dict] = {}
    names = []
    for r in workload:
        label = getattr(r.tenant, "name", r.tenant) or "default"
        if label not in by_tenant:
            names.append(label)
            by_tenant[label] = {"offered": 0, "served": 0, "shed": 0,
                                "dropped": 0, "slo_hits": 0,
                                "slo_misses": 0, "results": []}
        by_tenant[label]["offered"] += 1
    for res in results:
        label = res.tenant or "default"
        t = by_tenant.setdefault(
            label, {"offered": 0, "served": 0, "shed": 0, "dropped": 0,
                    "slo_hits": 0, "slo_misses": 0, "results": []})
        t["results"].append(res)
        if res.dropped is not None:
            t["dropped"] += 1
        else:
            t["served"] += 1
        if res.slo_ok is True:
            t["slo_hits"] += 1
        elif res.slo_ok is False:
            t["slo_misses"] += 1
    for label, _arrival in sched.shed:
        if label in by_tenant:
            by_tenant[label]["shed"] += 1
    tenants = {}
    for label in sorted(by_tenant):
        t = by_tenant[label]
        ttas = _tta_samples(t.pop("results"))
        tenants[label] = dict(t, goodput=t["slo_hits"] / horizon,
                              p50_tta=_pct(ttas, 50), p99_tta=_pct(ttas, 99))
    all_ttas = _tta_samples(results)
    hits = sum(t["slo_hits"] for t in tenants.values())
    depths = [d for _, d in sched.depth_series]
    queue = {"max_depth": max(depths) if depths else 0,
             "mean_depth": float(np.mean(depths)) if depths else 0.0,
             "samples": len(depths)}
    return LoadReport(horizon=horizon, offered=len(list(workload)),
                      served=sum(t["served"] for t in tenants.values()),
                      shed=len(sched.shed),
                      dropped=sum(t["dropped"] for t in tenants.values()),
                      p99_tta=_pct(all_ttas, 99), goodput=hits / horizon,
                      tenants=tenants, queue=queue,
                      burn=(burn.to_dict()
                            if getattr(burn, "enabled", False) else None))


def run_load(sched, workload, *, horizon: float,
             realtime: bool | None = None, burn=None) -> LoadReport:
    """Drive one workload through ``sched.run_open`` and summarize it."""
    results = sched.run_open(workload, realtime=realtime)
    return summarize_load(sched, workload, results, horizon=horizon,
                          burn=burn)
