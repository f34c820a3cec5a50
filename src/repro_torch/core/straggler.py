"""Straggler / completion-order models (paper §V simulation protocol).

The paper shuffles the N evaluated decoding polynomials uniformly — the m-th
element is the one computed by the m-th fastest worker.  We reproduce that
(``uniform_order``) and add the shifted-exponential latency model standard in
the CDC literature [1], used by the wall-clock serving simulations and the
fault-tolerance demos.

Scenario generators beyond the i.i.d. shifted-exponential fleet (the
workloads the ``repro.design`` autotuner is built to discriminate between):

* ``heterogeneous`` — per-worker ``(shift_n, rate_n)``: a fleet with a slow
  host class (bad racks / contended VMs).  The marginal is a *mixture* of
  shifted exponentials, which a single-(shift, rate) fit cannot represent —
  the profile fitter's empirical-CDF fallback exists for exactly this.
* ``bursty`` — i.i.d. base latencies, but with probability ``burst_prob``
  *per dispatched job* a random subset of workers is slowed together
  (correlated straggling: a network incast, a co-scheduled batch job).

Every model has a single-draw and a batched ``(trials, N)`` form; the
``sample_times`` / ``sample_times_batch`` dispatchers give callers (serving
backends, profile samplers) one entry point keyed on the model name.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["uniform_order", "shifted_exp_times", "order_from_times",
           "CompletionTrace", "simulate_completion",
           "CompletionBatch", "simulate_completion_batch",
           "heterogeneous_fleet", "heterogeneous_exp_times",
           "heterogeneous_exp_times_batch", "bursty_times",
           "bursty_times_batch", "sample_times", "sample_times_batch",
           "LATENCY_MODELS", "validate_latency_kw"]


def uniform_order(rng: np.random.Generator, N: int) -> np.ndarray:
    """Uniformly random completion order: ``order[m]`` = worker finishing m-th."""
    return rng.permutation(N)


def shifted_exp_times(rng: np.random.Generator, N: int, *, shift: float = 1.0,
                      rate: float = 1.0,
                      straggler_frac: float = 0.0,
                      straggler_slowdown: float = 5.0) -> np.ndarray:
    """Per-worker completion times ``t_n = shift + Exp(rate)``.

    A fraction of workers can be made persistent stragglers (× slowdown) to
    model bad hosts — the failure mode SAC is designed to ride through.
    """
    t = shift + rng.exponential(1.0 / rate, size=N)
    if straggler_frac > 0:
        k = int(round(straggler_frac * N))
        idx = rng.choice(N, size=k, replace=False)
        t[idx] *= straggler_slowdown
    return t


def heterogeneous_fleet(N: int, *, slow_frac: float = 0.25,
                        shift: float = 1.0, rate: float = 1.0,
                        slow_shift: float = 3.0,
                        slow_rate: float = 0.3) -> tuple[np.ndarray, np.ndarray]:
    """Per-worker ``(shifts, rates)`` for a two-class fleet.

    The first ``round(slow_frac·N)`` workers are the slow class — worker
    identity is arbitrary under uniform dispatch, so deterministic placement
    keeps seeded runs reproducible without an extra rng draw.
    """
    n_slow = int(round(slow_frac * N))
    shifts = np.full(N, float(shift))
    rates = np.full(N, float(rate))
    shifts[:n_slow] = float(slow_shift)
    rates[:n_slow] = float(slow_rate)
    return shifts, rates


def heterogeneous_exp_times(rng: np.random.Generator, N: int, *,
                            shifts=None, rates=None,
                            **fleet_kw) -> np.ndarray:
    """Per-worker ``t_n = shift_n + Exp(rate_n)`` — a heterogeneous fleet.

    Pass explicit ``shifts``/``rates`` arrays, or fleet-shape keywords for
    :func:`heterogeneous_fleet` (``slow_frac``, ``slow_shift``, ...).
    """
    if shifts is None or rates is None:
        shifts, rates = heterogeneous_fleet(N, **fleet_kw)
    shifts = np.broadcast_to(np.asarray(shifts, dtype=np.float64), (N,))
    rates = np.broadcast_to(np.asarray(rates, dtype=np.float64), (N,))
    return shifts + rng.exponential(1.0 / rates)


def heterogeneous_exp_times_batch(rng: np.random.Generator, N: int,
                                  trials: int, *, shifts=None, rates=None,
                                  **fleet_kw) -> np.ndarray:
    """``(trials, N)`` stacked heterogeneous-fleet completion times."""
    if shifts is None or rates is None:
        shifts, rates = heterogeneous_fleet(N, **fleet_kw)
    shifts = np.broadcast_to(np.asarray(shifts, dtype=np.float64), (N,))
    rates = np.broadcast_to(np.asarray(rates, dtype=np.float64), (N,))
    return shifts[None, :] + rng.exponential(1.0 / rates, size=(trials, N))


def _straggler_subsets(rng: np.random.Generator, N: int, trials: int,
                       k: int) -> np.ndarray:
    """``(trials, k)`` independent uniform k-subsets of ``range(N)``.

    One batched permuted-index draw; the first k entries of a uniform
    permutation are a uniform k-subset, matching the distribution of the
    per-trial ``rng.choice(N, k, replace=False)`` loop it replaces.
    """
    perm = rng.permuted(np.broadcast_to(np.arange(N), (trials, N)), axis=1)
    return perm[:, :k]


def bursty_times(rng: np.random.Generator, N: int, *, shift: float = 1.0,
                 rate: float = 1.0, burst_prob: float = 0.15,
                 burst_frac: float = 0.4,
                 burst_slowdown: float = 8.0) -> np.ndarray:
    """Shifted-exponential times with job-level correlated straggler bursts.

    With probability ``burst_prob`` the dispatched job hits a burst: a
    uniformly random ``round(burst_frac·N)`` subset of workers is slowed by
    ``burst_slowdown`` *together* — the correlated failure mode (incast,
    co-scheduled jobs) that per-worker models miss.
    """
    t = shift + rng.exponential(1.0 / rate, size=N)
    burst = rng.random() < burst_prob
    k = max(1, int(round(burst_frac * N)))
    idx = rng.choice(N, size=k, replace=False)   # drawn unconditionally so
    if burst:                                    # the stream shape is fixed
        t[idx] *= burst_slowdown
    return t


def bursty_times_batch(rng: np.random.Generator, N: int, trials: int, *,
                       shift: float = 1.0, rate: float = 1.0,
                       burst_prob: float = 0.15, burst_frac: float = 0.4,
                       burst_slowdown: float = 8.0) -> np.ndarray:
    """``(trials, N)`` bursty completion times (see :func:`bursty_times`)."""
    t = shift + rng.exponential(1.0 / rate, size=(trials, N))
    burst = rng.random(trials) < burst_prob
    k = max(1, int(round(burst_frac * N)))
    cols = _straggler_subsets(rng, N, trials, k)
    mult = np.ones((trials, N))
    mult[np.repeat(np.arange(trials), k), cols.ravel()] = burst_slowdown
    return np.where(burst[:, None], t * mult, t)


def order_from_times(times: np.ndarray) -> np.ndarray:
    return np.argsort(times, kind="stable")


def sample_times(rng: np.random.Generator, N: int, *,
                 model: str = "shifted_exp", **kw) -> np.ndarray:
    """One ``(N,)`` latency draw from a named model (the backend seam)."""
    try:
        fn = _TIME_MODELS[model][0]
    except KeyError:
        raise ValueError(f"unknown latency model {model!r}; known: "
                         f"{sorted(_TIME_MODELS)}") from None
    return fn(rng, N, **kw)


def sample_times_batch(rng: np.random.Generator, N: int, trials: int, *,
                       model: str = "shifted_exp", **kw) -> np.ndarray:
    """``(trials, N)`` stacked latency draws from a named model."""
    try:
        fn = _TIME_MODELS[model][1]
    except KeyError:
        raise ValueError(f"unknown latency model {model!r}; known: "
                         f"{sorted(_TIME_MODELS)}") from None
    return fn(rng, N, trials, **kw)


@dataclass
class CompletionTrace:
    """A realized completion process for one coded job."""

    order: np.ndarray           # (N,) worker index finishing m-th
    times: np.ndarray | None    # (N,) per-worker completion time (or None)

    @property
    def N(self) -> int:
        return len(self.order)

    def completed(self, m: int) -> np.ndarray:
        """Indices of the m fastest workers, in completion order."""
        return self.order[:m]

    def mask(self, m: int) -> np.ndarray:
        out = np.zeros(self.N, dtype=bool)
        out[self.order[:m]] = True
        return out

    def time_of(self, m: int) -> float:
        """Wall-clock time at which the m-th completion happens.

        ``m = 0`` (no completions yet) is the dispatch instant, 0.0 — NOT
        ``times[-1]``, which the old ``[m - 1]`` indexing silently returned.
        """
        if m < 0 or m > self.N:
            raise ValueError(f"m={m} outside [0, N={self.N}]")
        if m == 0:
            return 0.0
        if self.times is None:
            return float(m)
        return float(np.sort(self.times)[m - 1])


def _check_completion_model(model: str) -> None:
    if model != "uniform" and model not in _TIME_MODELS:
        raise ValueError(f"unknown completion model {model!r}; known: "
                         f"{['uniform', *sorted(_TIME_MODELS)]}")


def simulate_completion(rng: np.random.Generator, N: int, *,
                        model: str = "uniform", **kw) -> CompletionTrace:
    _check_completion_model(model)
    if model == "uniform":
        return CompletionTrace(order=uniform_order(rng, N), times=None)
    t = sample_times(rng, N, model=model, **kw)
    return CompletionTrace(order=order_from_times(t), times=t)


# --------------------------------------------------------------- batched API

@dataclass
class CompletionBatch:
    """A stack of realized completion processes — one row per trace.

    The batched Monte-Carlo engine (``repro.core.simulate.SimulationEngine``)
    consumes whole batches at once instead of looping over
    :class:`CompletionTrace` objects.
    """

    orders: np.ndarray          # (trials, N) worker index finishing m-th
    times: np.ndarray | None    # (trials, N) per-worker times (or None)

    @property
    def trials(self) -> int:
        return self.orders.shape[0]

    @property
    def N(self) -> int:
        return self.orders.shape[1]

    def trace(self, t: int) -> CompletionTrace:
        """The t-th row as a legacy single-trace object."""
        return CompletionTrace(order=self.orders[t],
                               times=None if self.times is None
                               else self.times[t])

    @staticmethod
    def from_traces(traces) -> "CompletionBatch":
        traces = list(traces)
        orders = np.stack([np.asarray(tr.order) for tr in traces])
        times = None
        if traces and traces[0].times is not None:
            times = np.stack([np.asarray(tr.times) for tr in traces])
        return CompletionBatch(orders=orders, times=times)


def uniform_orders(rng: np.random.Generator, N: int, trials: int) -> np.ndarray:
    """``(trials, N)`` independent uniform completion orders in one call."""
    return rng.permuted(np.broadcast_to(np.arange(N), (trials, N)), axis=1)


def shifted_exp_times_batch(rng: np.random.Generator, N: int, trials: int, *,
                            shift: float = 1.0, rate: float = 1.0,
                            straggler_frac: float = 0.0,
                            straggler_slowdown: float = 5.0) -> np.ndarray:
    """``(trials, N)`` stacked shifted-exponential completion times.

    The straggler subsets come from one batched permuted-index draw
    (:func:`_straggler_subsets`) — same distribution as the per-trial
    ``rng.choice`` loop it replaced (pinned by ``tests/test_straggler.py``),
    no Python-level loop over trials.
    """
    t = shift + rng.exponential(1.0 / rate, size=(trials, N))
    if straggler_frac > 0:
        k = int(round(straggler_frac * N))
        if k:
            cols = _straggler_subsets(rng, N, trials, k)
            t[np.repeat(np.arange(trials), k), cols.ravel()] \
                *= straggler_slowdown
    return t


def simulate_completion_batch(rng: np.random.Generator, N: int, trials: int, *,
                              model: str = "uniform", **kw) -> CompletionBatch:
    """Stacked traces ``(trials, N)`` in one generator call per model."""
    _check_completion_model(model)
    if model == "uniform":
        return CompletionBatch(orders=uniform_orders(rng, N, trials),
                               times=None)
    t = sample_times_batch(rng, N, trials, model=model, **kw)
    return CompletionBatch(orders=np.argsort(t, axis=1, kind="stable"),
                           times=t)


# (single-draw, batched) generator pairs behind the sample_times dispatchers
_TIME_MODELS = {
    "shifted_exp": (shifted_exp_times, shifted_exp_times_batch),
    "heterogeneous": (heterogeneous_exp_times, heterogeneous_exp_times_batch),
    "bursty": (bursty_times, bursty_times_batch),
}

LATENCY_MODELS = tuple(sorted(_TIME_MODELS))


def validate_latency_kw(model: str, kw: dict) -> None:
    """Reject unknown keywords for a latency model at configuration time.

    Serving backends call this from their constructors so a typo'd knob
    (``straggler_frc=``) fails where it was written, not at the first
    dispatch deep inside a serving run.
    """
    import inspect
    if model not in _TIME_MODELS:
        raise ValueError(f"unknown latency model {model!r}; known: "
                         f"{sorted(_TIME_MODELS)}")
    fns = [_TIME_MODELS[model][0]]
    if model == "heterogeneous":
        fns.append(heterogeneous_fleet)      # **fleet_kw forwards here
    valid = {p.name for fn in fns
             for p in inspect.signature(fn).parameters.values()
             if p.kind == p.KEYWORD_ONLY}
    unknown = sorted(set(kw) - valid)
    if unknown:
        raise ValueError(f"unknown keyword(s) {unknown} for latency model "
                         f"{model!r}; valid: {sorted(valid)}")
