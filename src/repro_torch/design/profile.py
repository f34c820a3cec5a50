"""Straggler profiles: fitted latency models the Pareto search samples from.

A :class:`StragglerProfile` summarizes observed per-worker completion times
(:class:`~repro_torch.core.straggler.CompletionTrace` / ``CompletionBatch`` rows,
or any ``(trials, N)`` stack) as a generative model:

* ``"shifted_exp"`` — the CDC literature's two-parameter model, fitted with
  the bias-corrected estimators for the two-parameter exponential
  (``shift* = t_min - (t̄ - t_min)/(n-1)``, ``1/rate* = n(t̄ - t_min)/(n-1)``).
* ``"empirical"`` — the nonparametric fallback: bootstrap resampling of the
  observed times, per worker column when the observation matrix is kept
  (heterogeneous fleets have per-worker marginals no single (shift, rate)
  can express), pooled otherwise.

``fit(..., kind="auto")`` picks: fit shifted-exp, measure the KS distance of
the fitted CDF against the pooled empirical CDF, and fall back to the
empirical model when the parametric fit misses (bursty / heterogeneous
fleets).  Profiles expose a ``cache_key()`` so sweep results can be cached
on ``(spec, profile)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.straggler import (LATENCY_MODELS, CompletionBatch,
                              CompletionTrace, sample_times_batch)

__all__ = ["StragglerProfile", "GeneratorProfile"]


def _pooled(times: np.ndarray) -> np.ndarray:
    flat = np.asarray(times, dtype=np.float64).ravel()
    if flat.size < 2:
        raise ValueError(f"need at least 2 observed times to fit a profile; "
                         f"got {flat.size}")
    if not np.all(np.isfinite(flat)) or np.any(flat < 0):
        raise ValueError("observed times must be finite and non-negative")
    return flat


@dataclass(frozen=True)
class StragglerProfile:
    """A generative latency model fitted from observations.

    ``sample`` keeps the observation matrix for the empirical model (and for
    refit diagnostics); ``ks`` is the KS distance of the shifted-exp fit
    against the pooled empirical CDF (the ``kind="auto"`` decision value).
    """

    kind: str                               # "shifted_exp" | "empirical"
    shift: float
    rate: float
    sample: np.ndarray | None = field(default=None, repr=False, compare=False)
    ks: float = 0.0
    n_obs: int = 0

    # ------------------------------------------------------------ fitting
    @staticmethod
    def fit(times, *, kind: str = "auto",
            ks_threshold: float = 0.08) -> "StragglerProfile":
        """Fit from an ``(..., N)`` stack (or flat array) of observed times.

        ``kind``: ``"shifted_exp"`` forces the parametric model,
        ``"empirical"`` the bootstrap, ``"auto"`` falls back to empirical
        when the parametric KS distance exceeds the *effective* threshold
        ``max(ks_threshold, 1/√n)`` — the ``1/√n`` floor (≈ the Lilliefors
        critical distance for a fitted exponential) keeps small observation
        windows from tripping the fallback on pure sampling noise, where
        bootstrapping a handful of values would be far worse than the
        parametric fit.
        """
        if kind not in ("auto", "shifted_exp", "empirical"):
            raise ValueError(f"unknown profile kind {kind!r}")
        times = np.asarray(times, dtype=np.float64)
        flat = _pooled(times)
        n = flat.size
        t_min = float(flat.min())
        excess = float(flat.mean()) - t_min
        # bias-corrected two-parameter-exponential estimators
        shift = t_min - excess / (n - 1)
        scale = excess * n / (n - 1)
        rate = 1.0 / max(scale, 1e-300)
        # KS distance of the fitted CDF vs the pooled empirical CDF
        s = np.sort(flat)
        fitted = 1.0 - np.exp(-np.clip(s - shift, 0.0, None) * rate)
        steps = np.arange(1, n + 1) / n
        ks = float(np.max(np.maximum(np.abs(fitted - steps),
                                     np.abs(fitted - (steps - 1.0 / n)))))
        resolved = kind
        if kind == "auto":
            threshold = max(ks_threshold, 1.0 / np.sqrt(n))
            resolved = "empirical" if ks > threshold else "shifted_exp"
        sample = times if resolved == "empirical" else None
        if sample is not None and sample.ndim > 2:
            sample = sample.reshape(-1, sample.shape[-1])
        return StragglerProfile(kind=resolved, shift=float(shift),
                                rate=float(rate), sample=sample, ks=ks,
                                n_obs=n)

    @staticmethod
    def from_traces(traces, **kw) -> "StragglerProfile":
        """Fit from completion traces carrying times (rows must share N)."""
        rows = []
        for tr in traces:
            if isinstance(tr, CompletionTrace):
                if tr.times is None:
                    raise ValueError("trace carries no times; profiles need "
                                     "the wall-clock completion process")
                rows.append(np.asarray(tr.times, dtype=np.float64))
            else:
                rows.append(np.asarray(tr, dtype=np.float64))
        return StragglerProfile.fit(np.stack(rows), **kw)

    @staticmethod
    def from_batch(batch: CompletionBatch, **kw) -> "StragglerProfile":
        if batch.times is None:
            raise ValueError("batch carries no times; profiles need the "
                             "wall-clock completion process")
        return StragglerProfile.fit(batch.times, **kw)

    # ----------------------------------------------------------- sampling
    def sample_times(self, rng: np.random.Generator, N: int,
                     trials: int) -> np.ndarray:
        """``(trials, N)`` latency draws from the fitted model."""
        if self.kind == "shifted_exp":
            return self.shift + rng.exponential(1.0 / self.rate,
                                                size=(trials, N))
        sample = self.sample
        if sample is None:
            raise ValueError("empirical profile lost its sample; refit")
        if sample.ndim == 2 and sample.shape[1] == N:
            # per-worker bootstrap: column marginals survive (heterogeneous
            # fleets), completion *order* statistics follow
            idx = rng.integers(0, sample.shape[0], size=(trials, N))
            return sample[idx, np.arange(N)[None, :]]
        flat = sample.ravel()
        return flat[rng.integers(0, flat.size, size=(trials, N))]

    def sample_batch(self, rng: np.random.Generator, N: int,
                     trials: int) -> CompletionBatch:
        t = self.sample_times(rng, N, trials)
        return CompletionBatch(orders=np.argsort(t, axis=1, kind="stable"),
                               times=t)

    def p_finish_by(self, t: float, *, elapsed: float = 0.0,
                    shard: int | None = None) -> float:
        """P(completion ≤ ``t`` │ still running at ``elapsed``).

        The speculation trigger: a shard that has already run ``elapsed``
        seconds without finishing gets its finish probability *conditioned*
        on that survival.  ``shard`` selects the per-worker column marginal
        when the empirical observation matrix is kept (heterogeneous
        fleets); otherwise the pooled/parametric model answers.

        Shifted-exp uses the conditional survival ``1 - S(t)/S(elapsed)``
        with ``S(x) = exp(-rate·max(0, x-shift))``.  The empirical model
        answers with the fraction of observed survivors past ``elapsed``
        that finish by ``t`` — and ``0.0`` when *no* observation survives
        past ``elapsed`` (the shard has outlived everything ever seen:
        treat it as hung).
        """
        t = float(t)
        elapsed = float(elapsed)
        if t <= elapsed:
            return 0.0
        if self.kind == "shifted_exp":
            s_now = np.exp(-self.rate * max(0.0, elapsed - self.shift))
            if s_now <= 0.0:
                return 1.0
            s_t = np.exp(-self.rate * max(0.0, t - self.shift))
            return float(1.0 - s_t / s_now)
        sample = self.sample
        if sample is None:
            raise ValueError("empirical profile lost its sample; refit")
        if (shard is not None and sample.ndim == 2
                and 0 <= int(shard) < sample.shape[1]):
            col = sample[:, int(shard)]
        else:
            col = sample.ravel()
        alive = col[col > elapsed]
        if alive.size == 0:
            return 0.0
        return float(np.mean(alive <= t))

    def expected_latency(self) -> float:
        """``E[t]`` under the fitted model — the scalar the scale-out hook
        compares across refits (``shift + 1/rate`` parametrically, the
        sample mean empirically)."""
        if self.kind == "empirical" and self.sample is not None:
            return float(np.mean(self.sample))
        return float(self.shift + 1.0 / self.rate)

    # ----------------------------------------------------------- identity
    def cache_key(self) -> tuple:
        """Hashable identity for (spec, profile)-keyed sweep caches."""
        if self.kind == "shifted_exp":
            return ("shifted_exp", round(self.shift, 12),
                    round(self.rate, 12))
        sample = self.sample if self.sample is not None else np.empty(0)
        return ("empirical", sample.shape, sample.tobytes())

    def __repr__(self):
        extra = ""
        if self.kind == "empirical" and self.sample is not None:
            extra = f", sample={self.sample.shape}"
        return (f"StragglerProfile({self.kind}, shift={self.shift:.3f}, "
                f"rate={self.rate:.3f}, ks={self.ks:.3f}, "
                f"n_obs={self.n_obs}{extra})")


class GeneratorProfile:
    """Profile-shaped adapter over a *known* latency generator.

    Same sampling surface as :class:`StragglerProfile`, but backed by one of
    the named :mod:`repro_torch.core.straggler` models instead of a fit — the
    oracle a fitted profile is judged against (``benchmarks/design_pareto.py``
    scores the autotuned pick on the true fleet, not the fitted one), and
    the direct route for scenario studies where the fleet is specified
    rather than observed.
    """

    def __init__(self, model: str = "shifted_exp", **kw):
        if model not in LATENCY_MODELS:
            raise ValueError(f"unknown latency model {model!r}; known: "
                             f"{list(LATENCY_MODELS)}")
        self.model = model
        self.kw = kw

    def sample_times(self, rng: np.random.Generator, N: int,
                     trials: int) -> np.ndarray:
        return sample_times_batch(rng, N, trials, model=self.model, **self.kw)

    def sample_batch(self, rng: np.random.Generator, N: int,
                     trials: int) -> CompletionBatch:
        t = self.sample_times(rng, N, trials)
        return CompletionBatch(orders=np.argsort(t, axis=1, kind="stable"),
                               times=t)

    def cache_key(self) -> tuple:
        return ("generator", self.model,
                tuple(sorted((k, repr(v)) for k, v in self.kw.items())))

    def __repr__(self):
        kw = ", ".join(f"{k}={v!r}" for k, v in sorted(self.kw.items()))
        return f"GeneratorProfile({self.model}{', ' if kw else ''}{kw})"
