"""Drift detection on the observed completion-time stream.

The adaptive policy's fixed refit window pays a full profile refit +
Pareto sweep every W requests whether or not the fleet changed, and waits a
whole window to react when it *does* change.  A :class:`DriftDetector` turns
the cadence into a trigger: the latency rows the policy already buffers are
split into a frozen *reference* sample (the data the current profile was
fitted on) and a sliding *recent* window, and a refit fires only when a
windowed two-sample test says they disagree.

Two tests, selectable by name (``make_drift_detector``):

* ``"ks"`` — two-sample Kolmogorov–Smirnov on the pooled times.  The null
  threshold is the classic large-sample critical distance
  ``c(α)·√((n+m)/(n·m))`` with ``c(α) = √(−ln(α/2)/2)``; distribution-free,
  so it needs no assumption the fleet is shifted-exponential (the empirical
  profile fallback exists precisely because it often is not).
* ``"page_hinkley"`` — Page–Hinkley on the running mean: cumulative
  ``Σ (t_i − t̄_i − δ)`` against its running minimum, flagged when the gap
  exceeds ``λ·σ_ref``.  One-sided by design (two detectors back-to-back for
  both directions); cheaper than KS and sensitive to slow mean creep that a
  windowed KS can miss, but blind to variance-only changes.

Both are *windowed*: only the last ``window`` observed rows vote, so a
long-stable history cannot average away a fresh change (the ROADMAP's
"trigger refits on change instead of a fixed window" item).

False-positive calibration: on a stationary shifted-exponential fleet the
KS detector at ``alpha = 0.01`` fires on ≈1% of disjoint windows by
construction; the measured rate for the committed settings is recorded in
``EXPERIMENTS.md`` (and pinned loosely by ``tests/test_drift.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["DriftReport", "KSDriftDetector", "PageHinkleyDetector",
           "make_drift_detector", "ks_2samp"]


def ks_2samp(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample KS statistic ``sup_t |F_a(t) − F_b(t)|`` (exact, sorted)."""
    a = np.sort(np.asarray(a, dtype=np.float64).ravel())
    b = np.sort(np.asarray(b, dtype=np.float64).ravel())
    if a.size == 0 or b.size == 0:
        raise ValueError("both samples must be non-empty")
    grid = np.concatenate([a, b])
    Fa = np.searchsorted(a, grid, side="right") / a.size
    Fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.max(np.abs(Fa - Fb)))


@dataclass(frozen=True)
class DriftReport:
    """One drift check: the decision plus the evidence behind it."""

    drifted: bool
    stat: float                  # test statistic (KS distance / PH gap)
    threshold: float             # the statistic's trigger level
    n_ref: int                   # reference observations voting
    n_recent: int                # recent observations voting

    def __repr__(self):
        mark = "DRIFT" if self.drifted else "ok"
        return (f"DriftReport({mark}, stat={self.stat:.4f}, "
                f"threshold={self.threshold:.4f}, "
                f"ref={self.n_ref}, recent={self.n_recent})")


class KSDriftDetector:
    """Windowed two-sample KS test: reference sample vs the recent window.

    ``observe(times)`` feeds one dispatched batch's per-worker times;
    ``check()`` compares the last ``window`` rows against the reference and
    returns a :class:`DriftReport`.  ``rebase()`` promotes the recent window
    to the new reference — call it after every refit, so drift is always
    measured against the data the *current* profile was fitted on.
    """

    def __init__(self, *, window: int = 32, alpha: float = 0.01,
                 min_rows: int = 8):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        if min_rows < 1:
            raise ValueError(f"min_rows must be >= 1, got {min_rows}")
        self.window = int(window)
        self.alpha = float(alpha)
        self.min_rows = int(min_rows)
        self._ref: np.ndarray | None = None       # pooled reference times
        self._recent: list[np.ndarray] = []       # rows, bounded by window
        self.n_checks = 0
        self.n_drifts = 0

    def observe(self, times) -> None:
        row = np.asarray(times, dtype=np.float64).ravel()
        if row.size == 0:
            raise ValueError("empty observation row")
        self._recent.append(row)
        if len(self._recent) > self.window:
            del self._recent[:len(self._recent) - self.window]

    @property
    def has_reference(self) -> bool:
        return self._ref is not None

    def rebase(self) -> None:
        """Promote the recent window to the reference (post-refit)."""
        if self._recent:
            self._ref = np.concatenate(self._recent)
            self._recent = []

    def check(self) -> DriftReport:
        """KS-compare recent vs reference.  Never drifts before both sides
        hold ``min_rows`` rows — a two-row window KS is pure noise."""
        n_rec = len(self._recent)
        if self._ref is None or n_rec < self.min_rows:
            ref_n = 0 if self._ref is None else self._ref.size
            return DriftReport(False, 0.0, float("inf"), ref_n,
                               sum(r.size for r in self._recent))
        recent = np.concatenate(self._recent)
        stat = ks_2samp(self._ref, recent)
        n, m = self._ref.size, recent.size
        c_alpha = np.sqrt(-np.log(self.alpha / 2.0) / 2.0)
        threshold = float(c_alpha * np.sqrt((n + m) / (n * m)))
        self.n_checks += 1
        drifted = stat > threshold
        self.n_drifts += int(drifted)
        return DriftReport(drifted, stat, threshold, n, m)

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        return {"kind": "ks", "window": self.window, "alpha": self.alpha,
                "min_rows": self.min_rows,
                "ref": None if self._ref is None else self._ref.tolist(),
                "recent": [r.tolist() for r in self._recent]}

    def load_state_dict(self, state: dict) -> None:
        ref = state.get("ref")
        self._ref = None if ref is None else np.asarray(ref, np.float64)
        self._recent = [np.asarray(r, np.float64)
                        for r in state.get("recent", [])]


class PageHinkleyDetector:
    """Page–Hinkley change detector on the mean completion time.

    Tracks ``U_t = Σ (x_i − x̄_i − δ)`` and flags when ``U_t − min U``
    exceeds ``lam`` (in units of the reference standard deviation, estimated
    from the first ``warmup`` rows).  Detects upward mean shifts — the
    serving-relevant direction (a fleet getting *faster* only makes the
    current code conservative; getting slower breaks the deadline math).
    """

    def __init__(self, *, delta: float = 0.05, lam: float = 12.0,
                 warmup: int = 16):
        if lam <= 0:
            raise ValueError(f"lam must be > 0, got {lam}")
        if warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {warmup}")
        self.delta = float(delta)
        self.lam = float(lam)
        self.warmup = int(warmup)
        self._warm: list[np.ndarray] = []
        self._sigma: float | None = None
        self._mean = 0.0
        self._n = 0
        self._cum = 0.0
        self._cum_min = 0.0
        self.n_checks = 0
        self.n_drifts = 0

    def observe(self, times) -> None:
        row = np.asarray(times, dtype=np.float64).ravel()
        if row.size == 0:
            raise ValueError("empty observation row")
        if self._sigma is None:
            self._warm.append(row)
            if len(self._warm) >= self.warmup:
                pool = np.concatenate(self._warm)
                self._sigma = float(max(pool.std(), 1e-12))
                self._warm = []
            return
        x = float(row.mean())
        self._n += 1
        self._mean += (x - self._mean) / self._n
        self._cum += x - self._mean - self.delta * self._sigma
        self._cum_min = min(self._cum_min, self._cum)

    @property
    def has_reference(self) -> bool:
        return self._sigma is not None

    def rebase(self) -> None:
        """Reset the cumulative statistic (post-refit): the new profile owns
        the new regime, so change is measured from here on."""
        self._mean = 0.0
        self._n = 0
        self._cum = 0.0
        self._cum_min = 0.0

    def check(self) -> DriftReport:
        if self._sigma is None:
            return DriftReport(False, 0.0, float("inf"), 0, self._n)
        gap = (self._cum - self._cum_min) / self._sigma
        self.n_checks += 1
        drifted = gap > self.lam
        self.n_drifts += int(drifted)
        return DriftReport(drifted, float(gap), self.lam, self.warmup,
                           self._n)

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        return {"kind": "page_hinkley", "delta": self.delta, "lam": self.lam,
                "warmup": self.warmup, "sigma": self._sigma,
                "mean": self._mean, "n": self._n, "cum": self._cum,
                "cum_min": self._cum_min}

    def load_state_dict(self, state: dict) -> None:
        self._sigma = state.get("sigma")
        self._mean = float(state.get("mean", 0.0))
        self._n = int(state.get("n", 0))
        self._cum = float(state.get("cum", 0.0))
        self._cum_min = float(state.get("cum_min", 0.0))


DRIFT_DETECTORS = ("ks", "page_hinkley")


def make_drift_detector(kind: str, **kw):
    """Detector factory for the policy / serve CLI (``ks`` | ``page_hinkley``)."""
    if kind == "ks":
        return KSDriftDetector(**kw)
    if kind == "page_hinkley":
        return PageHinkleyDetector(**kw)
    raise ValueError(f"unknown drift detector {kind!r}; known: "
                     f"{DRIFT_DETECTORS}")
