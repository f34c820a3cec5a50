"""Pareto search over a code space under a fitted straggler profile.

For every candidate :class:`~repro_torch.design.space.CodeSpec` the search samples
one shared completion batch per fleet size from the
:class:`~repro_torch.design.profile.StragglerProfile` (shared traces = paired
comparison, the variance-reduction that makes small sweeps trustworthy),
evaluates the error curves through the batched
:class:`~repro_torch.core.simulate.SimulationEngine`, and reduces them to three
serving-facing scalars:

* ``err_at_deadline`` — expected total relative error of the estimate a
  client holds at the deadline (1.0 where no estimate exists yet: the
  client's implicit estimate is 0, and ``‖C - 0‖²/‖C‖² = 1``).
* ``tta`` — expected time-to-accuracy: first wall-clock time the estimate
  error drops to the target, capped per trial at the last completion.
* ``cost`` — workers occupied (the fleet size N the spec deploys).

Dominated specs are pruned (:func:`pareto_frontier`); every evaluation is
cached on ``(spec, profile)`` so online refits (``AdaptivePolicy``) only pay
for configurations the new profile actually re-ranks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.simulate import ProblemContext, SimulationEngine
from .profile import StragglerProfile
from .space import CodeSpace

__all__ = ["DesignPoint", "ParetoSearch", "pareto_frontier"]


@dataclass(frozen=True)
class DesignPoint:
    """One evaluated spec: the objectives plus reach diagnostics."""

    spec: object
    err_at_deadline: float
    tta: float
    cost: int
    reach_frac: float = 1.0        # trials whose error hit the target
    m_at_deadline: float = 0.0     # mean completions by the deadline
    # expected worker-seconds actually burned per request: every dispatched
    # worker runs until it finishes or the request releases its fleet (the
    # estimate reached the target, or the deadline passed) — the cost the
    # elastic controller trades accuracy against
    worker_seconds: float = 0.0

    def objectives(self) -> tuple[float, float, float]:
        return (self.err_at_deadline, self.tta, float(self.cost))

    def dominates(self, other: "DesignPoint") -> bool:
        a, b = self.objectives(), other.objectives()
        return all(x <= y for x, y in zip(a, b)) and \
            any(x < y for x, y in zip(a, b))


def pareto_frontier(points) -> list[DesignPoint]:
    """Non-dominated subset on (err_at_deadline, tta, cost), stable order."""
    points = list(points)
    return [p for p in points
            if not any(q.dominates(p) for q in points if q is not p)]


class ParetoSearch:
    """Sweep a :class:`CodeSpace` through the batched engine.

    ``problem`` is the calibration workload ``(A, B)``; by default a seeded
    i.i.d. N(0, 1) problem sized for sweep speed (relative-error curves of
    the paper's codes are insensitive to problem scale for i.i.d. data —
    the paper's own §V protocol).  ``trials`` Monte-Carlo traces are sampled
    per fleet size from the profile and shared across every spec.
    """

    def __init__(self, space: CodeSpace, profile: StragglerProfile, *,
                 deadline: float, target_error: float = 1e-2,
                 trials: int = 64, seed: int = 0, problem=None,
                 rows: int = 40, inner_per_k: int = 64):
        if deadline <= 0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
        if target_error <= 0:
            raise ValueError(f"target_error must be > 0, got {target_error}")
        self.space = space
        self.profile = profile
        self.deadline = float(deadline)
        self.target_error = float(target_error)
        self.trials = int(trials)
        self.seed = int(seed)
        if problem is None:
            rng = np.random.default_rng([seed, 0xCA11B])
            inner = space.K * int(inner_per_k)
            problem = (rng.standard_normal((rows, inner)),
                       rng.standard_normal((inner, rows)))
        self.A, self.B = problem
        self._problems: dict[int, ProblemContext] = {}
        self._batches: dict[int, object] = {}
        # the profile is fixed per search, so its (possibly large) key is
        # computed once; cache entries are (spec, profile) as promised
        self._profile_key = profile.cache_key()
        self._cache: dict[tuple, DesignPoint] = {}
        self.cache_hits = 0
        self.cache_misses = 0

    # --------------------------------------------------------- shared state
    def _problem_ctx(self, K: int) -> ProblemContext:
        if K not in self._problems:
            self._problems[K] = ProblemContext.build(self.A, self.B, K)
        return self._problems[K]

    def _batch(self, N: int):
        """The shared completion batch for fleet size N (deterministic)."""
        if N not in self._batches:
            rng = np.random.default_rng([self.seed, N])
            self._batches[N] = self.profile.sample_batch(rng, N, self.trials)
        return self._batches[N]

    # ----------------------------------------------------------- evaluation
    def evaluate(self, spec) -> DesignPoint:
        """One spec → :class:`DesignPoint`, cached on (spec, profile)."""
        key = (spec, self._profile_key)
        if key in self._cache:
            self.cache_hits += 1
            return self._cache[key]
        self.cache_misses += 1
        batch = self._batch(spec.N)
        # G-SAC pair shuffles resample per deployment; one seeded shuffle
        # per search keeps the evaluation deterministic and cacheable
        code = spec.build(rng=np.random.default_rng([self.seed, 0x5AC]))
        engine = SimulationEngine(code, self.A, self.B,
                                  beta_mode=spec.beta_mode,
                                  problem=self._problem_ctx(spec.K))
        curves = engine.run_batch(batch)
        point = self._reduce(spec, batch, curves)
        self._cache[key] = point
        return point

    def _reduce(self, spec, batch, curves) -> DesignPoint:
        """Error curves + completion times → the three objectives."""
        t_sorted = np.sort(batch.times, axis=1)          # (T, N)
        total = np.where(np.isnan(curves.total), 1.0, curves.total)
        # completions by the deadline, per trial
        m_dl = (t_sorted <= self.deadline).sum(axis=1)   # (T,)
        err = np.ones(total.shape[0])
        has = m_dl >= 1
        err[has] = total[has, m_dl[has] - 1]
        # first wall-clock time the error reaches the target; capped at the
        # trial's final completion when it never does
        hit = total <= self.target_error                 # (T, N)
        first_m = np.where(hit.any(axis=1), hit.argmax(axis=1), -1)
        tta = t_sorted[:, -1].copy()
        reached = first_m >= 0
        tta[reached] = t_sorted[reached, first_m[reached]]
        # fleet release time: the target being reached frees the workers
        # early; otherwise they are held (and keep computing) to the deadline
        release = np.where(reached, np.minimum(tta, self.deadline),
                           self.deadline)
        ws = np.minimum(batch.times, release[:, None]).sum(axis=1)
        return DesignPoint(
            spec=spec,
            err_at_deadline=float(err.mean()),
            tta=float(tta.mean()),
            cost=int(spec.N),
            reach_frac=float(reached.mean()),
            m_at_deadline=float(m_dl.mean()),
            worker_seconds=float(ws.mean()))

    # -------------------------------------------------------------- search
    def run(self) -> list[DesignPoint]:
        """Evaluate every spec in the space (cached), deterministic order."""
        return [self.evaluate(spec) for spec in self.space.specs()]

    def frontier(self) -> list[DesignPoint]:
        """The non-dominated (err, tta, cost) subset of the full sweep."""
        return pareto_frontier(self.run())

    def best(self) -> DesignPoint:
        """The operating point for the configured accuracy/deadline target.

        Primary: minimum expected error at the deadline.  Ties (e.g. several
        exact-by-deadline codes) break toward faster time-to-target, then
        fewer workers, then enumeration order (stable).
        """
        points = self.run()
        return min(points, key=lambda p: (p.err_at_deadline, p.tta, p.cost))

    def best_for_target(self) -> DesignPoint:
        """The *cheapest* point meeting the accuracy target at the deadline.

        Cost-aware selection over the ``N_options`` axis: among points whose
        expected error at the deadline already meets ``target_error``, extra
        accuracy buys nothing — prefer the smallest dispatched fleet, then
        faster time-to-target.  When no point meets the target this reduces
        to :meth:`best` (accuracy first: a cheap fleet that misses the
        target is not an operating point, it is an outage).
        """
        meeting = [p for p in self.run()
                   if p.err_at_deadline <= self.target_error]
        if meeting:
            return min(meeting,
                       key=lambda p: (p.cost, p.tta, p.err_at_deadline))
        return self.best()
