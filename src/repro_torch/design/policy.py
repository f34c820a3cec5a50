"""Adaptive serving policy: online profile refits driving code switches.

The serving master (``repro_torch.serving.master.MasterScheduler``) feeds every
dispatched batch's observed per-worker completion times to
:meth:`AdaptivePolicy.observe` and consults :meth:`maybe_retune` between
batches.  The policy refits a
:class:`~repro_torch.design.profile.StragglerProfile` from the observation buffer,
sweeps the :class:`~repro_torch.design.space.CodeSpace` with a
:class:`~repro_torch.design.pareto.ParetoSearch`, and — when the frontier pick for
the operator's (target error, deadline) moved — hands the scheduler the
newly built code.  Switches happen only at batch boundaries, so a swapped-in
code serves exactly as it would have from a fresh scheduler (pinned
bit-identical by ``tests/test_design.py``).

Elastic-fleet extensions on top of the fixed-window policy:

* **Refit trigger** — with ``drift`` set (``"ks"`` / ``"page_hinkley"``,
  see :mod:`repro_torch.design.drift`), the fixed every-``window`` refit cadence
  becomes a *change* trigger: after the cold-start fit, refits fire only
  when the windowed two-sample test says the completion-time stream moved.
* **Per-request-class profiles** — with ``per_class=True`` every
  :class:`RequestClass` (rows bucket, inner dim, dtype) gets its own
  observation buffer, profile, and frontier pick; heterogeneous job shapes
  stop polluting each other's fits.
* **Cost-aware fleet sizing** — with ``cost_aware=True`` the pick is
  :meth:`~repro_torch.design.pareto.ParetoSearch.best_for_target`: the smallest
  dispatched fleet (over the space's ``N_options``) whose expected error at
  the deadline already meets the target, instead of max accuracy at pinned
  N.
* **Drift-aware scale-out** — with ``scale_out=True`` a drift-triggered
  refit whose fitted tail *worsened* (expected latency up more than
  ``scale_threshold``) may request a **larger** fleet instead of only
  switching codes: the pick jumps to the cheapest larger-N point meeting
  the target (``trigger="drift-scale-out"`` in the history).  With the
  cluster backend the extra workers are real — the pool acquires them at
  the next dispatch.
* **Persistence** — :meth:`state_dict` / :meth:`load_state_dict` (JSON-safe
  via :mod:`repro_torch.design.state`) snapshot fitted profiles, picks, and sweep
  caches so a restarted service skips the cold-start window.

The policy owns its randomness (search seeds, G-SAC shuffles); it never
draws from the scheduler's rng, so attaching a policy does not perturb the
served latency stream.

:class:`SpeculationPolicy` is the *within*-batch companion: the hedging
trigger the unified serving loop consults between events to decide whether
a still-pending shard should be re-dispatched to a backup worker
(:func:`layer_value` weighs what the next completion is worth to the
successive-approximation decode; ``StragglerProfile.p_finish_by`` says how
likely the shard is to arrive in time on its own).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .drift import DriftReport, make_drift_detector
from .pareto import DesignPoint, ParetoSearch
from .profile import StragglerProfile
from .space import CodeSpace

__all__ = ["AdaptivePolicy", "RetuneEvent", "RequestClass",
           "SpeculationPolicy", "layer_value"]


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (shape-class coarsening)."""
    return 1 << max(0, int(n - 1).bit_length())


def layer_value(code, m_done: int) -> float:
    """Marginal value of the *next* completion to the SAC decode, in [0, 1].

    Successive approximation makes completions unequally valuable: with
    ``m_done`` shards in hand, the next one is worth

    * ``0.0`` once ``m_done >= R`` — the decode is already exact;
    * ``1.0`` when it finishes a resolution boundary — it reaches the first
      estimate (``m_done + 1 <= F``) or exactness (``m_done + 1 >= R``);
    * otherwise the fraction of the remaining refinement ladder it climbs,
      ``(R - m_done) / (R - F)`` — closer to exactness, more valuable,
      mirroring the error-vs-m staircase of the layered code.

    An uncoded/one-shot code (``F == R``) only ever returns 0 or 1: every
    completion before R is a full boundary.
    """
    F = int(code.first_threshold)
    R = int(code.recovery_threshold)
    m = int(m_done)
    if m >= R:
        return 0.0
    if m + 1 >= R or m + 1 <= F:
        return 1.0
    return float(R - m) / float(max(R - F, 1))


@dataclass
class SpeculationPolicy:
    """The hedging trigger: when is a pending shard worth a second copy?

    Consulted by the serving loop between events.  With a fitted
    :class:`~repro_torch.design.profile.StragglerProfile` the rule is the paper's
    latency-quantile trigger: hedge when

    ``P(shard finishes by the deadline │ survived this long)
    < threshold × layer_value(code, m_done)``

    — a shard whose completion would finish a resolution layer is hedged
    eagerly; one the decode barely needs must look nearly hopeless first.
    Before any profile exists (cold start) the Spark-style rule applies:
    hedge once at least ``min_done_frac`` of the copies are in *and* the
    batch has run ``cold_multiple`` × the median observed completion time.

    ``max_per_batch`` caps speculative launches per batch (``None``:
    unbounded); ``poll`` is how often the serving loop wakes to evaluate
    the trigger while the stream is quiet.
    """

    threshold: float = 0.5
    cold_multiple: float = 1.5
    min_done_frac: float = 0.5
    max_per_batch: int | None = None
    poll: float = 0.02

    def should_speculate(self, *, code, m_done: int, elapsed: float,
                         deadline: float, done_times, n_pending: int,
                         profile=None, shard: int | None = None) -> bool:
        lv = layer_value(code, m_done)
        if lv <= 0.0:
            return False
        if profile is not None:
            p = profile.p_finish_by(deadline, elapsed=float(elapsed),
                                    shard=shard)
            return p < self.threshold * lv
        done = np.asarray(list(done_times), dtype=np.float64)
        n_done = done.size
        if n_done == 0 or n_done + n_pending == 0:
            return False
        if n_done / (n_done + n_pending) < self.min_done_frac:
            return False
        return float(elapsed) > self.cold_multiple * float(np.median(done))


@dataclass(frozen=True)
class RequestClass:
    """Shape/dtype bucket a request's latency profile is keyed on.

    ``rows`` is bucketed to the next power of two (64×2048 and 100×2048
    jobs share a latency regime; 4096×2048 does not); ``inner`` stays exact
    because it fixes the per-worker block size *and* the K-divisibility
    constraint; ``dtype`` is the numpy kind+itemsize of the promoted operand
    type (``f8``, ``c16``, ...) — precision changes the work per shard.
    """

    rows: int
    inner: int
    dtype: str

    @staticmethod
    def of(A, B) -> "RequestClass":
        A = np.asarray(A)
        B = np.asarray(B)
        dt = np.result_type(A.dtype, B.dtype)
        return RequestClass(rows=_pow2_bucket(max(A.shape[0], B.shape[-1])),
                            inner=int(A.shape[-1]),
                            dtype=f"{dt.kind}{dt.itemsize}")

    def label(self) -> str:
        return f"{self.rows}x{self.inner}/{self.dtype}"


@dataclass(frozen=True)
class RetuneEvent:
    """One refit: what was observed, what was picked, whether it switched."""

    n_seen: int                   # requests observed when the refit fired
    profile: StragglerProfile
    point: DesignPoint
    switched: bool
    cls: RequestClass | None = None     # request class (None: shared)
    trigger: str = "window"             # "window" | "drift" | "manual"
    drift: DriftReport | None = None    # evidence, when drift-triggered


@dataclass
class _ClassState:
    """Per-request-class observation buffer + tuning state."""

    times: deque = field(default_factory=deque)
    since_refit: int = 0
    seen: int = 0
    tuned: bool = False
    current_spec: object = None
    current_point: DesignPoint | None = None
    search: ParetoSearch | None = None
    detector: object = None
    last_profile: StragglerProfile | None = None   # the previous fit (the
    #                                                scale-out comparator)


class AdaptivePolicy:
    """Refit-and-switch policy over a declarative code space.

    ``window`` is the cold-start fit cadence in served requests (and the
    refit cadence when no drift detector is attached); ``buffer`` bounds the
    observation history (rows of per-worker times) so long-running services
    track drift instead of averaging over it.  ``drift`` selects a change
    detector (``"ks"`` / ``"page_hinkley"`` / ``None``); ``per_class``
    splits all state by :class:`RequestClass`; ``cost_aware`` swaps the
    pick rule to cheapest-fleet-meeting-target.
    """

    def __init__(self, space: CodeSpace, *, deadline: float,
                 target_error: float = 1e-2, window: int = 32,
                 trials: int = 48, seed: int = 0, buffer: int = 1024,
                 profile_kind: str = "auto", switch_margin: float = 0.05,
                 drift: str | None = None, drift_kw: dict | None = None,
                 per_class: bool = False, cost_aware: bool = False,
                 scale_out: bool = False, scale_threshold: float = 0.1):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not 0.0 <= switch_margin < 1.0:
            raise ValueError(f"switch_margin must be in [0, 1), got "
                             f"{switch_margin}")
        self.space = space
        self.deadline = float(deadline)
        self.target_error = float(target_error)
        self.window = int(window)
        self.trials = int(trials)
        self.seed = int(seed)
        self.buffer = int(buffer)
        self.profile_kind = profile_kind
        self.switch_margin = float(switch_margin)
        self.drift = drift
        self.drift_kw = dict(drift_kw or {})
        if drift is not None:                    # typos fail at construction
            make_drift_detector(drift, **self.drift_kw)
        self.per_class = bool(per_class)
        self.cost_aware = bool(cost_aware)
        self.scale_out = bool(scale_out)
        self.scale_threshold = float(scale_threshold)
        self._classes: dict[RequestClass | None, _ClassState] = {}
        self.history: list[RetuneEvent] = []

    # ------------------------------------------------------------- state map
    def _key(self, cls: RequestClass | None) -> RequestClass | None:
        return cls if self.per_class else None

    def _state(self, cls: RequestClass | None) -> _ClassState:
        key = self._key(cls)
        if key not in self._classes:
            st = _ClassState(times=deque(maxlen=self.buffer))
            if self.drift is not None:
                st.detector = make_drift_detector(self.drift,
                                                  **self.drift_kw)
            self._classes[key] = st
        return self._classes[key]

    def classes(self) -> list[RequestClass | None]:
        """Request classes with any observed state, insertion-ordered."""
        return list(self._classes)

    # back-compat single-class views (the shared surface; also what the serve
    # report prints for the shared-profile configuration)
    @property
    def current_spec(self):
        return self._state(None).current_spec

    @current_spec.setter
    def current_spec(self, spec):
        self._state(None).current_spec = spec

    @property
    def current_point(self) -> DesignPoint | None:
        return self._state(None).current_point

    @property
    def _search(self) -> ParetoSearch | None:
        return self._state(None).search

    # ---------------------------------------------------------- observation
    def observe(self, times: np.ndarray, n_requests: int = 1,
                cls: RequestClass | None = None) -> None:
        """Record one dispatched batch's per-worker completion times."""
        st = self._state(cls)
        row = np.asarray(times, dtype=np.float64)
        st.times.append(row)
        st.since_refit += int(n_requests)
        st.seen += int(n_requests)
        if st.detector is not None:
            st.detector.observe(row)

    @property
    def n_observed(self) -> int:
        return sum(st.seen for st in self._classes.values())

    # --------------------------------------------------------------- retune
    def fit_profile(self, cls: RequestClass | None = None) -> StragglerProfile:
        """Fit the straggler profile from the class's observation buffer."""
        st = self._state(cls)
        if not st.times:
            raise ValueError("no observations yet; cannot fit a profile")
        rows = list(st.times)
        N = rows[0].shape[-1]
        if any(r.shape[-1] != N for r in rows):
            # fleet size changed mid-stream (N-switch): pool the times
            return StragglerProfile.fit(np.concatenate([r.ravel()
                                                        for r in rows]),
                                        kind=self.profile_kind)
        return StragglerProfile.fit(np.stack(rows), kind=self.profile_kind)

    def _pick(self, search: ParetoSearch) -> DesignPoint:
        return (search.best_for_target() if self.cost_aware
                else search.best())

    def retune(self, cls: RequestClass | None = None, *,
               trigger: str = "manual", drift: DriftReport | None = None):
        """Refit + sweep now.  Returns the newly built code on a switch,
        else ``None``; either way the pick lands in :attr:`history`."""
        st = self._state(cls)
        profile = self.fit_profile(cls)
        search = ParetoSearch(self.space, profile, deadline=self.deadline,
                              target_error=self.target_error,
                              trials=self.trials, seed=self.seed)
        # a refit with an unchanged profile (rare, but possible with a
        # parametric fit on a stable buffer) can reuse the previous sweep;
        # a changed profile shares no keys, so don't carry stale entries
        if (st.search is not None
                and search._profile_key == st.search._profile_key):
            search._cache.update(st.search._cache)
        st.search = search
        best = self._pick(search)
        scaled = self._scale_out_pick(st, search, profile, trigger, best)
        if scaled is not None:
            # drift worsened the tail and no pick meets the target at the
            # current fleet: request a larger one.  Hysteresis is skipped —
            # holding an undersized fleet to avoid churn is the one move
            # that is always wrong here
            best, trigger = scaled, "drift-scale-out"
            switched = best.spec != st.current_spec
        else:
            switched = best.spec != st.current_spec
            if switched and st.current_spec is not None:
                # switch hysteresis: near-ties flip-flop with profile noise,
                # and every flip invalidates warm state downstream — only
                # move when the candidate beats the incumbent by the margin
                # (same profile, same shared traces: a paired comparison)
                incumbent = search.evaluate(st.current_spec)
                if not self._beats_incumbent(best, incumbent):
                    best, switched = incumbent, False
        st.last_profile = profile
        st.tuned = True
        if st.detector is not None:
            st.detector.rebase()       # drift is measured against this fit
        self.history.append(RetuneEvent(n_seen=st.seen, profile=profile,
                                        point=best, switched=switched,
                                        cls=self._key(cls), trigger=trigger,
                                        drift=drift))
        st.current_point = best
        if not switched:
            return None
        st.current_spec = best.spec
        return best.spec.build(rng=np.random.default_rng([self.seed, 0x5AC]))

    def _scale_out_pick(self, st: _ClassState, search: ParetoSearch,
                        profile: StragglerProfile, trigger: str,
                        best: DesignPoint) -> DesignPoint | None:
        """Drift-aware scale-*up*: a larger fleet for a worsened tail.

        Fires only when (a) ``scale_out`` is on, (b) the refit was drift-
        triggered, (c) the new profile's expected latency worsened by more
        than ``scale_threshold`` over the previous fit, and (d) the normal
        pick misses the accuracy target.  The request is then the cheapest
        point *above the incumbent fleet size* that meets the target — or,
        when none does, the larger-fleet point closest to it.  Either way
        the candidate must beat the *incumbent spec at its current fleet*
        strictly on error: more workers must buy accuracy, so a fleet where
        every size fails identically (e.g. err 1.0 across the board) never
        ratchets upward on repeated drift hits.  The serving side honors
        the request through the worker pool: the scheduler switches to the
        bigger-N code and the cluster backend acquires the extra workers at
        the next dispatch.
        """
        if not (self.scale_out and trigger == "drift"
                and st.last_profile is not None
                and st.current_point is not None
                and st.current_spec is not None):
            return None
        worsened = profile.expected_latency() > \
            (1.0 + self.scale_threshold) * st.last_profile.expected_latency()
        if not worsened or best.err_at_deadline <= self.target_error:
            return None
        larger = [p for p in search.run() if p.cost > st.current_point.cost]
        if not larger:
            return None
        meeting = [p for p in larger
                   if p.err_at_deadline <= self.target_error]
        cand = min(meeting,
                   key=lambda p: (p.cost, p.tta, p.err_at_deadline)) \
            if meeting else min(larger,
                                key=lambda p: (p.err_at_deadline, p.tta,
                                               p.cost))
        incumbent = search.evaluate(st.current_spec)
        return cand if cand.err_at_deadline < incumbent.err_at_deadline \
            else None

    def _beats_incumbent(self, cand: DesignPoint,
                         inc: DesignPoint) -> bool:
        """Hysteresis rule: does the candidate justify invalidating warm
        state?  Cost-aware mode adds the fleet axis: when both already meet
        the target, a strictly smaller fleet is a win on its own."""
        margin = 1.0 - self.switch_margin
        if self.cost_aware:
            cand_ok = cand.err_at_deadline <= self.target_error
            inc_ok = inc.err_at_deadline <= self.target_error
            if cand_ok and not inc_ok:
                return True
            if cand_ok and inc_ok:
                return cand.cost < inc.cost or (
                    cand.cost == inc.cost
                    and cand.err_at_deadline <= margin * inc.err_at_deadline)
            if not cand_ok and inc_ok:
                return False
        return cand.err_at_deadline <= margin * inc.err_at_deadline

    def maybe_retune(self, cls: RequestClass | None = None):
        """The scheduler's per-batch hook: cold-start fit after ``window``
        requests, then drift-triggered (or window-cadenced) refits."""
        st = self._state(cls)
        if not st.times:
            return None
        if (not st.tuned or st.detector is None
                or not st.detector.has_reference):
            # window-gated: cold start, the fixed-cadence mode, and an
            # un-armed detector (e.g. a snapshot saved without --drift
            # restored into a drift run — an unreferenced detector can
            # never fire, so waiting on it would disable refits forever)
            if st.since_refit < self.window:
                return None
            st.since_refit = 0
            return self.retune(cls, trigger="window")
        report = st.detector.check()
        if not report.drifted:
            return None
        st.since_refit = 0
        # the buffer is dominated by pre-change history (that is what made
        # the change detectable) — fit the new regime on the recent window
        # only, or the stale rows average the drift away and the refit
        # re-picks the old code
        window = getattr(st.detector, "window", self.window)
        if len(st.times) > window:
            for _ in range(len(st.times) - window):
                st.times.popleft()
        return self.retune(cls, trigger="drift", drift=report)

    # ---------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        """JSON-safe snapshot of per-class tuning state (profiles, picks,
        sweep caches, drift detectors).  Observation buffers are truncated
        to the drift window — enough to re-arm the detector, not the whole
        service history."""
        from .state import policy_state_dict
        return policy_state_dict(self)

    def load_state_dict(self, state: dict) -> dict:
        """Restore a :meth:`state_dict` snapshot.  Returns ``{class_or_None:
        built code}`` for every class with a restored pick, so the caller
        (``launch/serve.py``) can hand the scheduler warm codes and skip the
        cold-start window entirely."""
        from .state import load_policy_state
        return load_policy_state(self, state)
