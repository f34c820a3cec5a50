"""Straggler-aware code-design autotuner — the layer between simulation
and serving.

The paper's §IV design guidelines (group splits, layer ε, β regimes) assume
an operator picks the code by hand; the right operating point actually
depends on the fleet's straggler distribution and the accuracy target.
This subsystem automates the choice:

* :class:`CodeSpec` / :class:`CodeSpace` — declarative, hashable candidate
  configurations across every registered family, constructible through
  ``core/registry.py`` (:func:`repro_torch.core.registry.make_code_from_spec`).
* :class:`StragglerProfile` — shifted-exponential fit (bias-corrected) with
  an empirical-CDF bootstrap fallback, from observed completion times.
* :class:`ParetoSearch` — batched-engine sweep returning the (error at
  deadline, time-to-accuracy, worker cost) frontier, with dominance pruning
  and (spec, profile)-keyed result caching.
* :class:`AdaptivePolicy` — the serving hook: refit the profile online and
  switch the scheduler to the frontier pick for the operator's
  accuracy/deadline target.  Elastic-fleet extensions: drift-triggered
  refits (:mod:`repro_torch.design.drift` — windowed two-sample KS or
  Page–Hinkley instead of a fixed refit cadence), per-:class:`RequestClass`
  profiles (heterogeneous job shapes get separate fits and picks),
  cost-aware fleet sizing (``best_for_target``: the smallest dispatched N
  meeting the target), and JSON persistence (:mod:`repro_torch.design.state`) so
  restarts skip the cold-start window.

Quickstart::

    from repro_torch.design import CodeSpace, ParetoSearch, StragglerProfile
    profile = StragglerProfile.fit(observed_times)          # (trials, N)
    search = ParetoSearch(CodeSpace(K=8, N=24), profile,
                          deadline=2.0, target_error=1e-2)
    print(search.best().spec.label())
    for p in search.frontier():
        print(p.spec.label(), p.err_at_deadline, p.tta, p.cost)

Serving integration: ``python -m repro_torch.launch.serve --autotune``.
"""
from .drift import (DriftReport, KSDriftDetector, PageHinkleyDetector,
                    make_drift_detector)
from .pareto import DesignPoint, ParetoSearch, pareto_frontier
from .policy import (AdaptivePolicy, RequestClass, RetuneEvent,
                     SpeculationPolicy, layer_value)
from .profile import GeneratorProfile, StragglerProfile
from .space import CodeSpace, CodeSpec, default_spec, group_compositions
from .state import load_state, save_state

__all__ = [
    "CodeSpec", "CodeSpace", "default_spec", "group_compositions",
    "StragglerProfile", "GeneratorProfile", "DesignPoint", "ParetoSearch",
    "pareto_frontier", "AdaptivePolicy", "RetuneEvent", "RequestClass",
    "SpeculationPolicy", "layer_value",
    "DriftReport", "KSDriftDetector", "PageHinkleyDetector",
    "make_drift_detector", "save_state", "load_state",
]
