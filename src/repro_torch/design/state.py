"""Profile/pick persistence: JSON snapshot + restore of adaptive-policy state.

A restarted service used to pay the full cold-start window (``--profile-
window`` requests of observation before the first refit) every time, even
when the fleet had not changed across the restart.  This module snapshots
everything the :class:`~repro_torch.design.policy.AdaptivePolicy` learned —
per-request-class fitted profiles, current frontier picks, the
(spec, profile)-keyed sweep caches, and drift-detector state — as one JSON
document, and restores it into a freshly constructed policy so the first
request after a restart is served by the previously tuned code.

Everything here is JSON-safe by construction: numpy arrays round-trip
through ``tolist()`` (exact for float64 — ``json`` emits ``repr`` floats),
``CodeSpec`` through its dataclass fields, so restored profile cache keys
are byte-identical to the originals and warm sweep caches actually hit.

File-level entry points (used by ``launch/serve.py --profile-state``):

* :func:`save_state` — atomic write (temp file + rename) so a crash mid-save
  never leaves a truncated snapshot behind.
* :func:`load_state` — validate + restore; returns the per-class built codes
  so the scheduler starts warm.
"""
from __future__ import annotations

import json

import numpy as np

from ..ioutil import write_json_atomic
from .drift import make_drift_detector
from .pareto import DesignPoint, ParetoSearch
from .profile import StragglerProfile
from .space import CodeSpec

__all__ = ["STATE_VERSION", "spec_to_dict", "spec_from_dict",
           "profile_to_dict", "profile_from_dict", "point_to_dict",
           "point_from_dict", "policy_state_dict", "load_policy_state",
           "save_state", "load_state"]

STATE_VERSION = 1

# observation rows persisted per class — enough to warm the drift window
# and re-fit on the next retune, not the whole service history
_SAVED_ROWS = 64


# ------------------------------------------------------------------- pieces

def spec_to_dict(spec: CodeSpec) -> dict:
    return {"family": spec.family, "K": spec.K, "N": spec.N,
            "radius": spec.radius,
            "groups": None if spec.groups is None else list(spec.groups),
            "eps": spec.eps, "beta_mode": spec.beta_mode}


def spec_from_dict(d: dict) -> CodeSpec:
    return CodeSpec(family=d["family"], K=int(d["K"]), N=int(d["N"]),
                    radius=d.get("radius"),
                    groups=None if d.get("groups") is None
                    else tuple(d["groups"]),
                    eps=d.get("eps"), beta_mode=d.get("beta_mode", "one"))


def profile_to_dict(profile: StragglerProfile) -> dict:
    return {"kind": profile.kind, "shift": profile.shift,
            "rate": profile.rate, "ks": profile.ks, "n_obs": profile.n_obs,
            "sample": None if profile.sample is None
            else np.asarray(profile.sample).tolist()}


def profile_from_dict(d: dict) -> StragglerProfile:
    sample = d.get("sample")
    return StragglerProfile(kind=d["kind"], shift=float(d["shift"]),
                            rate=float(d["rate"]),
                            sample=None if sample is None
                            else np.asarray(sample, dtype=np.float64),
                            ks=float(d.get("ks", 0.0)),
                            n_obs=int(d.get("n_obs", 0)))


def point_to_dict(point: DesignPoint) -> dict:
    return {"spec": spec_to_dict(point.spec),
            "err_at_deadline": point.err_at_deadline, "tta": point.tta,
            "cost": point.cost, "reach_frac": point.reach_frac,
            "m_at_deadline": point.m_at_deadline,
            "worker_seconds": point.worker_seconds}


def point_from_dict(d: dict) -> DesignPoint:
    return DesignPoint(spec=spec_from_dict(d["spec"]),
                       err_at_deadline=float(d["err_at_deadline"]),
                       tta=float(d["tta"]), cost=int(d["cost"]),
                       reach_frac=float(d.get("reach_frac", 1.0)),
                       m_at_deadline=float(d.get("m_at_deadline", 0.0)),
                       worker_seconds=float(d.get("worker_seconds", 0.0)))


def _cls_to_dict(cls) -> dict | None:
    if cls is None:
        return None
    return {"rows": cls.rows, "inner": cls.inner, "dtype": cls.dtype}


def _cls_from_dict(d):
    if d is None:
        return None
    from .policy import RequestClass
    return RequestClass(rows=int(d["rows"]), inner=int(d["inner"]),
                        dtype=d["dtype"])


# ------------------------------------------------------------- policy state

def policy_state_dict(policy) -> dict:
    """Snapshot an :class:`~repro_torch.design.policy.AdaptivePolicy` as one
    JSON-safe dict (see module docstring for what is captured)."""
    classes = []
    for key, st in policy._classes.items():
        search = st.search
        cache = []
        profile = None
        if search is not None and isinstance(search.profile,
                                             StragglerProfile):
            profile = profile_to_dict(search.profile)
            cache = [{"spec": spec_to_dict(spec), "point": point_to_dict(p)}
                     for (spec, _), p in search._cache.items()]
        rows = list(st.times)[-_SAVED_ROWS:]
        classes.append({
            "cls": _cls_to_dict(key),
            "seen": st.seen,
            "since_refit": st.since_refit,
            "tuned": st.tuned,
            "profile": profile,
            "current_spec": None if st.current_spec is None
            else spec_to_dict(st.current_spec),
            "current_point": None if st.current_point is None
            else point_to_dict(st.current_point),
            "cache": cache,
            "times": [np.asarray(r).tolist() for r in rows],
            "detector": None if st.detector is None
            else st.detector.state_dict(),
        })
    return {"version": STATE_VERSION,
            "space": {"K": policy.space.K, "N": policy.space.N,
                      "N_options": list(policy.space.N_options)},
            "deadline": policy.deadline,
            "target_error": policy.target_error,
            "per_class": policy.per_class,
            "cost_aware": policy.cost_aware,
            "drift": policy.drift,
            "classes": classes}


def load_policy_state(policy, state: dict) -> dict:
    """Restore a :func:`policy_state_dict` snapshot into ``policy``.

    Returns ``{class_key_or_None: built code}`` for every class carrying a
    restored pick — the warm codes the scheduler should serve immediately.
    Raises :class:`ValueError` on version or problem-shape mismatch (a
    snapshot fitted for a different K describes a different contraction
    split; silently reusing it would serve garbage).
    """
    version = state.get("version")
    if version != STATE_VERSION:
        raise ValueError(f"profile-state version {version!r} unsupported "
                         f"(expected {STATE_VERSION}); refusing to restore")
    saved = state.get("space", {})
    if int(saved.get("K", policy.space.K)) != policy.space.K:
        raise ValueError(
            f"profile state was fitted for K={saved.get('K')} but the "
            f"policy's space has K={policy.space.K}; stale snapshot — "
            "delete it or restart with the original K")
    if int(saved.get("N", policy.space.N)) > policy.space.N:
        # a pick fitted for a larger fleet would dispatch more workers than
        # this run declares; refusing beats silently over-provisioning
        raise ValueError(
            f"profile state was fitted for a fleet of N={saved.get('N')} "
            f"but this run declares N={policy.space.N}; stale snapshot — "
            "delete it or restart with the original N")
    warm: dict = {}
    # a per-class snapshot restored into a pooled (per_class=False) policy
    # maps several entries onto key=None: counters add up, observation rows
    # accumulate, but the profile/pick/search must come from the class with
    # the most evidence — not from whichever entry was serialized last
    best_seen: dict = {}
    for entry in state.get("classes", []):
        key = _cls_from_dict(entry.get("cls"))
        if key is not None and not policy.per_class:
            key = None                      # snapshot was per-class; pool it
        st = policy._state(key)
        merging = key in best_seen
        seen = int(entry.get("seen", 0))
        st.seen = st.seen + seen if merging else seen
        st.since_refit = max(st.since_refit if merging else 0,
                             int(entry.get("since_refit", 0)))
        st.tuned = bool(entry.get("tuned", False)) or \
            (merging and st.tuned)
        for row in entry.get("times", []):
            st.times.append(np.asarray(row, dtype=np.float64))
        if merging and seen <= best_seen[key]:
            continue                        # a better-evidenced entry won
        best_seen[key] = seen
        if entry.get("profile") is not None:
            profile = profile_from_dict(entry["profile"])
            search = ParetoSearch(policy.space, profile,
                                  deadline=policy.deadline,
                                  target_error=policy.target_error,
                                  trials=policy.trials, seed=policy.seed)
            for item in entry.get("cache", []):
                spec = spec_from_dict(item["spec"])
                search._cache[(spec, search._profile_key)] = \
                    point_from_dict(item["point"])
            st.search = search
        if entry.get("current_point") is not None:
            st.current_point = point_from_dict(entry["current_point"])
        if entry.get("detector") is not None and policy.drift is not None:
            st.detector = make_drift_detector(policy.drift,
                                              **policy.drift_kw)
            st.detector.load_state_dict(entry["detector"])
        if entry.get("current_spec") is not None:
            spec = spec_from_dict(entry["current_spec"])
            st.current_spec = spec
            warm[key] = spec.build(
                rng=np.random.default_rng([policy.seed, 0x5AC]))
    return warm


# ------------------------------------------------------------------ file IO

def save_state(policy, path: str) -> str:
    """Atomically write the policy snapshot to ``path`` (never torn)."""
    return write_json_atomic(path, policy_state_dict(policy))


def load_state(policy, path: str) -> dict:
    """Read ``path`` and restore it into ``policy`` (see
    :func:`load_policy_state`)."""
    with open(path) as f:
        state = json.load(f)
    return load_policy_state(policy, state)
