"""Serving CLI — thin front-end over :mod:`repro_torch.serving`.

A master accepts matmul jobs (the paper's C = A·B workload), encodes them
with a selected SAC code, fans the encoded products out to N workers with
shifted-exponential latencies, and answers with successive refinement: an
event-driven loop pushes each completion into an incremental decoder and
emits estimates at deadline ticks (or at every completion with
``--stream``).

``--backend device`` (the default) runs the encode and the worker products
in the hand-written CUDA kernels; ``--backend sim`` computes them in float64
(numpy on the host, the oracle; torch float64 on the card when ``--device
cuda``).  Either way the operands, the reference product, the decoders and
the error norms live on ``--device`` — the CUDA card unless ``--device
cpu`` is given (the kernels' plain versions then run on the CPU).  Operands
are drawn with numpy exactly as the reference CLI draws them, so the two
packages serve identical requests::

    PYTHONPATH=src python -m repro_torch.launch.serve --code lsac_ortho \
        --rows 2048 --inner 32768 --requests 8 --json
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --rows 32 --inner 256 --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --autotune --per-class --target-error 1e-2 --profile-window 4 \
        --requests 16 --rows 32 --inner 256

``--autotune`` attaches the straggler-aware design policy
(:mod:`repro_torch.design`): every ``--profile-window`` requests the master
refits a straggler profile from observed worker latencies, sweeps the code
space through the batched simulation engine, and switches to the Pareto
pick for ``--target-error`` at the tightest deadline.  The ``--code``
argument is the starting code only.  On top of it: ``--drift ks|
page_hinkley`` (refit on detected change), ``--per-class`` (profiles and
picks per request class), ``--cost-aware --N-options 12,16,24`` (the
cheapest fleet meeting the target), ``--profile-state PATH`` (persist
profiles and sweep caches across restarts).  ``--fleet N`` dispatches only
the first N encode shards of the starting code; ``--class-cache`` gives
each request class its own decode-weight budget.  The observability group
(``--metrics-out``, ``--trace-out``, ``--flight-recorder``,
``--sample-interval``, ``--metrics-port``, ``--burn-alerts``) records the
run.  The worker-process cluster and its fleet, chaos, record/replay and
speculation flags are not ported yet.

Flags are grouped; illegal combinations are reported together up front,
and the effective config is emitted as one ``[serve] config {...}`` JSON
line.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core import (EpsApproxMatDotCode, GroupSACCode,
                              LayerSACCode, MatDotCode, x_complex)
from repro_torch.ioutil import write_json_atomic
from repro_torch.serving import (DecodeWeightCache, MasterScheduler,
                                 ServeConfig, make_backend, serve_request)

__all__ = ["CODES", "ServeReport", "build_code", "build_parser",
           "validate_args", "serve_request", "run_serve", "main"]


def _auto_groups(K: int) -> list[int]:
    """Two-group split derived from K (single group when K = 1)."""
    if K <= 1:
        return [K]
    a = (K + 1) // 2
    return [a, K - a]


@dataclass
class CodeSpec:
    build: Callable
    # returns a list of human-actionable problems for (K, N); empty = ok
    check: Callable


def _check_matdot_family(K: int, N: int) -> list[str]:
    out = []
    if N < 2 * K - 1:
        out.append(f"needs N >= 2K-1 = {2 * K - 1} workers for exact "
                   f"recovery; got --N {N} (raise --N or lower --K)")
    return out


def _check_gsac_k1_5(K: int, N: int) -> list[str]:
    if K <= 5:
        return [f"builds group sizes [5, K-5], so it needs --K >= 6; got "
                f"--K {K}.  Use --code gsac_auto (group sizes derived from "
                "K) or raise --K"]
    return _check_matdot_family(K, N)


def _check_lsac(K: int, N: int) -> list[str]:
    out = _check_matdot_family(K, N)
    if N % K != 0:
        out.append(f"clusters the N workers evenly over K anchors, so it "
                   f"needs K | N; got --K {K}, --N {N} (pick N a multiple "
                   "of K)")
    return out


CODES = {
    "matdot": CodeSpec(
        lambda K, N: MatDotCode(K, N, x_complex(N, 0.1)),
        _check_matdot_family),
    "eps_matdot": CodeSpec(
        lambda K, N: EpsApproxMatDotCode(K, N, x_complex(N, 0.1)),
        _check_matdot_family),
    "gsac_k1_5": CodeSpec(
        lambda K, N: GroupSACCode(K, N, x_complex(N, 0.1), [5, K - 5]),
        _check_gsac_k1_5),
    "gsac_auto": CodeSpec(
        lambda K, N: GroupSACCode(K, N, x_complex(N, 0.1), _auto_groups(K)),
        _check_matdot_family),
    "lsac_ortho": CodeSpec(
        lambda K, N: LayerSACCode(K, N, base="ortho", eps=6.25e-3),
        _check_lsac),
    "lsac_lagrange": CodeSpec(
        lambda K, N: LayerSACCode(K, N, base="lagrange", eps=3.33e-2),
        _check_lsac),
}


def validate_args(code: str, K: int, N: int) -> list[str]:
    """Actionable problems with a CLI configuration (empty list = valid)."""
    if code not in CODES:
        return [f"unknown --code {code!r}; known: {sorted(CODES)}"]
    out = []
    if K < 1 or N < 1:
        out.append(f"need --K >= 1 and --N >= 1; got --K {K}, --N {N}")
    out.extend(f"--code {code} {p}" for p in CODES[code].check(K, N))
    return out


def build_code(code: str, K: int, N: int):
    """Build a CLI code, raising ``SystemExit`` with actionable messages."""
    problems = validate_args(code, K, N)
    if problems:
        raise SystemExit("[serve] invalid arguments:\n  " +
                         "\n  ".join(problems))
    return CODES[code].build(K, N)


def build_parser() -> argparse.ArgumentParser:
    """The serving CLI, flags organized into argument groups."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--code", default="gsac_k1_5", choices=sorted(CODES))
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--N", type=int, default=24)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rows", type=int, default=100)
    ap.add_argument("--inner", type=int, default=2000)
    ap.add_argument("--deadlines", default="1.1,1.3,1.6,2.0,3.0")
    ap.add_argument("--straggler-frac", type=float, default=0.15)
    ap.add_argument("--beta", default="one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream", action="store_true",
                    help="emit an answer at every completion event")
    ap.add_argument("--json", action="store_true",
                    help="print the run as one serve-report JSON document "
                    "instead of the [serve] text lines")
    ap.add_argument("--batch-size", type=int, default=4,
                    help="requests encoded/dispatched together")
    ap.add_argument("--decoder", default="incremental",
                    choices=("incremental", "recompute"),
                    help="streaming decoder or the per-tick re-decode "
                    "baseline")
    ap.add_argument("--cache-size", type=int, default=1024,
                    help="decode-weight LRU entries (0 disables)")
    ap.add_argument("--class-cache", type=int, default=0,
                    help="per-request-class decode-weight sub-budget "
                    "(entries per class; 0 = one shared LRU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where operands, products and decode state live")

    fleet = ap.add_argument_group(
        "fleet", "execution backend and fleet sizing")
    fleet.add_argument("--backend", default="device",
                       choices=("device", "sim"),
                       help="worker products in the CUDA kernels (device) or "
                       "in float64 (sim, the oracle)")
    fleet.add_argument("--fleet", type=int, default=None,
                       help="dispatch only the first N encode shards of the "
                       "starting code (operator override)")

    tune = ap.add_argument_group(
        "autotune", "online straggler-profile refits and code switches")
    tune.add_argument("--autotune", action="store_true",
                      help="refit a straggler profile online and switch to "
                      "the Pareto-optimal code for the accuracy target")
    tune.add_argument("--target-error", type=float, default=1e-2,
                      help="autotune accuracy target (relative error)")
    tune.add_argument("--profile-window", type=int, default=16,
                      help="requests between autotune profile refits (the "
                      "cold-start gate when --drift is set)")
    tune.add_argument("--drift", default="none",
                      choices=("none", "ks", "page_hinkley"),
                      help="refit on detected completion-time drift instead "
                      "of every fixed window")
    tune.add_argument("--drift-alpha", type=float, default=0.01,
                      help="KS drift test significance level")
    tune.add_argument("--per-class", action="store_true",
                      help="separate straggler profiles and code picks per "
                      "request class (rows bucket, inner dim, dtype)")
    tune.add_argument("--cost-aware", action="store_true",
                      help="pick the cheapest fleet meeting --target-error "
                      "instead of max accuracy at pinned N")
    tune.add_argument("--scale-out", action="store_true",
                      help="let a drift-detected tail worsening request a "
                      "larger fleet (up to --N)")
    tune.add_argument("--N-options", default=None,
                      help="comma-separated candidate fleet sizes for the "
                      "cost axis (default: pinned --N)")
    tune.add_argument("--profile-state", default=None, metavar="PATH",
                      help="JSON snapshot of fitted profiles + sweep "
                      "caches; loaded at start if present, saved on exit")

    obs = ap.add_argument_group(
        "observability", "metrics registry, per-shard trace export, and "
        "the crash flight recorder")
    obs.add_argument("--metrics-out", default=None, metavar="PATH",
                     help="save a JSON metrics snapshot (serve and cache "
                     "counters) on exit")
    obs.add_argument("--trace-out", default=None, metavar="PATH",
                     help="save per-shard spans + accuracy-milestone "
                     "instants as Chrome trace-event JSON (open in "
                     "Perfetto or chrome://tracing)")
    obs.add_argument("--flight-recorder", default=None, metavar="PATH",
                     help="dump the last-N runtime events + a metrics "
                     "snapshot to PATH when a serve aborts (exception, "
                     "all-shards-lost batch, hang-abandon)")
    obs.add_argument("--sample-interval", type=float, default=None,
                     metavar="SECONDS",
                     help="tick a ring-buffer time-series sampler from the "
                     "event loop every SECONDS (on the virtual serve "
                     "clock)")
    obs.add_argument("--metrics-port", type=int, default=None,
                     metavar="PORT",
                     help="serve live Prometheus text (/metrics) and a "
                     "JSON scrape (/json) on 127.0.0.1:PORT from a "
                     "background thread (0 = ephemeral port)")
    obs.add_argument("--burn-alerts", action="store_true",
                     help="track per-tenant SLO error-budget burn rate "
                     "(multi-window 1x/6x) and stamp fire/clear alerts "
                     "into the trace + flight recorder")
    obs.add_argument("--burn-objective", type=float, default=0.9,
                     help="--burn-alerts: target SLO hit fraction "
                     "(default 0.9 — a 10%% error budget)")
    obs.add_argument("--burn-window", type=float, default=30.0,
                     help="--burn-alerts: long burn window in serve-clock "
                     "seconds (short window is 1/6 of it; default 30)")
    return ap


def _collect_problems(args) -> list[str]:
    """Every illegal flag combination at once, with actionable messages."""
    problems = []
    if args.inner % args.K != 0:
        problems.append(f"--inner {args.inner} must be divisible by --K "
                        f"{args.K} (the contraction dim splits into K "
                        "blocks)")
    if args.batch_size < 1:
        problems.append(f"--batch-size must be >= 1; got {args.batch_size}")
    if args.class_cache < 0:
        problems.append(f"--class-cache must be >= 0; got "
                        f"{args.class_cache}")
    if args.cache_size < 0:
        problems.append(f"--cache-size must be >= 0; got {args.cache_size}")
    problems.extend(validate_args(args.code, args.K, args.N))
    if args.sample_interval is not None and args.sample_interval <= 0:
        problems.append(f"--sample-interval must be > 0; got "
                        f"{args.sample_interval}")
    if args.metrics_port is not None \
            and not 0 <= args.metrics_port <= 65535:
        problems.append(f"--metrics-port must be in [0, 65535]; got "
                        f"{args.metrics_port}")
    if not args.burn_alerts:
        if args.burn_objective != 0.9:
            problems.append("--burn-objective requires --burn-alerts")
        if args.burn_window != 30.0:
            problems.append("--burn-window requires --burn-alerts")
    elif not 0.0 < args.burn_objective < 1.0:
        problems.append(f"--burn-objective must be in (0, 1); got "
                        f"{args.burn_objective}")
    elif args.burn_window <= 0:
        problems.append(f"--burn-window must be > 0; got "
                        f"{args.burn_window}")
    for flag, name in ((args.drift != "none", "--drift"),
                       (args.per_class, "--per-class"),
                       (args.cost_aware, "--cost-aware"),
                       (args.scale_out, "--scale-out"),
                       (args.N_options is not None, "--N-options"),
                       (args.profile_state is not None, "--profile-state")):
        if flag and not args.autotune:
            problems.append(f"{name} requires --autotune")
    if args.autotune and args.profile_window < 1:
        problems.append(f"--profile-window must be >= 1; got "
                        f"{args.profile_window}")
    if args.N_options is not None:
        try:
            N_options = tuple(int(x) for x in args.N_options.split(","))
        except ValueError:
            problems.append(f"--N-options must be comma-separated "
                            f"integers; got {args.N_options!r}")
        else:
            if any(n < 1 or n > args.N for n in N_options):
                problems.append(f"every --N-options entry must be in [1, "
                                f"--N {args.N}] on backend "
                                f"{args.backend!r} (acquiring workers past "
                                f"--N needs the worker-process cluster); "
                                f"got {list(N_options)}")
    return problems


def _effective_config(args, deadlines) -> str:
    """One JSON line of the effective configuration.

    The reference's keys, with the cluster flags this port does not take at
    their fixed values, plus ``device``."""
    cfg = {"code": args.code, "K": args.K, "N": args.N,
           "backend": args.backend, "requests": args.requests,
           "batch_size": args.batch_size, "decoder": args.decoder,
           "deadlines": list(deadlines), "seed": args.seed,
           "stream": bool(args.stream), "autotune": bool(args.autotune),
           "speculate": False, "replicate": 1, "device": args.device}
    if args.autotune:
        cfg.update(target_error=args.target_error,
                   profile_window=args.profile_window, drift=args.drift)
    return json.dumps(cfg, sort_keys=True)


@dataclass
class ServeReport:
    """JSON-serializable record of one serve run (the ``--json`` payload).

    Every field is plain data (dicts / lists / scalars), so the report
    round-trips through :meth:`to_json` / :meth:`from_json` unchanged and CI
    can assert on stable fields instead of grepping renderer text.  The text
    renderer (:func:`_render_report`) is a pure function of this object.
    """

    config: dict                      # effective config (+ problem shape)
    code: dict                        # served code + render context
    requests: list = field(default_factory=list)   # per-request answers
    summary: dict = field(default_factory=dict)    # wall / rps / deadlines
    cache: dict | None = None         # decode-weight cache stats
    autotune: dict | None = None      # restore / retune / save trail
    cluster: dict | None = None       # always None: no cluster in the port
    observability: dict | None = None  # metrics / trace / flight paths

    def to_dict(self) -> dict:
        return {"kind": "serve-report", "config": self.config,
                "code": self.code, "requests": self.requests,
                "summary": self.summary, "cache": self.cache,
                "autotune": self.autotune, "cluster": self.cluster,
                "observability": self.observability}

    @classmethod
    def from_dict(cls, d: dict) -> "ServeReport":
        if d.get("kind") != "serve-report":
            raise ValueError(f"not a serve-report payload: "
                             f"kind={d.get('kind')!r}")
        return cls(config=d["config"], code=d["code"],
                   requests=d["requests"], summary=d["summary"],
                   cache=d.get("cache"), autotune=d.get("autotune"),
                   cluster=d.get("cluster"),
                   observability=d.get("observability"))

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "ServeReport":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> str:
        return write_json_atomic(path, self.to_dict())


def _scalar(x):
    """numpy scalar -> python scalar (json-safe), preserving int vs float."""
    return x.item() if hasattr(x, "item") else x


def run_serve(args) -> ServeReport:
    """Run one serve configuration end to end; no output except aborts.

    The programmatic core behind :func:`main`: builds the backend /
    scheduler / policies from a parsed-args namespace, runs the request
    batch, and returns a :class:`ServeReport`.  Side-effect files
    (--record, --metrics-out, --trace-out, --profile-state) are written
    here; only their paths land in the report.  Raises ``SystemExit`` with
    the same actionable messages as the CLI for invalid configurations, and
    ``RuntimeError`` when ``--device cuda`` finds no card.
    """
    problems = _collect_problems(args)
    if problems:
        raise SystemExit("[serve] invalid arguments:\n  " +
                         "\n  ".join(problems))
    code = CODES[args.code].build(args.K, args.N)
    deadlines = tuple(float(x) for x in args.deadlines.split(","))
    config = json.loads(_effective_config(args, deadlines))
    config.update(rows=args.rows, inner=args.inner,
                  straggler_frac=args.straggler_frac,
                  cache_size=args.cache_size, class_cache=args.class_cache)
    # the device first: without a card this raises before anything starts
    backend = make_backend(args.backend, device=args.device,
                           straggler_frac=args.straggler_frac)
    # observability wiring: a live registry when anything will read it
    # (the flight recorder snapshots it into every dump, the sampler /
    # exporter / burn tracker read it live); None otherwise so every
    # layer keeps its no-op instruments
    from repro_torch.obs import (BurnRateTracker, FlightRecorder,
                                 MetricsExporter, MetricsRegistry,
                                 TimeSeriesSampler, Tracer)
    live_obs = (args.sample_interval is not None
                or args.metrics_port is not None or args.burn_alerts)
    registry = MetricsRegistry() \
        if (args.metrics_out is not None
            or args.flight_recorder is not None or live_obs) else None
    tracer = Tracer() if args.trace_out is not None else None
    flight = FlightRecorder(args.flight_recorder) \
        if args.flight_recorder is not None else None
    # an exporter without an explicit sampling interval still gets a
    # series to serve: default to 4 Hz
    interval = args.sample_interval if args.sample_interval is not None \
        else (0.25 if args.metrics_port is not None else None)
    sampler = TimeSeriesSampler(registry, interval=interval) \
        if interval is not None else None
    burn = None
    if args.burn_alerts:
        from repro_torch.obs import NULL_FLIGHT, NULL_TRACER
        burn = BurnRateTracker(
            objective=args.burn_objective, window=args.burn_window,
            metrics=registry,
            tracer=tracer if tracer is not None else NULL_TRACER,
            flight=flight if flight is not None else NULL_FLIGHT)
    exporter = None
    if args.metrics_port is not None:
        from repro_torch.obs import NULL_BURN, NULL_SAMPLER
        exporter = MetricsExporter(
            registry, sampler=sampler if sampler is not None
            else NULL_SAMPLER,
            burn=burn if burn is not None else NULL_BURN,
            port=args.metrics_port).start()
    cfg = ServeConfig(deadlines=deadlines, stream=args.stream,
                      batch_size=args.batch_size, beta_mode=args.beta,
                      decoder=args.decoder, seed=args.seed)
    # the recompute baseline never consults the cache — don't create one,
    # so the stats section only appears when caching is actually in play
    cache = DecodeWeightCache(args.cache_size,
                              class_budget=args.class_cache or None,
                              track_classes=args.class_cache > 0
                              or args.per_class, metrics=registry) \
        if args.cache_size > 0 and args.decoder == "incremental" else None
    policy = None
    if args.autotune:
        from repro_torch.design import AdaptivePolicy, CodeSpace
        N_options = None
        if args.N_options is not None:
            N_options = tuple(int(x) for x in args.N_options.split(","))
        drift = None if args.drift == "none" else args.drift
        drift_kw = {"alpha": args.drift_alpha} if drift == "ks" else {}
        policy = AdaptivePolicy(
            CodeSpace(args.K, args.N, beta_modes=(args.beta,),
                      N_options=N_options),
            deadline=min(deadlines), target_error=args.target_error,
            window=args.profile_window, seed=args.seed, drift=drift,
            drift_kw=drift_kw, per_class=args.per_class,
            cost_aware=args.cost_aware, scale_out=args.scale_out)
    sched = MasterScheduler(code, backend, cfg, cache, policy=policy,
                            metrics=registry, tracer=tracer, flight=flight,
                            sampler=sampler, burn=burn)
    tune_report = None
    if args.autotune:
        tune_report = {"restored": False, "restored_from": None,
                       "restored_picks": [], "retunes": [],
                       "no_retune": None, "state_saved": None,
                       "classes_saved": None, "space": len(policy.space)}
    if args.profile_state is not None and os.path.exists(args.profile_state):
        from repro_torch.design import load_state
        try:
            warm = load_state(policy, args.profile_state)
        except (ValueError, KeyError, OSError) as e:
            raise SystemExit(f"[serve] --profile-state "
                             f"{args.profile_state}: {e}")
        for cls, warm_code in warm.items():
            sched.set_code(warm_code, cls=cls)
        labels = [policy._state(cls).current_spec.label()
                  for cls in warm] or ["(no pick yet)"]
        tune_report.update(restored=True, restored_from=args.profile_state,
                           restored_picks=labels)
    # after the warm restore: set_code intentionally resets the fleet cap
    # (it was sized for the previous code), so the operator's explicit
    # --fleet must be applied to whatever code actually starts serving
    fleet_of = None
    if args.fleet is not None:
        try:
            sched.set_fleet(args.fleet)
        except ValueError as e:
            raise SystemExit(f"[serve] invalid arguments:\n  --fleet: {e}")
        fleet_of = sched.code.N

    rng = np.random.default_rng(args.seed)
    code_report = {"name": args.code, "K": args.K, "N": args.N,
                   "R": code.recovery_threshold,
                   "first": code.first_threshold,
                   "straggler_frac": args.straggler_frac,
                   "decoder": args.decoder, "backend": args.backend,
                   "batch": args.batch_size, "fleet": args.fleet,
                   "fleet_of": fleet_of}
    for _ in range(args.requests):
        A = rng.standard_normal((args.rows, args.inner))
        B = rng.standard_normal((args.inner, args.rows))
        sched.submit(A, B)

    if sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    t0 = time.time()
    try:
        results = sched.run()
        if sched.device.type == "cuda":
            torch.cuda.synchronize(sched.device)
    except BaseException:
        # an aborting serve is exactly what the flight recorder is for:
        # dump the ring before the traceback unwinds the process
        if flight is not None:
            path = flight.dump("exception", registry)
            print(f"[serve] flight recorder dumped {len(flight)} event(s) "
                  f"to {path} (reason: exception)")
        if exporter is not None:
            exporter.stop()
        raise
    wall = time.time() - t0

    agg = {dl: [] for dl in deadlines}
    ttfa = []
    requests = []
    for res in results:
        answers = [{"t": _scalar(a.t), "m": int(a.m), "kind": a.kind,
                    "rel_err": (None if a.rel_err is None
                                else float(a.rel_err))}
                   for a in res.answers]
        # lifecycle stamps ride along for offline attribution
        # (tools/sac_top.py attribution); additive keys only — the
        # pinned [serve] req lines never read them
        requests.append({"req_id": res.req_id, "answers": answers,
                         "batch": res.batch, "tenant": res.tenant,
                         "arrival": res.arrival,
                         "t_dispatch": res.t_dispatch,
                         "t_target": res.t_target, "t_done": res.t_done,
                         "t_exact": res.t_exact, "ttfa": res.ttfa,
                         "slo_ok": res.slo_ok, "dropped": res.dropped})
        for a in res.answers:
            if a.kind == "deadline" and a.rel_err is not None:
                agg[a.t].append(a.rel_err)
        # the time a client actually received the first estimate: the first
        # emitted answer carrying one (in deadline mode that is the tick
        # after the first-threshold completion, not the completion itself)
        first = next((a.t for a in res.answers if a.rel_err is not None),
                     None)
        if first is not None:
            ttfa.append(first)
    summary = {"requests": len(results), "wall_s": wall,
               "rps": len(results) / max(wall, 1e-9),
               "mean_ttfa": float(np.mean(ttfa)) if ttfa else None,
               "deadlines": [{"deadline": dl,
                              "mean_err": float(np.mean(agg[dl])),
                              "answers": len(agg[dl])}
                             for dl in deadlines if agg[dl]]}
    cache_report = None
    if cache is not None:
        st = cache.stats()
        cache_report = {"hits": int(st["hits"]), "misses": int(st["misses"]),
                        "hit_rate": float(st["hit_rate"]),
                        "size": int(st["size"]), "classes": []}
        for cls, cst in sorted(cache.class_stats().items(),
                               key=lambda kv: kv[0].label()):
            row = {"label": cls.label(), "hits": int(cst["hits"]),
                   "misses": int(cst["misses"]),
                   "hit_rate": float(cst["hit_rate"]),
                   "budget": cst["budget"]}
            if "size" in cst:
                row["size"] = int(cst["size"])
            cache_report["classes"].append(row)
    if policy is not None:
        for ev in policy.history:
            tune_report["retunes"].append({
                "n_seen": int(ev.n_seen),
                "cls": ev.cls.label() if ev.cls is not None else None,
                "profile_kind": ev.profile.kind,
                "ks": float(ev.profile.ks), "trigger": ev.trigger,
                "switched": bool(ev.switched),
                "pick": ev.point.spec.label(),
                "err_at_deadline": float(ev.point.err_at_deadline),
                "tta": float(ev.point.tta),
                "cost": _scalar(ev.point.cost)})
        if not policy.history:
            restored = any(policy._state(c).tuned for c in policy.classes())
            tune_report["no_retune"] = "restored" if restored else "window"
        if args.profile_state is not None:
            from repro_torch.design import save_state
            save_state(policy, args.profile_state)
            tune_report.update(state_saved=args.profile_state,
                               classes_saved=len(policy.classes()))
    obs_report = None
    if (args.metrics_out is not None or tracer is not None
            or flight is not None or live_obs):
        obs_report = {"metrics_out": args.metrics_out,
                      "trace_out": args.trace_out,
                      "trace_events": (tracer.n_events
                                       if tracer is not None else None),
                      "flight_recorder": args.flight_recorder,
                      "flight_dumps": (list(flight.dumps)
                                       if flight is not None else [])}
        if sampler is not None:
            obs_report["sample_interval"] = sampler.interval
            obs_report["samples"] = len(sampler)
        if exporter is not None:
            obs_report["metrics_port"] = exporter.port
        if burn is not None:
            obs_report["burn"] = {"objective": burn.objective,
                                  "window": burn.window,
                                  "alerts": len(burn.alerts),
                                  "firing": burn.firing()}
        if args.metrics_out is not None:
            registry.save(args.metrics_out)
        if tracer is not None:
            tracer.save(args.trace_out)
    if exporter is not None:
        exporter.stop()
    return ServeReport(config=config, code=code_report, requests=requests,
                       summary=summary, cache=cache_report,
                       autotune=tune_report, observability=obs_report)


def _render_report(rep: ServeReport) -> None:
    """Text renderer: the historical ``[serve] ...`` lines, from the report.

    Pure presentation — every value comes from the :class:`ServeReport`.
    """
    tune, cd = rep.autotune, rep.code
    cfg = rep.config
    if tune is not None and tune["restored"]:
        picks = tune["restored_picks"] or ["(no pick yet)"]
        print(f"[serve] restored profile state from {tune['restored_from']}: "
              f"{len(tune['restored_picks'])} warm pick(s) "
              f"[{', '.join(picks)}] — cold-start window skipped")
    if cd["fleet"] is not None:
        print(f"[serve] fleet restricted to the first {cd['fleet']} of "
              f"{cd['fleet_of']} shards")
    tune_s = (f" autotune(target={cfg['target_error']:g}, "
              f"window={cfg['profile_window']}, "
              f"space={tune['space']})" if tune is not None else "")
    print(f"[serve] code={cd['name']} K={cd['K']} N={cd['N']} "
          f"R={cd['R']} first={cd['first']} "
          f"straggler_frac={cd['straggler_frac']} decoder={cd['decoder']} "
          f"backend={cd['backend']} batch={cd['batch']}{tune_s} "
          f"device={cfg['device']}")
    for req in rep.requests:
        line = " | ".join(
            f"t={a['t']:.1f}: m={a['m']:2d} " +
            (f"err={a['rel_err']:.2e}" if a["rel_err"] is not None
             else "no-estimate")
            for a in req["answers"] if a["kind"] == "deadline")
        print(f"[serve] req {req['req_id']}: {line}")
    s = rep.summary
    first = (f"; mean time-to-first-answer {s['mean_ttfa']:.3f}"
             if s["mean_ttfa"] is not None else "")
    print(f"[serve] {s['requests']} requests in {s['wall_s']:.2f}s "
          f"({s['rps']:.1f} req/s){first}")
    for row in s["deadlines"]:
        print(f"[serve] deadline {row['deadline']:.1f}: mean rel err "
              f"{row['mean_err']:.3e} over {row['answers']} answers")
    if rep.cache is not None:
        st = rep.cache
        print(f"[serve] decode-weight cache: {st['hits']} hits / "
              f"{st['misses']} misses (hit rate {st['hit_rate']:.0%}, "
              f"size {st['size']})")
        for cst in st["classes"]:
            budget = (f"budget {cst['budget']}" if cst["budget"] is not None
                      else "shared")
            size = f", size {cst['size']}" if "size" in cst else ""
            print(f"[serve]   class {cst['label']}: {cst['hits']} hits / "
                  f"{cst['misses']} misses (hit rate {cst['hit_rate']:.0%}, "
                  f"{budget}{size})")
    if tune is not None:
        dl_min = min(cfg["deadlines"])
        for ev in tune["retunes"]:
            mark = "switch ->" if ev["switched"] else "keep"
            cls = f" [{ev['cls']}]" if ev["cls"] is not None else ""
            trig = f", {ev['trigger']}" if ev["trigger"] != "window" else ""
            print(f"[serve] retune @{ev['n_seen']} req{cls} "
                  f"({ev['profile_kind']} profile, ks={ev['ks']:.3f}"
                  f"{trig}): {mark} {ev['pick']} "
                  f"(E[err@{dl_min:g}]={ev['err_at_deadline']:.2e},"
                  f" tta={ev['tta']:.2f}, cost={ev['cost']})")
        if tune["no_retune"] == "restored":
            print("[serve] autotune: no retune fired this run "
                  "(restored picks stayed; drift never triggered)")
        elif tune["no_retune"] == "window":
            print(f"[serve] autotune: window {cfg['profile_window']} "
                  f"never filled ({cfg['requests']} requests) — no "
                  "retune ran")
        if tune["state_saved"] is not None:
            print(f"[serve] saved profile state to {tune['state_saved']} "
                  f"({tune['classes_saved']} class(es))")
    if rep.observability is not None:
        ob = rep.observability
        if ob["metrics_out"] is not None:
            print(f"[serve] metrics snapshot saved to {ob['metrics_out']}")
        if ob["trace_out"] is not None:
            print(f"[serve] trace: {ob['trace_events']} event(s) written to "
                  f"{ob['trace_out']} (open in Perfetto or "
                  "chrome://tracing)")
        if ob["flight_recorder"] is not None:
            for path in ob["flight_dumps"]:
                print(f"[serve] flight recorder dumped to {path}")
            if not ob["flight_dumps"]:
                print("[serve] flight recorder armed; no abort, nothing "
                      "dumped")
        if "samples" in ob:
            print(f"[serve] time-series: {ob['samples']} sample(s) at "
                  f"{ob['sample_interval']}s interval")
        if "metrics_port" in ob:
            print(f"[serve] metrics exporter served on port "
                  f"{ob['metrics_port']}")
        if "burn" in ob:
            b = ob["burn"]
            firing = ", ".join(b["firing"]) if b["firing"] else "none"
            print(f"[serve] burn-rate: objective {b['objective']:g}, "
                  f"window {b['window']:g}s, {b['alerts']} alert "
                  f"transition(s), firing at exit: {firing}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    problems = _collect_problems(args)
    if problems:
        raise SystemExit("[serve] invalid arguments:\n  " +
                         "\n  ".join(problems))
    if not args.json:
        deadlines = tuple(float(x) for x in args.deadlines.split(","))
        print(f"[serve] config {_effective_config(args, deadlines)}")
    report = run_serve(args)
    if args.json:
        print(report.to_json())
    else:
        _render_report(report)


if __name__ == "__main__":
    main()
