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
run.

Cluster runtime (``--backend cluster``): shards execute on a real worker
pool (:mod:`repro_torch.cluster`) and completion times are *measured* —
deadlines become wall-clock seconds from dispatch.  ``--workers`` is the
starting fleet (the pool acquires more whenever the serving code needs
them — the scale-out path), ``--spares`` keeps warm spares after releases,
``--grace`` bounds the wait for stragglers past the last deadline,
``--chaos`` injects reproducible perturbations (``sleep:LO:HI``,
``slow:C:DELAY``, ``crash:C``, ``hang:C``), ``--record PATH`` saves the
measured completion trace, and ``--replay PATH`` (``--backend replay``)
re-serves a recorded trace through the simulated product path
(bit-identical decode outputs).  ``--compute {device,numpy}`` picks the
shard-product implementation each worker runs: the ``coded_matmul`` kernel
on the worker's card (the default; ``--device cpu``: its plain version),
or the reference's float64 numpy einsum; ``--transport {local,socket}``
picks the master<->worker plumbing (pipes + shared memory, or framed TCP
with ``--hosts`` listener addresses).  A trace replays with ``--replay
PATH`` and the ``--compute`` it was recorded with.  With ``--autotune
--scale-out``, ``--N-options`` entries above ``--N`` are allowed on the
cluster backend::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --backend cluster --code matdot --K 2 --N 4 \
        --workers 4 --chaos crash:1,sleep:0.01:0.05 --requests 4 \
        --rows 16 --inner 64 --record trace.json
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --replay trace.json --code matdot --K 2 --N 4 \
        --requests 4 --rows 16 --inner 64

Speculative execution (``--speculate``, cluster backend): the scheduler
watches the live event stream and re-dispatches a still-pending shard to a
freshly leased backup worker when the straggler profile says it is unlikely
to finish before the deadline relative to the marginal value of its
resolution layer (``--hedge-threshold``).  First completion wins, losing
copies are cancelled (counted separately from losses), and crashed workers'
shards are re-queued to their replacements instead of abandoned.
``--replicate r`` instead pins ``r-1`` up-front copies of every shard — the
classic replication baseline the paper compares SAC against.

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
from repro_torch.device import resolve_device
from repro_torch.ioutil import write_json_atomic
from repro_torch.serving import (DecodeWeightCache, MasterScheduler,
                                 ServeConfig, make_backend, serve_request)

__all__ = ["CODES", "ServeReport", "build_code", "build_parser",
           "draw_operands", "validate_args", "serve_request", "run_serve",
           "main"]


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
        "fleet", "execution backend and worker-pool sizing")
    fleet.add_argument("--backend", default=None,
                       choices=("device", "sim", "cluster", "replay"),
                       help="worker products in the CUDA kernels (device, "
                       "the default), in float64 (sim, the oracle), on a "
                       "real multiprocess worker pool (cluster), or from a "
                       "recorded cluster trace (replay, the default with "
                       "--replay)")
    fleet.add_argument("--workers", type=int, default=4,
                       help="cluster: starting worker-pool size (grows on "
                       "demand — the scale-out path)")
    fleet.add_argument("--spares", type=int, default=0,
                       help="cluster: warm spare workers kept after "
                       "releases")
    fleet.add_argument("--grace", type=float, default=2.0,
                       help="cluster: seconds past the last deadline before "
                       "pending shards are abandoned (hang bound)")
    fleet.add_argument("--fleet", type=int, default=None,
                       help="dispatch only the first N encode shards of the "
                       "starting code (operator override)")
    fleet.add_argument("--compute", default=None,
                       choices=("device", "numpy"),
                       help="cluster/replay: shard products in the "
                       "coded_matmul kernel on each worker's card (device, "
                       "the default; its plain version with --device cpu) "
                       "or in the reference's float64 numpy einsum")
    fleet.add_argument("--transport", default="local",
                       choices=("local", "socket"),
                       help="cluster: master<->worker plumbing — pipes + "
                       "shared memory, or length-prefixed frames over TCP")
    fleet.add_argument("--hosts", default=None,
                       help="cluster --transport socket: comma-separated "
                       "listener addresses (default 127.0.0.1,127.0.0.1 — "
                       "two localhost 'hosts')")

    chaos = ap.add_argument_group(
        "chaos", "fault injection and trace record/replay")
    chaos.add_argument("--chaos", default=None,
                       help="cluster: injected perturbations, e.g. "
                       "'crash:1,sleep:0.01:0.05,slow:2:0.3,hang:1'")
    chaos.add_argument("--record", default=None, metavar="PATH",
                       help="cluster: save the measured completion trace as "
                       "JSON for --replay")
    chaos.add_argument("--replay", default=None, metavar="PATH",
                       help="re-serve a recorded cluster trace through the "
                       "simulated product path (bit-identical decode)")

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
                      "larger fleet (with --backend cluster the pool "
                      "acquires the workers)")
    tune.add_argument("--N-options", default=None,
                      help="comma-separated candidate fleet sizes for the "
                      "cost axis (default: pinned --N)")
    tune.add_argument("--profile-state", default=None, metavar="PATH",
                      help="JSON snapshot of fitted profiles + sweep "
                      "caches; loaded at start if present, saved on exit")

    spec = ap.add_argument_group(
        "speculation", "mid-batch shard re-dispatch (hedging) and the "
        "pinned-replication baseline")
    spec.add_argument("--speculate", action="store_true",
                      help="re-dispatch likely-late shards to backup "
                      "workers mid-batch; first completion wins, crashed "
                      "workers' shards re-queue to their replacements")
    spec.add_argument("--hedge-threshold", type=float, default=0.5,
                      help="hedge when P(finish by deadline) < threshold × "
                      "layer value of the shard's next completion")
    spec.add_argument("--max-speculations", type=int, default=None,
                      help="cap on speculative launches per batch "
                      "(default: unbounded)")
    spec.add_argument("--replicate", type=int, default=1,
                      help="pin r-1 up-front copies of every shard — the "
                      "replication baseline, no hedging policy in the loop")
    spec.add_argument("--max-requeue", type=int, default=3,
                      help="dispatch attempts per shard before a crashed "
                      "chain is declared lost (--speculate)")

    obs = ap.add_argument_group(
        "observability", "metrics registry, per-shard trace export, and "
        "the crash flight recorder")
    obs.add_argument("--metrics-out", default=None, metavar="PATH",
                     help="save a JSON metrics snapshot (pool/transport/"
                     "backend/serve/cache counters) on exit")
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
                     "event loop every SECONDS (virtual clock on modeled "
                     "backends, wall clock on the cluster)")
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


def _backend_name(args) -> str:
    """The backend ``--backend`` names, or its default: ``replay`` with
    ``--replay``, else ``device``."""
    if args.backend is not None:
        return args.backend
    return "replay" if args.replay is not None else "device"


def _collect_problems(args) -> list[str]:
    """Every illegal flag combination at once, with actionable messages."""
    problems = []
    backend = _backend_name(args)
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
    for flag, name in ((args.chaos is not None, "--chaos"),
                       (args.record is not None, "--record"),
                       (args.spares != 0, "--spares"),
                       (args.transport != "local", "--transport socket"),
                       (args.hosts is not None, "--hosts")):
        if flag and backend != "cluster":
            problems.append(f"{name} requires --backend cluster")
    if backend == "cluster":
        if args.workers < 0 or args.spares < 0:
            problems.append(f"--workers and --spares must be >= 0; got "
                            f"{args.workers}, {args.spares}")
        if args.grace <= 0:
            problems.append(f"--grace must be > 0; got {args.grace}")
    if args.hosts is not None and args.transport != "socket":
        problems.append("--hosts requires --transport socket (the local "
                        "transport has no listener addresses)")
    # device compute runs on the cluster's worker processes, or during
    # replay (ReplayBackend recomputes each shard through the same kernel
    # path) — the modeled backends have their own product story
    if args.compute == "device" and backend not in ("cluster", "replay"):
        problems.append("--compute device requires --backend cluster or "
                        "--replay PATH (re-serving a device-mode trace)")
    if backend == "replay" and args.replay is None:
        problems.append("--backend replay needs --replay PATH (the "
                        "recorded cluster trace)")
    if args.replay is not None and backend not in ("replay", "sim"):
        problems.append(f"--replay re-serves the trace through the "
                        f"simulated product path; drop --backend "
                        f"{backend}")
    # speculation group: hedging needs real in-flight shards (cluster) or a
    # recorded trace of a speculative run (replay); modeled backends have
    # nothing to re-dispatch
    if args.speculate and backend != "cluster" and args.replay is None:
        problems.append("--speculate requires --backend cluster (live "
                        "hedging) or --replay PATH (re-serving a recorded "
                        "speculative trace)")
    if args.replicate < 1:
        problems.append(f"--replicate must be >= 1; got {args.replicate}")
    elif args.replicate > 1 and backend != "cluster":
        problems.append("--replicate requires --backend cluster (pinned "
                        "copies run on real backup workers)")
    if not args.speculate:
        if args.hedge_threshold != 0.5:
            problems.append("--hedge-threshold requires --speculate")
        if args.max_speculations is not None:
            problems.append("--max-speculations requires --speculate")
    if args.max_requeue < 1:
        problems.append(f"--max-requeue must be >= 1; got "
                        f"{args.max_requeue}")
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
            # the cluster backend has a worker acquisition story, so fleet
            # candidates above the starting --N are servable (the pool
            # grows); modeled backends stay bounded by the starting fleet
            if backend == "cluster":
                if any(n < 1 for n in N_options):
                    problems.append(f"every --N-options entry must be >= 1; "
                                    f"got {list(N_options)}")
            elif any(n < 1 or n > args.N for n in N_options):
                problems.append(f"every --N-options entry must be in [1, "
                                f"--N {args.N}] on backend "
                                f"{backend!r} (only the cluster backend can "
                                f"acquire workers past --N); got "
                                f"{list(N_options)}")
    return problems


def _compute_kind(args) -> str:
    """The cluster/replay shard compute: ``--compute``, else ``device``."""
    return args.compute or "device"


def _effective_config(args, deadlines) -> str:
    """One JSON line of the effective configuration: the reference's keys,
    plus ``device``."""
    backend = _backend_name(args)
    cfg = {"code": args.code, "K": args.K, "N": args.N,
           "backend": backend if args.replay is None else "replay",
           "requests": args.requests, "batch_size": args.batch_size,
           "decoder": args.decoder, "deadlines": list(deadlines),
           "seed": args.seed, "stream": bool(args.stream),
           "autotune": bool(args.autotune),
           "speculate": bool(args.speculate),
           "replicate": args.replicate, "device": args.device}
    if backend == "cluster":
        cfg.update(workers=args.workers, spares=args.spares,
                   chaos=args.chaos, grace=args.grace,
                   compute=_compute_kind(args), transport=args.transport)
    if args.replay is not None:
        cfg.update(compute=_compute_kind(args))
    if args.speculate:
        cfg.update(hedge_threshold=args.hedge_threshold,
                   max_speculations=args.max_speculations,
                   max_requeue=args.max_requeue)
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
    cluster: dict | None = None       # pool + speculation + record stats
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


def run_serve(args, operands=None) -> ServeReport:
    """Run one serve configuration end to end; no output except aborts.

    The programmatic core behind :func:`main`: builds the backend /
    scheduler / policies from a parsed-args namespace, runs the request
    batch, and returns a :class:`ServeReport`.  ``operands`` are the
    ``--requests`` ``(A, B)`` pairs to serve; by default they are drawn
    from ``--seed``, and a caller that serves one job several times passes
    the list it drew once (``list(draw_operands(args))``).  Side-effect
    files (--record, --metrics-out, --trace-out, --profile-state) are written
    here; only their paths land in the report.  Raises ``SystemExit`` with
    the same actionable messages as the CLI for invalid configurations, and
    ``RuntimeError`` when ``--device cuda`` finds no card.  A cluster
    backend's workers are shut down on every exit path.
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
    backend_name = _backend_name(args)
    # the device first: without a card this raises before anything starts
    resolve_device(args.device)
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
    try:
        backend = _make_serve_backend(args, backend_name, registry)
    except BaseException:
        if exporter is not None:
            exporter.stop()
        raise
    try:
        return _serve_on(args, operands, backend, backend_name, code,
                         deadlines, config, registry, tracer, flight,
                         sampler, burn, exporter, live_obs)
    finally:
        if backend_name == "cluster":
            backend.close()


def _make_serve_backend(args, name: str, registry):
    """The execution backend the CLI flags describe."""
    if args.replay is not None:
        from repro_torch.cluster import TraceRecording
        try:
            recording = TraceRecording.load(args.replay)
        except (OSError, ValueError, KeyError) as e:
            raise SystemExit(f"[serve] --replay {args.replay}: {e}")
        return make_backend("replay", recording=recording,
                            compute=_compute_kind(args), device=args.device)
    if name == "cluster":
        hosts = (tuple(h.strip() for h in args.hosts.split(","))
                 if args.hosts is not None else None)
        try:
            return make_backend(
                "cluster", workers=args.workers, spares=args.spares,
                chaos=args.chaos, seed=args.seed,
                record=args.record is not None, grace=args.grace,
                speculate=args.speculate, replicate=args.replicate,
                max_requeue=args.max_requeue, compute=_compute_kind(args),
                transport=args.transport, hosts=hosts, metrics=registry,
                device=args.device)
        except ValueError as e:
            raise SystemExit(f"[serve] invalid arguments:\n  {e}")
    return make_backend(name, device=args.device,
                        straggler_frac=args.straggler_frac)


def draw_operands(args):
    """Yield the ``--requests`` ``(A, B)`` pairs a serve draws from
    ``--seed``, one at a time."""
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        A = rng.standard_normal((args.rows, args.inner))
        B = rng.standard_normal((args.inner, args.rows))
        yield A, B


def _serve_on(args, operands, backend, backend_name, code, deadlines,
              config, registry, tracer, flight, sampler, burn, exporter,
              live_obs) -> ServeReport:
    """Serve the CLI's requests on a built backend (see :func:`run_serve`)."""
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
    speculation = None
    if args.speculate:
        from repro_torch.design import SpeculationPolicy
        speculation = SpeculationPolicy(
            threshold=args.hedge_threshold,
            max_per_batch=args.max_speculations)
    sched = MasterScheduler(code, backend, cfg, cache, policy=policy,
                            speculation=speculation, metrics=registry,
                            tracer=tracer, flight=flight, sampler=sampler,
                            burn=burn)
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

    code_report = {"name": args.code, "K": args.K, "N": args.N,
                   "R": code.recovery_threshold,
                   "first": code.first_threshold,
                   "straggler_frac": args.straggler_frac,
                   "decoder": args.decoder,
                   "backend": "sim" if args.replay is not None
                   else backend_name,
                   "batch": args.batch_size, "fleet": args.fleet,
                   "fleet_of": fleet_of}
    if operands is None:
        operands = draw_operands(args)        # each pair submitted as drawn
    elif len(operands) != args.requests:
        raise ValueError(f"{len(operands)} operand pairs for --requests "
                         f"{args.requests}")
    for A, B in operands:
        sched.submit(A, B)

    startup_s = None
    if backend_name == "cluster":
        # the serve wall starts once the starting fleet is up: process
        # spawn (and a device worker's CUDA start) is not serving time
        t_up = time.time()
        backend.pool.wait_ready(timeout=backend.pool.ready_timeout)
        startup_s = time.time() - t_up
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
    cluster_report = None
    if backend_name == "cluster":
        pool = backend.pool
        ps = {k: int(v) for k, v in pool.stats.items()}
        cluster_report = {"pool": ps, "active": int(pool.size),
                          "spare": int(pool.spares),
                          "losses": [[int(b), int(s), why]
                                     for b, s, why in sched.losses],
                          "speculation": None, "recorded": None,
                          "startup_s": startup_s}
        if args.speculate or args.replicate > 1:
            by_reason = {}
            for _, _, why in sched.speculations:
                by_reason[why] = by_reason.get(why, 0) + 1
            cluster_report["speculation"] = {
                "launches": len(sched.speculations),
                "by_reason": by_reason,
                "requeued": ps["shards_requeued"],
                "backups_leased": ps["backups_leased"],
                "cancelled": ps["shards_cancelled"],
                "duplicates_reaped": ps["duplicates_reaped"]}
        if args.record is not None:
            backend.recording.save(args.record)
            cluster_report["recorded"] = {"path": args.record,
                                          "batches": len(backend.recording)}
        backend.close()
        # the workers' own launch counts, from their shutdown replies
        cluster_report["kernel_launches"] = pool.kernel_launches()
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
                       autotune=tune_report, cluster=cluster_report,
                       observability=obs_report)


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
    extra = ""
    if cfg["backend"] == "cluster":
        extra = (f" workers={cfg['workers']} spares={cfg['spares']} "
                 f"chaos={cfg['chaos'] or 'none'} compute={cfg['compute']} "
                 f"transport={cfg['transport']} (deadlines are wall-clock "
                 "seconds)")
    print(f"[serve] code={cd['name']} K={cd['K']} N={cd['N']} "
          f"R={cd['R']} first={cd['first']} "
          f"straggler_frac={cd['straggler_frac']} decoder={cd['decoder']} "
          f"backend={cd['backend']} batch={cd['batch']}{tune_s}{extra} "
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
    if rep.cluster is not None:
        cl, ps = rep.cluster, rep.cluster["pool"]
        print(f"[serve] cluster pool: {ps['spawned']} spawned, "
              f"{ps['acquired']} acquired, {ps['released']} released, "
              f"{ps['replaced']} replaced ({ps['crashed']} crashed, "
              f"{ps['retired']} retired); {cl['active']} active + "
              f"{cl['spare']} spare at exit")
        # shard-outcome tallies print unconditionally: cancellations and
        # reaped duplicates happen outside --speculate too (crash promotes
        # a racing copy, replication), and audits shouldn't need a rerun
        print(f"[serve] pool shards: {ps['shards_lost']} lost, "
              f"{ps['shards_cancelled']} cancelled, "
              f"{ps['duplicates_reaped']} duplicate(s) reaped, "
              f"{ps['shards_requeued']} re-queued")
        if cl["losses"]:
            lost = ", ".join(f"batch {b} shard {s} ({why})"
                             for b, s, why in cl["losses"])
            print(f"[serve] lost shards: {lost}")
        if cl["speculation"] is not None:
            sp = cl["speculation"]
            detail = ", ".join(f"{n} {why}" for why, n
                               in sorted(sp["by_reason"].items())) or "none"
            print(f"[serve] re-dispatch: {sp['launches']} "
                  f"speculative launch(es) ({detail}); "
                  f"{sp['requeued']} re-queued, "
                  f"{sp['backups_leased']} backup(s) leased")
            print(f"[serve] cancelled: {sp['cancelled']} first-wins "
                  f"loser(s), {sp['duplicates_reaped']} duplicate "
                  f"result(s) reaped")
        if cl["recorded"] is not None:
            print(f"[serve] recorded {cl['recorded']['batches']} batch "
                  f"trace(s) to {cl['recorded']['path']}")
        launches = ", ".join(f"{n} {k}" for k, n in
                             sorted(cl["kernel_launches"].items()))
        print(f"[serve] worker kernel launches: {launches or 'none'}")
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
