"""Serving CLI — thin front-end over :mod:`repro_torch.serving`.

A master accepts matmul jobs (the paper's C = A·B workload), encodes them
with a selected SAC code, fans the encoded products out to N workers with
shifted-exponential latencies, and answers with successive refinement: an
event-driven loop pushes each completion into an incremental decoder and
emits estimates at deadline ticks (or at every completion with
``--stream``).

``--backend device`` (the default) runs the encode and the worker products
in the hand-written CUDA kernels; ``--backend sim`` computes them on the
host in numpy float64 (the oracle).  Either way the operands, the reference
product, the decoders and the error norms live on ``--device`` — the CUDA
card unless ``--device cpu`` is given (the kernels' plain versions then run
on the CPU).  Operands are drawn with numpy exactly as the reference CLI
draws them, so the two packages serve identical requests::

    PYTHONPATH=src python -m repro_torch.launch.serve --code lsac_ortho \
        --rows 2048 --inner 32768 --requests 8 --json
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --rows 32 --inner 256 --requests 4
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core import (EpsApproxMatDotCode, GroupSACCode,
                              LayerSACCode, MatDotCode, x_complex)
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
    """The closed-loop serving CLI."""
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
    ap.add_argument("--backend", default="device", choices=("device", "sim"),
                    help="worker products in the CUDA kernels (device) or "
                    "on the host in numpy float64 (sim, the oracle)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where operands, products and decode state live")
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
    if args.cache_size < 0:
        problems.append(f"--cache-size must be >= 0; got {args.cache_size}")
    problems.extend(validate_args(args.code, args.K, args.N))
    return problems


def _effective_config(args, deadlines) -> str:
    """One JSON line of the effective configuration.

    The reference's keys, with the flags this port does not take at their
    fixed values, plus ``device``."""
    cfg = {"code": args.code, "K": args.K, "N": args.N,
           "backend": args.backend, "requests": args.requests,
           "batch_size": args.batch_size, "decoder": args.decoder,
           "deadlines": list(deadlines), "seed": args.seed,
           "stream": bool(args.stream), "autotune": False,
           "speculate": False, "replicate": 1, "device": args.device}
    return json.dumps(cfg, sort_keys=True)


@dataclass
class ServeReport:
    """JSON-serializable record of one serve run (the ``--json`` payload).

    The reference's keys; the sections of features this port does not have
    yet (``autotune``, ``cluster``, ``observability``) are ``None``.
    """

    config: dict                      # effective config (+ problem shape)
    code: dict                        # served code + render context
    requests: list = field(default_factory=list)   # per-request answers
    summary: dict = field(default_factory=dict)    # wall / rps / deadlines
    cache: dict | None = None         # decode-weight cache stats
    autotune: dict | None = None
    cluster: dict | None = None
    observability: dict | None = None

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


def run_serve(args) -> ServeReport:
    """Run one serve configuration end to end; returns a :class:`ServeReport`.

    Raises ``SystemExit`` with actionable messages for invalid
    configurations, and ``RuntimeError`` when ``--device cuda`` finds no
    card.
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
                  cache_size=args.cache_size, class_cache=0)
    backend = make_backend(args.backend, device=args.device,
                           straggler_frac=args.straggler_frac)
    cfg = ServeConfig(deadlines=deadlines, stream=args.stream,
                      batch_size=args.batch_size, beta_mode=args.beta,
                      decoder=args.decoder, seed=args.seed)
    # the recompute baseline never consults the cache — don't create one
    cache = DecodeWeightCache(args.cache_size) \
        if args.cache_size > 0 and args.decoder == "incremental" else None
    sched = MasterScheduler(code, backend, cfg, cache)

    rng = np.random.default_rng(args.seed)
    code_report = {"name": args.code, "K": args.K, "N": args.N,
                   "R": code.recovery_threshold,
                   "first": code.first_threshold,
                   "straggler_frac": args.straggler_frac,
                   "decoder": args.decoder, "backend": args.backend,
                   "batch": args.batch_size, "fleet": None,
                   "fleet_of": None}
    for _ in range(args.requests):
        A = rng.standard_normal((args.rows, args.inner))
        B = rng.standard_normal((args.inner, args.rows))
        sched.submit(A, B)

    if sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    t0 = time.time()
    results = sched.run()
    if sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    wall = time.time() - t0

    agg = {dl: [] for dl in deadlines}
    ttfa = []
    requests = []
    for res in results:
        answers = [{"t": float(a.t), "m": int(a.m), "kind": a.kind,
                    "rel_err": (None if a.rel_err is None
                                else float(a.rel_err))}
                   for a in res.answers]
        requests.append({"req_id": res.req_id, "answers": answers,
                         "batch": res.batch, "tenant": None,
                         "arrival": 0.0, "t_dispatch": None,
                         "t_target": None, "t_done": None,
                         "t_exact": res.t_exact, "ttfa": res.ttfa,
                         "slo_ok": None, "dropped": None})
        for a in res.answers:
            if a.kind == "deadline" and a.rel_err is not None:
                agg[a.t].append(a.rel_err)
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
    return ServeReport(config=config, code=code_report, requests=requests,
                       summary=summary, cache=cache_report)


def _render_report(rep: ServeReport) -> None:
    """Text renderer: the reference's ``[serve] ...`` lines, from the
    report."""
    cd = rep.code
    print(f"[serve] code={cd['name']} K={cd['K']} N={cd['N']} "
          f"R={cd['R']} first={cd['first']} "
          f"straggler_frac={cd['straggler_frac']} decoder={cd['decoder']} "
          f"backend={cd['backend']} batch={cd['batch']} "
          f"device={rep.config['device']}")
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
