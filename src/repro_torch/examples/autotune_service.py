"""End-to-end example: a serving fleet that tunes its own code.

A matmul service starts on the operator's classical pick — plain MatDot,
exact-only, nothing served before m = 2K-1 — on a fleet that turns out to
have a slow host class.  The :class:`AdaptivePolicy` watches the observed
worker latencies, refits a straggler profile every ``WINDOW`` requests
(the heterogeneous fleet trips the empirical-CDF fallback), sweeps the
full code space through the batched simulation engine, and switches the
master to the Pareto pick for the accuracy/deadline target.

The comparison is a paired counterfactual: the same request stream is
served twice with identical seeds — once adaptively, once pinned to the
starting code — so every per-deadline error difference on the post-switch
tail is the autotuner's doing.

The reference's ``examples/autotune_service.py`` on the port: the same
simulated backend on ``--device``, at the reference's sizes.

Run:  PYTHONPATH=src python -m repro_torch.examples.autotune_service \
          [--device cpu]
"""
import argparse

import numpy as np

from ..design import AdaptivePolicy, CodeSpace
from ..launch.serve import build_code
from ..serving import MasterScheduler, ServeConfig, SimulatedBackend

K, N = 8, 24
WINDOW = 16
DEADLINES = (1.7, 2.1, 3.0)
TARGET = 1e-2
REQUESTS = 48
INNER = 2000

BACKEND_KW = dict(model="heterogeneous", slow_frac=0.3, slow_shift=4.0,
                  slow_rate=0.3)


def serve(requests, policy, device):
    cfg = ServeConfig(deadlines=DEADLINES, batch_size=2, seed=3)
    sched = MasterScheduler(build_code("matdot", K, N),
                            SimulatedBackend(device=device, **BACKEND_KW),
                            cfg, policy=policy)
    for A, B in requests:
        sched.submit(A, B)
    return sched, sched.run()


def tail_errs(results, t, switch_at):
    return [a.rel_err for r in results if r.req_id >= switch_at
            for a in r.answers
            if a.kind == "deadline" and a.t == t and a.rel_err is not None]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(13)
    requests = [(rng.standard_normal((100, INNER)),
                 rng.standard_normal((INNER, 100)))
                for _ in range(REQUESTS)]

    space = CodeSpace(K, N, max_groups=2)
    policy = AdaptivePolicy(space, deadline=DEADLINES[0],
                            target_error=TARGET, window=WINDOW, trials=64,
                            seed=0)

    print("== autotuned matmul service vs the operator's fixed pick ==")
    print(f"   N={N} workers (30% slow hosts), K={K}, start code matdot, "
          f"space of {len(space)} candidates")
    print(f"   target: err <= {TARGET:g} at t={DEADLINES[0]}, refit every "
          f"{WINDOW} requests\n")

    sched, adaptive = serve(requests, policy, args.device)
    _, fixed = serve(requests, None, args.device)  # identical seeds

    for ev in policy.history:
        mark = "SWITCH ->" if ev.switched else "keep"
        print(f" retune @{ev.n_seen:3d} req: profile={ev.profile.kind} "
              f"(ks={ev.profile.ks:.3f})  {mark} {ev.point.spec.label()}  "
              f"E[err@{DEADLINES[0]}]={ev.point.err_at_deadline:.2e}  "
              f"tta={ev.point.tta:.2f}")

    switch_at = sched.switches[0][0] if sched.switches else REQUESTS

    n_tail = len([r for r in adaptive if r.req_id >= switch_at])
    print(f"\n post-switch tail ({n_tail} requests, same latency draws in "
          f"both runs):")
    for dl in DEADLINES:
        ea = tail_errs(adaptive, dl, switch_at)
        ef = tail_errs(fixed, dl, switch_at)
        fa = f"{np.mean(ea):.2e} ({len(ea)}/{n_tail} answered)" if ea \
            else "no answer yet"
        ff = f"{np.mean(ef):.2e} ({len(ef)}/{n_tail} answered)" if ef \
            else "no answer yet"
        print(f" deadline {dl:>4}: adaptive {fa:32s} fixed matdot {ff}")
    if sched.switches:
        print(f"\n first switch after request {switch_at}: "
              f"{sched.switches[0][1]} -> {sched.switches[0][2]}")


if __name__ == "__main__":
    main()
