"""End-to-end example (paper kind): a straggler-proof matmul service.

Serves a stream of batched matmul requests through the streaming serving
runtime (``repro_torch.serving``): requests queue at the master, dispatch
in batches to N simulated workers with shifted-exponential latencies and
20% persistent stragglers, and answers *refine* as completions arrive —
SAC emits its first (approximate) answer layers before classical MatDot's
all-or-nothing exact threshold.  Compares SAC against MatDot on
time-to-first-answer and shows the decode-weight cache amortizing repeated
straggler patterns across the request stream.

The reference's ``examples/coded_matmul_service.py`` on the port: the same
simulated backend, on ``--device`` (its float64 products on the card, or
the reference's numpy products on the CPU), at the reference's sizes.

Run:  PYTHONPATH=src python -m repro_torch.examples.coded_matmul_service \
          [--device cpu]
"""
import argparse

import numpy as np

from ..core import GroupSACCode, MatDotCode, x_complex
from ..serving import (DecodeWeightCache, MasterScheduler, ServeConfig,
                       SimulatedBackend)

INNER = 2000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(7)
    K, N = 8, 24
    deadlines = (1.15, 1.4, 1.8, 2.5, 4.0)

    sac = GroupSACCode(K, N, x_complex(N, 0.1), [4, 4], rng=rng)
    matdot = MatDotCode(K, N, x_complex(N, 0.1))

    print("== coded matmul service: SAC vs exact-only MatDot ==")
    print(f"   N={N} workers, 20% stragglers (5x slower), K={K}, "
          f"streaming incremental decode")

    requests = [(rng.standard_normal((100, INNER)),
                 rng.standard_normal((INNER, 100))) for _ in range(10)]

    ttfa = {}
    for label, code in (("sac", sac), ("matdot", matdot)):
        cache = DecodeWeightCache(256)
        cfg = ServeConfig(deadlines=deadlines, stream=True, batch_size=5,
                          seed=3)
        sched = MasterScheduler(code, SimulatedBackend(straggler_frac=0.2,
                                                       device=args.device),
                                cfg, cache)
        for A, B in requests:
            sched.submit(A, B)
        results = sched.run()
        ttfa[label] = results
        for res in results[:4] if label == "sac" else []:
            exact = next((a.t for a in res.answers if a.exact), None)
            print(f" req {res.req_id} [{label}]: first answer "
                  f"@t={res.ttfa:.2f}, "
                  f"exact @t={exact if exact is None else round(exact, 2)}")
        st = cache.stats()
        print(f" [{label}] decode-weight cache: {st['hits']} hits / "
              f"{st['misses']} misses (hit rate {st['hit_rate']:.0%})")

    f_sac = [r.ttfa for r in ttfa["sac"] if r.ttfa is not None]
    f_md = [r.ttfa for r in ttfa["matdot"] if r.ttfa is not None]
    print(f"\nmean time-to-first-answer: SAC {np.mean(f_sac):.2f} "
          f"vs MatDot {np.mean(f_md) if f_md else float('nan'):.2f} "
          f"(SAC answers at its first resolution layer, MatDot only at "
          f"R = 2K-1 = {matdot.recovery_threshold})")


if __name__ == "__main__":
    main()
