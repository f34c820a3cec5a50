"""Quickstart: successive approximation coding in ~40 lines.

Distributes C = A·B over N=24 simulated workers with group-wise SAC and
prints the estimate error after each additional worker reports in — the
paper's accuracy/speed tradeoff (Fig. 3a) live on your machine.

The reference's ``examples/quickstart.py`` on the port.  ``--device``
says where the worker products are computed: on the CPU the codes' own
numpy path (as the reference, so the table is the reference's), on the
card the simulated backend's float64 products.  The products and the
oracle blocks do not depend on ``m``, so each code computes them once.
``INNER`` is the reference's contraction length.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np

from ..core import (EpsApproxMatDotCode, GroupSACCode, LayerSACCode,
                    simulate_completion, split_contraction, x_complex)

INNER = 4000


def _products(code, A, B, device: str) -> np.ndarray:
    """All N worker products ``(N, Nx, Ny)`` as host float64."""
    if device == "cpu":
        return code.run_workers(A, B)
    from ..serving import SimulatedBackend
    P = SimulatedBackend(device=device).compute_products(code, [A], [B])
    return P[0].cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    A = rng.standard_normal((100, INNER))
    B = rng.standard_normal((INNER, 100))
    C = A @ B
    K, N = 8, 24

    codes = {
        "eps-approx MatDot [20]": EpsApproxMatDotCode(K, N,
                                                      x_complex(N, 0.1)),
        "group-wise SAC (K1=5)": GroupSACCode(K, N, x_complex(N, 0.1),
                                              [5, 3], rng=rng),
        "layer-wise SAC (Ortho)": LayerSACCode(K, N, base="ortho",
                                               eps=6.25e-3),
    }

    trace = simulate_completion(rng, N)          # uniform completion order
    blocks = split_contraction(A, B, K)
    work = {name: (_products(code, A, B, args.device),
                   code.oracle_context(*blocks))
            for name, code in codes.items()}
    print(f"{'m':>3} | " + " | ".join(f"{n:>24}" for n in codes))
    for m in range(1, N + 1):
        row = []
        for name, code in codes.items():
            products, oracle = work[name]
            est = code.decode(products, trace.order, m, oracle=oracle)
            if est is None:
                row.append(f"{'—':>24}")
            else:
                rel = np.linalg.norm(est - C) ** 2 / np.linalg.norm(C) ** 2
                tag = " EXACT" if m >= code.recovery_threshold else ""
                row.append(f"{rel:>18.3e}{tag:>6}")
        print(f"{m:>3} | " + " | ".join(row))


if __name__ == "__main__":
    main()
