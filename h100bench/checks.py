"""Readings that set a cell's limits, on the chip: the program's compared
numbers over many seeds, the control's (the plain reference in the next
lower precision, standing in the program's place) and the faults'.

    python3 h100bench/checks.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault half_batch --fault-seeds 4,5,6] \
        [--seconds 3] [--out chiprun_out/readings.jsonl]

Each seed runs the cell as ``run.py`` does (a short window), then compares
what it produced; one JSON line per reading.  The benchmark's own runs do
not run this.  Faults are planted in the program for the run they read:
``half_batch`` trains each step on the first half of its rows, the loss the
mean over them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent)]

from h100bench import run as harness  # noqa: E402
from h100bench import core  # noqa: E402


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted, for the duration."""
    if fault is None:
        yield
        return
    if fault != "half_batch":
        raise ValueError(f"unknown fault {fault!r}")
    import repro_torch.runtime.steps as steps
    make = steps.make_train_step

    def half(*a, **kw):
        step = make(*a, **kw)

        def run(params, opt, batch, i):
            t = batch["tokens"]
            return step(params, opt, {**batch, "tokens": t[:t.shape[0] // 2]},
                        i)
        return run

    steps.make_train_step = half
    try:
        yield
    finally:
        steps.make_train_step = make


def reading(name: str, seed: int, seconds: float, control: str | None,
            fault: str | None) -> list:
    got = {}
    t0 = time.perf_counter()
    with planted(fault):
        out = harness.run(name, seed, seconds, False,
                          hook=lambda d: got.setdefault("d", d))
    rows = [{"workload": name, "seed": seed, "kind": fault or "program",
             "numbers": {k: v["value"] for k, v in out["checks"].items()},
             "correct": out["correct"], "metrics": out["metrics"],
             "seconds": time.perf_counter() - t0}]
    if control:
        t0 = time.perf_counter()
        rows.append({"workload": name, "seed": seed,
                     "kind": f"control:{control}",
                     "numbers": got["d"].check(control),
                     "seconds": time.perf_counter() - t0})
    del got
    import torch
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    control = core.cell(args.workload)["traffic"]["control"]
    jobs = [(s, control if s in ctl else None, None)
            for s in seeds] + [(s, control, None) for s in sorted(ctl)
                               if s not in seeds]
    jobs += [(int(s), None, args.fault)
             for s in args.fault_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    for seed, c, fault in jobs:
        for row in reading(args.workload, seed, args.seconds, c, fault):
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
