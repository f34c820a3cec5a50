"""Checkpoint/restart fault-tolerance demo: crash mid-run, resume, and land
on the EXACT same trajectory (step-keyed data pipeline + atomic checkpoints).

The reference's ``examples/fault_tolerance.py`` on the port's training
loop (:mod:`repro_torch.launch.train`), on ``--device``.  Checkpoints go
to a fresh temporary directory, removed at the end.

Run:  PYTHONPATH=src python -m repro_torch.examples.fault_tolerance \
          [--device cpu]
"""
import argparse
import shutil
import tempfile

import numpy as np

from ..configs import get_arch
from ..launch.train import train

STEPS, CRASH_AT = 20, 10
CKPT_EVERY = 5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_arch("repro-100m", smoke=True)
    ckpt = tempfile.mkdtemp(prefix="repro_ft_")
    try:
        print("== run A: uninterrupted ==")
        _, _, losses_ref = train(cfg, steps=STEPS, batch=4, seq=128,
                                 ckpt_dir=None, resume=False, log_every=5,
                                 device=args.device)

        print(f"\n== run B: crash at step {CRASH_AT}, then resume ==")
        try:
            train(cfg, steps=STEPS, batch=4, seq=128, ckpt_dir=ckpt,
                  resume=False, ckpt_every=CKPT_EVERY,
                  simulate_failure_at=CRASH_AT, log_every=5,
                  device=args.device)
        except SystemExit as e:
            print(f"(crashed with exit code {e.code}, as scheduled)")

        _, _, losses_resumed = train(cfg, steps=STEPS, batch=4, seq=128,
                                     ckpt_dir=ckpt, resume=True,
                                     ckpt_every=CKPT_EVERY, log_every=5,
                                     device=args.device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    tail_ref = losses_ref[-len(losses_resumed):]
    diff = float(np.max(np.abs(np.array(tail_ref)
                               - np.array(losses_resumed))))
    print(f"\nmax |loss diff| on the resumed segment: {diff:.2e}")
    if not diff < 1e-5:
        raise SystemExit("resume must reproduce the uninterrupted run")
    print("OK: restart reproduces the uninterrupted run.")


if __name__ == "__main__":
    main()
