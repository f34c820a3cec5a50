"""Train a small LM with SAC-coded MLP layers riding through dead workers.

Trains repro-10m twice: (a) uncoded baseline, (b) coded MLP contractions
with 1 of 16 logical workers dead the whole run — losses must track each
other closely (exact recovery while dead <= N - (2K-1)).

The reference's ``examples/train_lm_coded.py`` on the port's training
loop (:mod:`repro_torch.launch.train`), on ``--device``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm_coded \
          [--device cpu]
"""
import argparse

from ..configs import get_arch
from ..launch.train import train

STEPS = 30


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_arch("repro-100m", smoke=True)      # repro-10m — CPU friendly

    print("== baseline (uncoded) ==")
    _, _, base_losses = train(cfg, steps=STEPS, batch=4, seq=128,
                              ckpt_dir=None, resume=False, log_every=10,
                              device=args.device)

    print("\n== coded MLP, 1 dead worker ==")
    _, _, coded_losses = train(cfg, steps=STEPS, batch=4, seq=128,
                               ckpt_dir=None, resume=False, coded=True,
                               dead_workers=1, log_every=10,
                               device=args.device)

    gap = max(abs(a - b) for a, b in zip(base_losses, coded_losses))
    print(f"\nmax |loss gap| over {STEPS} steps: {gap:.4f} "
          f"(coded training rides through the dead worker)")
    if not coded_losses[-1] < coded_losses[0]:
        raise SystemExit("coded training must converge")


if __name__ == "__main__":
    main()
