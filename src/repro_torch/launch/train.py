"""Training loop: synthetic data → train_step loop → checkpoints → resume.

Counterpart of the reference's ``launch/train.py``, with its flags and one
more, ``--device`` (the CUDA card by default; ``cpu`` runs on the CPU).

Fault-tolerance contract: the data pipeline is step-keyed and the checkpoint
stores (params, opt_state, step), so ``--resume`` reproduces the exact
trajectory a crash interrupted (``--simulate-failure-at`` exits with code 42
after that step).

SAC integration: ``--coded`` turns the MLP down-projections into coded
contractions; ``--dead-workers k`` masks k workers' contributions — training
proceeds with exact recovery while ``k <= N - (2K-1)``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
        --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen2-moe-a2.7b --smoke --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \
        --steps 300 --batch 32 --seq 1024 --ckpt-dir /tmp/ckpt --resume
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_arch
from ..core import MatDotCode, chebyshev_roots
from ..data.pipeline import SyntheticTokens
from ..device import resolve_device
from ..models import init_params
from ..optim.adamw import AdamWState, adamw_init
from ..runtime.coded import exact_weight_vector
from ..runtime.steps import make_train_step

__all__ = ["build_state", "train", "main"]


def build_state(cfg, seed: int = 0, *, device=None):
    """``(params, opt_state)``: the port's seeded random weights on the
    device and zero AdamW moments of ``cfg.opt_dtype``."""
    dev = resolve_device(device)
    params = init_params(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    opt = adamw_init(dict(params.named_parameters()),
                     getattr(torch, cfg.opt_dtype))
    return params, opt


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str | None,
          resume: bool, seed: int = 0, coded: bool = False,
          dead_workers: int = 0, coded_N: int = 16,
          simulate_failure_at: int | None = None, log_every: int = 10,
          ckpt_every: int = 25, device=None):
    """Train ``cfg`` for ``steps`` steps; returns ``(params, opt_state,
    losses)`` (the losses of the steps this call ran)."""
    dev = resolve_device(device)
    if coded:
        cfg = cfg.replace(coded=True)
    gen = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=seed,
                          n_codebooks=cfg.n_codebooks,
                          vision_tokens=cfg.vision_tokens if cfg.family == "vlm" else 0,
                          d_model=cfg.d_model)
    params, opt = build_state(cfg, seed, device=dev)
    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume:
        got = mgr.restore_latest(_tree(params, opt))
        if got[0] is not None:
            start, tree = got
            params.load_state_dict(tree["params"])
            opt = tree["opt"]
            print(f"[train] resumed from step {start}")

    coded_w = None
    if coded:
        code = MatDotCode(cfg.coded_K, coded_N, chebyshev_roots(coded_N))
        live = np.ones(coded_N, bool)
        if dead_workers:
            live[:dead_workers] = False
        coded_w = torch.as_tensor(exact_weight_vector(code, live),
                                  dtype=torch.float32, device=dev)
        print(f"[train] coded MLP: K={cfg.coded_K} N={coded_N} "
              f"dead={dead_workers} (tolerates {coded_N - 2 * cfg.coded_K + 1})")

    step_fn = make_train_step(cfg, device=dev)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        # tokens, and a vlm's vision_embeds
        batch_dev = {k: torch.as_tensor(v, device=dev)
                     for k, v in gen(step).items()}
        if coded_w is not None:
            batch_dev["coded_weights"] = coded_w
        params, opt, metrics = step_fn(params, opt, batch_dev, step)
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} ({dt:.1f}s)",
                  flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, _tree(params, opt))
        if simulate_failure_at is not None and step + 1 == simulate_failure_at:
            print(f"[train] SIMULATED FAILURE at step {step + 1}")
            raise SystemExit(42)
    if mgr:
        mgr.save(steps, _tree(params, opt))
    return params, opt, losses


def _tree(params, opt: AdamWState) -> dict:
    """What a checkpoint holds: the model's ``state_dict`` (by name) and
    the optimizer state (step, moments by name)."""
    return {"params": params.state_dict(), "opt": opt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--coded", action="store_true")
    ap.add_argument("--dead-workers", type=int, default=0)
    ap.add_argument("--simulate-failure-at", type=int)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch, smoke=args.smoke)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
          ckpt_dir=args.ckpt_dir, resume=args.resume, coded=args.coded,
          dead_workers=args.dead_workers,
          simulate_failure_at=args.simulate_failure_at, seed=args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
