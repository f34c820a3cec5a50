#!/usr/bin/env python
"""The coded-MLP loss gap of a package's training loop, reference or port.

Runs the package's ``launch.train.train`` twice from the same seed:
uncoded, and with the SAC-coded MLP down-projections (MatDot on Chebyshev
points, K = ``cfg.coded_K``, N = ``--coded-N``) with ``--dead-workers``
workers masked out, and prints each step's loss in both runs and their gap,
absolute and relative to the uncoded loss.  ``chip_smoke.py`` holds the
port's gap on the card to the reference's largest relative gap printed
here, times a stated factor.

First it prints the package's ``coded_contraction`` error against the
exact ``h @ w_down`` at the config's widths (``--tokens`` x d_ff x d_model,
N(0, 1) activations, N(0, 1/d_ff) weights, float64 product of the same
rounded operands), in float32 and in bfloat16, for every dead-worker count
the code tolerates, with the decode weights' sum of magnitudes.

Usage (``--package reference`` needs JAX; the port runs on ``--device``,
the CPU by default here):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/coded_gap.py \
        --package reference --arch repro-100m --batch 2 --seq 128 --steps 3
    PYTHONPATH=src python tools/coded_gap.py --package port --device cpu

``--layers`` cuts the depth; the widths, vocabulary and dtype are the
config's.  The two packages draw different random weights from one seed;
to train both from the same weights, save the reference's initial weights
and load them into the port (each run imports one package only):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/coded_gap.py \
        --package reference --save-weights w0.npz
    PYTHONPATH=src python tools/coded_gap.py --package port --weights w0.npz

Prints one JSON line last.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from unittest import mock

import numpy as np


def _contraction_errors(pkg: str, cfg, args) -> dict:
    """Relative Frobenius error of the package's coded contraction against
    float64 ``h @ w_down`` of the same rounded operands."""
    if pkg == "reference":
        import jax.numpy as jnp

        from repro.core import MatDotCode, chebyshev_roots
        from repro.runtime.coded import (coded_contraction, coded_generators,
                                         exact_weight_vector)

        def cast(x, dt):
            return jnp.asarray(x, dt)

        def host(x):
            return np.asarray(x.astype(jnp.float32), np.float64)

        def weights(w):
            return jnp.asarray(w, jnp.float32)
    else:
        import torch

        from repro_torch.core import MatDotCode, chebyshev_roots
        from repro_torch.runtime.coded import (coded_contraction,
                                               coded_generators,
                                               exact_weight_vector)

        def cast(x, dt):
            return torch.as_tensor(x, device=args.device).to(
                getattr(torch, dt))

        def host(x):
            return x.double().cpu().numpy()

        def weights(w):
            return torch.as_tensor(w, dtype=torch.float32,
                                   device=args.device)
    N, K = args.coded_N, cfg.coded_K
    code = MatDotCode(K, N, chebyshev_roots(N))
    G_A, G_B = coded_generators(code) if pkg == "reference" else \
        coded_generators(code, device=args.device)
    rng = np.random.default_rng(args.seed)
    h = rng.standard_normal((args.tokens, cfg.d_ff))
    w = rng.standard_normal((cfg.d_ff, cfg.d_model)) / np.sqrt(cfg.d_ff)
    out = {}
    for dt in ("float32", "bfloat16"):
        hd, wd = cast(h, dt), cast(w, dt)
        exact = host(hd) @ host(wd)
        for dead in range(N - code.recovery_threshold + 1):
            live = np.ones(N, bool)
            live[:dead] = False
            wv = exact_weight_vector(code, live)
            got = host(coded_contraction(hd, wd, G_A, G_B, weights(wv)))
            err = float(np.linalg.norm(got - exact) / np.linalg.norm(exact))
            out[f"{dt}_dead{dead}"] = err
            print(f"coded contraction {args.tokens}x{cfg.d_ff}x{cfg.d_model}"
                  f" {dt}, {dead} dead (sum |w| {np.abs(wv).sum():.4g}): "
                  f"relative error {err:.3e}")
        plain = host(hd @ wd)
        out[f"{dt}_plain"] = float(np.linalg.norm(plain - exact)
                                   / np.linalg.norm(exact))
        print(f"plain h @ w_down {dt}: relative error "
              f"{out[dt + '_plain']:.3e}")
    return out


def _save_reference_weights(path: str, cfg, seed: int) -> None:
    """The reference ``train()``'s initial weights (``build_state``), as
    float32 leaves under ``/``-joined tree paths (bf16 widens exactly)."""
    import jax

    from repro.launch.train import build_state
    params, _ = build_state(cfg, seed)
    flat = {jax.tree_util.keystr(k, simple=True, separator="/"):
            np.asarray(v.astype("float32"))
            for k, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(path, **flat)


def _port_weights(path: str):
    """A context in which the port's ``train()`` starts from the weights
    saved by ``--save-weights`` (cast to the config's dtypes)."""
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch import train as port_train

    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = f[key]
    build = port_train.build_state

    def build_state(cfg, seed=0, *, device=None):
        params, opt = build(cfg, seed, device=device)
        params.load_state_dict(
            lm_params_from_reference(tree, cfg).state_dict())
        return params, opt

    return mock.patch.object(port_train, "build_state", build_state)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("reference", "port"),
                    default="reference")
    ap.add_argument("--device", default="cpu",
                    help="the port's device (cpu or cuda)")
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--coded-N", type=int, default=16)
    ap.add_argument("--dead-workers", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=512,
                    help="rows of the contraction check")
    ap.add_argument("--save-weights", metavar="NPZ",
                    help="(reference) also save train()'s initial weights")
    ap.add_argument("--weights", metavar="NPZ",
                    help="(port) train from weights saved by --save-weights")
    args = ap.parse_args(argv)
    if args.save_weights and args.package != "reference" or \
            args.weights and args.package != "port":
        ap.error("--save-weights is for the reference, --weights the port")

    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=None, resume=False, seed=args.seed, log_every=1)
    if args.package == "reference":
        from repro.configs import get_arch
        from repro.launch.train import train
    else:
        from repro_torch.configs import get_arch
        from repro_torch.launch.train import train
        kw["device"] = args.device
    cfg = get_arch(args.arch)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.save_weights:
        _save_reference_weights(args.save_weights, cfg, args.seed)
    contraction = _contraction_errors(args.package, cfg, args)
    t0 = time.perf_counter()
    with _port_weights(args.weights) if args.weights else \
            contextlib.nullcontext():
        _, _, base = train(cfg, **kw)
        _, _, coded = train(cfg, coded=True, dead_workers=args.dead_workers,
                            coded_N=args.coded_N, **kw)
    gaps = [abs(c - b) for b, c in zip(base, coded)]
    rel = [g / abs(b) for g, b in zip(gaps, base)]
    out = {"package": args.package, "arch": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype, "batch": args.batch,
           "seq": args.seq, "coded_K": cfg.coded_K,
           "coded_N": args.coded_N, "dead_workers": args.dead_workers,
           "seed": args.seed, "weights": args.weights or args.package,
           "uncoded": base, "coded": coded,
           "abs_gap": gaps, "rel_gap": rel, "max_rel_gap": max(rel),
           "contraction": contraction,
           "train_seconds": time.perf_counter() - t0}
    for s, (b, c, r) in enumerate(zip(base, coded, rel)):
        print(f"step {s}: uncoded {b:.6f} coded {c:.6f} relative gap "
              f"{r:.3e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
