#!/usr/bin/env python
"""How far the coded MLP's bf16 rounding moves repro-100m's held-out loss.

``chip_smoke.py`` phase 14 trains repro-100m (bf16, batch 8 x 512) 30
steps uncoded and 20 with the coded MLP (K=8, N=16, one dead worker) and
holds a held-out loss to fall.  In bf16 the coded MLP's decode amplifies
rounding (``tools/coded_gap.py``: a relative error of ~8.8 in both
packages), so its loss at fixed weights moves with the attention kernel's
last bits.  This script prints, for the uncoded and the coded run, the
held-out loss before and after training on three held-out batches
(``SyntheticTokens`` steps 10**6, +1, +2) evaluated in bf16, and on the
first batch also on a float32 copy of the weights (where the coded MLP
decodes exactly).

Usage, on a machine with the card: ``python tools/coded_heldout.py [--src
DIR]``, where ``DIR`` is the ``src`` directory of the checkout whose
kernels to use (default: this one's), so that two checkouts compare in
one call.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, STEPS, CODED_STEPS, N, DEAD = 8, 512, 30, 20, 16, 1
HELDOUT = (10 ** 6, 10 ** 6 + 1, 10 ** 6 + 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import MatDotCode, chebyshev_roots
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import build_state, train
    from repro_torch.models import lm_loss
    from repro_torch.runtime.coded import exact_weight_vector
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cfg = get_arch("repro-100m")
    ccfg = cfg.replace(coded=True)
    live = np.ones(N, bool)
    live[:DEAD] = False
    cw = torch.as_tensor(exact_weight_vector(
        MatDotCode(cfg.coded_K, N, chebyshev_roots(N)), live),
        dtype=torch.float32, device="cuda")

    def held(c, params, w, step, float32=False):
        batch = {"tokens": torch.as_tensor(SyntheticTokens(
            c.vocab_size, SEQ, BATCH, seed=0)(step)["tokens"],
            dtype=torch.long, device="cuda")}
        if w is not None:
            batch["coded_weights"] = w
        if float32:
            params, c = copy.deepcopy(params).float(), c.replace(
                dtype="float32")
        with torch.no_grad():
            return float(lm_loss(params, batch, c))

    def losses(c, params, w):
        return {"bf16": [held(c, params, w, s) for s in HELDOUT],
                "float32": held(c, params, w, HELDOUT[0], True)}

    kw = dict(batch=BATCH, seq=SEQ, ckpt_dir=None, resume=False, seed=0,
              device="cuda", log_every=100)
    init, _ = build_state(cfg, 0, device="cuda")
    out = {"src": str(args.src), "uncoded": {"before": losses(cfg, init,
                                                               None)},
           "coded": {"before": losses(ccfg, init, cw)}}
    del init
    params, _, _ = train(cfg, steps=STEPS, **kw)
    out["uncoded"]["after"] = losses(cfg, params, None)
    del params
    params, _, _ = train(cfg, steps=CODED_STEPS, coded=True, coded_N=N,
                         dead_workers=DEAD, **kw)
    out["coded"]["after"] = losses(ccfg, params, cw)
    for run in ("uncoded", "coded"):
        b, a = out[run]["before"], out[run]["after"]
        print(f"{run}: bf16 held-out " + ", ".join(
            f"{x:.5f} -> {y:.5f}" for x, y in zip(b["bf16"], a["bf16"]))
            + f"; float32 copy {b['float32']:.5f} -> {a['float32']:.5f}")
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out["card"] = res.stdout.strip().splitlines()[0] if res.stdout else ""
    print(out["card"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
