"""An LM's weights made on the device from the seed, by the rules of its
configuration file, in a few large draws.

Each rule is keyed by the leaf's last name component (``"*"`` for the
rest): ``["normal", s]`` draws N(0, s²), ``["dense"]`` draws N(0, 2 /
(rows + cols)), ``["fill", c]`` sets ``c``, ``["log_arange"]`` sets each
row to log(1 … S).  Every drawn leaf of one dtype is a view into one
normal draw of that dtype, made by one ``torch.Generator`` seeded with the
seed, so the same seed gives the same weights on the same device.
"""
from __future__ import annotations

import math

import torch


def make(leaves, rules: dict, seed: int, device) -> dict:
    """``{name: tensor}`` for ``leaves`` = ``[(name, shape, dtype), …]``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out, drawn = {}, {}
    for name, shape, dt in leaves:
        rule = rules.get(name.split(".")[-1], rules["*"])
        if rule[0] in ("normal", "dense"):
            drawn.setdefault(dt, []).append((name, shape, rule))
            continue
        t = torch.empty(shape, dtype=getattr(torch, dt), device=device)
        if rule[0] == "fill":
            t.fill_(float(rule[1]))
        elif rule[0] == "log_arange":
            t.copy_(torch.log(torch.arange(1, shape[-1] + 1,
                                           dtype=torch.float32,
                                           device=device)).expand(shape))
        else:
            raise ValueError(f"unknown init rule {rule!r} for {name}")
        out[name] = t
    for dt, group in drawn.items():
        total = sum(math.prod(shape) for _, shape, _ in group)
        flat = torch.randn(total, generator=gen, dtype=getattr(torch, dt),
                           device=device)
        off = 0
        for name, shape, rule in group:
            n = math.prod(shape)
            s = float(rule[1]) if rule[0] == "normal" else \
                math.sqrt(2.0 / (shape[0] + shape[1]))
            out[name] = flat[off:off + n].view(shape).mul_(s)
            off += n
    return {name: out[name] for name, _, _ in leaves}
