"""AdamW + LR schedules (cosine, and WSD for minicpm-2b).

Counterpart of the reference's ``optim/adamw.py``, as plain functions over
named parameters (a mapping of name → tensor, e.g. ``dict(model.
named_parameters())``) rather than ``torch.optim.AdamW``, whose semantics
differ.  As in the reference: moments are float32 (or the given moment
dtype), the update math runs in float32 and is cast back to the parameter
dtype (round to nearest even), decay applies to matrices only (``ndim >=
2`` in the reference's layout, which stacks the layers: the caller names
the decayed parameters, see :func:`repro_torch.runtime.steps.
make_train_step`), ``b2 = 0.95``, and the schedules are evaluated in float32.  The
functions are functional: they return new tensors and leave their inputs
alone.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "wsd_schedule", "clip_by_global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    m: dict
    v: dict


def adamw_init(params: dict, moment_dtype: torch.dtype = torch.float32
               ) -> AdamWState:
    """Zero moments of ``moment_dtype`` for every named parameter."""
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
             for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros,
                      v={k: torch.zeros_like(z) for k, z in zeros.items()})


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, *, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, decay=None):
    """Returns (new_params, new_state).  ``lr`` may be a float32 scalar
    tensor.  ``decay``: the names that take weight decay (``None``: those
    with ``ndim >= 2``)."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    if decay is None:
        decay = {k for k, p in params.items() if p.ndim >= 2}
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        m, v = state.m[k], state.v[k]
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
        update = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        # decoupled weight decay on matrices only
        if k in decay:
            update = update + weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * update).to(p.dtype)
        new_m[k] = m32.to(m.dtype)
        new_v[k] = v32.to(v.dtype)
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """``(clipped grads, global norm)``; the norm is float32."""
    gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, gn


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, peak_lr, warmup: int, total: int,
                    floor_frac: float = 0.1):
    t = _steps(step)
    warm = peak_lr * t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)


def wsd_schedule(step, *, peak_lr, warmup: int, total: int,
                 decay_frac: float = 0.1, floor_frac: float = 0.01):
    """MiniCPM's warmup-stable-decay: warmup → flat → sharp exp decay."""
    t = _steps(step)
    decay_steps = max(int(total * decay_frac), 1)
    decay_start = total - decay_steps
    warm = peak_lr * t / max(warmup, 1)
    prog = torch.clamp((t - decay_start) / decay_steps, 0.0, 1.0)
    decay = peak_lr * (floor_frac ** prog)
    stable = torch.tensor(peak_lr, dtype=torch.float32, device=t.device)
    return torch.where(t < warmup, warm,
                       torch.where(t < decay_start, stable, decay))
