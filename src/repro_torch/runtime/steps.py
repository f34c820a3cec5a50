"""Prefill and decode steps: the units a server calls.

Counterpart of the reference's ``runtime/steps.py`` (``make_prefill_step``,
``make_decode_step``); ``make_train_step`` belongs to training (ROADMAP
A13).  The device is fixed when a step is made: the card unless the caller
asks for the CPU, raising without a card.  Tokens may come as numpy arrays
or tensors; the parameters must already be on the step's device.
"""
from __future__ import annotations

import torch

from ..configs import check_family
from ..device import resolve_device
from ..models import lm

__all__ = ["make_prefill_step", "make_decode_step"]


def _on(dev: torch.device, params, tokens) -> torch.Tensor:
    if params.embed.device.type != dev.type:
        raise ValueError(f"parameters on {params.embed.device}, step made "
                         f"for {dev}")
    return torch.as_tensor(tokens, dtype=torch.long, device=params.embed.device)


def make_prefill_step(cfg, max_seq: int | None = None, *, device=None,
                      use_kernels: bool = True):
    """``prefill_step(params, batch) -> (logits (B, 1, V), DecodeState)``
    over ``batch["tokens"]`` (B, L); caches sized for ``max_seq``.

    ``use_kernels`` is for comparisons only: ``False`` runs the kernels'
    plain versions on any device, so a check can hold a prefill through the
    kernels against the same prefill without them on the card.  A server
    leaves it on; the decode step has no such switch."""
    check_family(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = _on(dev, params, batch["tokens"])
        return lm.prefill(params, tokens, cfg, max_seq=max_seq,
                          use_kernels=use_kernels)

    return prefill_step


def make_decode_step(cfg, *, device=None):
    """``serve_step(params, tokens (B, 1), state) -> (logits (B, 1, V),
    state')``; the state's KV caches are updated in place."""
    check_family(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, tokens, state):
        return lm.decode_step(params, _on(dev, params, tokens), state, cfg)

    return serve_step
