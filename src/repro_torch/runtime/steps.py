"""Train, prefill and decode steps: the units a trainer and a server call.

Counterpart of the reference's ``runtime/steps.py``.  The device is fixed
when a step is made: the card unless the caller asks for the CPU, raising
without a card.  Tokens may come as numpy arrays or tensors; the
parameters must already be on the step's device.

The train step runs the flash and scan kernels and differentiates them
through their backward kernels (``flash_attention_bwd``,
``ssm_scan_bwd``); the reference's ``make_train_step`` differentiates the
jnp paths its Pallas kernels compute (``blockwise_attention``, the chunked
``ssm_scan_ref``; ``use_pallas=False``), whose gradients the backward
kernels' plain versions are held to.  The train step has no kernel
switch: on the CPU the wrappers run the plain versions.

On a mesh (:func:`repro_torch.models.hints.set_mesh`) the steps take and
return DTensor parameters, optimizer state and decode state with the
placements of :mod:`repro_torch.runtime.sharding` (those the reference's
dry run lowers with: ``param_shardings``, ``opt_state_shardings``,
``decode_state_shardings``); a global batch given as numpy or a plain
tensor is split by ``batch_shardings`` first.  The logits come back as
DTensors (vocab over the model axis); ``.full_tensor()`` gathers them.
"""
from __future__ import annotations

import functools

import torch

from .. import obs
from ..compat import DTensor
from ..configs import check_family
from ..device import resolve_device
from ..models import lm
from ..models.hints import get_mesh
from ..optim.adamw import (adamw_update, clip_by_global_norm,
                           cosine_schedule, wsd_schedule)

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "make_schedule", "decayed_names"]


def _on(dev: torch.device, params, tokens) -> torch.Tensor:
    if params.embed.device.type != dev.type:
        raise ValueError(f"parameters on {params.embed.device}, step made "
                         f"for {dev}")
    if isinstance(tokens, DTensor):
        return tokens
    t = torch.as_tensor(tokens, dtype=torch.long, device=params.embed.device)
    return _sharded(params, {"tokens": t})["tokens"]


def _sharded(params, batch: dict) -> dict:
    """A global batch split by ``batch_shardings`` when the parameters are
    DTensors (a mesh is registered), else as it is."""
    if not isinstance(params.embed, DTensor):
        return batch
    from .sharding import distribute_batch
    mesh = get_mesh()
    if mesh is None:
        raise ValueError("DTensor parameters with no mesh registered "
                         "(models.hints.set_mesh)")
    return distribute_batch(params.cfg, mesh, batch)


def make_schedule(cfg, *, peak_lr=3e-4, warmup=100, total=10_000):
    """minicpm-2b trains with WSD (its paper's contribution); cosine else."""
    fn = wsd_schedule if cfg.name.startswith("minicpm") else cosine_schedule
    return functools.partial(fn, peak_lr=peak_lr, warmup=warmup, total=total)


def decayed_names(named: dict, cfg) -> set:
    """The parameters AdamW decays: those with ``ndim >= 2`` in the
    reference's layout.  With ``cfg.use_scan`` the reference stacks each
    per-layer leaf along a leading layer axis, so a layer's norm scales,
    ``D``, ``dt_bias`` and ``conv_b`` are matrices there and decay; the
    final norm does not.  The MoE router (float32 in every model), the
    expert weights (ndim 3) and the codebook tables decay."""
    stacked = "layers." if cfg.use_scan else None
    return {k for k, p in named.items()
            if p.ndim + bool(stacked and k.startswith(stacked)) >= 2}


def make_train_step(cfg, schedule=None, *, max_grad_norm: float = 1.0,
                    device=None):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: the loss's gradient (autograd), clipped to
    ``max_grad_norm``, then one AdamW update at ``schedule(step + 1)``.

    ``params`` is an :class:`~repro_torch.models.LM` on the step's device,
    updated in place and returned; ``opt_state`` an :class:`~repro_torch.
    optim.AdamWState` over its named parameters; ``batch`` holds
    ``tokens`` (B, L) — (B, L, n_cb) for audio — and, for a vlm,
    ``vision_embeds`` (B, n_vis, d), for the coded FFN ``coded_weights``
    (N,).
    ``metrics``: ``loss``, ``grad_norm``, ``lr`` and ``step`` (tensors on
    the device; reading them waits for the step).

    Under a profiler the step is the ``train.step`` span over
    ``train.forward``, ``train.backward``, ``train.clip``,
    ``train.optimizer`` and ``train.apply`` (:func:`repro_torch.obs.span`)."""
    check_family(cfg)
    dev = resolve_device(device)
    schedule = schedule or make_schedule(cfg)

    def train_step(params, opt_state, batch, step):
        with obs.span("train.step"):
            inputs = {"tokens": _on(dev, params, batch["tokens"])}
            for key in ("vision_embeds", "coded_weights"):
                if batch.get(key) is not None and isinstance(batch[key],
                                                             DTensor):
                    inputs[key] = batch[key].to(torch.float32)
                elif batch.get(key) is not None:
                    inputs[key] = _sharded(params, {key: torch.as_tensor(
                        batch[key], dtype=torch.float32,
                        device=params.embed.device)})[key]
            named = dict(params.named_parameters())
            decay = decayed_names(named, cfg)
            try:
                for p in named.values():
                    p.requires_grad_(True)
                with torch.enable_grad():
                    with obs.span("train.forward", device=dev):
                        loss = lm.lm_loss(params, inputs, cfg)
                    with obs.span("train.backward", device=dev):
                        grads = torch.autograd.grad(loss, list(named.values()),
                                                    materialize_grads=True)
            finally:
                for p in named.values():
                    p.requires_grad_(False)
            with obs.span("train.clip", device=dev):
                grads, gnorm = clip_by_global_norm(dict(zip(named, grads)),
                                                   max_grad_norm)
            lr = schedule(step + 1)        # step 0 would sit at warmup lr=0
            with obs.span("train.optimizer", device=dev):
                new, opt_state = adamw_update(grads, opt_state, named, lr=lr,
                                              decay=decay)
            with obs.span("train.apply", device=dev), torch.no_grad():
                for k, p in named.items():
                    p.copy_(new[k])
            metrics = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr,
                       "step": opt_state.step}
            return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg, max_seq: int | None = None, *, device=None,
                      use_kernels: bool = True):
    """``prefill_step(params, batch) -> (logits (B, 1, V), DecodeState)``
    over ``batch["tokens"]`` (B, L); caches sized for ``max_seq``.  For
    audio the tokens are (B, L, n_cb) and the logits (B, 1, n_cb, V).  A
    vlm prefills its token stream only, as the reference's step does:
    vision embeddings are folded in by the training loss alone.

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
    state')`` — (B, 1, n_cb) tokens and (B, 1, n_cb, V) logits for audio;
    the state's KV caches are updated in place."""
    check_family(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, tokens, state):
        return lm.decode_step(params, _on(dev, params, tokens), state, cfg)

    return serve_step
