"""Sharding rules: DP / FSDP / TP / EP / sequence over the production mesh.

Counterpart of the reference's ``runtime/sharding.py``.  Axis semantics
(:mod:`repro_torch.launch.mesh`):

* ``pod``   — pure data parallelism across pods (gradient all-reduce)
* ``data``  — data parallelism within a pod; with ``cfg.fsdp`` weights are
  also sharded over it (ZeRO-3: all-gathered per layer where it is used)
* ``model`` — tensor/expert parallelism within a pod

Rules are name-based over the :class:`~repro_torch.models.LM`'s parameters
and divisibility-checked: a dim is only sharded if the axis size divides
it.  :func:`pick_spec` and :func:`batch_axes` are the reference's.
:func:`leaf_spec` is the reference's ``_leaf_spec`` mapped onto the port's
names: the reference stacks its layers, so every layer leaf there carries
a leading ``L`` that is never sharded; the port's layers have no such dim,
so each layer rule's dim is one lower here and the specs are the
reference's with that entry dropped.

Specs are :class:`~repro_torch.compat.P` tuples; the ``*_shardings``
functions return DTensor placements per leaf (:func:`~repro_torch.compat.
placements`).  :func:`distribute_lm` and :func:`distribute_adamw` put an
``LM`` and its AdamW state on a mesh by these rules.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..compat import (DTensor, P, axis_names, axis_sizes, distribute_tensor,
                      placements)

__all__ = ["batch_axes", "pick_spec", "leaf_spec", "param_shardings",
           "batch_shardings", "decode_state_shardings",
           "opt_state_shardings", "distribute_lm", "distribute_adamw",
           "distribute_batch"]


def batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes]))


def pick_spec(mesh, shape, prefs) -> P:
    """Build a spec from ``prefs``: list of (dim, axis-or-tuple), keeping
    only divisible assignments, first-come-first-served per dim/axis."""
    names = axis_names(mesh)
    spec = [None] * len(shape)
    used = set()
    for dim, axes in prefs:
        if axes is None or spec[dim] is not None:
            continue
        ax_t = (axes,) if isinstance(axes, str) else tuple(axes)
        if any(a in used or a not in names for a in ax_t):
            continue
        if shape[dim] % _axsize(mesh, ax_t) != 0:
            continue
        spec[dim] = axes if isinstance(axes, str) else tuple(axes)
        used.update(ax_t)
    return P(*spec)


def leaf_spec(name: str, shape, cfg, mesh) -> P:
    """Sharding rule for one parameter (a name like ``layers.3.attn.wq``)."""
    names = axis_names(mesh)
    fsdp = "data" if (cfg.fsdp and "data" in names) else None
    parts = name.split(".")
    leaf = parts[-1]
    in_layers = parts[0] == "layers"
    nd = len(shape)
    rep = P(*([None] * nd))

    if leaf == "embed" or (not in_layers and leaf == "lm_head"):
        if leaf == "embed":
            # (.., Vp, d): vocab → model, d → fsdp
            return pick_spec(mesh, shape, [(nd - 2, "model"), (nd - 1, fsdp)])
        # lm_head (.., d, Vp)
        return pick_spec(mesh, shape, [(nd - 1, "model"), (nd - 2, fsdp)])
    if not in_layers:
        return rep                                       # final_norm

    group = parts[2] if len(parts) > 3 else ""
    if group == "attn":
        if leaf in ("wq", "wk", "wv"):        # (d, Hx*hd)
            return pick_spec(mesh, shape, [(1, "model"), (0, fsdp)])
        if leaf == "wo":                       # (H*hd, d)
            return pick_spec(mesh, shape, [(0, "model"), (1, fsdp)])
        return pick_spec(mesh, shape, [(0, "model")])     # biases
    if group == "mlp" or (group == "moe" and parts[3:4] == ["shared"]):
        if leaf == "w_down":                   # (ff, d)
            return pick_spec(mesh, shape, [(0, "model"), (1, fsdp)])
        return pick_spec(mesh, shape, [(1, "model"), (0, fsdp)])
    if group == "moe":
        if leaf == "router":                   # (d, E)
            return pick_spec(mesh, shape, [(0, fsdp)])
        E = shape[0]
        ep = E % axis_sizes(mesh)["model"] == 0   # EP iff experts divide
        if leaf == "w_down":                   # (E, f, d)
            if ep:
                return pick_spec(mesh, shape, [(0, "model"), (2, fsdp)])
            return pick_spec(mesh, shape, [(1, "model"), (2, fsdp)])
        # w_gate / w_up                        # (E, d, f)
        if ep:
            return pick_spec(mesh, shape, [(0, "model"), (1, fsdp)])
        return pick_spec(mesh, shape, [(2, "model"), (1, fsdp)])
    if group == "ssm":
        if leaf == "in_proj":                  # (d, 2di)
            return pick_spec(mesh, shape, [(1, "model"), (0, fsdp)])
        if leaf == "conv_w":                   # (c, di)
            return pick_spec(mesh, shape, [(1, "model")])
        if leaf in ("conv_b", "dt_bias", "D"):  # (di,)
            return pick_spec(mesh, shape, [(0, "model")])
        if leaf == "x_proj":                   # (di, r+2s)
            return pick_spec(mesh, shape, [(0, "model")])
        if leaf == "dt_proj":                  # (r, di)
            return pick_spec(mesh, shape, [(1, "model")])
        if leaf == "A_log":                    # (di, s)
            return pick_spec(mesh, shape, [(0, "model")])
        if leaf == "out_proj":                 # (di, d)
            return pick_spec(mesh, shape, [(0, "model"), (1, fsdp)])
    # norms and anything unmatched: replicated
    return rep


def param_shardings(cfg, mesh, params) -> dict:
    """``{name: placements}`` for an ``LM`` or a ``{name: tensor}`` dict."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) \
        else params
    return {k: placements(leaf_spec(k, tuple(t.shape), cfg, mesh), mesh)
            for k, t in named.items()}


def batch_shardings(cfg, mesh, batch: dict) -> dict:
    """Batch dict: batch dim over (pod, data) when divisible."""
    baxes = batch_axes(mesh)
    return {k: placements(pick_spec(mesh, t.shape, [(0, baxes)]), mesh)
            for k, t in batch.items()}


def _state_spec(mesh, shape) -> P:
    """A decode-state leaf: the KV cache (L, B, Hkv, S, hd), the ssm state
    (L, B, di, s) or the conv tail (L, B, c-1, di) — batch over (pod,
    data), then heads, else sequence / channels, over model."""
    if len(shape) in (4, 5):
        return pick_spec(mesh, shape, [(1, batch_axes(mesh)), (2, "model"),
                                       (3, "model")])
    return P(*([None] * len(shape)))


def decode_state_shardings(cfg, mesh, state):
    """``DecodeState`` of placements (``None`` for an absent leaf or the
    position): batch over (pod, data); heads/channels over model.

    KV cache (L, B, Hkv, S, hd): prefer Hkv over model (contiguous heads);
    fall back to sequence sharding when Hkv doesn't divide the axis (MHA
    models — the cache is the dominant decode footprint and MUST shard).
    """
    def one(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
            return None
        return placements(_state_spec(mesh, tuple(leaf.shape)), mesh)
    return type(state)(*(one(x) for x in state[:4]), None)


def opt_state_shardings(cfg, mesh, params_shardings: dict):
    """AdamW moments inherit the parameter placements; step is replicated."""
    from ..optim.adamw import AdamWState
    return AdamWState(step=placements(P(), mesh), m=params_shardings,
                      v=params_shardings)


# ------------------------------------------------------------ distribution

def _dist(t: torch.Tensor, mesh, plc):
    """``t`` (the same full tensor on every rank) as a DTensor: each rank
    keeps a copy of its own shard (not a view that would hold the whole
    tensor's storage), with no communication."""
    d = distribute_tensor(t, mesh, plc, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        d = DTensor.from_local(local.clone(), mesh, plc, run_check=False,
                               shape=d.shape, stride=d.stride())
    return d


@torch.no_grad()
def distribute_lm(model: nn.Module, mesh, cfg=None) -> nn.Module:
    """Replace every parameter of ``model`` (an ``LM`` whose full weights
    every rank holds alike) by a DTensor parameter placed by
    :func:`leaf_spec`, in place; returns ``model``."""
    cfg = cfg or model.cfg
    plc = param_shardings(cfg, mesh, model)
    for name, p in list(model.named_parameters()):
        prefix, _, leaf = name.rpartition(".")
        owner = model.get_submodule(prefix) if prefix else model
        owner.register_parameter(leaf, nn.Parameter(
            _dist(p.data, mesh, plc[name]), requires_grad=False))
    return model


def distribute_adamw(state, mesh, params_shardings: dict):
    """An ``AdamWState`` (full moments alike on every rank) on ``mesh``."""
    sh = opt_state_shardings(None, mesh, params_shardings)
    return type(state)(
        step=_dist(state.step, mesh, sh.step),
        m={k: _dist(v, mesh, sh.m[k]) for k, v in state.m.items()},
        v={k: _dist(v, mesh, sh.v[k]) for k, v in state.v.items()})


def distribute_batch(cfg, mesh, batch: dict) -> dict:
    """A global batch (alike on every rank) sharded by
    :func:`batch_shardings`."""
    sh = batch_shardings(cfg, mesh, batch)
    return {k: _dist(torch.as_tensor(v), mesh, sh[k])
            for k, v in batch.items()}
