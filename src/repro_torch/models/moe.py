"""Mixture-of-Experts with sort-based capacity dispatch (kimi-k2, qwen2-moe).

Counterpart of the reference's ``models/moe.py`` on one device: router →
top-k experts per token → tokens are *sorted by expert* (a stable sort) and
scattered into a fixed ``(E, C)`` slot buffer (capacity ``C = k·T·cf/E``,
rounded up to 8, at least 8), the expert FFNs run as batched products over
``(E, C, d)``, and the results gather back weighted by their gates.  An
assignment past its expert's capacity is dropped: it adds zeros to the
expert's last slot and nothing to its token, as in the reference (here
it writes to a spare row of the buffer, which no expert reads).
:func:`moe_ref` is the drop-free oracle the tests compare against.

The reference also has a ``shard_map`` branch for a device mesh (experts
sharded over the model axis, one ``psum`` combine); it waits for the
port's mesh and sharding (ROADMAP A11).  The dispatch is gather / scatter
and the expert products are library products, as in the reference, which
computes them with ``jnp.einsum`` outside any Pallas kernel.

The router is float32 in every model: ``x`` is cast to float32 for the
router product (the reference's type promotion of a bf16 ``x`` times a
float32 router), never the router to ``x``'s dtype, which would change the
routing.  The reference combines with a scatter-add (chosen for its
transpose under ``shard_map``); on one device the port gathers each token's
k contributions back into token order and sums them: a fixed-order sum
with no atomics (in bf16 accumulated in float32 and rounded once, where
the reference rounds after each add), so a repeat prefill on the card is
bit-identical (``chip_smoke.py`` phase 9b checks it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["capacity", "moe_block", "moe_ref", "router_aux_loss"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(cfg, T: int) -> int:
    """Slots per expert for ``T`` tokens: ``round_up(max(8, int(cf·k·T /
    E)), 8)``."""
    k, E = cfg.experts_per_token, cfg.n_experts
    return _round_up(max(8, int(cfg.capacity_factor * k * T / E)), 8)


def _router_logits(p, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ p["router"]


def _top_k_gates(logits: torch.Tensor, k: int):
    """Top-k router probabilities, renormalized.  logits (T, E) f32."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)       # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, expert_ids, probs


def _local_dispatch_ffn(p, x: torch.Tensor, cfg, C: int):
    """Sort-dispatch into an (E, C, d) buffer, the expert FFNs, and the
    gate-weighted combine.  Returns ``(out (T, d), aux_loss)``."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = _router_logits(p, x)
    gate_vals, expert_ids, _ = _top_k_gates(logits, k)

    flat_ids = expert_ids.reshape(-1)                          # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    rank = torch.arange(T * k, device=x.device) - first
    # a kept assignment owns its slot; a dropped one writes to a spare row
    dest = torch.where(rank < C, sorted_ids * C + rank, E * C)

    buf = x.new_zeros((E * C + 1, d))
    buf[dest] = x[order // k]
    buf = buf[:E * C].view(E, C, d)

    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).reshape(E * C, d)

    # each (token, j) assignment's slot, in token order: the combine is a
    # fixed-order sum of a token's k contributions
    slot = torch.empty_like(dest)
    slot[order] = dest
    valid = (slot < E * C)[:, None]
    contrib = torch.where(valid, out_buf[slot.clamp(max=E * C - 1)], 0)
    contrib = contrib * gate_vals.reshape(-1, 1).to(contrib.dtype)
    out = contrib.view(T, k, d).sum(1)
    return out, router_aux_loss(logits, expert_ids, E, k)


def _shared_ffn(sp, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]


def moe_block(p, x: torch.Tensor, cfg):
    """x (T, d) → ((T, d), aux_loss): the routed experts at capacity
    :func:`capacity` ``(cfg, T)``, plus the shared experts when the config
    has them.  ``p`` maps ``router``, ``w_gate``, ``w_up``, ``w_down`` and
    (shared) ``shared`` to weights."""
    out, aux = _local_dispatch_ffn(p, x, cfg, capacity(cfg, x.shape[0]))
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p["shared"], x)
    return out, aux


def moe_ref(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Drop-free loop-over-experts oracle (tests only)."""
    gate_vals, expert_ids, _ = _top_k_gates(_router_logits(p, x),
                                            cfg.experts_per_token)
    out = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = F.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])
        y = h @ p["w_down"][e]
        w = torch.where(expert_ids == e, gate_vals, 0.0).sum(-1)  # (T,)
        out = out + w[:, None].to(y.dtype) * y
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p["shared"], x)
    return out


def router_aux_loss(logits: torch.Tensor, expert_ids: torch.Tensor, E: int,
                    k: int) -> torch.Tensor:
    """Switch-style load-balance loss: E · Σ_e f_e · P_e."""
    probs = torch.softmax(logits.float(), dim=-1)
    P = probs.mean(dim=0)                                      # (E,)
    counts = torch.bincount(expert_ids.reshape(-1), minlength=E).float()
    f = counts / torch.clamp(counts.sum(), min=1.0)
    return E * torch.sum(f * P)
