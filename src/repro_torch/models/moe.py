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

With a mesh registered (:func:`repro_torch.models.hints.set_mesh`) the
block runs as the reference's ``shard_map`` branch, here a ``local_map``
(:func:`repro_torch.compat.shard_map`): tokens stay on their data shard,
the experts are split over the model axis when it divides them (EP), else
their ffn dim is (expert-TP), the capacity comes from the local token
count, the FSDP all-gather of the weights' ``d`` shard runs inside the
body, and one all-reduce over the model axis completes the local experts,
the ffn shards and the shared expert; the load-balance loss is averaged
over the batch axes.  The dispatch is gather / scatter and the expert
products are library products, as in the reference, which computes them
with ``jnp.einsum`` outside any Pallas kernel.

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

from ..compat import (P, Partial, Replicate, Shard, all_gather_autograd,
                      axis_names, axis_sizes, shard_map)
from .hints import get_mesh, model_rank

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


def _local_dispatch_ffn(p, x: torch.Tensor, cfg, C: int, e_lo: int = 0,
                        E_loc: int | None = None):
    """Sort-dispatch into an (E_loc, C, d) buffer, the expert FFNs, and the
    gate-weighted combine.  Returns ``(out (T, d), aux_loss)``.

    ``p`` holds experts ``e_lo … e_lo + E_loc - 1`` (all of them by
    default); an assignment to another expert is left to the rank that
    holds it, and ``out`` is then this rank's partial sum."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    E_loc = E if E_loc is None else E_loc
    logits = _router_logits(p, x)
    gate_vals, expert_ids, _ = _top_k_gates(logits, k)

    flat_ids = expert_ids.reshape(-1)                          # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    rank = torch.arange(T * k, device=x.device) - first
    local = sorted_ids - e_lo
    # a kept assignment owns its slot; a dropped one, or one to another
    # rank's expert, writes to a spare row
    keep = (rank < C) & (local >= 0) & (local < E_loc)
    dest = torch.where(keep, local * C + rank, E_loc * C)

    buf = x.new_zeros((E_loc * C + 1, d))
    buf[dest] = x[order // k]
    buf = buf[:E_loc * C].view(E_loc, C, d)

    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).reshape(E_loc * C, d)

    # each (token, j) assignment's slot, in token order: the combine is a
    # fixed-order sum of a token's k contributions
    slot = torch.empty_like(dest)
    slot[order] = dest
    valid = (slot < E_loc * C)[:, None]
    contrib = torch.where(valid, out_buf[slot.clamp(max=E_loc * C - 1)], 0)
    contrib = contrib * gate_vals.reshape(-1, 1).to(contrib.dtype)
    out = contrib.view(T, k, d).sum(1)
    return out, router_aux_loss(logits, expert_ids, E, k)


def _shared_ffn(sp, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]


def moe_block(p, x: torch.Tensor, cfg):
    """x (T, d) → ((T, d), aux_loss): the routed experts at capacity
    :func:`capacity` ``(cfg, T)``, plus the shared experts when the config
    has them.  ``p`` maps ``router``, ``w_gate``, ``w_up``, ``w_down`` and
    (shared) ``shared`` to weights.  With a mesh registered, ``x`` and the
    weights are DTensors and the block runs sharded (:func:`_moe_mesh`)."""
    mesh = get_mesh()
    if mesh is not None and "model" in axis_names(mesh):
        return _moe_mesh(p, x, cfg, mesh)
    out, aux = _local_dispatch_ffn(p, x, cfg, capacity(cfg, x.shape[0]))
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p["shared"], x)
    return out, aux


def _moe_mesh(p, x, cfg, mesh):
    """The sharded block: a ``local_map`` whose input specs match the
    parameter placements of :mod:`repro_torch.runtime.sharding` exactly,
    with the FSDP all-gather inside the body (its autograd transpose is a
    reduce-scatter) and ONE all-reduce over the model axis after it."""
    T, d = x.shape
    E = cfg.n_experts
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    baxes = tuple(a for a in ("pod", "data") if a in names)
    dp = 1
    for a in baxes:
        dp *= sizes[a]
    msize = sizes["model"]
    ep = E % msize == 0
    E_loc = E // msize if ep else E
    T_loc = T // dp if T % dp == 0 else T
    tok = (baxes if len(baxes) > 1 else baxes[0]) \
        if baxes and T % dp == 0 else None
    C = capacity(cfg, T_loc)
    fsdp = bool(cfg.fsdp and "data" in names and d % sizes["data"] == 0)
    f_ax = "data" if fsdp else None
    w_specs = [P(f_ax, None),
               *((P("model", f_ax, None),) * 2 if ep
                 else (P(None, f_ax, "model"),) * 2),
               P("model", None, f_ax) if ep else P(None, "model", f_ax)]
    weights = [p["router"], p["w_gate"], p["w_up"], p["w_down"]]
    if cfg.n_shared_experts:
        sp = p["shared"]
        w_specs += [P(f_ax, "model"), P(f_ax, "model"), P("model", f_ax)]
        weights += [sp["w_gate"], sp["w_up"], sp["w_down"]]
    data_dim = names.index("data") if fsdp else None
    e_lo = model_rank(mesh) * E_loc if ep else 0

    def gather_d(t, dim):
        if not fsdp:
            return t
        return all_gather_autograd(t, dim, (mesh, data_dim))

    def body(x_loc, router, w_gate, w_up, w_down, *shared):
        p_full = {"router": gather_d(router, 0),
                  "w_gate": gather_d(w_gate, 1), "w_up": gather_d(w_up, 1),
                  "w_down": gather_d(w_down, 2)}
        # EP: out holds only the local experts' contributions; expert-TP:
        # the down-projection is a partial sum over the f shards; the
        # shared expert's f shards likewise — one all-reduce completes all
        out, aux = _local_dispatch_ffn(p_full, x_loc, cfg, C, e_lo, E_loc)
        if shared:
            out = out + _shared_ffn(
                {"w_gate": gather_d(shared[0], 0),
                 "w_up": gather_d(shared[1], 0),
                 "w_down": gather_d(shared[2], 1)}, x_loc)
        # the aux is averaged over the batch shards, and every model rank
        # computes the same one: each rank holds a 1/(shards·msize) share
        # of the sum, so that no gradient is counted once per rank
        return out, aux / (msize * (dp if tok is not None else 1))

    out_plc, aux_plc = [], []
    for a in names:
        if a == "model":
            out_plc.append(Partial())
            aux_plc.append(Partial())
        elif tok is not None:          # a batch axis the tokens are split on
            out_plc.append(Shard(0))
            aux_plc.append(Partial())
        else:
            out_plc.append(Replicate())
            aux_plc.append(Replicate())
    fn = shard_map(body, mesh=mesh, in_specs=(P(tok, None), *w_specs),
                   out_specs=(tuple(out_plc), tuple(aux_plc)))
    out, aux = fn(x, *weights)
    done = [Replicate() if isinstance(pl, Partial) else pl for pl in out_plc]
    return (out.redistribute(mesh, done),
            aux.redistribute(mesh, [Replicate()] * len(names)))


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
    ids = expert_ids.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.float32, device=ids.device
                         ).index_add_(0, ids, torch.ones_like(ids, dtype=
                                                              torch.float32))
    f = counts / torch.clamp(counts.sum(), min=1.0)
    return E * torch.sum(f * P)
