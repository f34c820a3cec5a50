"""Shared neural layers: norms, rotary/sinusoidal positions, gated MLPs.

Counterpart of the reference's ``models/layers.py``, with the same
numerics: ``rms_norm`` works in float32 and casts back, ``rope`` rotates
the two halves of the head (not interleaved pairs), and the GELU is the
tanh approximation.  :func:`cross_entropy_chunked` is the training
loss's memory-bounded cross entropy.

On a mesh the activations are DTensors.  The MLP's hidden activation is
pinned to (batch, …, model) as in the reference, and its down-projection's
partial sums are reduced over the model axis; ``rope`` runs on each rank's
local rows and heads; the cross entropy takes each rank's own rows in
chunks, with the vocabulary over the model axis (a vocab-parallel log-sum-
exp: a max and a sum over the axis, and the target's logit from the rank
that holds it).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..compat import Partial, Replicate, Shard, axis_names
from .hints import axes_hint, is_dt, local_like, model_rank, reduced

__all__ = ["rms_norm", "rope", "sinusoidal_positions", "gated_mlp",
           "mlp_hidden", "cross_entropy_chunked"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding.  x (..., L, H, hd); positions (..., L)."""
    if is_dt(x):
        return _rope_mesh(x, positions, theta)
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    ang = positions[..., :, None, None].float() * freqs   # (..., L, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope_mesh(x, positions, theta):
    """``rope`` of a DTensor x (B, L, H, hd) on each rank's rows and heads
    (the attention splits heads, never the head dim)."""
    mesh = x.device_mesh
    pos = local_like(positions, x, {0: 0, 1: 1})
    fn = local_map(lambda xl, pl: rope(xl, pl, theta),
                   out_placements=list(x.placements),
                   in_placements=(x.placements, pos.placements),
                   device_mesh=mesh)
    return fn(x, pos)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Classic transformer sinusoidal embedding (float32)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mlp_hidden(x: torch.Tensor, p, act: str = "swiglu") -> torch.Tensor:
    """The MLP's hidden activation, before the down-projection: SwiGLU /
    GeGLU gated — or plain GELU (act="gelu", no gate).  ``p`` maps ``w_up``
    and (gated) ``w_gate`` to weights."""
    if act == "gelu":
        return F.gelu(x @ p["w_up"], approximate="tanh")
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(f"unknown activation {act!r}")


def gated_mlp(x: torch.Tensor, p, act: str = "swiglu") -> torch.Tensor:
    """SwiGLU / GeGLU gated MLP — or plain GELU FFN (act="gelu", no gate).
    ``p`` maps ``w_up``, ``w_down`` and (gated) ``w_gate`` to weights.

    The hidden activation is pinned to (batch, ..., model) so the ff dim
    computes tensor-parallel instead of model-axis-replicated."""
    h = axes_hint(mlp_hidden(x, p, act), 0, x.ndim - 1)
    return reduced(h @ p["w_down"])


def _chunk_loss(logits_fn, h, t, m):
    lg = logits_fn(h).float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, t[:, None])[:, 0]
    return ((lse - ll) * m).sum(), m.sum()


def cross_entropy_chunked(logits_fn, hidden: torch.Tensor,
                          targets: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          chunk: int = 4096) -> torch.Tensor:
    """Memory-bounded CE: project→softmax over token chunks.

    ``logits_fn(h_chunk) -> (T_c, V)``; ``hidden (T, d)``; ``targets (T,)``
    integer; ``mask (T,)`` float32 weights (all ones when not given).  The
    last chunk is zero-padded and masked out.  Under autograd each chunk is
    recomputed in the backward pass (``torch.utils.checkpoint``), so the
    float32 ``(T, V)`` logits are never held at once.  Returns the masked
    mean of the token losses (float32).
    """
    if is_dt(hidden):
        return _cross_entropy_mesh(logits_fn, hidden, targets, mask, chunk)
    T = hidden.shape[0]
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if mask is None:
        mask = torch.ones((T,), dtype=torch.float32, device=hidden.device)
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    remat = torch.is_grad_enabled()
    losses, counts = [], []
    for i in range(0, hidden.shape[0], chunk):
        args = (logits_fn, hidden[i:i + chunk], targets[i:i + chunk],
                mask[i:i + chunk])
        loss, count = (checkpoint(_chunk_loss, *args, use_reentrant=False)
                       if remat else _chunk_loss(*args))
        losses.append(loss)
        counts.append(count)
    return torch.stack(losses).sum() / torch.clamp(torch.stack(counts).sum(),
                                                   min=1.0)


def _target_logit(lg, t):
    """Each row's logit at its target, from the vocab shard of this rank
    (zero on the others: a partial sum over the model axis)."""
    mesh = lg.device_mesh
    names = axis_names(mesh)
    vocab_split = "model" in names and isinstance(
        lg.placements[names.index("model")], Shard)

    def body(lg_l, t_l):
        V_loc = lg_l.shape[-1]
        lo = model_rank(mesh) * V_loc if vocab_split else 0
        inr = (t_l >= lo) & (t_l < lo + V_loc)
        idx = (t_l - lo).clamp(0, V_loc - 1)
        return torch.where(inr, torch.gather(lg_l, -1, idx[:, None])[:, 0],
                           0.0)

    row = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
           for pl in lg.placements]
    out = [Partial() if a == "model" and vocab_split else pl
           for a, pl in zip(names, row)]
    fn = local_map(body, out_placements=list(out),
                   in_placements=(lg.placements, row), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(lg, t)


def _chunk_loss_mesh(logits_fn, h, t, m):
    lg = axes_hint(logits_fn(h).float(), 0, 1)   # tokens → data, V → model
    mx = lg.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(lg - mx).sum(-1)) + mx[:, 0]
    return ((lse - _target_logit(lg, t)) * m).sum(), m.sum()


def _local_rows(t, i: int, n: int):
    """Rows ``i … i + n - 1`` of each rank's own rows of a DTensor split
    over its first dim (a DTensor again, split the same way)."""
    plc = list(t.placements)
    return local_map(lambda tl: tl[i:i + n], out_placements=plc,
                     in_placements=(plc,), device_mesh=t.device_mesh,
                     redistribute_inputs=True)(t)


def _cross_entropy_mesh(logits_fn, hidden, targets, mask, chunk):
    """The cross entropy over DTensor rows: each rank takes its own rows,
    ``chunk / (batch ranks)`` at a time, as the reference's chunks are
    spread over the batch axes."""
    mesh = hidden.device_mesh
    names = axis_names(mesh)
    dp = 1
    for a, pl in zip(names, hidden.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            dp *= mesh.size(names.index(a))
    T = hidden.shape[0]
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    targets = targets.redistribute(mesh, hidden.placements)
    mask = mask.redistribute(mesh, hidden.placements)
    T_loc = T // dp
    c = max(min(chunk, T) // dp, 1)
    remat = torch.is_grad_enabled()
    losses, counts = [], []
    for i in range(0, T_loc, c):
        n = min(c, T_loc - i)
        args = (logits_fn, _local_rows(hidden, i, n),
                _local_rows(targets, i, n), _local_rows(mask, i, n))
        loss, count = (checkpoint(_chunk_loss_mesh, *args, use_reentrant=False)
                       if remat else _chunk_loss_mesh(*args))
        losses.append(loss)
        counts.append(count)
    total, count = sum(losses), sum(counts)
    return total / torch.clamp(count, min=1.0)
