"""Shared neural layers: norms, rotary/sinusoidal positions, gated MLPs.

Counterpart of the reference's ``models/layers.py``, with the same
numerics: ``rms_norm`` works in float32 and casts back, ``rope`` rotates
the two halves of the head (not interleaved pairs), and the GELU is the
tanh approximation.  :func:`cross_entropy_chunked` is the training
loss's memory-bounded cross entropy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    ang = positions[..., :, None, None].float() * freqs   # (..., L, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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
    ``p`` maps ``w_up``, ``w_down`` and (gated) ``w_gate`` to weights."""
    return mlp_hidden(x, p, act) @ p["w_down"]


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
