"""Shared neural layers: norms, rotary/sinusoidal positions, gated MLPs.

Counterpart of the reference's ``models/layers.py``, with the same
numerics: ``rms_norm`` works in float32 and casts back, ``rope`` rotates
the two halves of the head (not interleaved pairs), and the GELU is the
tanh approximation.  ``cross_entropy_chunked`` belongs to training and is
not ported yet (ROADMAP A13).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "sinusoidal_positions", "gated_mlp"]


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


def gated_mlp(x: torch.Tensor, p, act: str = "swiglu") -> torch.Tensor:
    """SwiGLU / GeGLU gated MLP — or plain GELU FFN (act="gelu", no gate).
    ``p`` maps ``w_up``, ``w_down`` and (gated) ``w_gate`` to weights."""
    if act == "gelu":
        return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    if act == "swiglu":
        h = F.silu(gate) * up
    elif act == "geglu":
        h = F.gelu(gate, approximate="tanh") * up
    else:
        raise ValueError(f"unknown activation {act!r}")
    return h @ p["w_down"]
