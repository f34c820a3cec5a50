"""Plain PyTorch version of flash attention: materialized-scores GQA
attention with causal and sliding-window masks (the reference's
``kernels/flash_attention/ref.py``, ``attention_ref``)."""
from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0,
                  scale: float | None = None) -> torch.Tensor:
    """q (B, H, Lq, d), k/v (B, Hkv, Lkv, d) → (B, H, Lq, d) in q's dtype.

    Query i sits at absolute position ``q_offset + i``; ``window`` keeps
    keys with ``qpos - kpos < window``.  Rows with no unmasked key give 0.
    Scores are scaled by ``scale`` (default ``1 / sqrt(d)``).
    """
    B, H, Lq, d = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    group = H // Hkv
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (
        d ** -0.5 if scale is None else scale)
    qpos = q_offset + torch.arange(Lq, device=q.device)[:, None]
    kpos = torch.arange(Lkv, device=q.device)[None, :]
    mask = torch.ones((Lq, Lkv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p.masked_fill(~mask, 0.0)
    denom = p.sum(-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
