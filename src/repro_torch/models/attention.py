"""GQA attention: full-sequence attention through the flash kernel, and the
single-token KV-cache decode.

Counterpart of the reference's ``models/attention.py``.  The reference's
full-sequence path is ``blockwise_attention``, a jnp online softmax that
computes what its Pallas kernel computes; here it is the kernel itself
(:func:`repro_torch.kernels.flash_attention`).  One card, so there is no
``shard_map`` or GSPMD dispatch (mesh sharding is ROADMAP A11).
:func:`decode_attention` stays plain PyTorch, as in the reference.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_ref

__all__ = ["attention", "decode_attention"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              use_kernels: bool = True) -> torch.Tensor:
    """q (B, H, Lq, d); k/v (B, Hkv, Lkv, d) → (B, H, Lq, d).

    ``window`` is the layer's sliding window as a Python int (0: full
    attention).  ``use_kernels=False`` runs the plain version on any device
    instead of the kernel — the caller's explicit choice, for comparisons.
    """
    if use_kernels:
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    return attention_ref(q, k, v, causal=causal, window=window or None,
                         q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window: int = 0,
                     ring: bool = False) -> torch.Tensor:
    """Single-token decode.  q (B, H, 1, d); caches (B, Hkv, S, hd).

    Scores are masked to positions <= pos (and within the sliding window).
    ``ring=True``: the cache is a ring buffer (window-only archs) — slot s
    holds absolute position ``pos - ((pos - s) mod S)``.
    """
    B, H, _, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Hkv, group, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qg.float(),
                     k_cache.float()) / (d ** 0.5)
    kpos = torch.arange(S, device=q.device)
    if ring:
        abs_pos = pos - torch.remainder(pos - kpos, S)
        mask = abs_pos >= 0                         # slot ever written
        kdist = pos - abs_pos
    else:
        mask = kpos <= pos                          # incl. the current token
        kdist = pos - kpos
    if window:
        mask = mask & (kdist < window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return out.reshape(B, H, 1, d).to(q.dtype)
