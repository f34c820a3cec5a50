"""Plain PyTorch version of flash attention: materialized-scores GQA
attention with causal and sliding-window masks (the reference's
``kernels/flash_attention/ref.py``, ``attention_ref``), the same forward
with each row's log-sum-exp (:func:`flash_attention_lse_ref`), and the
backward from explicit formulas (:func:`flash_attention_bwd_ref`), which
the backward kernels are held to.  The reference differentiates its
``blockwise_attention`` with ``jax.grad``; the tests hold these formulas
to that gradient."""
from __future__ import annotations

import torch

__all__ = ["attention_ref", "flash_attention_lse_ref",
           "flash_attention_bwd_ref"]


def _mask(Lq: int, Lkv: int, causal: bool, window, q_offset: int, device):
    """(Lq, Lkv) bool: the keys each query may see (query i at absolute
    position ``q_offset + i``; ``window`` None: no window)."""
    qpos = q_offset + torch.arange(Lq, device=device)[:, None]
    kpos = torch.arange(Lkv, device=device)[None, :]
    mask = torch.ones((Lq, Lkv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def _scores(q, k, scale):
    """float32 scores (B, H, Lq, Lkv), K repeated over each group."""
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    d = q.shape[-1]
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (
        d ** -0.5 if scale is None else scale)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0,
                  scale: float | None = None) -> torch.Tensor:
    """q (B, H, Lq, d), k/v (B, Hkv, Lkv, d) → (B, H, Lq, d) in q's dtype.

    Query i sits at absolute position ``q_offset + i``; ``window`` keeps
    keys with ``qpos - kpos < window``.  Rows with no unmasked key give 0.
    Scores are scaled by ``scale`` (default ``1 / sqrt(d)``).
    """
    group = q.shape[1] // k.shape[1]
    vv = v.repeat_interleave(group, dim=1).float()
    s = _scores(q, k, scale)
    mask = _mask(q.shape[2], k.shape[2], causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p.masked_fill(~mask, 0.0)
    denom = p.sum(-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def flash_attention_lse_ref(q, k, v, *, causal: bool = True,
                            window: int | None = None, q_offset: int = 0,
                            scale: float | None = None):
    """:func:`attention_ref`'s output and the float32 log-sum-exp of each
    row's scaled scores over its unmasked keys, (B, H, Lq): what the
    forward kernel saves for the backward.  A row with no unmasked key has
    LSE 0 (finite; its probabilities are masked to 0 whatever it is).
    ``window`` 0 or None: no window."""
    window = window or None
    s = _scores(q, k, scale)
    mask = _mask(q.shape[2], k.shape[2], causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(mask.any(-1), lse, 0.0)
    out = attention_ref(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, scale=scale)
    return out, lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int | None = None, q_offset: int = 0,
                            scale: float | None = None):
    """The gradients ``(dq, dk, dv)`` of :func:`attention_ref` for the
    output gradient ``do``, in float32 arithmetic, each returned in its
    operand's dtype.  ``o`` is the forward's output and ``lse`` its
    log-sum-exp (:func:`flash_attention_lse_ref`):

        D = rowsum(dO ∘ O);  P = exp(S − lse);  dV = Pᵀ dO;
        dS = P ∘ (dO Vᵀ − D);  dQ = dS K · scale;  dK = dSᵀ Q · scale,

    S the scaled scores, P masked to 0 where a key is masked, and dK and
    dV summed over each KV head's group of query heads.  Rows with no
    unmasked key give zero gradients.  ``window`` 0 or None: no window."""
    B, H, Lq, d = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    group = H // Hkv
    sc = d ** -0.5 if scale is None else scale
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    qf, of, dof = q.float(), o.float(), do.float()
    mask = _mask(Lq, Lkv, causal, window or None, q_offset, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * sc
    p = torch.exp(s - lse.float()[..., None]).masked_fill(~mask, 0.0)
    Dr = (dof * of).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    ds = p * (dp - Dr)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * sc
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * sc
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(B, Hkv, group, Lkv, d).sum(2)
    dv = dv.reshape(B, Hkv, group, Lkv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
