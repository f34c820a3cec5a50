"""Decoder blocks: attention / SSM / hybrid mixers over one layer's weights.

Counterpart of the reference's ``models/blocks.py``.  A block is ``x +
mixer(norm(x))`` then ``x + ffn(norm(x))``; the mixer is GQA attention
(dense, moe, vlm, audio), Mamba (ssm), or both in parallel (hybrid —
hymba's parallel attn+mamba heads).  The FFN is the MoE block
(:func:`repro_torch.models.moe.moe_block`) when the config has experts,
else the (gated) MLP; with ``cfg.coded`` and decode weights, the MLP's
down-projection is the SAC-coded contraction
(:func:`repro_torch.runtime.coded.coded_contraction`; the MoE branch
ignores ``cfg.coded``, as the reference's does).  ``p`` is one layer of
:class:`repro_torch.models.lm.LM` (``p.attn["wq"]``, ``p.ssm["A_log"]``,
``p.mlp["w_up"]``, ``p.moe["router"]``, ...).

On a mesh the layer's weights are DTensors placed by
:mod:`repro_torch.runtime.sharding`: each block gathers their FSDP shards
once (ZeRO-3, :func:`~repro_torch.models.hints.fsdp_gather`; the MoE
gathers its own inside its body), and the attention's output projection
ends in an all-reduce over the model axis.  ``cfg.cost_mode`` (the dry
run's prefill proxy) runs materialized attention with the reference's
hints: batch on the data axes, the heads — or, when they do not divide
the axis, the query length — on the model axis.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
from torch.distributed.tensor.experimental import local_map

from ..compat import Replicate, Shard
from ..core import MatDotCode, chebyshev_roots
from ..runtime.coded import coded_contraction, coded_generators
from .attention import attention, decode_attention, decode_attention_mesh
from .hints import axes_hint, fsdp_gather, get_model_info, is_dt, reduced
from .layers import gated_mlp, mlp_hidden, rms_norm, rope
from .moe import moe_block
from .ssm import mamba_block, mamba_step

__all__ = ["block_forward", "block_decode_step"]


def _heads(t, n: int, hd: int):
    """(B, L, n·hd) → (B, L, n, hd).  A DTensor split over its last dim by
    an axis that does not divide ``n`` is gathered over that axis first (a
    shard may not cut a head), then split on each rank's own rows, whose
    reshape (unlike a DTensor's view) takes any layout, its gradient's
    too."""
    B, L, _ = t.shape
    if not is_dt(t):
        return t.reshape(B, L, n, hd)
    mesh = t.device_mesh
    keep = [Replicate() if isinstance(pl, Shard) and pl.dim % 3 == 2
            and n % mesh.size(i) else pl
            for i, pl in enumerate(t.placements)]
    if keep != list(t.placements):
        t = t.redistribute(mesh, keep)
    return local_map(lambda x: x.reshape(x.shape[0], x.shape[1], -1, hd),
                     out_placements=list(t.placements),
                     in_placements=(list(t.placements),),
                     device_mesh=mesh)(t)


def _qkv(p, x, cfg, positions):
    hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = _heads(q, H, hd), _heads(k, Hkv, hd), _heads(v, Hkv, hd)
    if cfg.pos_embed == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    # (B, heads, L, hd) views: the flash kernel takes their strides
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _merge_heads(out, B: int, L: int):
    """(B, H, L, hd) → (B, L, H·hd); a DTensor on each rank's own rows (a
    DTensor's reshape must be a view of them, which a redistributed
    output's layout need not allow)."""
    if not is_dt(out):
        return out.transpose(1, 2).reshape(B, L, -1)
    dims = {0: 0, 1: 2, 2: 1}          # batch, heads → features, positions
    plc = [Shard(dims[pl.dim % 4]) if isinstance(pl, Shard) else pl
           for pl in out.placements]
    return local_map(lambda t: t.transpose(1, 2).reshape(
        t.shape[0], t.shape[2], -1), out_placements=plc,
        in_placements=(list(out.placements),),
        device_mesh=out.device_mesh)(out)


def _gathered(p):
    """One layer's weights with their FSDP shards gathered (the layer
    itself when its weights are plain tensors); the MoE weights stay as
    they are."""
    if not is_dt(p.mixer_norm):
        return p
    view = SimpleNamespace(mixer_norm=fsdp_gather(p.mixer_norm),
                           ffn_norm=fsdp_gather(p.ffn_norm))
    for group in ("attn", "ssm", "mlp"):
        if hasattr(p, group):
            setattr(view, group, {k: fsdp_gather(w)
                                  for k, w in getattr(p, group).items()})
    if hasattr(p, "moe"):
        view.moe = p.moe
    return view


def _attn_forward(p, x, cfg, positions, window: int, use_kernels: bool):
    """Full-sequence attention sublayer.  Returns (out, (k, v))."""
    B, L, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if cfg.cost_mode:
        # materialized attention with the reference's hints: batch on data,
        # heads (when divisible) or query length on the model axis
        _, msize = get_model_info()
        mdim = 1 if (msize > 1 and cfg.n_heads % msize == 0) else 2
        q = axes_hint(q, 0, mdim)
        k, v = axes_hint(k, 0, None), axes_hint(v, 0, None)
        out = axes_hint(attention(q, k, v, causal=True, window=window,
                                  use_kernels=False), 0, mdim)
    else:
        out = attention(q, k, v, causal=True, window=window,
                        use_kernels=use_kernels)
    out = _merge_heads(out, B, L)
    return reduced(out @ p["wo"]), (k, v)


@functools.lru_cache(maxsize=None)
def _matdot_generators(K: int, N: int, device: torch.device):
    """The coded FFN's ``(G_A, G_B)``: MatDot on Chebyshev points (the
    best-conditioned real points), built once per (K, N, device) as the
    reference builds them once at trace time."""
    return coded_generators(MatDotCode(K, N, chebyshev_roots(N)),
                            device=device)


def _ffn(p, x, cfg, coded_weights=None):
    """Returns ``(out, moe_aux_loss)``; the loss is ``None`` without
    experts (the reference's is a zero there)."""
    if cfg.has_moe:
        B, L, d = x.shape
        out, aux = moe_block(p.moe, x.reshape(B * L, d), cfg)
        return out.reshape(B, L, d), aux
    if not cfg.d_ff:
        return torch.zeros_like(x), None
    if cfg.coded and coded_weights is not None:
        # SAC-coded down-projection: straggler-tolerant TP contraction over
        # N = len(coded_weights) workers
        B, L, d = x.shape
        G_A, G_B = _matdot_generators(cfg.coded_K, coded_weights.shape[0],
                                      x.device)
        h = mlp_hidden(x, p.mlp, cfg.mlp_act)
        out = coded_contraction(h.reshape(B * L, -1), p.mlp["w_down"], G_A,
                                G_B, coded_weights)
        return out.reshape(B, L, d), None
    return gated_mlp(x, p.mlp, cfg.mlp_act), None


def block_forward(p, x: torch.Tensor, cfg, positions, window: int, *,
                  return_state: bool = False, use_kernels: bool = True,
                  coded_weights=None):
    """One decoder block over a full sequence.

    ``window``: the layer's sliding window as a Python int (0: full).
    ``coded_weights``: the coded FFN's (N,) decode vector (with
    ``cfg.coded``; ``None`` runs the plain FFN).
    Returns ``(x', kv or None, ssm_state or None, moe_aux or None)`` — kv
    = (k, v) for caching; ssm_state = (conv_tail, h_final) when
    ``return_state``; moe_aux the MoE block's load-balance loss (float32
    scalar) when the config has experts.
    """
    p = _gathered(p)
    h = rms_norm(x, p.mixer_norm, cfg.norm_eps)
    kv = ssm_state = None

    def run_ssm(h):
        if return_state:
            return mamba_block(p.ssm, h, cfg, return_state=True,
                               use_kernels=use_kernels)
        return mamba_block(p.ssm, h, cfg, use_kernels=use_kernels), None

    if cfg.family == "hybrid":
        attn_out, kv = _attn_forward(p.attn, h, cfg, positions, window,
                                     use_kernels)
        ssm_out, ssm_state = run_ssm(h)
        x = x + 0.5 * (attn_out + ssm_out)        # parallel heads, mean-fused
    elif cfg.has_ssm:
        ssm_out, ssm_state = run_ssm(h)
        x = x + ssm_out
    else:
        attn_out, kv = _attn_forward(p.attn, h, cfg, positions, window,
                                     use_kernels)
        x = x + attn_out
    ffn_out, aux = _ffn(p, rms_norm(x, p.ffn_norm, cfg.norm_eps), cfg,
                        coded_weights)
    return x + ffn_out, kv, ssm_state, aux


def block_decode_step(p, x: torch.Tensor, cfg, pos: int, window: int,
                      kv_cache=None, ssm_state=None, cache_pos=None,
                      ring: bool = False):
    """One decoder block for one token.  x (B, 1, d).

    ``kv_cache``: (k (B,Hkv,S,hd), v), written IN PLACE at ``cache_pos``
    (defaults to ``pos``; differs for ring-buffer window caches).
    ``ssm_state``: (conv (B,c-1,di), h (B,di,s)).
    Returns (x', kv_cache, ssm_state').
    """
    B = x.shape[0]
    p = _gathered(p)
    h = rms_norm(x, p.mixer_norm, cfg.norm_eps)
    cpos = pos if cache_pos is None else cache_pos

    def attend(h):
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=x.device)
        q, k, v = _qkv(p.attn, h, cfg, positions)
        kc, vc = kv_cache
        if is_dt(kc):
            out = decode_attention_mesh(q, k, v, kc, vc, pos, cpos,
                                        window=window, ring=ring)
        else:
            kc[:, :, cpos] = k[:, :, 0]
            vc[:, :, cpos] = v[:, :, 0]
            out = decode_attention(q, kc, vc, pos, window=window, ring=ring)
        return reduced(_merge_heads(out, B, 1) @ p.attn["wo"])

    new_ssm = ssm_state
    if cfg.family == "hybrid":
        attn_out = attend(h)
        y, conv, hh = mamba_step(p.ssm, h[:, 0], ssm_state[0], ssm_state[1],
                                 cfg)
        x = x + 0.5 * (attn_out + y[:, None])
        new_ssm = (conv, hh)
    elif cfg.has_ssm:
        y, conv, hh = mamba_step(p.ssm, h[:, 0], ssm_state[0], ssm_state[1],
                                 cfg)
        x = x + y[:, None]
        new_ssm = (conv, hh)
    else:
        x = x + attend(h)
    x = x + _ffn(p, rms_norm(x, p.ffn_norm, cfg.norm_eps), cfg)[0]
    return x, kv_cache, new_ssm
