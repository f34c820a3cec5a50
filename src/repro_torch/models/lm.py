"""Decoder-only LM assembled from an ArchConfig: the serving path.

Counterpart of the reference's ``models/lm.py``, for every family:

* dense / moe — GQA attention + (gated MLP | MoE) blocks
* ssm — Mamba-1 blocks (attention-free)
* hybrid — parallel attention+Mamba heads per block (hymba)
* vlm — backbone LM consuming [vision embeds ; token embeds] in the
  training loss; serving prefills the token stream only, as the reference
* audio — n_codebooks parallel token streams, summed embeddings, one LM
  head per codebook (musicgen over EnCodec tokens)

The parameters live in an :class:`LM` module whose ``state_dict`` keys
follow the reference's tree (``embed``, ``layers.{i}.attn.wq``,
``layers.{i}.ssm.A_log``, ``layers.{i}.moe.shared.w_up``, ``final_norm``,
``lm_head``, ...), one submodule per layer in a ``ModuleList`` instead of a
stacked layer axis.  The functions mirror the reference's:
``embed_tokens``, ``forward_hidden``, ``compute_logits``,
``gathered_logits_fn``, ``lm_loss``, ``init_decode_state``, ``prefill`` and
``decode_step``.

The prefill and the training loss (:func:`lm_loss`) run each layer's
attention in the flash kernel and its Mamba half in the scan kernel
(``use_kernels=False`` on the prefill runs their plain versions instead,
for comparisons); under autograd the kernels' backward kernels give the
gradients, where the reference differentiates its ``blockwise_attention``
and chunked ``ssm_scan_ref``.  The decode state keeps the reference's stacked
per-layer layout; :func:`decode_step` writes the KV caches in place and
returns the state with the next position.

On a mesh (:func:`repro_torch.models.hints.set_mesh`, parameters placed by
:func:`repro_torch.runtime.sharding.distribute_lm`, tokens by
``distribute_batch``) the same functions run on DTensors: the embedding is
a vocab-parallel lookup (each model rank looks up the tokens its vocab
shard holds, one all-reduce), the hidden state is pinned to the batch
axes at every layer, the output head's FSDP shard is gathered once per
loss (:func:`gathered_logits_fn`), the decode state is made sharded by
``decode_state_shardings`` (:func:`init_decode_state` with ``mesh``), and
the prefill writes each rank's own part of it.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch import nn
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..compat import P, Partial, Replicate, Shard, axis_names, shard_map
from ..configs import check_family
from ..device import resolve_device
from .blocks import block_decode_step, block_forward
from .hints import (batch_hint, fsdp_gather, hint, is_dt, model_rank,
                    replicate_like)
from .layers import cross_entropy_chunked, rms_norm, sinusoidal_positions

__all__ = ["LM", "DecodeState", "init_params", "layer_windows",
           "embed_tokens", "forward_hidden", "compute_logits",
           "gathered_logits_fn", "lm_loss", "init_decode_state", "prefill",
           "decode_step"]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class _Layer(nn.Module):
    """One decoder layer's weights, under the reference's names."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model

        def P(*shape, dt=dtype):
            return _param(shape, dt, device)

        self.mixer_norm = P(d)
        if cfg.has_attention:
            hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
            attn = {"wq": P(d, H * hd), "wk": P(d, Hkv * hd),
                    "wv": P(d, Hkv * hd), "wo": P(H * hd, d)}
            if cfg.qkv_bias:
                attn.update(bq=P(H * hd), bk=P(Hkv * hd), bv=P(Hkv * hd))
            self.attn = nn.ParameterDict(attn)
        if cfg.has_ssm:
            di, s = cfg.resolved_d_inner, cfg.ssm_state
            r, c = cfg.resolved_dt_rank, cfg.ssm_conv
            self.ssm = nn.ParameterDict({
                "in_proj": P(d, 2 * di), "conv_w": P(c, di),
                "conv_b": P(di), "x_proj": P(di, r + 2 * s),
                "dt_proj": P(r, di), "dt_bias": P(di),
                "A_log": P(di, s, dt=torch.float32),
                "D": P(di, dt=torch.float32), "out_proj": P(di, d)})
        self.ffn_norm = P(d)
        if cfg.has_moe:
            E, f = cfg.n_experts, cfg.d_ff_expert
            moe = {"router": P(d, E, dt=torch.float32), "w_gate": P(E, d, f),
                   "w_up": P(E, d, f), "w_down": P(E, f, d)}
            if cfg.n_shared_experts:
                fs = f * cfg.n_shared_experts
                moe["shared"] = nn.ParameterDict({
                    "w_gate": P(d, fs), "w_up": P(d, fs), "w_down": P(fs, d)})
            self.moe = nn.ParameterDict(moe)
        elif cfg.d_ff:
            mlp = {"w_up": P(d, cfg.d_ff), "w_down": P(cfg.d_ff, d)}
            if cfg.mlp_act != "gelu":
                mlp["w_gate"] = P(d, cfg.d_ff)
            self.mlp = nn.ParameterDict(mlp)


class LM(nn.Module):
    """The LM's parameters (uninitialised; see :func:`init_params` and
    :func:`repro_torch.convert.lm_params_from_reference`)."""

    def __init__(self, cfg, *, dtype: torch.dtype, device):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        d, Vp = cfg.d_model, cfg.padded_vocab()
        cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        self.embed = _param(cb + (Vp, d), dtype, device)
        self.layers = nn.ModuleList(_Layer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param((d,), dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param(cb + (d, Vp), dtype, device)


@torch.no_grad()
def init_params(cfg, *, device=None, dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> LM:
    """Random weights with the reference's distributions (``models/
    layers.py`` ``init_dense``, ``models/ssm.py`` ``init_mamba_params``,
    ``models/moe.py`` ``init_moe_params``, ``models/lm.py``
    ``init_params``): scaled normals drawn in float32 and cast to
    ``dtype`` (the config's by default); S4D-real ``A_log``, ``D`` and the
    MoE ``router`` (``init_dense``) in float32; expert weights
    ``sqrt(2/(d+f))·N(0,1)``; embeddings, and per-codebook heads,
    ``d^-½·N(0,1)``.

    ``device=None`` means the card (raises without one).  Draws come from
    ``generator`` (a ``torch.Generator`` on ``device``; seeded 0 when not
    given), so one seed gives one model; they are not the reference's
    numbers (its weights cross over with ``lm_params_from_reference``).
    """
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    model = LM(cfg, dtype=dtype, device=dev)

    def normal(t: torch.Tensor, scale: float) -> None:
        t.copy_(scale * torch.randn(t.shape, generator=gen, device=dev))

    def dense(t: torch.Tensor) -> None:
        normal(t, math.sqrt(2.0 / (t.shape[0] + t.shape[1])))

    normal(model.embed, cfg.d_model ** -0.5)
    for layer in model.layers:
        layer.mixer_norm.fill_(1.0)
        layer.ffn_norm.fill_(1.0)
        if cfg.has_attention:
            for w in layer.attn.values():
                if w.ndim == 2:
                    dense(w)
                else:
                    w.zero_()                                 # qkv biases
        if cfg.has_ssm:
            p, s = layer.ssm, cfg.ssm_state
            dense(p["in_proj"])
            normal(p["conv_w"], 1.0 / cfg.ssm_conv)
            p["conv_b"].zero_()
            dense(p["x_proj"])
            dense(p["dt_proj"])
            p["dt_bias"].fill_(-4.6)                         # softplus⁻¹(0.01)
            p["A_log"].copy_(torch.log(torch.arange(
                1, s + 1, dtype=torch.float32, device=dev)).expand_as(
                    p["A_log"]))
            p["D"].fill_(1.0)
            dense(p["out_proj"])
        if cfg.has_moe:
            p = layer.moe
            dense(p["router"])
            sg = math.sqrt(2.0 / (cfg.d_model + cfg.d_ff_expert))
            for name in ("w_gate", "w_up", "w_down"):
                normal(p[name], sg)
            if cfg.n_shared_experts:
                for w in p["shared"].values():
                    dense(w)
        elif cfg.d_ff:
            for w in layer.mlp.values():
                dense(w)
    model.final_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        if cfg.n_codebooks:
            normal(model.lm_head, cfg.d_model ** -0.5)
        else:
            dense(model.lm_head)
    return model


def layer_windows(cfg) -> list[int]:
    """Per-layer sliding-window sizes as Python ints (0 = full attention)."""
    if not cfg.has_attention:
        return [0] * cfg.n_layers
    w = [cfg.sliding_window] * cfg.n_layers
    if cfg.sliding_window and cfg.global_attn_layers:
        for i in cfg.global_attn_layers:
            if i < cfg.n_layers:
                w[i] = 0
    return w


def embed_tokens(params: LM, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens (B, L) integer — or (B, L, n_cb) for audio — → (B, L, d)."""
    if is_dt(tokens):
        x = _embed_mesh(params.embed, tokens, cfg)
    elif cfg.n_codebooks:
        x = sum(params.embed[c][tokens[..., c]]
                for c in range(cfg.n_codebooks))
    else:
        x = params.embed[tokens]
    if cfg.pos_embed == "sinusoidal":
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = x + replicate_like(sinusoidal_positions(pos, cfg.d_model), x
                               ).to(x.dtype)
    return x


def _embed_mesh(embed, tokens, cfg):
    """The vocab-parallel lookup: the table's FSDP shard gathered, each
    model rank looking up the tokens its vocab shard holds (zeros for the
    others), and one all-reduce over the model axis."""
    mesh = tokens.device_mesh
    names = axis_names(mesh)
    table = fsdp_gather(embed)
    vdim = table.ndim - 2
    split = "model" in names and \
        table.placements[names.index("model")] == Shard(vdim)

    def body(tab, tok):
        V_loc = tab.shape[-2]
        lo = model_rank(mesh) * V_loc if split else 0

        def look(t, c=None):
            idx = t - lo
            inr = (idx >= 0) & (idx < V_loc)
            rows = (tab if c is None else tab[c])[idx.clamp(0, V_loc - 1)]
            return torch.where(inr[..., None], rows, 0)

        if cfg.n_codebooks:
            return sum(look(tok[..., c], c) for c in range(cfg.n_codebooks))
        return look(tok)

    tok_plc = tuple(tokens.placements)
    out = tuple(Partial() if a == "model" and split else pl
                for a, pl in zip(names, tok_plc))
    x = shard_map(body, mesh=mesh, in_specs=(tuple(table.placements),
                                             tok_plc),
                  out_specs=out)(table, tokens)
    return x.redistribute(mesh, [Replicate() if isinstance(pl, Partial)
                                 else pl for pl in out])


def forward_hidden(params: LM, x: torch.Tensor, cfg, positions, *,
                   use_kernels: bool = True, coded_weights=None):
    """Run all decoder blocks and the final norm.  x (B, L, d) → ((B, L,
    d), moe_aux_loss): the loss is the mean of the layers' MoE
    load-balance losses (float32; zero without experts).
    ``coded_weights``: the coded FFN's decode vector (with ``cfg.coded``).
    With ``cfg.remat`` under autograd each layer is recomputed in the
    backward pass (``torch.utils.checkpoint``): memory only, the numbers
    are the same."""
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for p_l, win in zip(params.layers, layer_windows(cfg)):
        x = batch_hint(x)       # re-anchor the batch sharding at each layer
        def layer(x, p_l=p_l, win=win):
            x, _, _, aux = block_forward(p_l, x, cfg, positions, win,
                                         use_kernels=use_kernels,
                                         coded_weights=coded_weights)
            return x, aux
        x, aux = checkpoint(layer, x, use_reentrant=False) if remat \
            else layer(x)
        auxes.append(aux)
    aux = torch.stack(auxes).mean() if cfg.has_moe else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params.final_norm, cfg.norm_eps), aux


def compute_logits(params: LM, hidden: torch.Tensor, cfg,
                   codebook: int | None = None) -> torch.Tensor:
    """hidden (..., d) → logits over the (padded) vocab (of ``codebook``
    for audio)."""
    return gathered_logits_fn(params, cfg, codebook)(hidden)


def gathered_logits_fn(params: LM, cfg, codebook: int | None = None):
    """``h ↦ logits`` through the (tied or untied) output head, the
    ``codebook``-th for audio, with the head's FSDP d-shard gathered ONCE
    (on a mesh: the table re-sharded to vocab-over-model up front, so no
    CE chunk's logits product sums over the data axis; autograd reduces
    the accumulated gradient back with one reduce-scatter).  On one device
    this is the plain product."""
    if cfg.tie_embeddings:
        table = params.embed if not cfg.n_codebooks \
            else params.embed[codebook]
        table = hint(table, P("model", None))
        return lambda h: h @ table.T
    head = params.lm_head if not cfg.n_codebooks \
        else params.lm_head[codebook]
    head = hint(head, P(None, "model"))
    return lambda h: h @ head


def _all_logits(params: LM, h: torch.Tensor, cfg) -> torch.Tensor:
    """(B, 1, V) logits — or (B, 1, n_cb, V) for audio."""
    if cfg.n_codebooks:
        return torch.stack([compute_logits(params, h, cfg, c)
                            for c in range(cfg.n_codebooks)], dim=2)
    return compute_logits(params, h, cfg)


def lm_loss(params: LM, batch: dict, cfg, *,
            use_kernels: bool = True) -> torch.Tensor:
    """Next-token CE loss (float32) over ``batch["tokens"]`` (B, L) — (B,
    L, n_cb) for audio, the mean over codebooks — a tensor on the
    parameters' device.  For vlm, ``batch["vision_embeds"]`` (B, n_vis, d)
    is prepended to the token embeddings and only text positions are
    scored; with experts, ``0.01·`` the MoE load-balance loss is added;
    ``batch["coded_weights"]`` (N,), when present, runs the coded FFN.
    The layers run the flash and scan kernels, whose backward kernels
    autograd calls (on the CPU their plain versions, which autograd
    differentiates); ``use_kernels=False`` runs the plain versions on any
    device, for comparisons only, as on :func:`prefill`."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = embed_tokens(params, tokens, cfg)
    n_vis = 0
    if cfg.family == "vlm":
        vis = batch["vision_embeds"].to(x.dtype)        # (B, n_vis, d)
        n_vis = vis.shape[1]
        x = torch.cat([vis, x], dim=1)
    L = x.shape[1]
    positions = torch.arange(L, device=x.device)[None].expand(B, L)
    h, moe_aux = forward_hidden(params, x, cfg, positions,
                                use_kernels=use_kernels,
                                coded_weights=batch.get("coded_weights"))
    h = h[:, n_vis:]                # text positions only
    h = h[:, :-1]                   # predict token t+1 from position t
    T = h.shape[0] * h.shape[1]
    hidden = h.reshape(T, cfg.d_model)
    aux_term = 0.01 * moe_aux if cfg.has_moe else 0.0
    # at most 32 chunks, each a multiple of 512 rows (the reference's rule)
    chunk = max(cfg.loss_chunk, -(-T // 32))
    chunk = ((chunk + 511) // 512) * 512
    if cfg.n_codebooks:
        losses = [cross_entropy_chunked(
            gathered_logits_fn(params, cfg, c), hidden,
            tokens[:, 1:, c].reshape(T), chunk=chunk)
            for c in range(cfg.n_codebooks)]
        return sum(losses) / cfg.n_codebooks + aux_term
    tgt = tokens[:, 1:].reshape(T)
    return cross_entropy_chunked(gathered_logits_fn(params, cfg), hidden,
                                 tgt, chunk=chunk) + aux_term


class DecodeState(NamedTuple):
    """Stacked per-layer decode state + current position (a Python int)."""
    kv_k: Any            # (L, B, Hkv, S, hd) or () for attention-free
    kv_v: Any
    conv: Any            # (L, B, c-1, di) or ()
    ssm_h: Any           # (L, B, di, s) float32 or ()
    pos: int


def init_decode_state(cfg, batch: int, max_seq: int, *,
                      dtype: torch.dtype | None = None,
                      device=None, mesh=None) -> DecodeState:
    """Zero caches and states; with ``mesh`` each leaf a DTensor placed by
    :func:`repro_torch.runtime.sharding.decode_state_shardings`, each rank
    allocating its own shard only."""
    dtype = dtype or getattr(torch, cfg.dtype)
    if mesh is not None:
        from ..runtime.sharding import decode_state_shardings
        from torch.distributed.tensor import zeros as dzeros
        shapes = init_decode_state(cfg, batch, max_seq, dtype=dtype,
                                   device="meta")
        plc = decode_state_shardings(cfg, mesh, shapes)
        return DecodeState(*(
            () if not isinstance(t, torch.Tensor) else
            dzeros(t.shape, dtype=t.dtype, device_mesh=mesh, placements=pl)
            for t, pl in zip(shapes[:4], plc[:4])), 0)
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    L = cfg.n_layers
    kv_k = kv_v = conv = ssm_h = ()
    if cfg.has_attention:
        hd, Hkv = cfg.resolved_head_dim, cfg.n_kv_heads
        S = max_seq
        if cfg.sliding_window and not cfg.global_attn_layers:
            S = min(max_seq, cfg.sliding_window)  # window-only: ring buffer
        kv_k = torch.zeros((L, batch, Hkv, S, hd), dtype=dtype, device=dev)
        kv_v = torch.zeros((L, batch, Hkv, S, hd), dtype=dtype, device=dev)
    if cfg.has_ssm:
        di = cfg.resolved_d_inner
        conv = torch.zeros((L, batch, cfg.ssm_conv - 1, di), dtype=dtype,
                           device=dev)
        ssm_h = torch.zeros((L, batch, di, cfg.ssm_state),
                            dtype=torch.float32, device=dev)
    return DecodeState(kv_k, kv_v, conv, ssm_h, 0)


def prefill(params: LM, tokens: torch.Tensor, cfg,
            max_seq: int | None = None, *, use_kernels: bool = True):
    """Process a full prompt, build the decode state, return last logits.

    tokens (B, L) — (B, L, n_cb) for audio — on the parameters' device →
    (logits (B, 1, V) — (B, 1, n_cb, V) — and :class:`DecodeState` at
    position L).  A vlm prefills its token stream only, as the reference
    does (vision embeddings enter through :func:`lm_loss`).  The KV cache
    is built at ``max_seq`` (≥ L) slots, or as a ring buffer of the window
    for window-only archs; the SSM state comes from the scan kernel.
    """
    B, L = tokens.shape[:2]
    S = max_seq or L
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(L, device=x.device)[None].expand(B, L)
    state = init_decode_state(
        cfg, B, S, dtype=x.dtype, device=x.device,
        mesh=tokens.device_mesh if is_dt(tokens) else None)
    for i, (p_l, win) in enumerate(zip(params.layers, layer_windows(cfg))):
        x = batch_hint(x)
        x, kv, ssm, _ = block_forward(p_l, x, cfg, positions, win,
                                      return_state=cfg.has_ssm,
                                      use_kernels=use_kernels)
        if cfg.has_attention:
            Scap = state.kv_k.shape[3]
            for cache, t in zip((state.kv_k, state.kv_v), kv):
                if is_dt(cache):
                    _write_cache_mesh(cache, i, t, L)
                elif Scap >= L:
                    cache[i, :, :, :L] = t
                else:         # ring cache: slot = absolute pos mod Scap
                    cache[i] = torch.roll(t[:, :, -Scap:], L % Scap, dims=2)
        if cfg.has_ssm:
            if is_dt(state.conv):
                _store_mesh(state.conv, i, ssm[0])
                _store_mesh(state.ssm_h, i, ssm[1])
            else:
                state.conv[i] = ssm[0]
                state.ssm_h[i] = ssm[1]
    h = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _all_logits(params, h[:, -1:], cfg), state._replace(pos=L)


def _layer_spec(buf) -> tuple:
    """Placements of one layer ``buf[i]`` of a stacked DTensor state
    leaf."""
    return tuple(Shard(pl.dim - 1) if isinstance(pl, Shard) else pl
                 for pl in buf.placements)


def _store_mesh(buf, i: int, t) -> None:
    """``buf[i] = t`` for a stacked DTensor state leaf: ``t`` placed as one
    layer of ``buf`` and each rank writing its own shard."""
    def body(b, tl):
        b[i] = tl

    local_map(body, out_placements=None,
              in_placements=(tuple(buf.placements), _layer_spec(buf)),
              device_mesh=buf.device_mesh, redistribute_inputs=True)(buf, t)


def _write_cache_mesh(cache, i: int, t, L: int) -> None:
    """Layer ``i`` of a DTensor KV cache (L, B, Hkv, S, hd) from a prefill's
    k or v (B, Hkv, L, hd): the first L slots, or the ring buffer's image
    when the cache holds fewer; a cache split over its slots takes ``t``
    whole on every model rank and keeps its own slots."""
    mesh = cache.device_mesh
    names = axis_names(mesh)
    Scap = cache.shape[3]
    by_seq = "model" in names and \
        cache.placements[names.index("model")] == Shard(3)
    t_plc = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == 2
                  else pl for pl in _layer_spec(cache))

    def body(c, tl):
        S_loc = c.shape[3]
        lo = model_rank(mesh) * S_loc if by_seq else 0
        if Scap >= L:
            a, b = max(lo, 0), min(lo + S_loc, L)
            if a < b:
                c[i, :, :, a - lo:b - lo] = tl[:, :, a:b]
        else:         # ring cache: slot = absolute pos mod Scap
            img = torch.roll(tl[:, :, -Scap:], L % Scap, dims=2)
            c[i] = img[:, :, lo:lo + S_loc]

    local_map(body, out_placements=None,
              in_placements=(tuple(cache.placements), t_plc),
              device_mesh=mesh, redistribute_inputs=True)(cache, t)


def decode_step(params: LM, tokens: torch.Tensor, state: DecodeState, cfg):
    """One new token with existing state.  tokens (B, 1) — (B, 1, n_cb)
    for audio.

    Returns (logits (B, 1, V) — (B, 1, n_cb, V) — and the new state).
    The KV caches are updated in place.  For window-only archs the write
    position wraps (ring buffer); masking uses absolute positions, so
    correctness holds as long as the cache holds at least the window.
    """
    x = embed_tokens(params, tokens, cfg)
    pos = int(state.pos)
    if cfg.pos_embed == "sinusoidal":
        # embed_tokens added position 0; replace with the true position
        zero = torch.zeros((1, 1), dtype=torch.long, device=x.device)
        x = x - replicate_like(sinusoidal_positions(zero, cfg.d_model),
                               x).to(x.dtype)
        x = x + replicate_like(sinusoidal_positions(zero + pos, cfg.d_model),
                               x).to(x.dtype)
    has_kv, has_ssm = cfg.has_attention, cfg.has_ssm
    ring = bool(has_kv and cfg.sliding_window and not cfg.global_attn_layers
                and state.kv_k.shape[3] <= cfg.sliding_window)
    if has_kv and not ring and pos >= state.kv_k.shape[3]:
        raise ValueError(f"position {pos}: the KV cache holds "
                         f"{state.kv_k.shape[3]} (prefill with a larger "
                         "max_seq)")
    cache_pos = pos % state.kv_k.shape[3] if ring else pos
    convs, hs = [], []
    for i, (p_l, win) in enumerate(zip(params.layers, layer_windows(cfg))):
        kv = (state.kv_k[i], state.kv_v[i]) if has_kv else None
        ssm = (state.conv[i], state.ssm_h[i]) if has_ssm else None
        x, _, ssm = block_decode_step(p_l, x, cfg, pos, win, kv_cache=kv,
                                      ssm_state=ssm, cache_pos=cache_pos,
                                      ring=ring)
        if has_ssm:
            convs.append(ssm[0])
            hs.append(ssm[1])
    h = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = _all_logits(params, h, cfg)
    new_state = DecodeState(
        state.kv_k, state.kv_v,
        torch.stack(convs) if has_ssm else (),
        torch.stack(hs) if has_ssm else (), pos + 1)
    return logits, new_state
