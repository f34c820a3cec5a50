"""GQA attention: full-sequence attention through the flash kernel, and the
single-token KV-cache decode.

Counterpart of the reference's ``models/attention.py``.  The reference's
full-sequence path is ``blockwise_attention``, a jnp online softmax that
computes what its Pallas kernel computes and that ``jax.grad``
differentiates in training; here it is the kernel itself
(:func:`repro_torch.kernels.flash_attention`), in training too, through
its backward kernels.
:func:`decode_attention` stays plain PyTorch, as in the reference.

On a mesh (DTensor operands) the reference's dispatch is kept: when the
model axis is wider than one, divides the query length into chunks of a
multiple of 128 and the batch divides the batch axes, each model rank runs
the flash kernel on its own contiguous query chunk, with the matching
``q_offset``, against K and V replicated over the model axis (the
reference's ``_smap_attention``), and the output goes back to heads over
the axis for the output projection; otherwise the query heads go over the
model axis when they divide it (the head-parallel pin of the reference's
``_gspmd_attention``), each rank taking the KV heads its query heads read,
else every model rank runs all heads.
Either way the kernel sees each rank's local tensors inside a
``local_map`` body; no DTensor reaches it.  The decode on a mesh
(:func:`decode_attention_mesh`) writes the new token into the cache and
attends on the placements ``decode_state_shardings`` gives it: KV heads
over the model axis, else the sequence, whose per-rank partial softmaxes
are combined by a max and a sum over the axis.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol

from ..compat import P, Shard, axis_names, axis_sizes, shard_map
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_ref
from .hints import hint, is_dt, model_rank

__all__ = ["attention", "decode_attention", "decode_attention_mesh"]


def _batch_spec(mesh, B: int):
    """The batch axes as one spec entry when they divide ``B``, else
    ``None``; and their total size."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    baxes = tuple(a for a in ("pod", "data") if a in names)
    bsize = 1
    for a in baxes:
        bsize *= sizes[a]
    if not baxes or B % bsize != 0:
        return None, bsize
    return (baxes if len(baxes) > 1 else baxes[0]), bsize


def _local_attention(q, k, v, causal, window, q_offset, use_kernels):
    """One rank's attention, its output laid out (B, L, H, d)-contiguous
    as the unsharded path's (no copy when it already is), so that the
    caller's merge of the heads is a view of each rank's rows."""
    if use_kernels:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    else:
        out = attention_ref(q, k, v, causal=causal, window=window or None,
                            q_offset=q_offset)
    return out.transpose(1, 2).contiguous().transpose(1, 2)


def _mesh_attention(q, k, v, causal, window, q_offset, use_kernels):
    mesh = q.device_mesh
    B, H, Lq, _ = q.shape
    Hkv = k.shape[1]
    msize = axis_sizes(mesh).get("model", 1)
    bspec, bsize = _batch_spec(mesh, B)
    if (msize > 1 and Lq % msize == 0 and (Lq // msize) % 128 == 0
            and B % max(bsize, 1) == 0):
        chunk = Lq // msize

        def body(ql, kl, vl):
            off = q_offset + model_rank(mesh) * chunk
            return _local_attention(ql, kl, vl, causal, window, off,
                                    use_kernels)

        fn = shard_map(body, mesh=mesh,
                       in_specs=(P(bspec, None, "model", None), P(bspec),
                                 P(bspec)),
                       out_specs=P(bspec, None, "model", None))
        # back to heads over the model axis (all-to-all) for the output
        # projection, whose rows are split by head; replicated when the
        # heads do not divide the axis
        heads = "model" if H % msize == 0 else None
        return hint(fn(q, k, v), P(bspec, heads))
    # head-parallel when the query heads divide the model axis (the
    # reference's condition); each rank then takes its own KV heads, split
    # with the queries when they divide the axis too, else sliced from the
    # replicated ones (a rank's query heads share one group's KV heads, or
    # hold whole groups)
    group = H // Hkv
    H_loc = H // msize if msize > 1 and H % msize == 0 else H
    heads = "model" if H_loc < H and (H_loc % group == 0
                                      or group % H_loc == 0) else None
    kv_heads = heads if heads and Hkv % msize == 0 else None

    def body(ql, kl, vl):
        if heads and not kv_heads:
            lo = model_rank(mesh) * ql.shape[1] // group
            n = max(ql.shape[1] // group, 1)
            kl, vl = kl[:, lo:lo + n], vl[:, lo:lo + n]
        return _local_attention(ql, kl, vl, causal, window, q_offset,
                                use_kernels)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(bspec, heads), P(bspec, kv_heads),
                             P(bspec, kv_heads)),
                   out_specs=P(bspec, heads))
    return fn(q, k, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              use_kernels: bool = True) -> torch.Tensor:
    """q (B, H, Lq, d); k/v (B, Hkv, Lkv, d) → (B, H, Lq, d).

    ``window`` is the layer's sliding window as a Python int (0: full
    attention).  ``use_kernels=False`` runs the plain version on any device
    instead of the kernel — the caller's explicit choice, for comparisons.
    Under autograd the kernel's gradients come from its backward kernels
    (the train step's path), the plain version's from autograd.  DTensor
    operands take the mesh branches of the module note.
    """
    if is_dt(q):
        return _mesh_attention(q, k, v, causal, window, q_offset,
                               use_kernels)
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


def decode_attention_mesh(q, k, v, k_cache, v_cache, pos: int,
                          cache_pos: int, *, window: int = 0,
                          ring: bool = False):
    """The decode on a mesh: write ``k``/``v`` (B, Hkv, 1, hd) at slot
    ``cache_pos`` of one layer's DTensor caches (B, Hkv, S, hd), in place,
    and attend with ``q`` (B, H, 1, d), as :func:`decode_attention`.

    With the caches' KV heads over the model axis each rank attends with
    its own heads; with the sequence over it each rank scores its own
    slots and the partial softmaxes are combined by a max and a sum over
    the axis; replicated caches attend whole on every rank.
    """
    mesh = k_cache.device_mesh
    names = axis_names(mesh)
    B, H, _, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    group = H // Hkv
    bspec, _ = _batch_spec(mesh, B)
    on_model = k_cache.placements[names.index("model")] \
        if "model" in names else None
    by_seq = isinstance(on_model, Shard) and on_model.dim == 2
    heads = "model" if isinstance(on_model, Shard) and on_model.dim == 1 \
        else None

    def write(kc, vc, kl, vl):
        lo = model_rank(mesh) * kc.shape[2] if by_seq else 0
        if lo <= cache_pos < lo + kc.shape[2]:
            kc[:, :, cache_pos - lo] = kl[:, :, 0]
            vc[:, :, cache_pos - lo] = vl[:, :, 0]

    def body(ql, kc, vc, kl, vl):
        write(kc, vc, kl, vl)
        if not by_seq:
            return decode_attention(ql, kc, vc, pos, window=window, ring=ring)
        # this rank's slots: absolute slots lo … lo + S_loc - 1 of S
        Bl, S_loc = ql.shape[0], kc.shape[2]
        qg = ql.reshape(Bl, Hkv, group, d)
        s = torch.einsum("bhgd,bhsd->bhgs", qg.float(),
                         kc.float()) / (d ** 0.5)
        kpos = model_rank(mesh) * S_loc + torch.arange(S_loc,
                                                       device=ql.device)
        if ring:
            abs_pos = pos - torch.remainder(pos - kpos, S)
            mask = abs_pos >= 0
            kdist = pos - abs_pos
        else:
            mask = kpos <= pos
            kdist = pos - kpos
        if window:
            mask = mask & (kdist < window)
        s = s.masked_fill(~mask, float("-inf"))
        group_m = (mesh, names.index("model"))
        m = funcol.all_reduce(s.amax(-1, keepdim=True), "max", group_m)
        p = torch.exp(s - m).masked_fill(~mask, 0.0)
        num = funcol.all_reduce(torch.einsum("bhgs,bhsd->bhgd", p,
                                             vc.float()), "sum", group_m)
        den = funcol.all_reduce(p.sum(-1)[..., None], "sum", group_m)
        return (num / den).reshape(Bl, H, 1, d).to(ql.dtype)

    cache_spec = P(bspec, None, "model") if by_seq else P(bspec, heads)
    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(bspec, heads), cache_spec, cache_spec,
                             P(bspec, heads), P(bspec, heads)),
                   out_specs=P(bspec, heads))
    return fn(q, k_cache, v_cache, k, v)
