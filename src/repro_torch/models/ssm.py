"""Mamba-1 block (falcon-mamba; also the SSM half of hymba).

Counterpart of the reference's ``models/ssm.py``.  Block: in_proj → [x, z];
causal depthwise conv on x; data-dependent Δ, B, C from x; diagonal
selective scan (:func:`repro_torch.kernels.ssm_scan`); gate by SiLU(z);
out_proj.  Unlike the reference, the full-sequence block runs the scan
kernel in both modes: with ``return_state`` the kernel also hands back the
final state for the decode, where the reference drops to its plain scan;
in training the kernel's backward kernel differentiates it, where the
reference differentiates its chunked jnp scan.
Decode keeps O(1) state per layer: the conv tail and the SSM state h, and
steps in plain PyTorch (:func:`ssm_step_ref`), as in the reference.

On a mesh (DTensor activations) the channels go over the model axis, as
the reference's hints put them (``xz`` and ``xin`` pinned to (batch, …,
model)): ``in_proj``'s x and z halves are each split over the axis (the
weight is gathered over the axis and re-split, so no activation moves),
the conv, the scan kernel and the decode step run on each rank's own
channels inside ``local_map`` bodies, and the ``x_proj`` and ``out_proj``
contractions over the channels end in an all-reduce.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..compat import P, Replicate, Shard, shard_map
from ..kernels.ssm_scan.ops import ssm_scan, ssm_step_ref
from ..kernels.ssm_scan.ref import ssm_scan_ref
from .hints import axes_hint, get_batch_axes, get_model_info, is_dt, reduced

__all__ = ["mamba_block", "mamba_step"]


def _split_xproj(xp, r, s):
    return xp[..., :r], xp[..., r:r + s], xp[..., r + s:]


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x (B, L, di); w (c, di)."""
    c = w.shape[0]
    xp = F.pad(x, (0, 0, c - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None] for i in range(c))
    return out + b[None, None]


def mamba_block(p, x: torch.Tensor, cfg, *, return_state: bool = False,
                use_kernels: bool = True):
    """Full-sequence mamba mixer.  x (B, L, d) → (B, L, d).

    ``p`` maps the reference's parameter names to tensors.
    ``return_state=True`` also returns ``(conv_tail (B, c-1, di), h_final
    (B, di, s))`` for the prefill → decode hand-off.  B and C reach the
    scan as column views of the ``x_proj`` output, without a copy.
    """
    if is_dt(x):
        return _mamba_block_mesh(p, x, cfg, return_state, use_kernels)
    s, r = cfg.ssm_state, cfg.resolved_dt_rank
    xz = x @ p["in_proj"]
    xin_raw, z = xz.chunk(2, dim=-1)
    xin = F.silu(_causal_conv(xin_raw, p["conv_w"], p["conv_b"]))
    dt_r, B, C = _split_xproj(xin @ p["x_proj"], r, s)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    scan = ssm_scan if use_kernels else ssm_scan_ref
    y, h_final = scan(xin, dt, A, B, C, p["D"], return_final=True)
    out = (y * F.silu(z)) @ p["out_proj"]
    if not return_state:
        return out
    c = cfg.ssm_conv
    pad = F.pad(xin_raw, (0, 0, c - 1, 0))
    return out, (pad[:, pad.shape[1] - (c - 1):, :], h_final)


def mamba_step(p, x_t: torch.Tensor, conv_state: torch.Tensor,
               h: torch.Tensor, cfg):
    """One decode step.  x_t (B, d); conv_state (B, c-1, di); h (B, di, s).

    Returns (y_t (B, d), conv_state', h').
    """
    if is_dt(x_t):
        return _mamba_step_mesh(p, x_t, conv_state, h, cfg)
    s, r = cfg.ssm_state, cfg.resolved_dt_rank
    xin, z = (x_t @ p["in_proj"]).chunk(2, dim=-1)           # (B, di)
    window = torch.cat([conv_state, xin[:, None]], dim=1)    # (B, c, di)
    conv_out = torch.einsum("bcd,cd->bd", window.float(),
                            p["conv_w"].float()) + p["conv_b"]
    xin = F.silu(conv_out.to(x_t.dtype))
    dt_r, B, C = _split_xproj(xin @ p["x_proj"], r, s)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h, y = ssm_step_ref(h.float(), xin.float(), dt.float(), A, B.float(),
                        C.float(), p["D"])
    y = y.to(x_t.dtype) * F.silu(z)
    return y @ p["out_proj"], window[:, 1:], h


# ------------------------------------------------------------------ mesh

def _specs(x, cfg):
    """(batch entry, channel entry) of the mesh specs: the batch axes when
    they divide x's batch, the model axis when it divides the channels."""
    baxes = get_batch_axes()
    mesh = x.device_mesh
    bsize = 1
    for a in baxes:
        bsize *= mesh.size(mesh.mesh_dim_names.index(a))
    b = (baxes if len(baxes) > 1 else baxes[0]) \
        if baxes and x.shape[0] % bsize == 0 else None
    _, msize = get_model_info()
    ch = "model" if msize > 1 and cfg.resolved_d_inner % msize == 0 else None
    return b, ch


def _in_halves(w, di, ch):
    """``in_proj`` (d, 2di) as its x and z halves, each split over the
    model axis by ``ch``."""
    mesh = w.device_mesh
    full = w.redistribute(mesh, [Replicate()] * mesh.ndim)
    plc = [Replicate()] * mesh.ndim
    if ch:
        plc[mesh.mesh_dim_names.index("model")] = Shard(1)
    return (full[:, :di].redistribute(mesh, plc),
            full[:, di:].redistribute(mesh, plc))


def _x_proj(xin, p, cfg):
    """(dt, B, C) from the channel-split ``xin``: the ``x_proj`` partial
    sums reduced over the model axis."""
    s, r = cfg.ssm_state, cfg.resolved_dt_rank
    dt_r, B, C = _split_xproj(reduced(xin @ p["x_proj"]), r, s)
    return F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"]), B, C


def _mamba_block_mesh(p, x, cfg, return_state, use_kernels):
    mesh = x.device_mesh
    b, ch = _specs(x, cfg)
    di, c = cfg.resolved_d_inner, cfg.ssm_conv
    wx, wz = _in_halves(p["in_proj"], di, ch)
    xin_raw = axes_hint(x @ wx, 0, 2)          # channels on the model axis
    z = x @ wz

    def conv(xr, w, bias):
        xin = F.silu(_causal_conv(xr, w, bias))
        pad = F.pad(xr, (0, 0, c - 1, 0))
        return xin, pad[:, pad.shape[1] - (c - 1):, :]

    act = P(b, None, ch)
    xin, tail = shard_map(conv, mesh=mesh,
                          in_specs=(act, P(None, ch), P(ch)),
                          out_specs=(act, act))(xin_raw, p["conv_w"],
                                                p["conv_b"])
    dt, B, C = _x_proj(xin, p, cfg)
    A = -torch.exp(p["A_log"])
    scan = ssm_scan if use_kernels else ssm_scan_ref

    def body(xl, dtl, Al, Bl, Cl, Dl):
        return scan(xl, dtl, Al, Bl, Cl, Dl, return_final=True)

    y, h_final = shard_map(
        body, mesh=mesh,
        in_specs=(act, act, P(ch, None), P(b), P(b), P(ch)),
        out_specs=(act, P(b, ch, None)))(xin, dt, A, B, C, p["D"])
    out = reduced((y * F.silu(z)) @ p["out_proj"])
    if not return_state:
        return out
    return out, (tail, h_final)


def _mamba_step_mesh(p, x_t, conv_state, h, cfg):
    mesh = x_t.device_mesh
    b, ch = _specs(x_t, cfg)
    di = cfg.resolved_d_inner
    wx, wz = _in_halves(p["in_proj"], di, ch)
    xin, z = x_t @ wx, x_t @ wz                              # (B, di)

    def conv(cs, xl, w, bias):
        window = torch.cat([cs, xl[:, None]], dim=1)         # (B, c, di)
        out = torch.einsum("bcd,cd->bd", window.float(), w.float()) + bias
        return F.silu(out.to(xl.dtype)), window[:, 1:]

    xin, conv_new = shard_map(
        conv, mesh=mesh,
        in_specs=(P(b, None, ch), P(b, ch), P(None, ch), P(ch)),
        out_specs=(P(b, ch), P(b, None, ch)))(conv_state, xin, p["conv_w"],
                                               p["conv_b"])
    dt, B, C = _x_proj(xin, p, cfg)
    A = -torch.exp(p["A_log"])

    def step(hl, xl, dtl, Al, Bl, Cl, Dl):
        return ssm_step_ref(hl.float(), xl.float(), dtl.float(), Al,
                            Bl.float(), Cl.float(), Dl)

    h, y = shard_map(
        step, mesh=mesh,
        in_specs=(P(b, ch, None), P(b, ch), P(b, ch), P(ch, None), P(b),
                  P(b), P(ch)),
        out_specs=(P(b, ch, None), P(b, ch)))(h, xin, dt, A, B, C, p["D"])
    y = y.to(x_t.dtype) * F.silu(z)
    return reduced(y @ p["out_proj"]), conv_new, h
