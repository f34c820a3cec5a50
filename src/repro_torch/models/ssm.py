"""Mamba-1 block (falcon-mamba; also the SSM half of hymba).

Counterpart of the reference's ``models/ssm.py``.  Block: in_proj → [x, z];
causal depthwise conv on x; data-dependent Δ, B, C from x; diagonal
selective scan (:func:`repro_torch.kernels.ssm_scan`); gate by SiLU(z);
out_proj.  Unlike the reference, the full-sequence block runs the scan
kernel in both modes: with ``return_state`` the kernel also hands back the
final state for the decode, where the reference drops to its plain scan.
Decode keeps O(1) state per layer: the conv tail and the SSM state h, and
steps in plain PyTorch (:func:`ssm_step_ref`), as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan.ops import ssm_scan, ssm_step_ref
from ..kernels.ssm_scan.ref import ssm_scan_ref

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
