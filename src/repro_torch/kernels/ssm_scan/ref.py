"""Plain PyTorch version of the Mamba-1 selective scan: a loop over time
(the reference's ``kernels/ssm_scan/ref.py``), the same forward with the
state at every chunk boundary (:func:`ssm_scan_fwd_ref`), and the backward
that recomputes each chunk's states from its checkpoint and runs the
adjoint recurrence back in time (:func:`ssm_scan_bwd_ref`), which the
backward kernel is held to.  The reference differentiates its chunked,
rematerialized ``lax.scan`` with ``jax.grad``; the tests hold the backward
here to that gradient.
"""
from __future__ import annotations

import torch

__all__ = ["CHUNK", "ssm_scan_ref", "ssm_scan_fwd_ref", "ssm_scan_bwd_ref",
           "ssm_step_ref"]

# time steps between two saved states: the reference's chunk of
# rematerialization (``ssm_scan_ref(chunk=256)``)
CHUNK = 256


def ssm_step_ref(h, x_t, dt_t, A, B_t, C_t, D):
    """One recurrence step (the decode path).

    h (Bt, Dm, S); x_t/dt_t (Bt, Dm); B_t/C_t (Bt, S) → (h', y_t (Bt, Dm)).
    """
    decay = torch.exp(dt_t[..., None] * A[None])            # (Bt, Dm, S)
    h = decay * h + (dt_t * x_t)[..., None] * B_t[:, None, :]
    y = (h * C_t[:, None, :]).sum(-1) + D[None] * x_t
    return h, y


def ssm_scan_ref(x, dt, A, B, C, D, *, return_final: bool = False):
    """Full-sequence scan in float32.  x/dt (Bt, L, Dm), A (Dm, S), B/C
    (Bt, L, S), D (Dm,) → y (Bt, L, Dm) in x's dtype, and with
    ``return_final`` the final state h (Bt, Dm, S) in float32."""
    y, h, _ = ssm_scan_fwd_ref(x, dt, A, B, C, D)
    return (y, h) if return_final else y


def ssm_scan_fwd_ref(x, dt, A, B, C, D, *, chunk: int = CHUNK):
    """:func:`ssm_scan_ref` with its final state and the state before every
    ``chunk``-th step: ``(y, h_final, checkpoints)``, checkpoints
    (Bt, ⌈L/chunk⌉, Dm, S) float32, ``checkpoints[:, c]`` the state
    before step ``c·chunk`` (zeros for c = 0).  Autograd differentiates
    ``y`` and ``h_final``; the checkpoints carry no gradient."""
    Bt, L, Dm = x.shape
    f32 = torch.float32
    A, D = A.to(f32), D.to(f32)
    h = torch.zeros((Bt, Dm, A.shape[1]), dtype=f32, device=x.device)
    y = torch.empty((Bt, L, Dm), dtype=f32, device=x.device)
    ckpt = torch.empty((Bt, -(-L // chunk), Dm, A.shape[1]), dtype=f32,
                       device=x.device)
    for t in range(L):
        if t % chunk == 0:
            ckpt[:, t // chunk] = h.detach()
        h, y[:, t] = ssm_step_ref(h, x[:, t].to(f32), dt[:, t].to(f32), A,
                                  B[:, t].to(f32), C[:, t].to(f32), D)
    return y.to(x.dtype), h, ckpt


def ssm_scan_bwd_ref(x, dt, A, B, C, D, dy, checkpoints, *,
                     chunk: int = CHUNK):
    """The gradients ``(dx, ddt, dA, dB, dC, dD)`` of :func:`ssm_scan_ref`'s
    ``y`` for the output gradient ``dy`` (none flows through the final
    state), in float32 arithmetic, each returned in its operand's dtype.

    Each chunk of ``checkpoints`` (:func:`ssm_scan_fwd_ref`), last first,
    has its states recomputed from its checkpoint; then, with a_t =
    exp(Δ_t A) and u_t = Δ_t x_t, the adjoint g_t = ∂L/∂h_t runs back in
    time, g_t = a_{t+1} g_{t+1} + C_t dy_t, and

        dC_t = Σ_d h_t dy_t;   dB_t = Σ_d g_t u_t;   du_t = Σ_s g_t B_t;
        dx_t = D dy_t + Δ_t du_t;   dΔ_t = x_t du_t + Σ_s g_t h_{t-1} a_t A;
        dA = Σ_{b,t} g_t h_{t-1} a_t Δ_t;   dD = Σ_{b,t} dy_t x_t.
    """
    Bt, L, Dm = x.shape
    f32 = torch.float32
    xf, dtf, dyf = x.to(f32), dt.to(f32), dy.to(f32)
    Bf, Cf = B.to(f32), C.to(f32)
    Af = A.to(f32)
    g = torch.zeros((Bt, Dm, A.shape[1]), dtype=f32, device=x.device)
    dx = torch.empty((Bt, L, Dm), dtype=f32, device=x.device)
    ddt = torch.empty_like(dx)
    dB = torch.empty((Bt, L, A.shape[1]), dtype=f32, device=x.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros_like(Af)
    for c in reversed(range(checkpoints.shape[1])):
        t0, t1 = c * chunk, min(L, (c + 1) * chunk)
        h = checkpoints[:, c].to(f32)
        before = []                      # h_{t-1} for t = t0 .. t1 - 1
        for t in range(t0, t1):
            before.append(h)
            h = torch.exp(dtf[:, t, :, None] * Af) * h + \
                (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        for t in reversed(range(t0, t1)):
            hp = before[t - t0]
            a = torch.exp(dtf[:, t, :, None] * Af)
            u = dtf[:, t] * xf[:, t]
            h = a * hp + u[..., None] * Bf[:, t, None, :]
            g = g + Cf[:, t, None, :] * dyf[:, t, :, None]
            dC[:, t] = (h * dyf[:, t, :, None]).sum(1)
            dB[:, t] = (g * u[..., None]).sum(1)
            du = (g * Bf[:, t, None, :]).sum(-1)
            gha = g * hp * a
            dA += (gha * dtf[:, t, :, None]).sum(0)
            dx[:, t] = D.to(f32) * dyf[:, t] + dtf[:, t] * du
            ddt[:, t] = xf[:, t] * du + (gha * Af).sum(-1)
            g = g * a
    dD = (dyf * xf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype), dD.to(D.dtype))
