"""Plain PyTorch version of the Mamba-1 selective scan: a loop over time
(the reference's ``kernels/ssm_scan/ref.py``).

:func:`traced_steps` caps the loop for the dry run, which traces a few
steps on fake tensors and multiplies their cost by the sequence length
(``repro_torch.launch.dryrun``); outside it the loop runs every step.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["ssm_scan_ref", "ssm_step_ref", "traced_steps"]

_STEP_CAP: int | None = None


@contextlib.contextmanager
def traced_steps(n: int):
    """Within this context :func:`ssm_scan_ref` runs only its first ``n``
    steps (the rest of ``y`` is left unwritten): for tracing on fake
    tensors only."""
    global _STEP_CAP
    old, _STEP_CAP = _STEP_CAP, int(n)
    try:
        yield
    finally:
        _STEP_CAP = old


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
    Bt, L, Dm = x.shape
    f32 = torch.float32
    A, D = A.to(f32), D.to(f32)
    h = torch.zeros((Bt, Dm, A.shape[1]), dtype=f32, device=x.device)
    y = torch.empty((Bt, L, Dm), dtype=f32, device=x.device)
    for t in range(L if _STEP_CAP is None else min(L, _STEP_CAP)):
        h, y[:, t] = ssm_step_ref(h, x[:, t].to(f32), dt[:, t].to(f32), A,
                                  B[:, t].to(f32), C[:, t].to(f32), D)
    y = y.to(x.dtype)
    return (y, h) if return_final else y
