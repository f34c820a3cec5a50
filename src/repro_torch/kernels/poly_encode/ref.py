"""Plain PyTorch version of the polynomial encode.

Used for CPU tensors, by the tests, and on the card as the kernel's
comparison point.  Accumulates in float32 and returns X's dtype, as the
reference's jnp oracle does.
"""
from __future__ import annotations

import torch

__all__ = ["poly_encode_ref"]


def poly_encode_ref(G: torch.Tensor, X: torch.Tensor, *,
                    parts: int = 1) -> torch.Tensor:
    """``E[w] = Σ_k G[w,k] X[k]``: (W, K) × ([Bt,] K, R, C) → ([Bt,] W, R, C).

    With ``parts`` > 1 the ``parts·W`` generator rows are split into parts
    (e.g. ``[G.real; G.imag]``) and the result is laid out
    ``(parts, [Bt,] W, R, C)``, each part contiguous — the kernel's layout.
    """
    E = torch.einsum("wk,...krc->...wrc", G.float(), X.float()).to(X.dtype)
    if parts == 1:
        return E
    rows = G.shape[0]
    if rows % parts:
        raise ValueError(f"{rows} generator rows do not split into {parts} "
                         "parts")
    E = E.unflatten(-3, (parts, rows // parts))     # (..., P, W, R, C)
    return E.movedim(-4, 0).contiguous()
