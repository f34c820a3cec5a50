"""Plain PyTorch version of the coded worker-task matmul.

Used for CPU tensors, by the tests, and on the card as the kernel's
comparison point.  Accumulates in float32 and returns the operands' result
dtype, as the reference's jnp oracle does.
"""
from __future__ import annotations

import torch

__all__ = ["coded_matmul_ref", "coded_matmul_complex_ref"]


def coded_matmul_ref(E_A: torch.Tensor, E_B: torch.Tensor) -> torch.Tensor:
    """``(W, M, Z) @ (W, Z, N) -> (W, M, N)`` in one einsum."""
    out = torch.einsum("wmz,wzn->wmn", E_A.float(), E_B.float())
    return out.to(torch.promote_types(E_A.dtype, E_B.dtype))


def coded_matmul_complex_ref(Ar, Ai, Br, Bi):
    """Complex worker products as (re, im) pairs of real tensors."""
    re = coded_matmul_ref(Ar, Br) - coded_matmul_ref(Ai, Bi)
    im = coded_matmul_ref(Ar, Bi) + coded_matmul_ref(Ai, Br)
    return re, im
