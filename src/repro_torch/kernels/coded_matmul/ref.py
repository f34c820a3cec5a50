"""Plain PyTorch version of the coded worker-task matmul.

Used for CPU tensors, by the tests, and on the card as the kernel's
comparison point.  Accumulates in float32 and returns the operands' result
dtype, as the reference's jnp oracle does.

:func:`coded_matmul_3xtf32_ref` emulates the float32 kernel's arithmetic
(three TF32 products) for the tests and ``chip_smoke.py``; the main path
never calls it.
"""
from __future__ import annotations

import torch

__all__ = ["coded_matmul_ref", "coded_matmul_complex_ref", "tf32_round",
           "coded_matmul_3xtf32_ref"]


def coded_matmul_ref(E_A: torch.Tensor, E_B: torch.Tensor) -> torch.Tensor:
    """``(W, M, Z) @ (W, Z, N) -> (W, M, N)`` in one einsum."""
    out = torch.einsum("wmz,wzn->wmn", E_A.float(), E_B.float())
    return out.to(torch.promote_types(E_A.dtype, E_B.dtype))


def coded_matmul_complex_ref(Ar, Ai, Br, Bi):
    """Complex worker products as (re, im) pairs of real tensors."""
    re = coded_matmul_ref(Ar, Br) - coded_matmul_ref(Ai, Bi)
    im = coded_matmul_ref(Ar, Bi) + coded_matmul_ref(Ai, Br)
    return re, im


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does.  On the int32 view: adding half
    a TF32 ulp to the magnitude bits carries into the kept bits exactly when
    the 13 dropped bits are at least half, whatever the sign."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def coded_matmul_3xtf32_ref(E_A: torch.Tensor,
                            E_B: torch.Tensor) -> torch.Tensor:
    """What the float32 kernel computes: each operand split as ``hi =
    tf32(x)``, ``lo = tf32(x - hi)``, and ``A_lo·B_hi + A_hi·B_lo +
    A_hi·B_hi`` summed in float32 (the ``A_lo·B_lo`` term, about 2^-22 of
    a product, dropped).  Returns float32."""
    A, B = E_A.float(), E_B.float()
    A_hi, B_hi = tf32_round(A), tf32_round(B)
    A_lo, B_lo = tf32_round(A - A_hi), tf32_round(B - B_hi)
    small = coded_matmul_ref(A_lo, B_hi) + coded_matmul_ref(A_hi, B_lo)
    return small + coded_matmul_ref(A_hi, B_hi)
