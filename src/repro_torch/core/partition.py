"""Block partitioning of the matmul operands (paper §II-A).

``C = A @ B`` with ``A: (Nx, Nz)``, ``B: (Nz, Ny)`` is split along the
contraction dimension into ``K`` equal blocks so that
``C = sum_k A_k @ B_k`` — the "information dimension" of every code in this
repo.  Numpy arrays are split into stacked copies (the host float64 control
path); torch tensors are split into strided *views* with no copy — the
device encode kernel reads the blocks through their strides.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["split_contraction", "stack_blocks", "block_outer_products"]


def split_contraction(A, B, K: int):
    """Split ``A`` column-wise and ``B`` row-wise into ``K`` equal blocks.

    Returns ``(A_blocks, B_blocks)`` stacked on a leading axis:
    ``A_blocks: (K, Nx, Nz//K)``, ``B_blocks: (K, Nz//K, Ny)``.  Tensors may
    carry a leading request-batch axis — ``A: (Bt, Nx, Nz)``, ``B: (Bt, Nz,
    Ny)`` split into ``(Bt, K, Nx, Nz//K)`` and ``(Bt, K, Nz//K, Ny)`` views.
    """
    Nz = A.shape[-1]
    if B.shape[-2] != Nz:
        raise ValueError(f"contraction mismatch: A has {Nz}, B has "
                         f"{B.shape[-2]}")
    if Nz % K != 0:
        raise ValueError(f"contraction dim {Nz} not divisible by K={K}")
    step = Nz // K
    if isinstance(A, torch.Tensor) and isinstance(B, torch.Tensor):
        return _split_view_cols(A, K, step), _split_view_rows(B, K, step)
    A, B = np.asarray(A), np.asarray(B)
    A_blocks = np.stack([A[:, k * step:(k + 1) * step] for k in range(K)],
                        axis=0)
    B_blocks = np.stack([B[k * step:(k + 1) * step, :] for k in range(K)],
                        axis=0)
    return A_blocks, B_blocks


def _split_view_cols(A: torch.Tensor, K: int, step: int) -> torch.Tensor:
    """``(..., Nx, K·step)`` → ``(..., K, Nx, step)`` view (block k = columns
    ``k·step:(k+1)·step``)."""
    *lead, Nx, Nz = A.shape
    *lead_st, s_row, s_col = A.stride()
    return A.as_strided(tuple(lead) + (K, Nx, step),
                        tuple(lead_st) + (step * s_col, s_row, s_col))


def _split_view_rows(B: torch.Tensor, K: int, step: int) -> torch.Tensor:
    """``(..., K·step, Ny)`` → ``(..., K, step, Ny)`` view (block k = rows
    ``k·step:(k+1)·step``)."""
    *lead, Nz, Ny = B.shape
    *lead_st, s_row, s_col = B.stride()
    return B.as_strided(tuple(lead) + (K, step, Ny),
                        tuple(lead_st) + (step * s_row, s_row, s_col))


def stack_blocks(blocks):
    """Inverse helper — not generally needed; kept for tests."""
    return np.concatenate(list(blocks), axis=-1)


def block_outer_products(A_blocks, B_blocks):
    """The K "useful" computations ``A_k @ B_k`` — the decode targets.

    Returns ``(K, Nx, Ny)``.  Used by the β oracle (Thm. 1) and by tests.
    """
    if isinstance(A_blocks, torch.Tensor):
        return torch.einsum("kij,kjl->kil", A_blocks, B_blocks)
    return np.einsum("kij,kjl->kil", A_blocks, B_blocks)
