"""Worker products of the coded matmul: the CUDA kernels and their wrappers.

Counterpart of the reference's ``kernels/coded_matmul/ops.py``, whose TPU
kernel is ``coded_matmul_pallas`` (``src/repro/kernels/coded_matmul/
kernel.py``).  The source (``csrc/coded_matmul.cu``) holds three batched
GEMM kernels: float32 runs three TF32 tensor-core products per output
(each operand split into a TF32 high and low part, ``A_hi·B_hi +
A_hi·B_lo + A_lo·B_hi``), which keeps float32 accuracy; bf16 runs on
Hopper's warpgroup products (``wgmma``) fed by TMA loads, with a float32
accumulator and one rounding to bf16, when TMA can address the operands
(:func:`tma_aligned`), and otherwise on a CUDA-core kernel.  Its source
note gives the bound on the card and the designs.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
a kernel or raises — there is no fallback.  :func:`coded_matmul` counts
its launches in ``coded_matmul.launches``, those in bf16 also in
``coded_matmul.bf16_launches``, and those of the CUDA-core bf16 instance
also in ``coded_matmul.bf16_simt_launches``.  Complex evaluation points
run as four launches into two outputs (``re = ArBr − AiBi``, ``im = ArBi
+ AiBr``), accumulating in place with no temporaries.
"""
from __future__ import annotations

import torch

from .._build import check, load, refuse_autograd
from .ref import coded_matmul_ref

__all__ = ["coded_matmul", "worker_products", "worker_products_complex",
           "tma_aligned"]

_KERNEL_DTYPES = {torch.float32: "coded_matmul_f32",
                  torch.bfloat16: "coded_matmul_bf16"}
# rows of C one block owns, in every instance (BM, TC_BM and WG_BM in the
# source): the grid's y extent is ceil(M / TILE_ROWS)
TILE_ROWS = 128
GRID_MAX = 65535                     # the grid's y and z extents


def _check(E_A: torch.Tensor, E_B: torch.Tensor, out) -> tuple:
    if E_A.ndim != 3 or E_B.ndim != 3:
        raise ValueError(f"need (W, M, Z) and (W, Z, N) operands; got "
                         f"{tuple(E_A.shape)} and {tuple(E_B.shape)}")
    W, M, Z = E_A.shape
    W2, Z2, N = E_B.shape
    if (W2, Z2) != (W, Z):
        raise ValueError(f"shape mismatch {tuple(E_A.shape)} x "
                         f"{tuple(E_B.shape)}")
    if E_B.device != E_A.device:
        raise ValueError(f"operands on {E_A.device} and {E_B.device}")
    if out is not None:
        if tuple(out.shape) != (W, M, N):
            raise ValueError(f"out has shape {tuple(out.shape)}, need "
                             f"{(W, M, N)}")
        if out.device != E_A.device:
            raise ValueError(f"out on {out.device}, operands on "
                             f"{E_A.device}")
        if out.dtype != torch.promote_types(E_A.dtype, E_B.dtype):
            raise TypeError(f"out is {out.dtype}, operands give "
                            f"{torch.promote_types(E_A.dtype, E_B.dtype)}")
    return W, M, N, Z


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Rows of every worker's matrix contiguous (any worker stride)."""
    return t.shape[2] <= 1 or t.stride(2) == 1 and (
        t.shape[1] <= 1 or t.stride(1) == t.shape[2])


def tma_aligned(E_A: torch.Tensor, E_B: torch.Tensor) -> bool:
    """Whether TMA can address bf16 operands ``(W, M, Z)`` and ``(W, Z,
    N)`` with contiguous rows, so that they take the ``wgmma`` instance:
    every global stride and base 16-byte aligned — Z and N multiples of 8,
    each worker stride a positive multiple of 8 elements (any, when W ==
    1), both first elements on 16 bytes.  Other operands take the
    CUDA-core instance.  The C entry of the ``wgmma`` instance refuses
    what this refuses."""
    W, _, Z = E_A.shape
    N = E_B.shape[2]

    def ok(t: torch.Tensor) -> bool:
        stride = t.stride(0)
        return t.data_ptr() % 16 == 0 and (
            W == 1 or stride > 0 and stride % 8 == 0)

    return Z > 0 and Z % 8 == 0 and N % 8 == 0 and ok(E_A) and ok(E_B)


def coded_matmul(E_A: torch.Tensor, E_B: torch.Tensor,
                 out: torch.Tensor | None = None, *, accumulate: bool = False,
                 sign: int = 1) -> torch.Tensor:
    """``out[w] = (out[w] if accumulate else 0) + sign · E_A[w] @ E_B[w]``.

    ``(W, M, Z) @ (W, Z, N) -> (W, M, N)`` with a float32 accumulator, in
    the operands' dtype.  On the card the operands must be float32 or
    bfloat16 (the TPU kernel has no float64), of one dtype, with contiguous
    rows (any worker stride, so views of a larger stack need no copy).
    """
    W, M, N, Z = _check(E_A, E_B, out)
    if accumulate and out is None:
        raise ValueError("accumulate=True needs an out tensor")
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1; got {sign}")
    if E_A.device.type == "cpu":
        P = coded_matmul_ref(E_A, E_B)
        if sign < 0:
            P = -P
        if out is None:
            return P
        out.copy_(out + P if accumulate else P)
        return out
    refuse_autograd("coded_matmul", E_A, E_B)
    if E_A.dtype != E_B.dtype or E_A.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the coded_matmul kernel takes float32 or bfloat16 "
                        f"operands of one dtype; got {E_A.dtype} and "
                        f"{E_B.dtype}")
    if not (_rows_contiguous(E_A) and _rows_contiguous(E_B)):
        raise ValueError("coded_matmul operands need contiguous rows "
                         f"(strides {E_A.stride()} and {E_B.stride()})")
    if out is None:
        out = torch.empty((W, M, N), dtype=E_A.dtype, device=E_A.device)
    elif not _rows_contiguous(out):
        raise ValueError(f"coded_matmul out needs contiguous rows (strides "
                         f"{out.stride()})")
    if W > GRID_MAX or -(-M // TILE_ROWS) > GRID_MAX:
        raise ValueError(f"grid too large for W={W}, M={M}")
    if W == 0 or M == 0 or N == 0:
        return out
    entry = _KERNEL_DTYPES[E_A.dtype]
    simt = E_A.dtype == torch.bfloat16 and not tma_aligned(E_A, E_B)
    if simt:
        entry = "coded_matmul_bf16_simt"
    lib = load("coded_matmul")
    fn = getattr(lib, entry)
    with torch.cuda.device(E_A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(E_A.data_ptr(), E_B.data_ptr(), out.data_ptr(), W, M, N, Z,
                E_A.stride(0), E_B.stride(0), out.stride(0), sign,
                int(accumulate), stream)
    check(lib, rc, "coded_matmul")
    coded_matmul.launches += 1
    if E_A.dtype == torch.bfloat16:
        coded_matmul.bf16_launches += 1
        if simt:
            coded_matmul.bf16_simt_launches += 1
    return out


coded_matmul.launches = 0
coded_matmul.bf16_launches = 0
coded_matmul.bf16_simt_launches = 0


def worker_products(E_A: torch.Tensor, E_B: torch.Tensor) -> torch.Tensor:
    """All resident workers' products ``(W, M, N)``."""
    return coded_matmul(E_A, E_B)


def worker_products_complex(Ar, Ai, Br, Bi):
    """(re, im) products for complex evaluation points — 4 real GEMMs,
    accumulated in place into two outputs."""
    re = coded_matmul(Ar, Br)
    coded_matmul(Ai, Bi, re, accumulate=True, sign=-1)
    im = coded_matmul(Ar, Bi)
    coded_matmul(Ai, Br, im, accumulate=True)
    return re, im
