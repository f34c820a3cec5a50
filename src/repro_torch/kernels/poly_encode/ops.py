"""Polynomial encode: the CUDA kernel and its wrapper.

Counterpart of the reference's ``kernels/poly_encode/ops.py``, whose TPU
kernel is ``poly_encode_pallas`` (``src/repro/kernels/poly_encode/
kernel.py``).  The kernel (``csrc/poly_encode.cu``) reads each X element
once and writes every worker's output from it; its source note gives the
bound on the card and the design.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises — there is no fallback.  :func:`poly_encode` counts
its launches in ``poly_encode.launches``.
"""
from __future__ import annotations

import torch

from .._build import check, load, refuse_autograd
from .ref import poly_encode_ref

__all__ = ["poly_encode"]

_KERNEL_DTYPES = {torch.float32: "poly_encode_f32",
                  torch.bfloat16: "poly_encode_bf16"}
_MAX_K = 64                       # largest register tile the kernel has
_MAX_G_BYTES = 48 * 1024          # G lives in (default-size) shared memory


def poly_encode(G: torch.Tensor, X: torch.Tensor, *,
                parts: int = 1) -> torch.Tensor:
    """Encode K blocks into W worker operands: ``E[w] = Σ_k G[w,k] X[k]``.

    ``G: (parts·W, K)`` float32; ``X: (K, R, C)`` or, with a request-batch
    axis, ``(Bt, K, R, C)``, any strides (the ``split_contraction`` views
    go in as they are).  Returns ``([Bt,] W, R, C)`` in X's dtype, or with
    ``parts`` > 1 (``G = [G.real; G.imag]`` for complex points, one launch)
    ``(parts, [Bt,] W, R, C)`` with every part contiguous.
    """
    if G.ndim != 2 or X.ndim not in (3, 4):
        raise ValueError(f"need G (W, K) and X ([Bt,] K, R, C); got "
                         f"{tuple(G.shape)} and {tuple(X.shape)}")
    rows, K = G.shape
    if X.shape[-3] != K:
        raise ValueError(f"generator K={K} vs blocks K={X.shape[-3]}")
    if parts < 1 or rows % parts:
        raise ValueError(f"{rows} generator rows do not split into {parts} "
                         "parts")
    if G.device != X.device:
        raise ValueError(f"G on {G.device}, X on {X.device}")
    if X.device.type == "cpu":
        return poly_encode_ref(G, X, parts=parts)
    refuse_autograd("poly_encode", G, X)
    if G.dtype != torch.float32 or not G.is_contiguous():
        raise TypeError(f"the poly_encode kernel takes a contiguous float32 "
                        f"G; got {G.dtype}, strides {G.stride()}")
    if X.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the poly_encode kernel takes float32 or bfloat16 "
                        f"X; got {X.dtype}")
    if K > _MAX_K or rows * K * 4 > _MAX_G_BYTES:
        raise ValueError(f"G {tuple(G.shape)} exceeds the kernel's limits "
                         f"(K <= {_MAX_K}, {_MAX_G_BYTES} bytes)")
    X4 = X if X.ndim == 4 else X.unsqueeze(0)
    Bt, _, R, C = X4.shape
    if Bt > 65535:
        raise ValueError(f"request batch {Bt} exceeds the grid")
    W = rows // parts
    out = torch.empty((parts, Bt, W, R, C), dtype=X.dtype, device=X.device)
    if out.numel():
        lib = load("poly_encode")
        fn = getattr(lib, _KERNEL_DTYPES[X.dtype])
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(G.data_ptr(), X4.data_ptr(), out.data_ptr(), rows, W, K,
                    R, C, Bt, *X4.stride(), stream)
        check(lib, rc, "poly_encode")
        poly_encode.launches += 1
    if X.ndim == 3:
        out = out[:, 0]
    return out[0] if parts == 1 else out


poly_encode.launches = 0
