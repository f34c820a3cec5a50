"""Selective scan: the CUDA kernel and its wrapper.

Counterpart of the reference's ``kernels/ssm_scan/ops.py``, whose TPU
kernel is ``ssm_scan_pallas`` (``src/repro/kernels/ssm_scan/kernel.py``).
The kernel (``csrc/ssm_scan.cu``) gives each (batch, channel) two lanes
that hold its states in registers, steps through time software-pipelined
(the next step's operands and exps in flight while this step updates h),
stages 128-channel x 32-step chunks of x and dt by ``cp.async`` and writes
y back as coalesced rows.  It also returns the final state, which the TPU
kernel cannot: the prefill hands it to the decode recurrence.

At hymba-1.5b's prefill (4 x 8192 x 3200 x 16, bf16) the card's bound is
its 1.68e9 exps (0.401 ms on an H100); the grid's 400 warps' worth of
lanes on 528 schedulers and the four FP32 operations that go with each
exp keep the kernel above it.  Measured by ``chip_smoke.py`` on that card
(700 W) with 1, 2 or 4 lanes per channel: 1.38, 0.93 and 1.10 ms there
(the first port took 3.9 ms), and 1.56, 1.59 and 2.18 ms at
falcon-mamba-7b's 8192 channels; the kernel keeps 2.  The source note
gives the design.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises — there is no fallback.  :func:`ssm_scan` counts its
launches in ``ssm_scan.launches``.  The launch is bound to PyTorch as the
custom op ``repro_torch::ssm_scan``, whose fake registration gives the
outputs' shapes without running anything, so the dry run traces the
kernel path on fake tensors; it has no FLOP formula (the scan does no
matrix products, and the reference's dry run counts those alone).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from .._build import check, load, refuse_autograd
from .ref import ssm_scan_ref, ssm_step_ref

__all__ = ["ssm_scan", "ssm_step_ref"]

_KERNEL_DTYPES = {torch.float32: "ssm_scan_f32",
                  torch.bfloat16: "ssm_scan_bf16"}


def ssm_scan(x, dt, A, B, C, D, *, return_final: bool = False):
    """Mamba-1 selective scan, ``h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t B_t``,
    ``y_t = Σ_s h_t C_t + D x_t``, from ``h_0 = 0``.

    x/dt (Bt, L, Dm), A (Dm, S) float32, B/C (Bt, L, S), D (Dm,) float32 →
    y (Bt, L, Dm) in x's dtype; with ``return_final`` also the final state
    h (Bt, Dm, S) in float32.  On the card x, dt, B and C are float32 or
    bfloat16 of one dtype, with any batch and time strides and a contiguous
    last dim (B and C are column slices of the ``x_proj`` output and go in
    as they are).
    """
    if x.ndim != 3 or dt.shape != x.shape or A.ndim != 2 or B.ndim != 3 \
            or C.shape != B.shape or D.ndim != 1:
        raise ValueError(f"need x/dt (Bt, L, Dm), A (Dm, S), B/C (Bt, L, S),"
                         f" D (Dm,); got {tuple(x.shape)}, {tuple(dt.shape)},"
                         f" {tuple(A.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}, {tuple(D.shape)}")
    Bt, L, Dm = x.shape
    S = A.shape[1]
    if A.shape[0] != Dm or D.shape[0] != Dm or B.shape != (Bt, L, S):
        raise ValueError(f"x {tuple(x.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, D {tuple(D.shape)} disagree")
    if len({t.device for t in (x, dt, A, B, C, D)}) != 1:
        raise ValueError("ssm_scan operands on more than one device")
    if x.device.type == "cpu" and not is_fake(x):
        return ssm_scan_ref(x, dt, A, B, C, D, return_final=return_final)
    refuse_autograd("ssm_scan", x, dt, A, B, C, D)
    if not (x.dtype == dt.dtype == B.dtype == C.dtype) \
            or x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the ssm_scan kernel takes float32 or bfloat16 x, "
                        f"dt, B, C of one dtype; got {x.dtype}, {dt.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError(f"the ssm_scan kernel takes float32 A and D; got "
                        f"{A.dtype} and {D.dtype}")
    y, h = _scan_op(x, dt, A, B, C, D)
    return (y, h) if return_final else y


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=(),
                         device_types="cuda")
def _scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    Bt, L, Dm = x.shape
    S = A.shape[1]
    # the kernel reads along the contiguous last dims; anything else is
    # copied once here.  The state sizes and batches it takes are known to
    # its launcher alone, which raises through ``check``.
    x, dt, B, C = (t if t.stride(2) == 1 else t.contiguous()
                   for t in (x, dt, B, C))
    A, D = A.contiguous(), D.contiguous()
    y = torch.empty((Bt, L, Dm), dtype=x.dtype, device=x.device)
    h = torch.empty((Bt, Dm, S), dtype=torch.float32, device=x.device)
    if y.numel() or h.numel():
        lib = load("ssm_scan")
        fn = getattr(lib, _KERNEL_DTYPES[x.dtype])
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
                    Bt, L, Dm, S, x.stride(0), x.stride(1), dt.stride(0),
                    dt.stride(1), B.stride(0), B.stride(1), C.stride(0),
                    C.stride(1), stream)
        check(lib, rc, f"ssm_scan (Bt={Bt}, state size {S})")
        ssm_scan.launches += 1
    return y, h


@_scan_op.register_fake
def _(x, dt, A, B, C, D):
    Bt, L, Dm = x.shape
    return (x.new_empty((Bt, L, Dm)),
            x.new_empty((Bt, Dm, A.shape[1]), dtype=torch.float32))


ssm_scan.launches = 0
