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

Under autograd on the card the forward also writes the state before
every 256th step (:data:`~.ref.CHUNK`, the reference's chunk of
rematerialization; (Bt, ⌈L/256⌉, Dm, S) float32), and the backward is the
kernel's own (:func:`ssm_scan_bwd`, the custom op
``repro_torch::ssm_scan_bwd``): each chunk's states recomputed from its
checkpoint, the adjoint run back in time, and the sums over channels and
batch rows (dB, dC, dA, dD) reduced deterministically in a second pass.
No gradient flows through the final state: asking for one raises.
:func:`ssm_scan_bwd` counts its launches in ``ssm_scan_bwd.launches``;
its operations are its exps (two a (t, channel, state) in the recompute
and one in the adjoint), so it too has no FLOP formula.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from .._build import check, load
from .ref import (CHUNK, ssm_scan_bwd_ref, ssm_scan_fwd_ref, ssm_scan_ref,
                  ssm_step_ref)

__all__ = ["ssm_scan", "ssm_scan_fwd", "ssm_scan_bwd", "ssm_step_ref"]

_KERNEL_DTYPES = {torch.float32: "ssm_scan_f32",
                  torch.bfloat16: "ssm_scan_bf16"}
_BWD_DTYPES = {torch.float32: "ssm_scan_bwd_f32",
               torch.bfloat16: "ssm_scan_bwd_bf16"}


def ssm_scan(x, dt, A, B, C, D, *, return_final: bool = False):
    """Mamba-1 selective scan, ``h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t B_t``,
    ``y_t = Σ_s h_t C_t + D x_t``, from ``h_0 = 0``.

    x/dt (Bt, L, Dm), A (Dm, S) float32, B/C (Bt, L, S), D (Dm,) float32 →
    y (Bt, L, Dm) in x's dtype; with ``return_final`` also the final state
    h (Bt, Dm, S) in float32.  On the card x, dt, B and C are float32 or
    bfloat16 of one dtype, with any batch and time strides and a contiguous
    last dim (B and C are column slices of the ``x_proj`` output and go in
    as they are).  Under autograd the backward is the kernel's own (module
    note); the final state then carries no gradient.
    """
    _check(x, dt, A, B, C, D)
    if x.device.type == "cpu" and not is_fake(x):
        return ssm_scan_ref(x, dt, A, B, C, D, return_final=return_final)
    _kernel_dtypes(x, dt, A, B, C, D)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C, D)):
        y, h = _ScanFn.apply(x, dt, A, B, C, D)
    else:
        y, h, _ = _scan_op(x, dt, A, B, C, D, False)
    return (y, h) if return_final else y


def _check(x, dt, A, B, C, D) -> None:
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


def _kernel_dtypes(x, dt, A, B, C, D) -> None:
    if not (x.dtype == dt.dtype == B.dtype == C.dtype) \
            or x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the ssm_scan kernel takes float32 or bfloat16 x, "
                        f"dt, B, C of one dtype; got {x.dtype}, {dt.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError(f"the ssm_scan kernel takes float32 A and D; got "
                        f"{A.dtype} and {D.dtype}")


def ssm_scan_fwd(x, dt, A, B, C, D):
    """``(y, h_final, checkpoints)``: :func:`ssm_scan`'s outputs and the
    state before every 256th step, (Bt, ⌈L/256⌉, Dm, S) float32, what its
    backward reads; no autograd.  A CPU tensor takes
    :func:`~.ref.ssm_scan_fwd_ref`."""
    _check(x, dt, A, B, C, D)
    if x.device.type == "cpu" and not is_fake(x):
        return ssm_scan_fwd_ref(x, dt, A, B, C, D)
    _kernel_dtypes(x, dt, A, B, C, D)
    return _scan_op(x, dt, A, B, C, D, True)


def ssm_scan_bwd(x, dt, A, B, C, D, dy, checkpoints):
    """The gradients ``(dx, ddt, dA, dB, dC, dD)`` of :func:`ssm_scan`'s y
    for the output gradient ``dy``, from the forward's ``checkpoints``
    (:func:`ssm_scan_fwd`), each in its operand's dtype (dB and dC
    contiguous): the backward kernel on the card,
    :func:`~.ref.ssm_scan_bwd_ref` on a CPU tensor."""
    _check(x, dt, A, B, C, D)
    Bt, L, Dm = x.shape
    S = A.shape[1]
    if dy.shape != x.shape or checkpoints.shape != (Bt, -(-L // CHUNK), Dm,
                                                    S):
        raise ValueError(f"dy {tuple(dy.shape)} must be x's shape and the "
                         f"checkpoints {tuple(checkpoints.shape)} "
                         f"(Bt, ceil(L / {CHUNK}), Dm, S)")
    if x.device.type == "cpu" and not is_fake(x):
        return ssm_scan_bwd_ref(x, dt, A, B, C, D, dy, checkpoints)
    _kernel_dtypes(x, dt, A, B, C, D)
    if dy.dtype != x.dtype or checkpoints.dtype != torch.float32:
        raise TypeError(f"the ssm_scan backward takes dy in x's dtype "
                        f"{x.dtype} and float32 checkpoints; got {dy.dtype},"
                        f" {checkpoints.dtype}")
    return _scan_bwd_op(x, dt, A, B, C, D, dy, checkpoints)


class _ScanFn(torch.autograd.Function):
    """The kernel under autograd: the forward saves its operands and its
    checkpoints; the backward runs the backward kernel.  A gradient for
    the final state raises."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        y, h, ckpt = _scan_op(x, dt, A, B, C, D, True)
        ctx.save_for_backward(x, dt, A, B, C, D, ckpt)
        # a gradient that reaches h arrives as a tensor, an unused h's as
        # None: the backward raises on the first
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        if dh is not None:
            raise RuntimeError("ssm_scan: the backward kernel takes no "
                               "gradient of the final state")
        x, dt, A, B, C, D, ckpt = ctx.saved_tensors
        if dy is None:
            return (None,) * 6
        return _scan_bwd_op(x, dt, A, B, C, D, dy.to(x.dtype), ckpt)


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=(),
                         device_types="cuda")
def _scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             with_ckpt: bool
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
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
    ckpt = torch.empty((Bt, -(-L // CHUNK), Dm, S) if with_ckpt else (0,),
                       dtype=torch.float32, device=x.device)
    if y.numel() or h.numel():
        lib = load("ssm_scan")
        fn = getattr(lib, _KERNEL_DTYPES[x.dtype])
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
                    ckpt.data_ptr() if with_ckpt else None,
                    Bt, L, Dm, S, x.stride(0), x.stride(1), dt.stride(0),
                    dt.stride(1), B.stride(0), B.stride(1), C.stride(0),
                    C.stride(1), stream)
        check(lib, rc, f"ssm_scan (Bt={Bt}, state size {S})")
        ssm_scan.launches += 1
    return y, h, ckpt


@_scan_op.register_fake
def _(x, dt, A, B, C, D, with_ckpt):
    Bt, L, Dm = x.shape
    S = A.shape[1]
    return (x.new_empty((Bt, L, Dm)),
            x.new_empty((Bt, Dm, S), dtype=torch.float32),
            x.new_empty((Bt, -(-L // CHUNK), Dm, S) if with_ckpt else (0,),
                        dtype=torch.float32))


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=(),
                         device_types="cuda")
def _scan_bwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 dy: torch.Tensor, ckpt: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor, torch.Tensor]:
    Bt, L, Dm = x.shape
    S = A.shape[1]
    x, dt, B, C = (t if t.stride(2) == 1 else t.contiguous()
                   for t in (x, dt, B, C))
    A, D, dy, ckpt = (t.contiguous() for t in (A, D, dy, ckpt))
    dev = x.device
    dx = torch.empty((Bt, L, Dm), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bt, L, Dm), dtype=dt.dtype, device=dev)
    dB = torch.empty((Bt, L, S), dtype=B.dtype, device=dev)
    dC = torch.empty((Bt, L, S), dtype=C.dtype, device=dev)
    dA = torch.empty((Dm, S), dtype=torch.float32, device=dev)
    dD = torch.empty((Dm,), dtype=torch.float32, device=dev)
    if dx.numel() == 0:
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_(), dD.zero_()
    lib = load("ssm_scan")
    # per-block partial sums the second pass reduces (dB and dC per batch
    # row, channel block, step and state; dA and dD per batch row) and each
    # block's states at its sub-chunk starts
    sizes = (ctypes.c_longlong * 2)()
    check(lib, lib.ssm_scan_bwd_scratch(Bt, L, Dm, S, sizes),
          f"ssm_scan backward (state size {S})")
    scratch = torch.empty((sizes[0],), dtype=torch.float32, device=dev)
    fn = getattr(lib, _BWD_DTYPES[x.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), dy.data_ptr(), ckpt.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                dC.data_ptr(), dD.data_ptr(), scratch.data_ptr(), Bt, L, Dm,
                S, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
                B.stride(0), B.stride(1), C.stride(0), C.stride(1), stream)
    check(lib, rc, f"ssm_scan backward (Bt={Bt}, state size {S})")
    ssm_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dD


@_scan_bwd_op.register_fake
def _(x, dt, A, B, C, D, dy, ckpt):
    Bt, L, Dm = x.shape
    S = A.shape[1]
    return (x.new_empty((Bt, L, Dm)), dt.new_empty((Bt, L, Dm)),
            A.new_empty((Dm, S), dtype=torch.float32),
            B.new_empty((Bt, L, S)), C.new_empty((Bt, L, S)),
            D.new_empty((Dm,), dtype=torch.float32))


ssm_scan.launches = 0
ssm_scan_bwd.launches = 0
