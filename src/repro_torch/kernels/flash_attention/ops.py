"""Flash attention: the CUDA kernel and its wrapper.

Counterpart of the reference's ``kernels/flash_attention/ops.py``, whose
TPU kernel is ``flash_attention_pallas`` (``src/repro/kernels/
flash_attention/kernel.py``).  The source (``csrc/flash_attention.cu``)
holds two kernels: bf16 runs FlashAttention-2 on the tensor cores
(``mma.sync`` bf16 products fed by ``ldmatrix`` from a ``cp.async`` ring of
K/V tiles), float32 the first CUDA-core design, whose products keep full
float32 accuracy.  Both loop only over the keys the causal mask and the
window leave.  Its source note gives the bound on the card and the designs.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises — there is no fallback.  :func:`flash_attention`
counts its launches in ``flash_attention.launches``.  The launch is bound
to PyTorch as the custom op ``repro_torch::flash_attention``, whose fake
registration gives the output's shape without running anything and whose
FLOP formula is ``4·B·H·Lq·Lkv·d`` (the two products over every (query,
key) pair, as the reference's dry run counts its blockwise attention): the
dry run traces the kernel path on fake tensors of any device type.

The kernels are instantiated for the head dims that the source lists
(``FLASH_HEAD_DIMS``: 16, 32, 64, 128 and 256), which the library reports
(:func:`head_dims`); the reference's kernel takes any.  A head dim between
them (minicpm-smoke's 18, kimi-k2's 112) runs the next instance up on
operands zero-padded along the head dim, with the true dim's scale
(:func:`run_padded`): the zero columns add nothing to q·k, and the output
columns they give are dropped.  A head dim above the largest raises
``ValueError``.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from .._build import check, load, refuse_autograd
from .ref import attention_ref

__all__ = ["flash_attention", "head_dims", "instance_dim", "run_padded"]

_KERNEL_DTYPES = {torch.float32: "flash_attention_f32",
                  torch.bfloat16: "flash_attention_bf16"}


def _strides(t: torch.Tensor) -> list[int]:
    """(batch, head, position) strides in elements; 0 for a dim of size 1,
    whose stride the kernel never uses."""
    return [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3])]


def _rows_16b(t: torch.Tensor) -> bool:
    """Every row starts on 16 bytes (8 bf16): what the bf16 kernel's
    ``cp.async`` copies need."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in _strides(t))


def head_dims() -> tuple[int, ...]:
    """The head dims the kernels are instantiated for, ascending, as the
    built library reports them (builds it on first use)."""
    lib = load("flash_attention")
    buf = (ctypes.c_int * 64)()
    n = lib.flash_attention_head_dims(buf, len(buf))
    return tuple(buf[:min(n, len(buf))])


def instance_dim(d: int, dims) -> int:
    """The smallest head dim of ``dims`` (ascending) that is >= ``d``."""
    for D in dims:
        if d <= D:
            return D
    raise ValueError(f"flash_attention: head dim {d} is above "
                     f"{dims[-1]}, the largest the kernel is built for")


def run_padded(kernel, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               dims, **kw) -> torch.Tensor:
    """``kernel(q, k, v, scale=1/sqrt(d), **kw)`` at the instance's head
    dim: q, k and v zero-padded along their last dim d to
    ``instance_dim(d, dims)`` (fresh contiguous tensors), the output's
    first d columns returned.  At a built head dim the operands go in as
    they are."""
    d = q.shape[-1]
    D = instance_dim(d, dims)
    if D != d:
        q, k, v = (_zero_pad(t, D) for t in (q, k, v))
    out = kernel(q, k, v, scale=1.0 / d ** 0.5, **kw)
    return out if D == d else out[..., :d]


def _zero_pad(t: torch.Tensor, D: int) -> torch.Tensor:
    out = t.new_zeros(t.shape[:-1] + (D,))
    out[..., :t.shape[-1]] = t
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax GQA attention.  q (B, H, Lq, d); k, v (B, Hkv, Lkv, d)
    → (B, H, Lq, d) in q's dtype.

    Query i sits at absolute position ``q_offset + i``; ``window`` > 0
    keeps keys with ``qpos - kpos < window`` (``None`` or 0: no window).
    On the card q, k and v may be any strided views whose last dim is
    contiguous (the model's ``(B, L, H, d)`` → ``(B, H, L, d)`` views go in
    as they are); the output takes q's layout.  In bf16 each row must also
    start on 16 bytes (pointer 16-byte aligned, strides multiples of 8
    elements); an operand whose rows do not is copied once.  A head dim
    without an instance is padded (:func:`run_padded`), and the output is
    then a view of the padded one's first d columns.
    """
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, H, Lq, d) and k, v (B, Hkv, Lkv, d); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Lq, d = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    window = int(window or 0)
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be "
                         ">= 0")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu" and not is_fake(q):
        return attention_ref(q, k, v, causal=causal, window=window or None,
                             q_offset=q_offset)
    refuse_autograd("flash_attention", q, k, v)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the flash_attention kernel takes float32 or "
                        f"bfloat16 q, k, v of one dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    return _flash_op(q, k, v, bool(causal), window, int(q_offset))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, q_offset: int) -> torch.Tensor:
    out = run_padded(_launch, q, k, v, head_dims(), causal=causal,
                     window=window, q_offset=q_offset)
    # an op's output may not be a view: a padded run's first d columns
    # are copied out
    return out if out._base is None else out.clone()


@_flash_op.register_fake
def _(q, k, v, causal, window, q_offset):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    B, H, Lq, d = q_shape
    return 4 * B * H * Lq * k_shape[2] * d


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            scale: float, causal: bool, window: int,
            q_offset: int) -> torch.Tensor:
    """One launch of the dtype's kernel at a built head dim."""
    B, H, Lq, d = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    # the query groups and grid sizes the kernel takes are known to its
    # launcher alone, which raises through ``check``
    # the kernels read rows along the contiguous last dim, the bf16 one
    # with 16-byte copies; any other layout is copied once here
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        q, k, v = (t if _rows_16b(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    out = torch.empty_like(q)            # q's layout, last dim contiguous
    if out.numel() == 0:
        return out
    lib = load("flash_attention")
    fn = getattr(lib, _KERNEL_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, Hkv, Lq, Lkv, d, int(bool(causal)), window, q_offset,
                scale, *_strides(q), *_strides(k), *_strides(v),
                *_strides(out), stream)
    check(lib, rc, f"flash_attention (B={B}, H={H}, Hkv={Hkv}, head dim "
                   f"{d})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
