"""Flash attention: the CUDA kernel and its wrapper.

Counterpart of the reference's ``kernels/flash_attention/ops.py``, whose
TPU kernel is ``flash_attention_pallas`` (``src/repro/kernels/
flash_attention/kernel.py``).  The source (``csrc/flash_attention.cu``)
holds two forward kernels: bf16 runs FlashAttention-3's shape on Hopper's
warpgroup products (``wgmma``, fed by TMA loads of Q, K and V tiles through
an ``mbarrier`` ring, a producer warpgroup beside two consumer
warpgroups), float32 the first CUDA-core design, whose products keep full
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

Under autograd on the card the forward also writes each row's float32
log-sum-exp, and the backward is the kernels' own
(:func:`flash_attention_bwd`, the custom op
``repro_torch::flash_attention_bwd``): the row dots ``D = rowsum(dO∘O)``,
then dK and dV per KV block and dQ per query block, recomputing P from
the LSE (FlashAttention-2's backward; in bf16 on Hopper's warpgroup
products, ``wgmma``; the source note gives the design).
Its FLOP formula is ``10·d`` per unmasked (query, key) pair at the true
head dim.  The serving path asks for no LSE, so its launches are as
before.  :func:`flash_attention_bwd` counts its launches in
``flash_attention_bwd.launches``.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from .._build import check, load
from .ref import attention_ref, flash_attention_bwd_ref, \
    flash_attention_lse_ref

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "head_dims", "instance_dim", "run_padded", "tma_aligned",
           "unmasked_pairs"]

_KERNEL_DTYPES = {torch.float32: "flash_attention_f32",
                  torch.bfloat16: "flash_attention_bf16"}
_BWD_DTYPES = {torch.float32: "flash_attention_bwd_f32",
               torch.bfloat16: "flash_attention_bwd_bf16"}


def _strides(t: torch.Tensor) -> list[int]:
    """(batch, head, position) strides in elements; 0 for a dim of size 1,
    whose stride the kernel never uses."""
    return [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3])]


def tma_aligned(t: torch.Tensor) -> bool:
    """Whether the bf16 kernels read the (B, heads, L, d) operand ``t`` as
    it lies: last dim contiguous, first element on 16 bytes, and every
    batch, head and position stride a multiple of 8 elements (16 bytes) —
    what the forward's TMA tensor maps and the backward's ``cp.async``
    copies address.  The wrapper copies an operand that fails it once; the
    C entries refuse what this refuses."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st in _strides(t))


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
               dims, *extra, **kw):
    """``kernel(q, k, v, *extra, scale=1/sqrt(d), **kw)`` at the
    instance's head dim: q, k, v and the 4-D tensors of ``extra`` (the
    backward's o and dO; not the 3-D LSE) zero-padded along their last dim
    d to ``instance_dim(d, dims)`` (fresh contiguous tensors), and the
    first d columns of each 4-D output returned (the kernel returns a
    tensor or a tuple).  At a built head dim the operands go in as they
    are."""
    d = q.shape[-1]
    D = instance_dim(d, dims)
    if D != d:
        q, k, v = (_zero_pad(t, D) for t in (q, k, v))
        extra = tuple(_zero_pad(t, D) if t.ndim == 4 else t for t in extra)
    out = kernel(q, k, v, *extra, scale=1.0 / d ** 0.5, **kw)
    if D == d:
        return out
    if isinstance(out, tuple):
        return tuple(t[..., :d] if t.ndim == 4 else t for t in out)
    return out[..., :d]


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
    as they are); the output takes q's layout.  In bf16 an operand must
    also pass :func:`tma_aligned`; one that does not is copied once.  A
    head dim without an instance is padded (:func:`run_padded`), and the
    output is then a view of the padded one's first d columns.
    """
    window = int(window or 0)
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu" and not is_fake(q):
        return attention_ref(q, k, v, causal=causal, window=window or None,
                             q_offset=q_offset)
    _kernel_dtypes(q, k, v)
    args = (bool(causal), window, int(q_offset))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashFn.apply(q, k, v, *args)
    return _flash_op(q, k, v, *args, False)[0]


def _check(q, k, v, window: int, q_offset: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, H, Lq, d) and k, v (B, Hkv, Lkv, d); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, d = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be "
                         ">= 0")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def _kernel_dtypes(q, k, v) -> None:
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the flash_attention kernel takes float32 or "
                        f"bfloat16 q, k, v of one dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0):
    """:func:`flash_attention`'s output and the float32 log-sum-exp of each
    row (B, H, Lq), what its backward reads; no autograd.  A CPU tensor
    takes :func:`~.ref.flash_attention_lse_ref`."""
    window = int(window or 0)
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu" and not is_fake(q):
        return flash_attention_lse_ref(q, k, v, causal=causal,
                                       window=window or None,
                                       q_offset=q_offset)
    _kernel_dtypes(q, k, v)
    return _flash_op(q, k, v, bool(causal), window, int(q_offset), True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` for the
    output gradient ``do``, from the forward's output ``o`` and log-sum-exp
    ``lse`` (:func:`flash_attention_fwd`), in the operands' dtype: the
    backward kernels on the card, :func:`~.ref.flash_attention_bwd_ref` on
    a CPU tensor.  dK and dV sum over each KV head's query group."""
    window = int(window or 0)
    _check(q, k, v, window, q_offset)
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != q.shape[:3]:
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} must be "
                         f"q's shape {tuple(q.shape)} and lse "
                         f"{tuple(lse.shape)} its first three dims")
    if q.device.type == "cpu" and not is_fake(q):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window or None,
                                       q_offset=q_offset)
    _kernel_dtypes(q, k, v)
    if o.dtype != q.dtype or do.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"the flash_attention backward takes o and do in "
                        f"q's dtype {q.dtype} and a float32 lse; got "
                        f"{o.dtype}, {do.dtype}, {lse.dtype}")
    return _flash_bwd_op(q, k, v, o, lse, do, bool(causal), window,
                         int(q_offset))


class _FlashFn(torch.autograd.Function):
    """The kernel under autograd: the forward saves q, k, v, its output and
    its LSE; the backward runs the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = _flash_op(q, k, v, causal, window, q_offset, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_op(q, k, v, o, lse, do.to(q.dtype),
                                   *ctx.args)
        return dq, dk, dv, None, None, None


def unmasked_pairs(Lq: int, Lkv: int, causal: bool, window: int,
                   q_offset: int) -> int:
    """The (query, key) pairs the masks leave (query i at ``q_offset +
    i``, keys 0 … Lkv − 1; ``window`` 0: none), from the shapes."""
    total = 0
    for i in range(Lq):
        pos = q_offset + i
        hi = min(Lkv - 1, pos) if causal else Lkv - 1
        lo = max(0, pos - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, q_offset: int, with_lse: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    out, lse = run_padded(_launch, q, k, v, head_dims(), causal=causal,
                          window=window, q_offset=q_offset,
                          with_lse=with_lse)
    # an op's output may not be a view: a padded run's first d columns
    # are copied out
    return (out if out._base is None else out.clone()), lse


@_flash_op.register_fake
def _(q, k, v, causal, window, q_offset, with_lse):
    B, H, Lq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, Lq) if with_lse else (0,),
                        dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    B, H, Lq, d = q_shape
    return 4 * B * H * Lq * k_shape[2] * d


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool, window: int, q_offset: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    grads = run_padded(_launch_bwd, q, k, v, head_dims(), o, lse, do,
                       causal=causal, window=window, q_offset=q_offset)
    return tuple(t if t._base is None else t.clone() for t in grads)


@_flash_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, window, q_offset):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q_shape, k_shape, *args, **kwargs) -> int:
    """10·d per unmasked pair: S = QKᵀ and dP = dO Vᵀ recomputed, dV, dQ
    and dK (2·d each), against the forward's 4·d."""
    causal, window, q_offset = args[4:7]
    B, H, Lq, d = q_shape
    return 10 * B * H * d * unmasked_pairs(Lq, k_shape[2], causal, window,
                                           q_offset)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            scale: float, causal: bool, window: int, q_offset: int,
            with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the dtype's kernel at a built head dim; the LSE
    (B, H, Lq) float32 when asked, else an empty tensor."""
    B, H, Lq, d = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    # the query groups and grid sizes the kernel takes are known to its
    # launcher alone, which raises through ``check``
    q, k, v = _rows(q, k, v)
    out = torch.empty_like(q)            # q's layout, last dim contiguous
    lse = q.new_empty((B, H, Lq) if with_lse else (0,), dtype=torch.float32)
    if out.numel() == 0:
        return out, lse
    lib = load("flash_attention")
    fn = getattr(lib, _KERNEL_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None,
                B, H, Hkv, Lq, Lkv, d, int(bool(causal)), window, q_offset,
                scale, *_strides(q), *_strides(k), *_strides(v),
                *_strides(out), stream)
    check(lib, rc, f"flash_attention (B={B}, H={H}, Hkv={Hkv}, head dim "
                   f"{d})")
    flash_attention.launches += 1
    return out, lse


def _rows(*ts):
    """The operands as the kernels read them: rows along a contiguous last
    dim, in bf16 as :func:`tma_aligned` asks; any other layout is copied
    once here."""
    if ts[0].dtype == torch.bfloat16:
        return tuple(t if tma_aligned(t) else
                     t.clone(memory_format=torch.contiguous_format)
                     for t in ts)
    return tuple(t if t.stride(3) == 1 else t.contiguous() for t in ts)


def _launch_bwd(q, k, v, o, lse, do, *, scale: float, causal: bool,
                window: int, q_offset: int):
    """One backward at a built head dim: the row dots, the dK/dV kernel and
    the dQ kernel, one call of the C entry; contiguous (dq, dk, dv)."""
    B, H, Lq, d = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    q, k, v, o, do = _rows(q, k, v, o, do)
    lse = lse.contiguous()
    dq, dk, dv = q.new_empty(q.shape), k.new_empty(k.shape), \
        v.new_empty(v.shape)
    if dq.numel() == 0 and dk.numel() == 0:
        return dq, dk, dv
    rowdot = q.new_empty((B, H, Lq), dtype=torch.float32)
    lib = load("flash_attention")
    fn = getattr(lib, _BWD_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), rowdot.data_ptr(), B, H, Hkv, Lq, Lkv, d,
                int(bool(causal)), window, q_offset, scale, *_strides(q),
                *_strides(k), *_strides(v), *_strides(o), *_strides(do),
                stream)
    check(lib, rc, f"flash_attention backward (B={B}, H={H}, Hkv={Hkv}, "
                   f"head dim {d})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
