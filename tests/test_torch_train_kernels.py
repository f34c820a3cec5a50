"""Training through the kernels: the plain backward of flash attention and
of the selective scan against the reference's gradients, and the train
step's trace through the backward custom ops.

The reference trains attention through ``blockwise_attention`` and the
scan through its chunked ``ssm_scan_ref``, both differentiated by
``jax.grad``; the port's backward kernels are held on the card to the
plain backward here (``flash_attention_bwd_ref``, ``ssm_scan_bwd_ref``),
which these tests hold to ``jax.grad`` of the reference on the CPU.
Inputs are drawn with numpy from a seed and handed to both packages.

Tolerances: relative Frobenius error 1e-5 for float32 (the same formulas
in float32 on both sides, summed in other orders) and the reference's
``_tol`` for bfloat16, 5e-2 (the reference's gradient rounds its
intermediates to bf16 where the plain backward keeps float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import ssm_scan_ref as ref_ssm_scan
from repro.models.attention import blockwise_attention
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention.ops import (flash_attention_bwd,
                                                     flash_attention_fwd,
                                                     unmasked_pairs)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_lse_ref)
from repro_torch.kernels.ssm_scan.ops import ssm_scan_bwd, ssm_scan_fwd
from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_ref,
                                              ssm_scan_fwd_ref, ssm_scan_ref)

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _pair(arr: np.ndarray, dtype: str):
    """The same values in jax and torch (bf16 rounded once, by jax)."""
    j = jnp.asarray(arr, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TDT[dtype])


# ------------------------------------------------------- flash attention

# (B, H, Hkv, Lq, Lkv, d, causal, window, q_offset): the reference's flash
# sweep (its decode-suffix rows at q_offset = Lkv - Lq), then GQA groups of
# 5 and 8, windows, a query chunk's q_offset, lengths off the blocks of 16,
# non-causal, and a window that leaves the last rows no key
FLASH_CASES = [
    (1, 2, 2, 64, 64, 16, True, 0, 0),
    (2, 4, 2, 64, 64, 32, True, 0, 0),
    (1, 8, 1, 32, 32, 16, True, 0, 0),
    (1, 2, 1, 16, 80, 16, True, 0, 64),
    (1, 2, 2, 50, 70, 16, True, 0, 20),
    (1, 10, 2, 45, 45, 16, True, 8, 0),
    (2, 8, 1, 37, 37, 32, True, 16, 0),
    (1, 4, 2, 24, 72, 16, True, 12, 48),
    (1, 5, 5, 33, 33, 18, False, 0, 0),
    (1, 4, 2, 40, 20, 16, True, 6, 0),
]


def _flash_inputs(case, dtype, seed=0):
    B, H, Hkv, Lq, Lkv, d = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Lq, d), (B, Hkv, Lkv, d), (B, Hkv, Lkv, d),
                      (B, H, Lq, d))]
    return [_pair(a, dtype) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_ref_matches_jax_grad_of_blockwise_attention(case, dtype):
    causal, window, q_offset = case[6:]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _flash_inputs(case, dtype)

    def f(q, k, v):
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, bq=16, bkv=16)

    _, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jdo)
    o, lse = flash_attention_lse_ref(tq, tk, tv, causal=causal,
                                     window=window or None,
                                     q_offset=q_offset)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                                  window=window, q_offset=q_offset)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TDT[dtype] and g.shape == tuple(w.shape)
        err = _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert err <= TOL[dtype], (name, err)


@pytest.mark.parametrize("case", FLASH_CASES[:-1])
def test_flash_bwd_ref_matches_autograd_of_attention_ref(case):
    """The explicit formulas against torch autograd of the materialized
    forward (float32; the last case is left out: autograd of
    ``attention_ref`` gives NaN on a row with no key)."""
    causal, window, q_offset = case[6:]
    (_, tq), (_, tk), (_, tv), (_, tdo) = _flash_inputs(case, "float32", 1)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = attention_ref(*leaves, causal=causal, window=window or None,
                        q_offset=q_offset)
    want = torch.autograd.grad(out, leaves, tdo)
    o, lse = flash_attention_fwd(tq, tk, tv, causal=causal, window=window,
                                 q_offset=q_offset)
    got = flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                              window=window, q_offset=q_offset)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g.numpy(), w.numpy()) <= TOL["float32"], name


def test_flash_lse_and_empty_rows():
    """The LSE is the row's log-sum-exp, finite (0) on a row with no key,
    and such a row's gradients are zero."""
    case = FLASH_CASES[-1]
    causal, window, q_offset = case[6:]
    (_, q), (_, k), (_, v), (_, do) = _flash_inputs(case, "float32", 2)
    o, lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    assert torch.isfinite(lse).all()
    Lq, Lkv = q.shape[2], k.shape[2]
    empty = [i for i in range(Lq) if i - window + 1 > Lkv - 1]
    assert empty and (lse[..., empty] == 0).all()
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(2, dim=1)) / q.shape[-1] ** 0.5
    i = empty[0] - 1
    lo = i - window + 1
    want = torch.logsumexp(s[..., i, lo:], dim=-1)
    torch.testing.assert_close(lse[..., i], want, rtol=1e-6, atol=1e-6)
    dq, _, _ = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, q_offset=q_offset)
    assert (dq[..., empty, :] == 0).all()


def test_unmasked_pairs_counts_the_masks():
    for Lq, Lkv, causal, window, off in [(64, 64, True, 0, 0),
                                         (50, 70, True, 0, 20),
                                         (40, 20, True, 6, 0),
                                         (33, 33, False, 0, 0),
                                         (24, 72, True, 12, 48)]:
        qpos = off + np.arange(Lq)[:, None]
        kpos = np.arange(Lkv)[None, :]
        mask = np.ones((Lq, Lkv), bool)
        if causal:
            mask &= qpos >= kpos
        if window:
            mask &= qpos - kpos < window
        assert unmasked_pairs(Lq, Lkv, causal, window, off) == mask.sum()


# ------------------------------------------------------------ the scan

# (Bt, L, Dm, S): the reference's scan sweep, then L a multiple of the
# 256-step chunk and L off it across two chunks
SCAN_CASES = [(1, 32, 16, 4), (2, 48, 24, 16), (2, 100, 40, 8),
              (1, 512, 12, 4), (2, 300, 10, 8)]


def _scan_inputs(Bt, L, Dm, S, dtype, seed=0):
    """x, dt, A, B, C, D, dy as (jax, torch) pairs; B and C are column
    views of one ``x_proj``-like (Bt, L, r + 2S) output on the torch side,
    as the model hands them to the scan."""
    rng = np.random.default_rng(seed)
    r = 3
    x = rng.standard_normal((Bt, L, Dm)).astype(np.float32)
    dt = np.exp(rng.normal(-2.5, 0.5, (Bt, L, Dm))).astype(np.float32)
    A = -np.exp(rng.standard_normal((Dm, S))).astype(np.float32)
    xp = rng.standard_normal((Bt, L, r + 2 * S)).astype(np.float32)
    D = rng.standard_normal(Dm).astype(np.float32)
    dy = rng.standard_normal((Bt, L, Dm)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jdt, tdt = _pair(dt, dtype)
    jxp, txp = _pair(xp, dtype)
    jdy, tdy = _pair(dy, dtype)
    return {"x": (jx, tx), "dt": (jdt, tdt),
            "A": (jnp.asarray(A), torch.from_numpy(A)),
            "B": (jxp[..., r:r + S], txp[..., r:r + S]),
            "C": (jxp[..., r + S:], txp[..., r + S:]),
            "D": (jnp.asarray(D), torch.from_numpy(D)), "dy": (jdy, tdy)}


@pytest.mark.parametrize("shape,dtype",
                         [(s, "float32") for s in SCAN_CASES] +
                         [(s, "bfloat16") for s in SCAN_CASES[:3]])
def test_ssm_scan_bwd_ref_matches_jax_grad_of_the_reference_scan(shape,
                                                                 dtype):
    ins = _scan_inputs(*shape, dtype)
    names = ("x", "dt", "A", "B", "C", "D")
    _, vjp = jax.vjp(lambda *a: ref_ssm_scan(*a), *(ins[n][0]
                                                    for n in names))
    want = vjp(ins["dy"][0])
    t = [ins[n][1] for n in names]
    assert not t[3].is_contiguous()             # a column view
    y, h, ckpt = ssm_scan_fwd_ref(*t)
    assert ckpt.shape == (shape[0], -(-shape[1] // 256), shape[2], shape[3])
    got = ssm_scan_bwd_ref(*t, ins["dy"][1], ckpt)
    for name, g, w, op in zip(names, got, want, t):
        assert g.dtype == op.dtype and g.shape == op.shape
        err = _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
        assert err <= TOL[dtype], (name, err)


def test_ssm_scan_fwd_ref_checkpoints_are_the_states():
    """The chunk checkpoints are the states before steps 0, 256, …, and
    the forward's y and final state are :func:`ssm_scan_ref`'s."""
    ins = _scan_inputs(2, 600, 6, 4, "float32")
    t = [ins[n][1] for n in ("x", "dt", "A", "B", "C", "D")]
    y, h, ckpt = ssm_scan_fwd_ref(*t)
    y0, h0 = ssm_scan_ref(*t, return_final=True)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert (ckpt[:, 0] == 0).all()
    _, h256 = ssm_scan_ref(*(a[:, :256] if a.ndim == 3 else a for a in t),
                           return_final=True)
    torch.testing.assert_close(ckpt[:, 1], h256, rtol=0, atol=0)


def test_ssm_scan_bwd_ref_matches_autograd_of_the_plain_loop():
    ins = _scan_inputs(2, 280, 8, 4, "float32", seed=3)
    t = [ins[n][1].clone().requires_grad_(True)
         for n in ("x", "dt", "A", "B", "C", "D")]
    y = ssm_scan_ref(*t)
    want = torch.autograd.grad(y, t, ins["dy"][1])
    plain = [a.detach() for a in t]
    _, _, ckpt = ssm_scan_fwd(*plain)
    got = ssm_scan_bwd(*plain, ins["dy"][1], ckpt)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= TOL["float32"]


# ------------------------------------------------- the train step's trace

def test_train_step_trace_reaches_both_backward_ops():
    """hymba-smoke's train step on fake tensors (as the dry run traces it)
    runs the kernels' forward and backward custom ops: the layers'
    flash and scan launches in the forward, the recompute and the
    backward."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import LM
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.steps import make_train_step

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            self.seen[name] = self.seen.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    cfg = get_arch("hymba-1.5b", smoke=True)
    with FakeTensorMode():
        model = LM(cfg, dtype=torch.float32, device="cpu")
        opt = adamw_init(dict(model.named_parameters()))
        tokens = torch.zeros((2, 24), dtype=torch.long)
        step = make_train_step(cfg, device="cpu")
        with Ops() as ops:
            step(model, opt, {"tokens": tokens}, 0)
    n = cfg.n_layers
    fwd = 2 * n if cfg.remat else n
    assert ops.seen.get("repro_torch.flash_attention") == fwd
    assert ops.seen.get("repro_torch.ssm_scan") == fwd
    assert ops.seen.get("repro_torch.flash_attention_bwd") == n
    assert ops.seen.get("repro_torch.ssm_scan_bwd") == n
