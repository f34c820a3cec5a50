"""CUDA kernels of the port against their plain versions, on the card.

The kernels have no CPU mode: every test here carries the ``gpu`` marker
and skips without a CUDA card.  The file imports nothing of JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's ``_tol`` (float32 2e-4, bfloat16 5e-2, atol
scaled by the contraction length; the selective scan 1e-4 in float32), over
the shape sweeps of ``tests/test_kernels.py`` including the non-divisible
shapes, plus hymba-1.5b's attention and scan shapes (the attention there
to 1e-2 and a relative Frobenius error of 1e-2: its outputs are small).
The bf16 tensor-core flash kernel's edge cases also hold each block of 16
query rows of each head to a relative Frobenius error of 1e-2, so that a
mask off by one key in a few rows shows.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import split_contraction
from repro_torch.kernels import (coded_matmul, flash_attention, poly_encode,
                                 ssm_scan, worker_products,
                                 worker_products_complex)
from repro_torch.kernels.coded_matmul.ref import (coded_matmul_3xtf32_ref,
                                                  coded_matmul_complex_ref,
                                                  coded_matmul_ref)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.poly_encode.ref import poly_encode_ref
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import decode_step, init_params, prefill

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
MATMUL_SHAPES = [(1, 64, 64, 64), (3, 100, 200, 60), (2, 96, 200, 64),
                 (4, 33, 77, 129), (1, 128, 1024, 128)]
ENCODE_SHAPES = [(24, 8, 100, 1000), (5, 3, 70, 33), (2, 1, 16, 16),
                 (7, 11, 129, 65)]
FLASH_SHAPES = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 64, 64, 32),
                (1, 8, 1, 32, 32, 16), (1, 2, 1, 16, 80, 16),
                (1, 2, 2, 50, 70, 16),
                (1, 25, 5, 300, 300, 64),       # hymba's heads
                (2, 4, 1, 70, 70, 128), (1, 8, 1, 40, 40, 256),
                # head dims without an instance, run padded to the next
                (1, 4, 2, 40, 60, 18), (2, 16, 2, 70, 90, 112)]
# float32 3xTF32 tile edges (W, M, Z, N): M and N off the 128 tile, Z off
# the 32 k-step and the 8 of an mma, Z < 8, Z % 4 != 0 (the 4-byte copies)
# and Z % 4 == 0 (the 16-byte copies)
MATMUL_EDGES = [(2, 1, 1, 1), (1, 3, 5, 7), (2, 64, 4, 64), (3, 129, 4, 131),
                (1, 200, 36, 200), (2, 130, 33, 129), (1, 257, 100, 250),
                (1, 128, 4096, 128)]
# bf16 flash tile edges (Lq, Lkv): off the 128 / 64 query tiles and the 64
# (32 at d = 256) key tiles
FLASH_EDGES = [(1, 1), (7, 130), (65, 64), (129, 129), (200, 333), (300, 97)]
FLASH_DIMS = [16, 18, 32, 64, 112, 128, 256]
# (Bt, L, Dm, S): the reference's sweep and odd state sizes, then the
# kernel's edges: L = 1, L a multiple of its 32-step chunk (the unrolled
# path) and off it, Dm off its 128-channel block with rows of 16 bytes
# (the cp.async path) and without, each state-size instance
SCAN_SHAPES = [(1, 32, 16, 4), (2, 48, 24, 16), (2, 100, 40, 8),
               (1, 33, 17, 16), (2, 40, 70, 5), (1, 20, 9, 32),
               (1, 70, 33, 1), (1, 1, 8, 16), (2, 64, 136, 16),
               (1, 95, 264, 32), (2, 31, 130, 16), (1, 33, 17, 5),
               (2, 31, 130, 32), (1, 1, 8, 4)]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=device).to(DTYPES[dtype])


def _assert_close(got, want, rtol, atol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("W,M,Z,N", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_coded_matmul_kernel_matches_plain(cuda, W, M, Z, N, dtype):
    A = _randn((W, M, Z), dtype, cuda, 0)
    B = _randn((W, Z, N), dtype, cuda, 1)
    before = coded_matmul.launches
    got = worker_products(A, B)
    torch.cuda.synchronize()
    assert coded_matmul.launches == before + 1
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (W, M, N)
    _assert_close(got, coded_matmul_ref(A, B), TOL[dtype],
                  TOL[dtype] * Z ** 0.5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_worker_products_complex_kernel_matches_plain(cuda, dtype):
    ops = [_randn(s, dtype, cuda, i) for i, s in
           enumerate([(3, 33, 77)] * 2 + [(3, 77, 129)] * 2)]
    before = coded_matmul.launches
    re, im = worker_products_complex(*ops)
    torch.cuda.synchronize()
    assert coded_matmul.launches == before + 4
    want_re, want_im = coded_matmul_complex_ref(*ops)
    _assert_close(re, want_re, TOL[dtype], 2 * TOL[dtype] * 77 ** 0.5)
    _assert_close(im, want_im, TOL[dtype], 2 * TOL[dtype] * 77 ** 0.5)


def test_coded_matmul_kernel_views_and_accumulate(cuda):
    """Worker-strided views in, ``out -= A@B`` accumulation."""
    stack = _randn((2, 5, 40, 24), "float32", cuda, 2)
    A = stack[0]                                  # a view with worker stride
    B = _randn((5, 24, 17), "float32", cuda, 3)
    out = torch.ones(5, 40, 17, device=cuda)
    coded_matmul(A, B, out, accumulate=True, sign=-1)
    _assert_close(out, 1 - coded_matmul_ref(A, B), 2e-4, 2e-4 * 24 ** 0.5)


@pytest.mark.parametrize("W,M,Z,N", MATMUL_EDGES)
def test_coded_matmul_f32_tile_edges(cuda, W, M, Z, N):
    """The 3xTF32 kernel off its tiles: to the reference's 2e-4 against the
    plain version, and to 1e-5 (relative Frobenius) against the emulation
    of its own arithmetic."""
    A = _randn((W, M, Z), "float32", cuda, 30)
    B = _randn((W, Z, N), "float32", cuda, 31)
    got = worker_products(A, B)
    _assert_close(got, coded_matmul_ref(A, B), 2e-4, 2e-4 * Z ** 0.5)
    emu = coded_matmul_3xtf32_ref(A, B)
    assert float(torch.linalg.vector_norm(got - emu)
                 / torch.linalg.vector_norm(emu)) <= 1e-5


@pytest.mark.parametrize("Z,N", [(24, 17), (64, 48)])
@pytest.mark.parametrize("offset", [0, 1])
def test_coded_matmul_f32_views_and_accumulate(cuda, Z, N, offset):
    """Worker-strided views (the 16-byte copies when rows allow them, the
    4-byte ones for odd rows or an unaligned base) and ``out -= A@B``."""
    W, M = 5, 40
    flat = _randn((2 * W * M * Z + offset,), "float32", cuda, 32)
    A = flat[offset:].view(W, 2, M, Z)[:, 1]      # worker stride 2*M*Z
    B = _randn((W, Z, N), "float32", cuda, 33)
    out = torch.ones(W, M, N, device=cuda)
    coded_matmul(A, B, out, accumulate=True, sign=-1)
    _assert_close(out, 1 - coded_matmul_ref(A, B), 2e-4, 2e-4 * Z ** 0.5)


@pytest.mark.parametrize("W,K,R,C", ENCODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_poly_encode_kernel_matches_plain(cuda, W, K, R, C, dtype):
    G = _randn((W, K), "float32", cuda, 4)
    X = _randn((K, R, C), dtype, cuda, 5)
    before = poly_encode.launches
    got = poly_encode(G, X)
    torch.cuda.synchronize()
    assert poly_encode.launches == before + 1
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (W, R, C)
    _assert_close(got, poly_encode_ref(G, X), TOL[dtype], TOL[dtype] * K)


def test_poly_encode_kernel_strided_batch_and_parts(cuda):
    A = _randn((3, 40, 96), "float32", cuda, 6)
    B = _randn((3, 96, 30), "float32", cuda, 7)
    G = _randn((10, 8), "float32", cuda, 8)
    Ab, Bb = split_contraction(A, B, 8)           # strided views, no copy
    for X in (Ab, Bb):
        got = poly_encode(G, X, parts=2)
        assert tuple(got.shape[:3]) == (2, 3, 5)
        _assert_close(got, poly_encode_ref(G, X, parts=2), 2e-4, 2e-4 * 8)


def test_wrappers_reject_bad_dtype_and_layout(cuda):
    A64 = torch.zeros(2, 8, 8, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        worker_products(A64, A64)                 # the kernel has no float64
    A = torch.zeros(2, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        worker_products(A, A.bfloat16())          # mixed dtypes
    with pytest.raises(ValueError):
        worker_products(A.transpose(1, 2), A)     # rows not contiguous
    with pytest.raises(ValueError):
        worker_products(A, A.cpu())               # two devices
    with pytest.raises(TypeError):
        poly_encode(torch.zeros(4, 2, device=cuda),
                    torch.zeros(2, 8, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        poly_encode(torch.zeros(4, 2, dtype=torch.float64, device=cuda),
                    torch.zeros(2, 8, 8, device=cuda))


@pytest.mark.parametrize("B,H,Hkv,Lq,Lkv,d", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_matches_plain(cuda, B, H, Hkv, Lq, Lkv, d, dtype):
    q = _randn((B, H, Lq, d), dtype, cuda, 10)
    k = _randn((B, Hkv, Lkv, d), dtype, cuda, 11)
    v = _randn((B, Hkv, Lkv, d), dtype, cuda, 12)
    off = Lkv - Lq
    before = flash_attention.launches
    got = flash_attention(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (B, H, Lq, d)
    _assert_close(got, attention_ref(q, k, v, q_offset=off), TOL[dtype],
                  TOL[dtype])


@pytest.mark.parametrize("window", [1, 8, 24, 64, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_windows_and_noncausal(cuda, window, causal, dtype):
    q = _randn((1, 10, 200, 64), dtype, cuda, 13)
    k = _randn((1, 2, 230, 64), dtype, cuda, 14)
    v = _randn((1, 2, 230, 64), dtype, cuda, 15)
    got = flash_attention(q, k, v, causal=causal, window=window, q_offset=30)
    _assert_close(got, attention_ref(q, k, v, causal=causal, window=window,
                                     q_offset=30), TOL[dtype], TOL[dtype])


def test_flash_library_reports_its_head_dims(cuda):
    """The library reports the head dims its source instantiates, and each
    of them runs unpadded: the kernel gets q itself, not a padded copy."""
    from repro_torch.kernels.flash_attention import ops
    dims = ops.head_dims()
    assert dims == (16, 32, 64, 128, 256)
    for d in dims:
        q = _randn((1, 2, 40, d), "bfloat16", cuda, 18)
        seen = []

        def kernel(q_, k_, v_, **kw):
            seen.append(q_.data_ptr())
            return ops._launch(q_, k_, v_, with_lse=False, **kw)[0]
        got = ops.run_padded(kernel, q, q, q, dims, causal=True, window=0,
                             q_offset=0)
        assert seen == [q.data_ptr()]
        _assert_close(got, attention_ref(q, q, q), 5e-2, 5e-2)


def test_flash_kernel_takes_model_views(cuda):
    """(B, L, H, d) activations moved to (B, H, L, d) go in without a copy,
    and the output keeps q's layout; a fully masked row gives zeros."""
    x = _randn((2, 96, 10, 32), "bfloat16", cuda, 16)
    kv = _randn((2, 96, 2, 32), "bfloat16", cuda, 17)
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    got = flash_attention(q, k, k, window=16)
    assert got.stride() == q.stride()
    _assert_close(got, attention_ref(q, k, k, window=16), 5e-2, 5e-2)
    out = flash_attention(q[:, :, :4], k, k, window=1, q_offset=200)
    assert not out.float().abs().max()


def _assert_flash_rows(got, want, rows=16, tol=1e-2):
    """Relative Frobenius error of each block of ``rows`` query rows of each
    (batch, head) <= tol; blocks that should be 0 (rows that see no key)
    must be 0.  The rounding of P and of the output to bf16 stays well
    inside tol; a mask off by one key moves a row by about 1 / keys."""
    B, H, L, d = want.shape
    pad = (0, 0, 0, -L % rows)
    g, w = (torch.nn.functional.pad(x.float(), pad).reshape(B, H, -1,
                                                              rows * d)
            for x in (got, want))
    err = torch.linalg.vector_norm(g - w, dim=-1)
    ref = torch.linalg.vector_norm(w, dim=-1)
    assert bool((err <= tol * ref).all()), float(
        (err / ref.clamp_min(1e-30)).max())


def _assert_flash_bf16(got, want):
    _assert_close(got, want, 5e-2, 5e-2)
    _assert_flash_rows(got, want)


def _flash_case(device, B, H, Hkv, Lq, Lkv, d, seed):
    """bf16 q (B, H, Lq, d), k and v (B, Hkv, Lkv, d)."""
    return (_randn((B, H, Lq, d), "bfloat16", device, seed),
            _randn((B, Hkv, Lkv, d), "bfloat16", device, seed + 1),
            _randn((B, Hkv, Lkv, d), "bfloat16", device, seed + 2))


@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("Lq,Lkv", FLASH_EDGES)
def test_flash_bf16_tile_edges(cuda, Lq, Lkv, d):
    """Lq and Lkv off the tensor-core kernel's tiles, causal (queries
    aligned to the end of the keys where Lkv >= Lq), non-causal and
    windowed."""
    q, k, v = _flash_case(cuda, 1, 4, 2, Lq, Lkv, d, 40)
    off = max(0, Lkv - Lq)
    for causal, window in ((True, 0), (False, 0), (True, 33)):
        got = flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=off)
        _assert_flash_bf16(got, attention_ref(q, k, v, causal=causal,
                                              window=window or None,
                                              q_offset=off))


@pytest.mark.parametrize("window", [37, 64, 100])
@pytest.mark.parametrize("d", [64, 256])
def test_flash_bf16_window_starts_inside_a_tile(cuda, window, d):
    """q_offset > 0 with a window whose first key falls inside a key tile,
    and rows (past Lkv + window) that see no key at all: those give 0."""
    q, k, v = _flash_case(cuda, 2, 6, 3, 230, 300, d, 43)
    for off in (250, 41):
        got = flash_attention(q, k, v, window=window, q_offset=off)
        _assert_flash_bf16(got, attention_ref(q, k, v, window=window,
                                              q_offset=off))
    got = flash_attention(q, k[:, :, :50], v[:, :, :50], window=window)
    _assert_flash_bf16(got, attention_ref(q, k[:, :, :50], v[:, :, :50],
                                          window=window))
    assert not got[:, :, 50 + window:].float().abs().max()


@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("group", [1, 5, 8])
def test_flash_bf16_query_groups(cuda, group, d):
    """GQA reads K/V of head h // group; no limit on the group in bf16."""
    q, k, v = _flash_case(cuda, 2, 2 * group, 2, 100, 100, d, 46)
    for window in (0, 30):
        got = flash_attention(q, k, v, window=window)
        _assert_flash_bf16(got, attention_ref(q, k, v,
                                              window=window or None))


def test_flash_bf16_takes_a_group_the_float32_kernel_refuses(cuda):
    """128 query heads on one KV head at d = 128: the float32 kernel's
    group-per-block limit (group * 4 lanes <= 256) refuses it, bf16 runs."""
    q, k, v = _flash_case(cuda, 1, 128, 1, 20, 20, 128, 49)
    _assert_flash_bf16(flash_attention(q, k, v), attention_ref(q, k, v))
    with pytest.raises(ValueError):
        flash_attention(q.float(), k.float(), v.float())


def test_flash_bf16_copies_unaligned_views(cuda):
    """Rows that do not start on 16 bytes (an odd position stride and an
    unaligned base) are copied once and give the same result."""
    B, L, H, d = 2, 70, 4, 64
    flat = _randn((B * L * (H * d + 1) + 1,), "bfloat16", cuda, 50)
    x = flat[1:].view(B, L, H * d + 1)[..., :H * d].view(B, L, H, d)
    q = k = v = x.transpose(1, 2)                 # position stride H*d + 1
    assert q.stride(2) % 8 and q.data_ptr() % 16
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=16)
    assert flash_attention.launches == before + 1
    _assert_flash_bf16(got, attention_ref(q.contiguous(), k.contiguous(),
                                          v.contiguous(), window=16))


@pytest.mark.parametrize("L", [2048])
@pytest.mark.parametrize("window", [0, 1024])
def test_flash_kernel_hymba_prefill_shape(cuda, L, window):
    """hymba's heads at a long prompt.  With N(0, 1) q and k most outputs
    are about sqrt(e / keys) ~ 0.03-0.05, so the sweep's bf16 5e-2 would
    pass a kernel wrong by a typical value: the limits here sit between the
    kernel's measured error (one bf16 ulp, max 3.9e-3 at L = 8192 on an
    H100; PERF.md) and that scale."""
    q = _randn((1, 25, L, 64), "bfloat16", cuda, 18)
    k = _randn((1, 5, L, 64), "bfloat16", cuda, 19)
    v = _randn((1, 5, L, 64), "bfloat16", cuda, 20)
    got = flash_attention(q, k, v, window=window)
    want = attention_ref(q, k, v, window=window or None)
    _assert_close(got, want, 1e-2, 1e-2)
    g, w = got.float(), want.float()
    assert float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w)) <= 1e-2


def _scan_inputs(Bt, L, Dm, S, dtype, device, seed, offset=None):
    """x, dt, A, B, C, D; with ``offset``, B and C are column slices at that
    offset of one (Bt, L, offset + 2S) projection, as in the model (hymba's
    dt_rank puts them at 100)."""
    rng = np.random.default_rng(seed)

    def f(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    x = f(rng.standard_normal((Bt, L, Dm))).to(DTYPES[dtype])
    dt = f(rng.uniform(0.01, 0.2, (Bt, L, Dm))).to(DTYPES[dtype])
    A = f(-rng.uniform(0.1, 1.0, (Dm, S)))
    if offset is not None:       # column slices of one x_proj output
        xp = f(rng.standard_normal((Bt, L, offset + 2 * S))).to(DTYPES[dtype])
        B, C = xp[..., offset:offset + S], xp[..., offset + S:]
    else:
        B = f(rng.standard_normal((Bt, L, S))).to(DTYPES[dtype])
        C = f(rng.standard_normal((Bt, L, S))).to(DTYPES[dtype])
    D = f(rng.standard_normal((Dm,)))
    return x, dt, A, B, C, D


def _assert_scan(args, y, h, y_tol):
    want_y, want_h = ssm_scan_ref(*args, return_final=True)
    assert y.dtype == args[0].dtype and h.dtype == torch.float32
    _assert_close(y, want_y, y_tol, y_tol)
    _assert_close(h, want_h, 1e-4, 1e-4)


@pytest.mark.parametrize("Bt,L,Dm,S", SCAN_SHAPES)
@pytest.mark.parametrize("offset", [None, 7, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_matches_plain(cuda, Bt, L, Dm, S, offset, dtype):
    """y to 1e-4 in float32 and 5e-2 in bf16, the state to 1e-4; B and C
    contiguous, at the misaligned offset 7 (2-byte aligned in bf16) and at
    hymba's 100."""
    args = _scan_inputs(Bt, L, Dm, S, dtype, cuda, 21, offset)
    before = ssm_scan.launches
    y, h = ssm_scan(*args, return_final=True)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    _assert_scan(args, y, h, 1e-4 if dtype == "float32" else 5e-2)


def test_ssm_scan_kernel_zero_dt_rows_pass_the_state(cuda):
    """dt = 0 decays by exactly 1 and adds nothing (the Pallas padding
    rule): rows of zeros leave h as it was, and y is C h + D x there."""
    args = list(_scan_inputs(2, 70, 136, 16, "float32", cuda, 25, 100))
    args[1][:, 10:45] = 0.0
    args[1][1, 60:] = 0.0
    y, h = ssm_scan(*args, return_final=True)
    _assert_scan(args, y, h, 1e-4)
    _, h10 = ssm_scan(*(a[:, :10] if a.ndim == 3 else a for a in args),
                      return_final=True)
    _, h45 = ssm_scan(*(a[:, :45] if a.ndim == 3 else a for a in args),
                      return_final=True)
    torch.testing.assert_close(h45, h10, rtol=0, atol=0)


def test_ssm_scan_kernel_decay_underflow(cuda):
    """A large |dt A| (up to 50 * 16 = 800) makes the decay underflow to 0:
    the state then holds only the newest input."""
    args = list(_scan_inputs(1, 40, 136, 16, "float32", cuda, 26, 100))
    S = args[2].shape[1]
    args[2] = -torch.arange(1, S + 1, dtype=torch.float32,
                            device=cuda).expand(136, S).contiguous()
    args[1] = args[1] * 250.0
    y, h = ssm_scan(*args, return_final=True)
    _assert_scan(args, y, h, 1e-4)


def test_ssm_scan_kernel_hymba_shape_bf16(cuda):
    """hymba's channels and state (Dm=3200, S=16), bf16 activations with B
    and C as strided views; y in bf16 to 5e-2, the f32 state to 1e-4."""
    args = _scan_inputs(2, 256, 3200, 16, "bfloat16", cuda, 22, 7)
    y, h = ssm_scan(*args, return_final=True)
    _assert_scan(args, y, h, 5e-2)


def test_ssm_scan_kernel_hymba_parameters_bf16(cuda):
    """hymba's own A = -(1..16) and dt = softplus(dt_proj + dt_bias) near
    0.01 (models/lm.py init), B and C at its dt_rank offset 100: y in bf16
    to 5e-2, the f32 state to 1e-4."""
    x, dt, _, B, C, D = _scan_inputs(1, 300, 3200, 16, "bfloat16", cuda, 27,
                                     100)
    rng = np.random.default_rng(28)
    dt = torch.nn.functional.softplus(torch.tensor(
        -4.6 + 0.5 * rng.standard_normal(x.shape), dtype=torch.float32,
        device=cuda)).to(torch.bfloat16)
    A = -torch.arange(1, 17, dtype=torch.float32,
                      device=cuda).expand(3200, 16).contiguous()
    args = (x, dt, A, B, C, D)
    y, h = ssm_scan(*args, return_final=True)
    _assert_scan(args, y, h, 5e-2)


def test_hymba_smoke_on_the_card_matches_the_cpu(cuda):
    """The same float32 weights: prefill through the kernels on the card
    against the plain versions on the CPU, then decode steps."""
    cfg = get_arch("hymba-1.5b", smoke=True)
    cpu = init_params(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    gpu = init_params(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.tensor(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (2, 40)))
    before = (flash_attention.launches, ssm_scan.launches)
    lg, sg = prefill(gpu, tokens[:, :32].to(cuda), cfg, max_seq=40)
    assert (flash_attention.launches, ssm_scan.launches) == (
        before[0] + cfg.n_layers, before[1] + cfg.n_layers)
    lc, sc = prefill(cpu, tokens[:, :32], cfg, max_seq=40)
    _assert_close(lg, lc, 2e-4, 2e-4)
    _assert_close(sg.ssm_h, sc.ssm_h, 2e-4, 2e-4)
    for t in range(32, 40):
        lg, sg = decode_step(gpu, tokens[:, t:t + 1].to(cuda), sg, cfg)
        lc, sc = decode_step(cpu, tokens[:, t:t + 1], sc, cfg)
        _assert_close(lg, lc, 2e-3, 2e-3)


def test_lm_wrappers_reject_bad_dtype(cuda):
    q = torch.zeros(1, 2, 8, 16, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim 300"):   # above 256
        flash_attention(*(torch.zeros(1, 2, 8, 300, device=cuda),) * 3)
    kv = torch.zeros(1, 1, 8, 128, device=cuda)
    with pytest.raises(ValueError):              # 128 heads x 4 lanes > 256
        flash_attention(torch.zeros(1, 128, 8, 128, device=cuda), kv, kv)
    x = torch.zeros(1, 4, 8, device=cuda)
    A = torch.zeros(8, 4, device=cuda)
    with pytest.raises(TypeError):
        ssm_scan(x, x, A.double(), x[..., :4], x[..., :4], A[:, 0])
    with pytest.raises(ValueError):
        ssm_scan(torch.zeros(1, 4, 8, device=cuda),
                 torch.zeros(1, 4, 8, device=cuda),
                 torch.zeros(8, 40, device=cuda),
                 torch.zeros(1, 4, 40, device=cuda),
                 torch.zeros(1, 4, 40, device=cuda),
                 torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):              # no state at all
        ssm_scan(x, x, A[:, :0], x[..., :0], x[..., :0], A[:, 0])


# ------------------------------------------- open loop and engine on card

def _open_loop_pair(device):
    from repro_torch.core import LayerSACCode
    from repro_torch.serving import (MasterScheduler, ServeConfig,
                                     SimulatedBackend, TenantSpec,
                                     TorchDeviceBackend, build_workload)
    tenants = [TenantSpec("interactive", rows=96, inner=512,
                          target_error=3e-1, deadline=3.0, weight=2.0),
               TenantSpec("batch", rows=128, inner=1024, target_error=1e-2,
                          deadline=8.0, weight=1.0)]
    wl = build_workload(tenants, rate=3.0, horizon=10.0, seed=30)
    code = LayerSACCode(8, 24, base="ortho", eps=6.25e-3)
    out = []
    for backend in (TorchDeviceBackend(straggler_frac=0.15, device=device),
                    SimulatedBackend(straggler_frac=0.15, device="cpu")):
        cfg = ServeConfig(deadlines=(0.6, 1.2, 2.4), batch_size=4, seed=29,
                          queue_policy="edf", queue_limit=6,
                          shed_expired=True, stream=True)
        sched = MasterScheduler(code, backend, cfg)
        out.append((sched, sched.run_open(wl)))
    return out


def test_run_open_on_the_card_matches_sim(cuda):
    """The open loop through the kernels on the card against the float64
    oracle on the CPU: the same sheds, drops, batches and target crossings;
    on the approximate layers the estimates agree to 1e-5·‖C‖ (float32
    products).  An exact state's fit can amplify the float32 rounding by
    its conditioning, which depends on the completion order (the
    reference's float32 device path does the same), so exact states are
    held below the tightest tenant target, 1e-2."""
    before = (coded_matmul.launches, poly_encode.launches)
    (dev, rd), (sim, rs) = _open_loop_pair(cuda)
    R = dev.code.recovery_threshold
    assert coded_matmul.launches > before[0]
    assert poly_encode.launches > before[1]
    assert dev.shed == sim.shed
    key = [(r.req_id, r.batch, r.tenant, r.dropped, r.t_dispatch,
            r.t_target, r.t_done, r.slo_ok) for r in rd]
    assert key == [(r.req_id, r.batch, r.tenant, r.dropped, r.t_dispatch,
                    r.t_target, r.t_done, r.slo_ok) for r in rs]
    assert any(r.t_target is not None for r in rd)
    for a, b in zip(rd, rs):
        for x, y in zip(a.answers, b.answers, strict=True):
            assert (x.t, x.m, x.kind) == (y.t, y.m, y.kind)
            if y.rel_err is None:
                continue
            if x.m < R:
                assert abs(np.sqrt(x.rel_err) - np.sqrt(y.rel_err)) <= 1e-5
            else:
                assert x.rel_err <= 1e-2


@pytest.mark.parametrize("name", ["layer_sac", "group_sac", "orthomatdot"])
@pytest.mark.parametrize("norms", ["exact", "gram"])
def test_engine_torch_backend_on_the_card_matches_numpy(cuda, name, norms):
    """``SimulationEngine(backend="torch")`` on the card against the numpy
    backend: 1e-10 relative plus twice the float64 rounding bound."""
    from repro_torch.core import (GroupSACCode, LayerSACCode,
                                  OrthoMatDotCode, SimulationEngine,
                                  simulate_completion_batch, x_complex)
    code = {"layer_sac": LayerSACCode(4, 12, base="ortho", eps=1e-2),
            "group_sac": GroupSACCode(4, 12, x_complex(12, 0.1), [2, 2]),
            "orthomatdot": OrthoMatDotCode(4, 12)}[name]
    rng = np.random.default_rng(2)
    A, B = rng.standard_normal((40, 320)), rng.standard_normal((320, 30))
    batch = simulate_completion_batch(np.random.default_rng(4), 12, 16)
    ref = SimulationEngine(code, A, B, norms=norms)
    got = SimulationEngine(code, A, B, norms=norms, backend="torch",
                           device=cuda).run_batch(batch)
    want, bound = ref.run_batch(batch), ref.rounding_bound(batch)
    for attr in ("total", "approx", "comp"):
        r, e, b = (getattr(c, attr) for c in (want, got, bound))
        assert np.array_equal(np.isnan(r), np.isnan(e))
        ok = ~np.isnan(r)
        assert np.all(np.abs(e[ok] - r[ok])
                      <= 1e-10 * np.abs(r[ok]) + 2 * b[ok]), attr


@pytest.mark.parametrize("complex_points", [False, True])
def test_sim_backend_on_the_card_matches_the_cpu_oracle(cuda,
                                                        complex_points):
    from repro_torch.core import GroupSACCode, LayerSACCode, x_complex
    from repro_torch.serving import SimulatedBackend
    code = GroupSACCode(4, 12, x_complex(12, 0.1), [2, 2]) \
        if complex_points else LayerSACCode(4, 12, base="ortho", eps=1e-2)
    rng = np.random.default_rng(8)
    As = [rng.standard_normal((30, 64)) for _ in range(3)]
    Bs = [rng.standard_normal((64, 20)) for _ in range(3)]
    want = SimulatedBackend(device="cpu").compute_products(code, As, Bs)
    got = SimulatedBackend(device=cuda).compute_products(code, As, Bs)
    assert got.device.type == "cuda" and got.dtype == want.dtype
    got = got.cpu().numpy()
    want = want.numpy()
    assert np.linalg.norm(got - want) <= 1e-13 * np.linalg.norm(want)


@pytest.mark.parametrize("extra", [
    ["--per-class", "--class-cache", "8"],
    ["--cost-aware", "--N-options", "16,24", "--drift", "ks",
     "--fleet", "20"],
], ids=["per-class", "cost-aware-drift-fleet"])
def test_serve_cli_tune_and_observability_flags_on_the_card(cuda, extra,
                                                            tmp_path):
    """The autotuned serve with the tune, fleet, cache and observability
    flags on the device backend launches the kernels and writes what the
    flags ask for."""
    from repro_torch.launch.serve import build_parser, run_serve
    before = (coded_matmul.launches, poly_encode.launches)
    argv = ["--rows", "64", "--inner", "512", "--requests", "8",
            "--code", "lsac_ortho", "--autotune", "--profile-window", "4",
            "--profile-state", str(tmp_path / "state.json"),
            "--metrics-out", str(tmp_path / "m.json"),
            "--trace-out", str(tmp_path / "t.json"),
            "--flight-recorder", str(tmp_path / "f.json"),
            "--sample-interval", "0.5", "--metrics-port", "0",
            "--burn-alerts", *extra]
    rep = run_serve(build_parser().parse_args(argv)).to_dict()
    assert coded_matmul.launches > before[0]
    assert poly_encode.launches > before[1]
    assert rep["autotune"]["retunes"] and rep["config"]["device"] == "cuda"
    assert rep["observability"]["metrics_port"] > 0
    for name in ("state.json", "m.json", "t.json"):
        assert (tmp_path / name).exists()
    again = run_serve(build_parser().parse_args(argv)).to_dict()
    assert again["autotune"]["restored"]


# ----------------------------------------------------------- the cluster

def _cluster_reqs(rng, n, rows=40, inner=96):
    return [(rng.standard_normal((rows, inner)),
             rng.standard_normal((inner, rows))) for _ in range(n)]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_cluster_on_the_card_matches_sim(cuda):
    """Three worker processes, each computing its shard's products in the
    ``coded_matmul`` kernel on the card (complex points: four launches a
    shard), against the float64 oracle: 1e-5 relative per shard.  The
    launch counts come from the workers' own counters."""
    from repro_torch.cluster.backend import ClusterBackend
    from repro_torch.core import MatDotCode, x_complex
    from repro_torch.serving import SimulatedBackend
    code = MatDotCode(2, 3, x_complex(3, 0.1))
    As, Bs = zip(*_cluster_reqs(np.random.default_rng(2), 2))
    with ClusterBackend(workers=3, seed=0, compute="device",
                        device=cuda) as be:
        assert be.pool.wait_ready(timeout=120.0), "workers never came up"
        d = be.dispatch_batch(code, As, Bs)
        d.drain(60.0)
        got = d.product_stack()
        d.finalize()
    assert not d.lost and got.device.type == "cuda"
    assert got.dtype == torch.complex64
    want = SimulatedBackend(device=cuda).compute_products(code, As, Bs)
    for shard in range(code.N):
        assert _rel(got[:, shard].cpu().numpy(),
                    want[:, shard].cpu().numpy()) < 1e-5, shard
    assert be.pool.kernel_launches() == {"coded_matmul": 4 * code.N}


def test_cluster_device_record_replay_bit_identity_on_the_card(cuda):
    from repro_torch.cluster.backend import ClusterBackend, ReplayBackend
    from repro_torch.core import LayerSACCode
    from repro_torch.serving import MasterScheduler, ServeConfig
    code = LayerSACCode(2, 4, base="ortho", eps=6.25e-3)
    reqs = _cluster_reqs(np.random.default_rng(6), 4)
    cfg = ServeConfig(deadlines=(0.05, 0.2, 1.0), stream=True, batch_size=2,
                      seed=0)

    def serve(backend):
        sched = MasterScheduler(code, backend, cfg)
        for A, B in reqs:
            sched.submit(A, B)
        return [[(a.t, a.m, a.rel_err, a.kind) for a in r.answers]
                for r in sched.run()]

    with ClusterBackend(workers=4, seed=1, chaos="sleep:0.005:0.02",
                        record=True, compute="device", device=cuda) as be:
        live = serve(be)
        rec = be.recording
    assert len(rec) == 2
    assert live == serve(ReplayBackend(rec, compute="device", device=cuda))
    assert be.pool.kernel_launches()["coded_matmul"] >= 2 * code.N


def test_cluster_worker_that_cannot_see_the_card_fails(cuda, monkeypatch):
    """A device worker with no visible card reports it and the pool raises:
    the worker never computes on the CPU instead."""
    from repro_torch.cluster.backend import ClusterBackend
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with ClusterBackend(workers=1, compute="device", device=cuda) as be:
        with pytest.raises(RuntimeError, match="failed to start.*no CUDA"):
            be.pool.wait_ready(timeout=120.0)


# (B, H, Hkv, Lq, Lkv, d, causal, window, q_offset): the backward over
# every built head dim and the padded 18 and 112, groups of 1, 5 and 8,
# windows and a query chunk's offset, lengths off the 64-row tiles, a row
# that sees no key
FLASH_BWD_CASES = [(1, 2, 2, 64, 64, 16, True, 0, 0),
                   (2, 4, 2, 70, 70, 32, True, 0, 0),
                   (1, 25, 5, 300, 300, 64, True, 100, 0),
                   (1, 10, 2, 129, 200, 128, True, 0, 71),
                   (1, 8, 1, 40, 40, 256, True, 0, 0),
                   (1, 4, 4, 65, 97, 18, False, 0, 0),
                   (1, 16, 2, 129, 130, 112, True, 33, 1),
                   (1, 4, 2, 100, 40, 64, True, 20, 0)]
# (Bt, L, Dm, S, offset): the scan's backward over each state-size
# instance, L across its 256-step chunks and sub-chunks, Dm off the
# 128-channel block, B and C as column views
SCAN_BWD_CASES = [(1, 32, 16, 4, None), (2, 100, 40, 8, 7),
                  (2, 300, 136, 16, 100), (1, 513, 33, 32, None),
                  (1, 1, 8, 5, None)]
# relative Frobenius error of each gradient against the plain backward:
# float32 kernels compute the same float32 formulas in another order; the
# bf16 ones round P and dS (flash) to bf16 for the second products and
# every gradient to bf16; relative to a norm of at least 1e-2 an element
# (a gradient that cancels to ~0 has no relative error to speak of)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _rel_fro(got, want) -> float:
    den = max(want.float().norm().item(), 1e-2 * want.numel() ** 0.5)
    return (got.float() - want.float()).norm().item() / den


@pytest.mark.parametrize("kind,case,dtype", [
    ("flash", c, dt) for c in FLASH_BWD_CASES for dt in DTYPES] + [
    ("scan", c, dt) for c in SCAN_BWD_CASES for dt in DTYPES])
def test_flash_and_scan_differentiate_on_the_card(cuda, kind, case, dtype):
    """Under autograd flash and the scan launch their backward kernels, and
    the gradients match the plain backward (``flash_attention_bwd_ref``,
    ``ssm_scan_bwd_ref``) on the same inputs; a gradient of the scan's
    final state raises."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref)
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_bwd
    from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_ref,
                                                  ssm_scan_fwd_ref)
    if kind == "flash":
        B, H, Hkv, Lq, Lkv, d, causal, window, off = case
        leaves = [_randn(s, dtype, cuda, 40 + i).requires_grad_(True)
                  for i, s in enumerate(((B, H, Lq, d), (B, Hkv, Lkv, d),
                                         (B, Hkv, Lkv, d)))]
        kw = {"causal": causal, "window": window, "q_offset": off}
        before = flash_attention_bwd.launches
        out = flash_attention(*leaves, **kw)
        do = _randn(out.shape, dtype, cuda, 43)
        got = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches == before + 1
        plain = [t.detach() for t in leaves]
        o, lse = flash_attention_lse_ref(*plain, **kw)
        want = flash_attention_bwd_ref(*plain, o.to(out.dtype), lse, do,
                                       **kw)
    else:
        Bt, L, Dm, S, offset = case
        x, dt, A, B, C, D = _scan_inputs(Bt, L, Dm, S, dtype, cuda, 44,
                                         offset)
        base = [x, dt, A, B._base if B._base is not None else B,
                C._base if C._base is not None else C, D]
        for t in {id(t): t for t in base}.values():
            t.requires_grad_(True)
        if offset is not None:
            B = base[3][..., offset:offset + S]
            C = base[3][..., offset + S:]
        args = (x, dt, A, B, C, D)
        before = ssm_scan_bwd.launches
        y, h = ssm_scan(*args, return_final=True)
        dy = _randn(y.shape, dtype, cuda, 45)
        got = torch.autograd.grad(y, args, dy, retain_graph=True)
        torch.cuda.synchronize()
        assert ssm_scan_bwd.launches == before + 1
        with pytest.raises(RuntimeError, match="final state"):
            torch.autograd.grad(h.sum(), args, allow_unused=True)
        plain = [t.detach() for t in args]
        _, _, ckpt = ssm_scan_fwd_ref(*plain)
        want = ssm_scan_bwd_ref(*plain, dy, ckpt)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        assert _rel_fro(g, w) <= BWD_TOL[dtype]


def test_kernels_refuse_autograd_on_the_card(cuda):
    """The serve's kernels have no backward pass: under autograd their
    wrappers raise on the card instead of returning an output with no
    gradient."""
    E = torch.randn((2, 8, 8), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        coded_matmul(E, E)
    with torch.no_grad():
        coded_matmul(E, E)
    G = torch.randn((4, 2), device="cuda")
    X = torch.randn((2, 8, 8), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        poly_encode(G, X)
    with torch.no_grad():
        poly_encode(G, X)
