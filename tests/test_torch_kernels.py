"""Port kernels: plain versions against the reference Pallas kernels and jnp
oracles.

Inputs are drawn with numpy from a seed and handed to both packages (bf16
inputs are rounded once, by jax, and passed on exactly).  The reference
kernels run as the reference's own tests run them on the CPU: Pallas in
``interpret=True``.  Tolerances are the reference's ``_tol`` (float32 2e-4,
bfloat16 5e-2, atol scaled by the contraction length), over the shape
sweeps of ``tests/test_kernels.py`` including the non-divisible shapes
(flash attention: 2e-4 / 5e-2 flat; selective scan: 1e-4).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import MatDotCode as RefMatDotCode
from repro.core import split_contraction as ref_split_contraction
from repro.core import x_equal as ref_x_equal
from repro.kernels.coded_matmul.kernel import coded_matmul_pallas
from repro.kernels.coded_matmul.ref import (coded_matmul_complex_ref,
                                            coded_matmul_ref)
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.poly_encode.kernel import poly_encode_pallas
from repro.kernels.poly_encode.ref import poly_encode_ref
from repro.kernels.ssm_scan.kernel import ssm_scan_pallas
from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.core import MatDotCode, split_contraction, x_equal
from repro_torch.kernels import (_build, coded_matmul, flash_attention,
                                 poly_encode, ssm_scan, worker_products,
                                 worker_products_complex)
from repro_torch.kernels.coded_matmul.ref import \
    coded_matmul_ref as plain_coded_matmul
from repro_torch.kernels.coded_matmul.ref import (coded_matmul_3xtf32_ref,
                                                  tf32_round)
from repro_torch.kernels.flash_attention.ops import instance_dim, run_padded
from repro_torch.kernels.flash_attention.ref import \
    attention_ref as plain_attention
from repro_torch.kernels.poly_encode.ref import \
    poly_encode_ref as plain_poly_encode

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MATMUL_SHAPES = [(1, 64, 64, 64), (3, 100, 200, 60), (2, 96, 200, 64),
                 (4, 33, 77, 129), (1, 128, 1024, 128)]
ENCODE_SHAPES = [(24, 8, 100, 1000), (5, 3, 70, 33), (2, 1, 16, 16),
                 (7, 11, 129, 65)]


def _tol(name):
    return {"float32": 2e-4, "bfloat16": 5e-2}[name]


def _pair(arr: np.ndarray, name: str):
    """The same values as a jax array and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(arr, jdt)
    t = torch.from_numpy(np.array(j, np.float32)).to(tdt)
    return j, t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _matmul_inputs(W, M, Z, N, name, seed=0):
    rng = np.random.default_rng(seed)
    return (_pair(rng.standard_normal((W, M, Z)), name),
            _pair(rng.standard_normal((W, Z, N)), name))


# ------------------------------------------------------------- coded matmul

@pytest.mark.parametrize("W,M,Z,N", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_coded_matmul_plain_matches_pallas(W, M, Z, N, dtype):
    (ja, ta), (jb, tb) = _matmul_inputs(W, M, Z, N, dtype)
    want = coded_matmul_pallas(ja, jb, bm=32, bn=32, bz=64, interpret=True)
    got = worker_products(ta, tb)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (W, M, N)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=_tol(dtype),
                               atol=_tol(dtype) * Z ** 0.5)


@pytest.mark.parametrize("W,M,Z,N", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_coded_matmul_plain_matches_jnp_ref(W, M, Z, N, dtype):
    (ja, ta), (jb, tb) = _matmul_inputs(W, M, Z, N, dtype, seed=1)
    np.testing.assert_allclose(_f32(plain_coded_matmul(ta, tb)),
                               _f32(coded_matmul_ref(ja, jb)),
                               rtol=_tol(dtype), atol=_tol(dtype) * Z ** 0.5)


@pytest.mark.parametrize("W,M,Z,N", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_worker_products_complex_matches_jnp_ref(W, M, Z, N, dtype):
    """The four-GEMM wrapper (accumulating in place) against the
    reference's complex oracle."""
    rng = np.random.default_rng(2)
    (jar, tar), (jai, tai) = (_pair(rng.standard_normal((W, M, Z)), dtype)
                              for _ in range(2))
    (jbr, tbr), (jbi, tbi) = (_pair(rng.standard_normal((W, Z, N)), dtype)
                              for _ in range(2))
    re, im = worker_products_complex(tar, tai, tbr, tbi)
    want_re, want_im = coded_matmul_complex_ref(jar, jai, jbr, jbi)
    tol = _tol(dtype)
    np.testing.assert_allclose(_f32(re), _f32(want_re), rtol=tol,
                               atol=2 * tol * Z ** 0.5)
    np.testing.assert_allclose(_f32(im), _f32(want_im), rtol=tol,
                               atol=2 * tol * Z ** 0.5)


@pytest.mark.parametrize("blocks", [(16, 16, 16), (64, 32, 128),
                                    (128, 128, 512)])
def test_coded_matmul_plain_matches_pallas_block_shapes(blocks):
    bm, bn, bz = blocks
    (ja, ta), (jb, tb) = _matmul_inputs(2, 80, 160, 72, "float32", seed=3)
    want = coded_matmul_pallas(ja, jb, bm=bm, bn=bn, bz=bz, interpret=True)
    np.testing.assert_allclose(_f32(worker_products(ta, tb)), _f32(want),
                               rtol=2e-4, atol=1e-3)


def test_coded_matmul_accumulate_and_sign_on_cpu():
    """``out ± A@B`` semantics of the wrapper the complex path builds on."""
    (_, ta), (_, tb) = _matmul_inputs(2, 9, 13, 7, "float32", seed=4)
    P = plain_coded_matmul(ta, tb)
    out = torch.ones_like(P)
    coded_matmul(ta, tb, out, accumulate=True, sign=-1)
    torch.testing.assert_close(out, 1 - P)
    coded_matmul(ta, tb, out)                     # plain store overwrites
    torch.testing.assert_close(out, P)


def test_tf32_round_is_round_to_nearest_ties_away():
    """``tf32_round`` is ``cvt.rna.tf32.f32``: 10 mantissa bits kept, ties
    away from zero."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -20,
                      1 + 3 * 2 ** -11, 3.0, -0.0], dtype=torch.float32)
    want = [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -9, 3.0, -0.0]
    assert tf32_round(x).tolist() == want
    r = torch.tensor(np.random.default_rng(7).standard_normal(10_000),
                     dtype=torch.float32)
    hi = tf32_round(r)
    assert not int((hi.view(torch.int32) & 0x1FFF).abs().sum())
    assert float(((r - hi).abs() / r.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("W,M,Z,N", MATMUL_SHAPES + [(1, 64, 4096, 64)])
def test_3xtf32_emulation_within_float32_tolerance(W, M, Z, N):
    """Three TF32 products (``A_lo·B_hi + A_hi·B_lo + A_hi·B_hi``), the float32
    kernel's arithmetic on the card, stay within the reference's float32
    tolerance of its jnp oracle."""
    (ja, ta), (jb, tb) = _matmul_inputs(W, M, Z, N, "float32", seed=5)
    np.testing.assert_allclose(_f32(coded_matmul_3xtf32_ref(ta, tb)),
                               _f32(coded_matmul_ref(ja, jb)), rtol=2e-4,
                               atol=2e-4 * Z ** 0.5)


def test_single_tf32_pass_misses_float32_tolerance():
    """Why the kernel takes three passes: one TF32 product at Z = 4096 with
    N(0, 1) operands errs by ~0.02 per output, beyond the float32 atol of
    2e-4 * sqrt(Z) = 0.0128 on a large share of the outputs."""
    Z = 4096
    (ja, ta), (jb, tb) = _matmul_inputs(1, 64, Z, 64, "float32", seed=6)
    want = _f32(coded_matmul_ref(ja, jb))
    limit = 2e-4 * Z ** 0.5 + 2e-4 * np.abs(want)
    one = _f32(plain_coded_matmul(tf32_round(ta), tf32_round(tb)))
    three = _f32(coded_matmul_3xtf32_ref(ta, tb))
    assert np.mean(np.abs(one - want) > limit) > 0.1
    assert not np.any(np.abs(three - want) > limit)


@pytest.mark.parametrize("dropped", ["A_hi*B_lo", "A_lo*B_hi"])
def test_two_tf32_passes_miss_float32_tolerance(dropped):
    """Nor do two passes suffice: dropping either cross term of the 3xTF32
    split at Z = 4096 leaves more than 5 % of the outputs beyond the float32
    limit, so the float32 bound counts three TF32 products."""
    Z = 4096
    (ja, ta), (jb, tb) = _matmul_inputs(1, 64, Z, 64, "float32", seed=6)
    want = _f32(coded_matmul_ref(ja, jb))
    limit = 2e-4 * Z ** 0.5 + 2e-4 * np.abs(want)
    a_hi, b_hi = tf32_round(ta), tf32_round(tb)
    a_lo, b_lo = tf32_round(ta - a_hi), tf32_round(tb - b_hi)
    cross = (plain_coded_matmul(a_lo, b_hi) if dropped == "A_hi*B_lo"
             else plain_coded_matmul(a_hi, b_lo))
    two = _f32(cross + plain_coded_matmul(a_hi, b_hi))
    assert np.mean(np.abs(two - want) > limit) > 0.05


@pytest.mark.parametrize("bad", ["shape", "out_shape", "accumulate", "sign"])
def test_coded_matmul_rejects_bad_arguments(bad):
    A, B = torch.zeros(2, 3, 4), torch.zeros(2, 4, 5)
    with pytest.raises(ValueError):
        if bad == "shape":
            coded_matmul(A, torch.zeros(2, 5, 5))
        elif bad == "out_shape":
            coded_matmul(A, B, torch.zeros(2, 3, 4))
        elif bad == "accumulate":
            coded_matmul(A, B, accumulate=True)
        else:
            coded_matmul(A, B, sign=2)


# -------------------------------------------------------------- poly encode

def _encode_blocks(W, K, R, C):
    """Pallas block shape for a sweep case: small blocks with masked
    remainders, wider for the long case so interpret mode stays quick."""
    return (64, 256) if C >= 512 else (32, 32)


def _encode_inputs(W, K, R, C, name, seed=0):
    rng = np.random.default_rng(seed)
    jg, tg = _pair(rng.standard_normal((W, K)), "float32")
    jx, tx = _pair(rng.standard_normal((K, R, C)), name)
    return (jg, tg), (jx, tx)


@pytest.mark.parametrize("W,K,R,C", ENCODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_poly_encode_plain_matches_pallas(W, K, R, C, dtype):
    (jg, tg), (jx, tx) = _encode_inputs(W, K, R, C, dtype)
    br, bc = _encode_blocks(W, K, R, C)
    want = poly_encode_pallas(jg, jx, br=br, bc=bc, interpret=True)
    got = poly_encode(tg, tx)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (W, R, C)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=_tol(dtype),
                               atol=_tol(dtype) * K)


@pytest.mark.parametrize("W,K,R,C", ENCODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_poly_encode_plain_matches_jnp_ref(W, K, R, C, dtype):
    (jg, tg), (jx, tx) = _encode_inputs(W, K, R, C, dtype, seed=1)
    np.testing.assert_allclose(_f32(plain_poly_encode(tg, tx)),
                               _f32(poly_encode_ref(jg, jx)),
                               rtol=_tol(dtype), atol=_tol(dtype) * K)


def test_poly_encode_is_the_paper_encoder():
    """Port encode == CDC code encode (MatDot generator), and == the
    reference Pallas kernel on the same blocks."""
    code = MatDotCode(4, 9, x_equal(9, 0.5))
    ref_code = RefMatDotCode(4, 9, ref_x_equal(9, 0.5))
    rng = np.random.default_rng(42)
    A = rng.standard_normal((32, 64))
    Ab, _ = ref_split_contraction(A, rng.standard_normal((64, 8)), 4)
    G_A, _ = code.generator()
    np.testing.assert_array_equal(G_A, ref_code.generator()[0])
    got = poly_encode(torch.tensor(G_A, dtype=torch.float32),
                      torch.tensor(Ab, dtype=torch.float32))
    want = np.einsum("nk,kij->nij", G_A, Ab)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    pallas = poly_encode_pallas(jnp.asarray(G_A, jnp.float32),
                                jnp.asarray(Ab, jnp.float32), br=16, bc=16,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)


def test_poly_encode_reads_strided_block_views():
    """Batched encode over split_contraction views (no copy) equals the
    encode of contiguous stacked blocks, request by request."""
    rng = np.random.default_rng(5)
    A = torch.tensor(rng.standard_normal((3, 6, 20)), dtype=torch.float32)
    B = torch.tensor(rng.standard_normal((3, 20, 7)), dtype=torch.float32)
    G = torch.tensor(rng.standard_normal((9, 4)), dtype=torch.float32)
    Ab, Bb = split_contraction(A, B, 4)
    assert Ab.shape == (3, 4, 6, 5) and Bb.shape == (3, 4, 5, 7)
    assert Ab.data_ptr() == A.data_ptr()          # a view, not a copy
    EA, EB = poly_encode(G, Ab), poly_encode(G, Bb)
    for r in range(3):
        ab, bb = ref_split_contraction(A[r].numpy(), B[r].numpy(), 4)
        torch.testing.assert_close(EA[r], poly_encode(G, torch.tensor(ab)))
        torch.testing.assert_close(EB[r], poly_encode(G, torch.tensor(bb)))


def test_poly_encode_parts_layout():
    """``parts=2`` over ``[G.real; G.imag]``: part p, request b, worker w
    is the encode with generator row ``p·W + w``."""
    rng = np.random.default_rng(6)
    X = torch.tensor(rng.standard_normal((2, 3, 4, 5)), dtype=torch.float32)
    G = torch.tensor(rng.standard_normal((10, 3)), dtype=torch.float32)
    E = poly_encode(G, X, parts=2)
    assert E.shape == (2, 2, 5, 4, 5)
    assert E[0].is_contiguous() and E[1].is_contiguous()
    torch.testing.assert_close(E[1], poly_encode(G[5:], X))
    torch.testing.assert_close(E[0], poly_encode(G[:5], X))


@pytest.mark.parametrize("bad", ["K", "ndim", "parts"])
def test_poly_encode_rejects_bad_arguments(bad):
    G, X = torch.zeros(4, 3), torch.zeros(3, 5, 6)
    with pytest.raises(ValueError):
        if bad == "K":
            poly_encode(torch.zeros(4, 2), X)
        elif bad == "ndim":
            poly_encode(G, torch.zeros(5, 6))
        else:
            poly_encode(G, X, parts=3)


# ----------------------------------------------------------- flash attention

FLASH_SHAPES = [(1, 2, 2, 64, 64, 16),          # MHA square
                (2, 4, 2, 64, 64, 32),          # GQA
                (1, 8, 1, 32, 32, 16),          # MQA
                (1, 2, 1, 16, 80, 16),          # decode suffix (Lq < Lkv)
                (1, 2, 2, 50, 70, 16)]          # non-divisible remainders


def _qkv_inputs(B, H, Hkv, Lq, Lkv, d, name, seed):
    rng = np.random.default_rng(seed)
    return (_pair(rng.standard_normal((B, H, Lq, d)), name),
            _pair(rng.standard_normal((B, Hkv, Lkv, d)), name),
            _pair(rng.standard_normal((B, Hkv, Lkv, d)), name))


@pytest.mark.parametrize("B,H,Hkv,Lq,Lkv,d", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_pallas(B, H, Hkv, Lq, Lkv, d, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv_inputs(B, H, Hkv, Lq, Lkv, d, dtype, 7)
    off = Lkv - Lq
    want = flash_attention_pallas(jq, jk, jv, q_offset=off, bq=16, bkv=16,
                                  interpret=True)
    got = flash_attention(tq, tk, tv, q_offset=off)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, H, Lq, d)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=_tol(dtype),
                               atol=_tol(dtype))


@pytest.mark.parametrize("B,H,Hkv,Lq,Lkv,d", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_jnp_ref(B, H, Hkv, Lq, Lkv, d, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv_inputs(B, H, Hkv, Lq, Lkv, d, dtype, 8)
    off = Lkv - Lq
    np.testing.assert_allclose(
        _f32(plain_attention(tq, tk, tv, q_offset=off)),
        _f32(attention_ref(jq, jk, jv, q_offset=off)), rtol=_tol(dtype),
        atol=_tol(dtype))


@pytest.mark.parametrize("window", [8, 24, 64])
def test_flash_plain_sliding_window_matches_pallas(window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv_inputs(1, 2, 2, 96, 96, 16,
                                               "float32", 9)
    want = flash_attention_pallas(jq, jk, jv, window=window, bq=16, bkv=16,
                                  interpret=True)
    got = flash_attention(tq, tk, tv, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_f32(got), _f32(attention_ref(
        jq, jk, jv, window=window)), rtol=2e-4, atol=2e-4)


def test_flash_plain_noncausal_matches_pallas():
    (jq, tq), (jk, tk), (jv, tv) = _qkv_inputs(1, 2, 2, 48, 48, 16,
                                               "float32", 10)
    want = flash_attention_pallas(jq, jk, jv, causal=False, bq=16, bkv=16,
                                  interpret=True)
    got = flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-4, atol=2e-4)


def test_flash_window_zero_is_full_attention_and_views_pass():
    """``window`` 0 and None both mean full attention (the model's per-layer
    convention), and the model's (B, L, H, d) → (B, H, L, d) views give the
    same answer as contiguous copies."""
    (_, tq), (_, tk), (_, tv) = _qkv_inputs(2, 4, 2, 20, 20, 16, "float32",
                                            11)
    full = flash_attention(tq, tk, tv)
    torch.testing.assert_close(flash_attention(tq, tk, tv, window=0), full)
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (tq, tk, tv))
    assert not qv.is_contiguous()
    torch.testing.assert_close(flash_attention(qv, kv, vv), full)
    # a fully masked row (query before every key) gives zeros, not NaN
    out = flash_attention(tq[:, :, :1], tk, tv, window=1, q_offset=30)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("bad", ["heads", "dim", "window", "offset", "ndim"])
def test_flash_rejects_bad_arguments(bad):
    q, k = torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError):
        if bad == "heads":
            flash_attention(q, torch.zeros(1, 3, 8, 16),
                            torch.zeros(1, 3, 8, 16))
        elif bad == "dim":
            flash_attention(q, torch.zeros(1, 2, 8, 32),
                            torch.zeros(1, 2, 8, 32))
        elif bad == "window":
            flash_attention(q, k, k, window=-1)
        elif bad == "offset":
            flash_attention(q, k, k, q_offset=-2)
        else:
            flash_attention(q[0], k, k)


# the head dims csrc/flash_attention.cu instantiates (FLASH_HEAD_DIMS; on
# the card the wrapper reads them from the library, and
# tests/test_torch_gpu.py holds the library to this list)
BUILT_HEAD_DIMS = (16, 32, 64, 128, 256)


@pytest.mark.parametrize("d", [18, 112])
def test_flash_padded_head_dim_matches_unpadded(d):
    """A head dim without a kernel instance runs the next one up on
    zero-padded operands with the true dim's scale (``run_padded``): with
    the plain version standing in for the kernel, the padded run equals
    the unpadded one, under GQA, a window and a query offset."""
    (_, tq), (_, tk), (_, tv) = _qkv_inputs(2, 8, 2, 37, 53, d, "float32",
                                            12)
    D = instance_dim(d, BUILT_HEAD_DIMS)
    seen = []

    def kernel(q, k, v, **kw):
        seen.append(tuple(q.shape))
        for t in (q, k, v):
            assert t.is_contiguous() and not t[..., d:].any()
        return plain_attention(q, k, v, **kw)

    for causal, window in ((True, None), (True, 16), (False, 24)):
        kw = {"causal": causal, "window": window, "q_offset": 16}
        got = run_padded(kernel, tq, tk, tv, BUILT_HEAD_DIMS, **kw)
        assert got.shape == (2, 8, 37, d)
        torch.testing.assert_close(got, plain_attention(tq, tk, tv, **kw),
                                   rtol=1e-6, atol=1e-6)
    assert seen == [(2, 8, 37, D)] * 3


def test_flash_instance_dims():
    """Each head dim up to 256 maps to the smallest built instance that
    holds it; a built dim maps to itself; above 256 raises, naming it."""
    assert [instance_dim(d, BUILT_HEAD_DIMS)
            for d in (1, 16, 18, 33, 64, 72, 112, 128, 200, 256)] == [
                16, 16, 32, 64, 64, 128, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="head dim 300"):
        instance_dim(300, BUILT_HEAD_DIMS)


# ----------------------------------------------------------------- ssm scan

SCAN_SHAPES = [(1, 32, 16, 4), (2, 48, 24, 16), (2, 100, 40, 8),
               (1, 33, 17, 16)]


def _scan_inputs(Bt, L, Dm, S, seed):
    """x, dt, A, B, C, D as in the reference's test, each as (jax, torch)."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((Bt, L, Dm)),
            rng.uniform(0.01, 0.2, (Bt, L, Dm)),
            -rng.uniform(0.1, 1.0, (Dm, S)),
            rng.standard_normal((Bt, L, S)),
            rng.standard_normal((Bt, L, S)),
            rng.standard_normal((Dm,)))
    return [_pair(a, "float32") for a in arrs]


@pytest.mark.parametrize("Bt,L,Dm,S", SCAN_SHAPES)
def test_ssm_scan_plain_matches_pallas(Bt, L, Dm, S):
    pairs = _scan_inputs(Bt, L, Dm, S, 12)
    want = ssm_scan_pallas(*(j for j, _ in pairs), bd=8, bl=16,
                           interpret=True)
    got = ssm_scan(*(t for _, t in pairs))
    assert got.dtype == torch.float32 and got.shape == (Bt, L, Dm)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("Bt,L,Dm,S", SCAN_SHAPES)
def test_ssm_scan_plain_final_state_matches_jnp_ref(Bt, L, Dm, S):
    pairs = _scan_inputs(Bt, L, Dm, S, 13)
    want_y, want_h = ssm_scan_ref(*(j for j, _ in pairs), return_final=True)
    y, h = ssm_scan(*(t for _, t in pairs), return_final=True)
    assert h.dtype == torch.float32 and h.shape == (Bt, Dm, S)
    np.testing.assert_allclose(_f32(y), _f32(want_y), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f32(h), _f32(want_h), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("r", [3, 7, 100])
def test_ssm_scan_takes_column_views_of_x_proj(r):
    """B and C as column slices of one (Bt, L, r + 2S) projection (the
    model's layout; hymba's dt_rank r is 100) give the same scan as
    contiguous copies."""
    x, dt, A, _, _, D = (t for _, t in _scan_inputs(2, 20, 12, 4, 14))
    xp = torch.randn(2, 20, r + 8, generator=torch.Generator().manual_seed(0))
    B, C = xp[..., r:r + 4], xp[..., r + 4:]
    assert B.stride(1) == r + 8 and not B.is_contiguous()
    y, h = ssm_scan(x, dt, A, B, C, D, return_final=True)
    y2, h2 = ssm_scan(x, dt, A, B.contiguous(), C.contiguous(), D,
                      return_final=True)
    torch.testing.assert_close(y, y2)
    torch.testing.assert_close(h, h2)


def test_scan_phase_clock_marks_fit_the_kernel_source():
    """``tools/scan_phase_clocks.py`` edits a copy of ``csrc/ssm_scan.cu``
    at fixed anchors: each must still appear once in the source, and every
    phase gets its mark."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "scan_phase_clocks.py"
    spec = importlib.util.spec_from_file_location("scan_phase_clocks", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.instrumented_source()
    for p in range(len(tool.PHASES)):
        assert f"SCAN_MARK({p})" in src
    assert "scan_phase_read" in src


@pytest.mark.parametrize("bad", ["A", "B", "D", "ndim"])
def test_ssm_scan_rejects_bad_shapes(bad):
    x = torch.zeros(2, 5, 6)
    A, B, D = torch.zeros(6, 4), torch.zeros(2, 5, 4), torch.zeros(6)
    with pytest.raises(ValueError):
        if bad == "A":
            ssm_scan(x, x, torch.zeros(5, 4), B, B, D)
        elif bad == "B":
            ssm_scan(x, x, A, torch.zeros(2, 5, 3), torch.zeros(2, 5, 3), D)
        elif bad == "D":
            ssm_scan(x, x, A, B, B, torch.zeros(5))
        else:
            ssm_scan(x[0], x[0], A, B, B, D)


@pytest.mark.parametrize("rc,error", [(_build.UNSUPPORTED, ValueError),
                                      (0, None)])
def test_launcher_codes_map_to_exceptions(rc, error):
    """A C entry's UNSUPPORTED (arguments no kernel instance takes: the
    sources alone know their tiling) raises ValueError; 0 passes."""
    if error is None:
        _build.check(None, rc, "flash_attention")
    else:
        with pytest.raises(error, match="flash_attention .head dim 48"):
            _build.check(None, rc, "flash_attention (head dim 48)")
