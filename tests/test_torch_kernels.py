"""Port kernels: plain versions against the reference Pallas kernels and jnp
oracles, and the CUDA kernels against their plain versions.

Inputs are drawn with numpy from a seed and handed to both packages (bf16
inputs are rounded once, by jax, and passed on exactly).  The reference
kernels run as the reference's own tests run them on the CPU: Pallas in
``interpret=True``.  Tolerances are the reference's ``_tol`` (float32 2e-4,
bfloat16 5e-2, atol scaled by the contraction length), over the shape
sweeps of ``tests/test_kernels.py`` including the non-divisible shapes.

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
from repro.kernels.poly_encode.kernel import poly_encode_pallas
from repro.kernels.poly_encode.ref import poly_encode_ref
from repro_torch.core import MatDotCode, split_contraction, x_equal
from repro_torch.kernels import (coded_matmul, poly_encode, worker_products,
                                 worker_products_complex)
from repro_torch.kernels.coded_matmul.ref import \
    coded_matmul_ref as plain_coded_matmul
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
