"""CUDA kernels of the port against their plain versions, on the card.

The kernels have no CPU mode: every test here carries the ``gpu`` marker
and skips without a CUDA card.  The file imports nothing of JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's ``_tol`` (float32 2e-4, bfloat16 5e-2, atol
scaled by the contraction length), over the shape sweeps of
``tests/test_kernels.py`` including the non-divisible shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import split_contraction
from repro_torch.kernels import (coded_matmul, poly_encode, worker_products,
                                 worker_products_complex)
from repro_torch.kernels.coded_matmul.ref import (coded_matmul_complex_ref,
                                                  coded_matmul_ref)
from repro_torch.kernels.poly_encode.ref import poly_encode_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
MATMUL_SHAPES = [(1, 64, 64, 64), (3, 100, 200, 60), (2, 96, 200, 64),
                 (4, 33, 77, 129), (1, 128, 1024, 128)]
ENCODE_SHAPES = [(24, 8, 100, 1000), (5, 3, 70, 33), (2, 1, 16, 16),
                 (7, 11, 129, 65)]

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
