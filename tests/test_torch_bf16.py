"""bf16 worker products on the port's device backend, against the reference.

The same seeded numpy requests go through ``TorchDeviceBackend(dtype=
torch.bfloat16)`` on the CPU (the kernels' plain versions) and through the
reference's ``DeviceBackend(dtype=jnp.bfloat16, use_pallas=False)``.
Tolerances, with their reasons:

* products: the reference's bf16 kernel tolerance (``tests/
  test_kernels.py``), ``rtol`` 5e-2 and ``atol`` 5e-2·√Z with Z the
  contraction length of a worker product;
* served estimates: in bf16 an estimate need not be near ``C`` (an exact
  state's weights amplify the products' rounding), so each one is held to
  the bound its decode weights put on the product errors: with ``P̃`` the
  bf16 products and ``P`` the float64 oracle's,
  ``|‖est − C‖ − ‖β Σ w_j P_j − C‖| ≤ |β| Σ_j |w_j| ‖P̃_j − P_j‖``, plus
  the float64 decode's own rounding (1e-9 of ``‖C‖``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.serving import DeviceBackend as RefDeviceBackend
from repro.serving import MasterScheduler as RefScheduler
from repro.serving import ServeConfig as RefServeConfig
from repro_torch.convert import code_from_reference
from repro_torch.serving import (MasterScheduler, ServeConfig,
                                 SimulatedBackend, TorchDeviceBackend,
                                 make_backend)

BF16_RTOL = 5e-2
K, N = 4, 12


def _codes():
    return {
        "lsac_ortho": lambda: ref_core.LayerSACCode(K, N, base="ortho",
                                                    eps=6.25e-3),
        "matdot": lambda: ref_core.MatDotCode(K, N,
                                              ref_core.chebyshev_roots(N)),
        "gsac": lambda: ref_core.GroupSACCode(K, N, ref_core.x_complex(N, 0.1),
                                              [2, 2]),
    }


CODES = _codes()


def _requests(seed, n, rows=16, inner=64, cols=8):
    rng = np.random.default_rng(seed)
    return ([rng.standard_normal((rows, inner)) for _ in range(n)],
            [rng.standard_normal((inner, cols)) for _ in range(n)])


def _widened(P) -> np.ndarray:
    """Products of either package as float64 / complex128 numpy."""
    if isinstance(P, torch.Tensor):
        P = P.numpy() if P.is_complex() else P.double().numpy()
    P = np.asarray(P)
    return P.astype(np.complex128 if np.iscomplexobj(P) else np.float64)


@pytest.mark.parametrize("name", sorted(CODES))
@pytest.mark.parametrize("n_shards", [None, 7])
def test_bf16_products_match_reference(name, n_shards):
    """bf16 products of both packages on the same requests; real points
    come back bf16, complex points complex64 of the widened bf16 parts."""
    ref = CODES[name]()
    As, Bs = _requests(3, 2)
    want = RefDeviceBackend(dtype=jnp.bfloat16, use_pallas=False) \
        .compute_products(ref, As, Bs, n_shards)
    got = TorchDeviceBackend(device="cpu", dtype=torch.bfloat16) \
        .compute_products(code_from_reference(ref), As, Bs, n_shards)
    assert got.dtype == (torch.complex64 if np.iscomplexobj(want)
                         else torch.bfloat16)
    assert tuple(got.shape) == want.shape
    Z = As[0].shape[1] // K
    np.testing.assert_allclose(_widened(got), _widened(want),
                               rtol=BF16_RTOL, atol=BF16_RTOL * Z ** 0.5)


def test_compute_dtype_rules():
    """None and float32 are the float32 path; bfloat16 as a dtype or a
    name; anything else raises naming it."""
    for dt, want in ((None, torch.float32), ("float32", torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     ("bfloat16", torch.bfloat16),
                     ("torch.bfloat16", torch.bfloat16)):
        assert TorchDeviceBackend(device="cpu", dtype=dt).dtype == want
    for bad in (torch.float16, "float16", torch.float64):
        with pytest.raises(ValueError, match=str(bad).removeprefix("torch.")):
            TorchDeviceBackend(device="cpu", dtype=bad)
    be = make_backend("device", device="cpu", dtype="bfloat16")
    assert isinstance(be, TorchDeviceBackend) and be.dtype == torch.bfloat16


class _Keeping(TorchDeviceBackend):
    """The bf16 device backend, keeping each batch's products and latency
    row."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.kept, self.times = [], []

    def compute_products(self, *a, **kw):
        P = super().compute_products(*a, **kw)
        self.kept.append(P)
        return P

    def draw_latencies(self, rng, N):
        t = super().draw_latencies(rng, N)
        self.times.append(t)
        return t


def _weight_bound_ratio(code, results, As, Bs, kept, times, batch,
                        beta_mode="one") -> float:
    """The worst ratio of ``|‖est − C‖ − ‖est₆₄ − C‖|`` to its weight bound
    (module docstring) over every estimate the serve made."""
    worst = 0.0
    for res in results:
        i = res.batch - 1
        r = res.req_id - i * batch
        order = np.argsort(times[i], kind="stable")
        P = _widened(kept[i][r])
        P64 = _widened(SimulatedBackend(device="cpu").compute_products(
            code, [As[res.req_id]], [Bs[res.req_id]])[0])
        diff = np.linalg.norm(P - P64, axis=(-2, -1))
        C = As[res.req_id] @ Bs[res.req_id]
        c_norm = np.linalg.norm(C)
        for a in res.answers:
            if a.rel_err is None:
                continue
            w, info = code.estimate_weights(order[:a.m], a.m)
            beta = complex(code.beta(info, a.m, beta_mode, None))
            sel = order[:len(w)]
            est64 = (beta * np.tensordot(w, P64[sel], axes=1)).real
            err64 = np.linalg.norm(est64 - C)
            bound = abs(beta) * float(np.abs(w) @ diff[sel]) + 1e-9 * c_norm
            worst = max(worst, abs(np.sqrt(a.rel_err) * c_norm - err64)
                        / bound)
    return worst


@pytest.mark.parametrize("name", ["lsac_ortho", "gsac"])
def test_bf16_serve_matches_reference_within_weight_bound(name):
    """A short bf16 serve in both packages: the same answer stream (times,
    m, kinds), and every estimate of each package within its weight
    bound of the float64 estimate with the same weights."""
    ref = CODES[name]()
    code = code_from_reference(ref)
    As, Bs = _requests(11, 4)
    kw = dict(deadlines=(1.1, 1.6, 3.0), stream=True, batch_size=2, seed=5)
    port_be = _Keeping(device="cpu", dtype=torch.bfloat16,
                       straggler_frac=0.2)
    port = MasterScheduler(code, port_be, ServeConfig(**kw))
    ref_be = RefDeviceBackend(dtype=jnp.bfloat16, use_pallas=False,
                              straggler_frac=0.2)
    refs = RefScheduler(ref, ref_be, RefServeConfig(**kw))
    for A, B in zip(As, Bs):
        port.submit(A, B)
        refs.submit(A, B)
    got, want = port.run(), refs.run()
    assert len(port_be.kept) == 2
    assert [[(a.t, a.m, a.kind) for a in r.answers] for r in got] == \
        [[(a.t, a.m, a.kind) for a in r.answers] for r in want]
    for rg, rw in zip(got, want):
        assert [a.rel_err is None for a in rg.answers] == \
            [a.rel_err is None for a in rw.answers]
    assert _weight_bound_ratio(code, got, As, Bs, port_be.kept,
                               port_be.times, 2) <= 1.0
    # the reference's products on the same batches, with the same draws
    ref_kept = [ref_be.compute_products(ref, As[i:i + 2], Bs[i:i + 2])
                for i in (0, 2)]
    assert _weight_bound_ratio(code, want, As, Bs, ref_kept,
                               port_be.times, 2) <= 1.0
