"""The port's coded runtime (``repro_torch.runtime.coded``) against the
reference's ``repro.runtime.coded``, on the CPU.

Inputs are drawn with numpy from a seed and given to both packages.
Tolerances:

* decode weight vectors — equal (the same float64 numpy code);
* ``coded_contraction`` — 1e-5 relative Frobenius to the reference's for
  every dead count, below 1e-3 to ``h @ W`` (the reference's own limit);
  its autograd gradient within 1e-5 relative of the reference's ``jax.grad``
  and within the reference test's 1e-2 of the plain gradient;
* ``distributed_coded_matmul`` over 2 and 4 gloo ranks (one process each,
  ``FileStore`` rendezvous under ``tmp_path``) — below 1e-5 relative to
  ``A @ B`` (the reference's multi-device limit) and 1e-5 to the
  reference's on a one-device mesh, every rank's answer identical;
* ``decode_on_mesh`` — 1e-5 to the reference's, below 1e-3 to ``A @ B``.

Processes: each rank is a ``python -c`` child with a 60 s collective
time-out, waited for with a bound and killed in a ``finally``; one-rank
groups live in this process and are destroyed after each test.
"""
import datetime
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.compat import make_mesh
from repro.core import GroupSACCode as RefGroupSAC
from repro.core import MatDotCode as RefMatDot
from repro.core import chebyshev_roots as ref_cheb
from repro.runtime import coded as ref
from repro.serving import DeviceBackend as RefDeviceBackend
from repro.serving import IncrementalDecoder as RefDecoder
from repro_torch.core import GroupSACCode, MatDotCode, chebyshev_roots
from repro_torch.core.partition import split_contraction
from repro_torch.runtime import coded
from repro_torch.serving import IncrementalDecoder, TorchDeviceBackend

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------- decode weights

def test_decode_weight_vector_equals_reference():
    rng = np.random.default_rng(0)
    order = rng.permutation(10)
    got = coded.decode_weight_vector(
        MatDotCode(4, 10, chebyshev_roots(10)), order, 7)
    want = ref.decode_weight_vector(RefMatDot(4, 10, ref_cheb(10)), order, 7)
    np.testing.assert_array_equal(got, want)
    # stragglers get exactly zero
    w = coded.decode_weight_vector(MatDotCode(3, 8, chebyshev_roots(8)),
                                   np.arange(8), 5)
    assert np.all(w[5:] == 0)


def test_group_sac_weight_vectors_equal_reference_at_every_layer():
    mine = GroupSACCode(4, 10, chebyshev_roots(10) * 0.3, [2, 2])
    theirs = RefGroupSAC(4, 10, ref_cheb(10) * 0.3, [2, 2])
    order = np.arange(10)
    for m in [2, 4, 6, mine.recovery_threshold]:
        np.testing.assert_array_equal(
            coded.decode_weight_vector(mine, order, m),
            ref.decode_weight_vector(theirs, order, m))


@pytest.mark.parametrize("dead", [0, 1, 2, 3])
def test_exact_weight_vector_equals_reference(dead):
    rng = np.random.default_rng(dead)
    live = np.ones(8, bool)
    live[rng.choice(8, dead, replace=False)] = False
    np.testing.assert_array_equal(
        coded.exact_weight_vector(MatDotCode(3, 8, chebyshev_roots(8)), live),
        ref.exact_weight_vector(RefMatDot(3, 8, ref_cheb(8)), live))


def test_complex_weights_refused_like_the_reference():
    from repro_torch.core import x_complex
    code = MatDotCode(2, 5, x_complex(5, 1.0))
    with pytest.raises(ValueError, match="complex decode weights"):
        coded.decode_weight_vector(code, np.arange(5), 3)
    with pytest.raises(ValueError, match="real evaluation points"):
        coded.coded_generators(code)


# ------------------------------------------------------ coded contraction

def _contraction_case(T=32, F=128, d=16, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, F)).astype(np.float32)
    W = (rng.standard_normal((F, d)) / np.sqrt(F)).astype(np.float32)
    return h, W


def test_coded_contraction_matches_reference_and_plain_for_each_dead_count():
    K, N = 4, 8
    h, W = _contraction_case()
    code = MatDotCode(K, N, chebyshev_roots(N))
    G_A, G_B = coded.coded_generators(code)
    rG_A, rG_B = ref.coded_generators(RefMatDot(K, N, ref_cheb(N)))
    rng = np.random.default_rng(1)
    for dead in range(N - code.recovery_threshold + 1):
        live = np.ones(N, bool)
        live[rng.choice(N, dead, replace=False)] = False
        w = coded.exact_weight_vector(code, live)
        got = coded.coded_contraction(torch.from_numpy(h),
                                      torch.from_numpy(W), G_A, G_B,
                                      torch.as_tensor(w, dtype=torch.float32))
        want = ref.coded_contraction(jnp.asarray(h), jnp.asarray(W), rG_A,
                                     rG_B, jnp.asarray(w, jnp.float32))
        assert _rel(got, want) < TOL, dead
        assert _rel(got, h @ W) < 1e-3, dead
    plain = coded.coded_contraction_reference(torch.from_numpy(h),
                                              torch.from_numpy(W))
    np.testing.assert_array_equal(plain.numpy(), h @ W)


def test_coded_contraction_gradient_matches_reference():
    K, N = 4, 8
    h, W = _contraction_case(T=16, F=64, d=8, seed=2)
    code = MatDotCode(K, N, chebyshev_roots(N))
    w = coded.exact_weight_vector(code, np.ones(N, bool))
    G_A, G_B = coded.coded_generators(code)
    Wt = torch.from_numpy(W).requires_grad_(True)
    (coded.coded_contraction(torch.from_numpy(h), Wt, G_A, G_B,
                             torch.as_tensor(w, dtype=torch.float32)) ** 2
     ).sum().backward()
    rG_A, rG_B = ref.coded_generators(RefMatDot(K, N, ref_cheb(N)))
    g_ref = jax.grad(lambda W: (ref.coded_contraction(
        jnp.asarray(h), W, rG_A, rG_B, jnp.asarray(w, jnp.float32)) ** 2
    ).sum())(jnp.asarray(W))
    assert _rel(Wt.grad, g_ref) < TOL
    g_plain = 2 * h.T @ (h @ W)
    np.testing.assert_allclose(Wt.grad.numpy(), g_plain, rtol=1e-2,
                               atol=1e-2)


# ------------------------------------------------ distributed job path

def _job(K=3, N=8, seed=0):
    """The reference's multi-device case (tests/test_runtime.py): A 16x48,
    B 48x12, MatDot on Chebyshev points; float32 stacks and weights at m =
    R and m = N."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((16, 48))
    B = rng.standard_normal((48, 12))
    code = MatDotCode(K, N, chebyshev_roots(N))
    E_A, E_B = coded.encode_operands(code, *split_contraction(A, B, K))
    ws = {f"m{m}": coded.decode_weight_vector(code, np.arange(N), m)
          for m in (code.recovery_threshold, N)}
    return A, B, E_A.astype(np.float32), E_B.astype(np.float32), ws


def _ref_mesh_estimate(E_A, E_B, w):
    return np.asarray(ref.distributed_coded_matmul(
        jnp.asarray(E_A), jnp.asarray(E_B), jnp.asarray(w, jnp.float32),
        make_mesh((1,), ("model",)), axis="model", use_pallas=False))


RANK_SCRIPT = textwrap.dedent("""
    import datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.runtime.coded import distributed_coded_matmul
    rank, world, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(io + "/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        d = np.load(io + "/in.npz")
        E_A, E_B = torch.from_numpy(d["E_A"]), torch.from_numpy(d["E_B"])
        out = {k: distributed_coded_matmul(
                   E_A, E_B, torch.from_numpy(d[k].astype(np.float32))
               ).numpy() for k in d.files if k.startswith("m")}
        try:
            distributed_coded_matmul(E_A[:7], E_B[:7],
                                     torch.ones(7, dtype=torch.float32))
            out["refused"] = np.array("")
        except ValueError as e:
            out["refused"] = np.array(str(e))
        np.savez(io + f"/out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
""")


def _run_ranks(world: int, io: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = []
    try:
        for r in range(world):
            log = open(io / f"rank{r}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_SCRIPT, str(r), str(world),
                 str(io)], env=env, stdout=log, stderr=subprocess.STDOUT))
            log.close()
        rcs = [p.wait(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    logs = "".join((io / f"rank{r}.log").read_text()[-2000:]
                   for r in range(world))
    assert rcs == [0] * world, logs
    return [dict(np.load(io / f"out{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_coded_matmul_over_gloo_ranks(world, tmp_path):
    A, B, E_A, E_B, ws = _job()
    np.savez(tmp_path / "in.npz", E_A=E_A, E_B=E_B, **ws)
    outs = _run_ranks(world, tmp_path)
    for key, w in ws.items():
        want = _ref_mesh_estimate(E_A, E_B, w)
        for out in outs:
            np.testing.assert_array_equal(out[key], outs[0][key])
            assert _rel(out[key], A @ B) < TOL, key
            assert _rel(out[key], want) < TOL, key
    for out in outs:                         # 7 workers tile neither size
        assert f"N=7 workers must tile the process group({world})" in \
            str(out["refused"])


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process, destroyed after the test."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_distributed_coded_matmul_one_rank_matches_reference_mesh(world1):
    A, B, E_A, E_B, ws = _job(seed=3)
    for w in ws.values():
        got = coded.distributed_coded_matmul(
            torch.from_numpy(E_A), torch.from_numpy(E_B),
            torch.as_tensor(w, dtype=torch.float32))
        assert _rel(got, _ref_mesh_estimate(E_A, E_B, w)) < TOL
        assert _rel(got, A @ B) < TOL


def test_decode_on_mesh_matches_reference(world1):
    """The case of tests/test_serving.py's decode_on_mesh test: MatDot
    (3, 8) on Chebyshev points, every worker pushed to an incremental
    decoder, its weight vector decoded on the job path."""
    code = MatDotCode(3, 8, chebyshev_roots(8))
    ref_code = RefMatDot(3, 8, ref_cheb(8))
    rng = np.random.default_rng(5)
    A = rng.standard_normal((16, 48))
    B = rng.standard_normal((48, 12))
    P = code.run_workers(A, B)
    dec, ref_dec = IncrementalDecoder(code), RefDecoder(ref_code)
    for n in range(8):
        dec.push(n, torch.from_numpy(P[n]))
        ref_dec.push(n, P[n])
    w = dec.weight_vector()
    np.testing.assert_allclose(w, ref_dec.weight_vector(), rtol=1e-10,
                               atol=1e-12)
    got = TorchDeviceBackend(device="cpu").decode_on_mesh(code, A, B, w)
    want = RefDeviceBackend.decode_on_mesh(
        ref_code, A, B, ref_dec.weight_vector(), make_mesh((1,), ("model",)),
        use_pallas=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 12)
    assert _rel(got, want) < TOL
    assert _rel(got, A @ B) < 1e-3
    with pytest.raises(ValueError, match="complex decode weights"):
        TorchDeviceBackend(device="cpu").decode_on_mesh(
            code, A, B, w.astype(np.complex128))


def test_distributed_coded_matmul_needs_a_process_group():
    _, _, E_A, E_B, ws = _job()
    if dist.is_initialized():
        pytest.fail("a process group leaked from another test")
    with pytest.raises((RuntimeError, ValueError)):
        coded.distributed_coded_matmul(
            torch.from_numpy(E_A), torch.from_numpy(E_B),
            torch.as_tensor(ws["m5"], dtype=torch.float32))
