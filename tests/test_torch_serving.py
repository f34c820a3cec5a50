"""Port serving against the reference: backends, decoders, scheduler, slice.

Everything here runs the port on the CPU (``device="cpu"``), where the
kernel wrappers take their plain versions; the same seeded numpy inputs go
through the reference.  Tolerances, with their reasons:

* products of the float32 device path: ≤1e-4 relative, as the reference
  pins its own device backend against the simulated one;
* the on-device float32 encode against the reference's host float64
  encode: ≤1e-6 relative (float32 rounding of operands and sum);
* decoders on float64 products: ≤1e-10 relative against ``code.decode``,
  widened by the worst-case rounding of the weighted sum (``2·p·ε·Σ|w_i|
  ‖P_i‖``) where ill-conditioned weights make two summation orders differ
  by more; inside the port the incremental resolve path is bit-identical to
  the recompute decoder;
* whole serve runs: identical report keys, answer times, ``m``, kinds and
  cache traffic; the squared relative errors agree as stated per test
  (numpy and torch sum in different orders, and ill-conditioned decodes
  amplify that rounding).
"""
import json

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import CODE_NAMES
from repro.launch import serve as ref_serve
from repro.serving import DeviceBackend as RefDeviceBackend
from repro.serving import SimulatedBackend as RefSimulatedBackend
from repro_torch.convert import code_from_reference
from repro_torch.launch import serve as port_serve
from repro_torch.serving import (DecodeWeightCache, IncrementalDecoder,
                                 MasterScheduler, RecomputeDecoder,
                                 ServeConfig, SimulatedBackend,
                                 TorchDeviceBackend, make_backend,
                                 make_decoder, serve_request)

K, N = 8, 24
CPU = torch.device("cpu")


def _registry_code(name, K=4, N=12):
    pts = {"matdot": ref_core.chebyshev_roots(N),
           "eps_matdot": ref_core.x_complex(N, 0.1),
           "group_sac": ref_core.x_complex(N, 0.1)}.get(name)
    kw = {"group_sizes": [2, 2]} if name == "group_sac" else {}
    return ref_core.make_code(name, K, N, eval_points=pts, **kw)


def serving_code_matrix():
    xc = ref_core.x_complex(N, 0.1)
    return {
        "matdot": ref_core.MatDotCode(K, N, xc),
        "eps_matdot": ref_core.EpsApproxMatDotCode(K, N, xc),
        "gsac_5_3": ref_core.GroupSACCode(K, N, xc, [5, 3]),
        "gsac_4_4": ref_core.GroupSACCode(K, N, xc, [4, 4],
                                          rng=np.random.default_rng(3)),
        "lsac_ortho": ref_core.LayerSACCode(K, N, base="ortho", eps=6.25e-3),
        "lsac_lagrange": ref_core.LayerSACCode(K, N, base="lagrange",
                                               eps=3.33e-2),
    }


def _requests(rng, n, rows=16, inner=32, cols=8):
    return ([rng.standard_normal((rows, inner)) for _ in range(n)],
            [rng.standard_normal((inner, cols)) for _ in range(n)])


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------- backends

@pytest.mark.parametrize("name", CODE_NAMES)
@pytest.mark.parametrize("n_shards", [None, 10])
def test_device_backend_products_match_reference(name, n_shards):
    """Port device products (plain kernels on CPU) against the reference
    DeviceBackend (jnp) and SimulatedBackend, real and complex points."""
    ref = _registry_code(name)
    code = code_from_reference(ref)
    As, Bs = _requests(np.random.default_rng(3), 2)
    sim = RefSimulatedBackend().compute_products(ref, As, Bs, n_shards)
    dev = RefDeviceBackend(use_pallas=False).compute_products(ref, As, Bs,
                                                              n_shards)
    got = TorchDeviceBackend(device="cpu").compute_products(code, As, Bs,
                                                            n_shards)
    assert tuple(got.shape) == sim.shape
    assert got.is_complex() == np.iscomplexobj(sim)
    got = got.numpy()
    assert _rel(got, sim) < 1e-4
    assert _rel(got, dev) < 1e-4


@pytest.mark.parametrize("name", CODE_NAMES)
def test_simulated_backend_is_the_reference_oracle(name):
    """The port's host backend is the reference's numpy path: bit-equal."""
    ref = _registry_code(name)
    code = code_from_reference(ref)
    As, Bs = _requests(np.random.default_rng(4), 3)
    want = RefSimulatedBackend().compute_products(ref, As, Bs)
    got = SimulatedBackend(device="cpu").compute_products(code, As, Bs)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["matdot", "group_sac", "layer_sac_ortho",
                                  "lagrange"])
@pytest.mark.parametrize("n_shards", [None, 9])
def test_device_encode_matches_reference_encode_batch(name, n_shards):
    """The on-device encode (poly_encode over strided views, one launch
    per operand, ``[G.real; G.imag]`` for complex points) against the
    reference's host float64 ``_encode_batch``."""
    ref = _registry_code(name)
    code = code_from_reference(ref)
    As, Bs = _requests(np.random.default_rng(5), 3, rows=12, inner=40,
                       cols=6)
    want_A, want_B = RefSimulatedBackend._encode_batch(ref, As, Bs, n_shards)
    (ea, ea_im), (eb, eb_im) = TorchDeviceBackend._encode_batch(
        code, [torch.tensor(A) for A in As], [torch.tensor(B) for B in Bs],
        n_shards)
    assert (ea_im is not None) == np.iscomplexobj(want_A)
    for re, im, want in ((ea, ea_im, want_A), (eb, eb_im, want_B)):
        got = re.double().numpy()
        if im is not None:
            got = got + 1j * im.double().numpy()
        assert got.shape == want.shape
        assert _rel(got, want) < 1e-6


def test_device_backend_rejects_bad_n_shards():
    code = code_from_reference(_registry_code("matdot"))
    As, Bs = _requests(np.random.default_rng(0), 1)
    with pytest.raises(ValueError, match="n_shards"):
        TorchDeviceBackend(device="cpu").compute_products(code, As, Bs, 13)


def test_device_backend_draws_reference_latencies():
    ref = RefDeviceBackend(straggler_frac=0.2)
    port = TorchDeviceBackend(device="cpu", straggler_frac=0.2)
    np.testing.assert_array_equal(
        port.draw_latencies(np.random.default_rng(9), 24),
        ref.draw_latencies(np.random.default_rng(9), 24))


def test_make_backend_names():
    assert isinstance(make_backend("sim", device="cpu"), SimulatedBackend)
    assert isinstance(make_backend("device", device="cpu"),
                      TorchDeviceBackend)
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        make_backend("tpu")


# ------------------------------------------------------------- decoders

def _port_products(ref, A, B):
    """Reference float64 worker products, as a CPU tensor."""
    return torch.from_numpy(ref.run_workers(A, B))


def _decode_tol(ref, order, m, P_np, want, beta_mode="one", oracle=None):
    """1e-10 relative, plus the rounding bound of the decode's weighted sum
    (numpy and torch sum its terms in different orders)."""
    w, info = ref.estimate_weights(np.asarray(order)[:m], m)
    beta = abs(ref.beta(info, m, beta_mode, oracle))
    terms = sum(abs(wi) * np.linalg.norm(P_np[n])
                for wi, n in zip(w, np.asarray(order)[:len(w)]))
    eps = np.finfo(np.float64).eps
    return 1e-10 + 2 * len(w) * eps * beta * terms / np.linalg.norm(want)


def _traces(code, rng):
    out = [ref_core.simulate_completion(rng, code.N, model="uniform"),
           ref_core.simulate_completion(rng, code.N, model="shifted_exp",
                                        straggler_frac=0.3)]
    out.append(ref_core.CompletionTrace(order=np.arange(code.N)[::-1],
                                        times=None))
    return out


@pytest.mark.parametrize("name", list(serving_code_matrix()))
@pytest.mark.parametrize("kind", ["incremental", "recompute"])
def test_decoder_matches_reference_decode(name, kind):
    """≤1e-10 relative (plus the weighted sum's rounding bound) against
    the reference ``code.decode`` on every (code, m) state, straggler-heavy
    orders included."""
    ref = serving_code_matrix()[name]
    code = code_from_reference(ref)
    rng = np.random.default_rng(0)
    A, B = rng.standard_normal((20, 160)), rng.standard_normal((160, 20))
    P_np = ref.run_workers(A, B)
    P = torch.from_numpy(P_np)
    for trace in _traces(ref, rng):
        dec = make_decoder(kind, code)
        for m in range(1, ref.N + 1):
            w = int(trace.order[m - 1])
            dec.push(w, P[w])
            got = dec.estimate()
            want = ref.decode(P_np, trace.order, m)
            assert (got is None) == (want is None), (name, m)
            if want is not None:
                assert got.dtype == torch.float64
                tol = _decode_tol(ref, trace.order, m, P_np, want)
                assert _rel(got.numpy(), want) <= tol, (name, m)


@pytest.mark.parametrize("name", list(serving_code_matrix()))
def test_incremental_resolve_bit_identical_to_recompute(name):
    """Inside the port, every resolve-path estimate equals the recompute
    decoder's bit for bit (same weights, same torch recombine)."""
    ref = serving_code_matrix()[name]
    code = code_from_reference(ref)
    rng = np.random.default_rng(1)
    P = _port_products(ref, rng.standard_normal((12, 80)),
                       rng.standard_normal((80, 12)))
    order = rng.permutation(code.N)
    inc, rec = IncrementalDecoder(code), RecomputeDecoder(code)
    resolved = 0
    for m in range(1, code.N + 1):
        w = int(order[m - 1])
        inc.push(w, P[w])
        rec.push(w, P[w])
        before = inc.stats["resolve"]
        got = inc.estimate()
        if inc.stats["resolve"] > before:
            resolved += 1
            assert torch.equal(got, rec.estimate()), (name, m)
    assert resolved >= 1


def test_incremental_with_beta_modes_matches_reference():
    rng = np.random.default_rng(1)
    A, B = rng.standard_normal((24, 240)), rng.standard_normal((240, 24))
    cases = [(ref_core.GroupSACCode(K, N, ref_core.x_complex(N, 0.1),
                                    [5, 3]), "unbiased"),
             (ref_core.LayerSACCode(K, N, base="ortho", eps=6.25e-3),
              "oracle")]
    for ref, beta_mode in cases:
        code = code_from_reference(ref)
        Ab, Bb = ref_core.split_contraction(A, B, ref.K)
        oracle = ref.oracle_context(Ab, Bb)
        P_np = ref.run_workers(A, B)
        trace = ref_core.simulate_completion(rng, ref.N, model="shifted_exp",
                                             straggler_frac=0.25)
        dec = IncrementalDecoder(code, beta_mode=beta_mode, oracle=oracle)
        for m in range(1, ref.N + 1):
            w = int(trace.order[m - 1])
            dec.push(w, torch.from_numpy(P_np[w]))
            got = dec.estimate()
            want = ref.decode(P_np, trace.order, m, beta_mode, oracle)
            assert (got is None) == (want is None)
            if want is not None:
                tol = _decode_tol(ref, trace.order, m, P_np, want, beta_mode,
                                  oracle)
                assert _rel(got.numpy(), want) <= tol


def test_incremental_update_mode_accounting():
    rng = np.random.default_rng(2)
    A, B = rng.standard_normal((16, 160)), rng.standard_normal((160, 16))
    lsac = code_from_reference(
        ref_core.LayerSACCode(K, N, base="ortho", eps=6.25e-3))
    P = torch.from_numpy(lsac.run_workers(A, B))
    dec = IncrementalDecoder(lsac)
    for m in range(1, N + 1):
        dec.push(m - 1, P[m - 1])
        dec.estimate()
    R = lsac.recovery_threshold
    assert dec.stats["rank1"] == R - 1
    assert dec.stats["resolve"] == 1
    assert dec.stats["reuse"] == N - R


def test_decoder_state_stays_on_the_product_device_and_type():
    code = code_from_reference(_registry_code("group_sac"))
    P = torch.from_numpy(code.run_workers(
        np.random.default_rng(0).standard_normal((6, 16)),
        np.random.default_rng(1).standard_normal((16, 5)))).to(
            torch.complex64)
    dec = IncrementalDecoder(code)
    for n in range(code.N):
        dec.push(n, P[n])
    assert dec._buf.dtype == torch.complex128 and dec._buf.device == CPU
    est = dec.estimate()
    assert est.dtype == torch.float64 and tuple(est.shape) == (6, 5)


def test_incremental_weight_vector_matches_reference_decoder():
    from repro.serving import IncrementalDecoder as RefIncremental
    ref = ref_core.LayerSACCode(4, 12, base="ortho", eps=1e-2)
    code = code_from_reference(ref)
    rng = np.random.default_rng(3)
    P_np = ref.run_workers(rng.standard_normal((8, 16)),
                           rng.standard_normal((16, 8)))
    order = rng.permutation(12)
    a, b = IncrementalDecoder(code), RefIncremental(ref)
    for m in range(1, 13):
        w = int(order[m - 1])
        a.push(w, torch.from_numpy(P_np[w]))
        b.push(w, P_np[w])
        np.testing.assert_allclose(a.weight_vector(), b.weight_vector(),
                                   rtol=1e-12, atol=1e-12)


def test_decoder_push_is_idempotent_per_worker():
    code = code_from_reference(ref_core.LayerSACCode(2, 8, base="ortho",
                                                     eps=6.25e-3))
    rng = np.random.default_rng(6)
    A, B = rng.standard_normal((8, 16)), rng.standard_normal((16, 8))
    P = torch.from_numpy(code.run_workers(A, B))
    for kind in ("incremental", "recompute"):
        dec = make_decoder(kind, code)
        for n in range(code.first_threshold):
            dec.push(n, P[n])
        before = dec.estimate().clone()
        dec.push(0, P[0])
        assert dec.stats["dup_ignored"] == 1
        assert torch.equal(dec.estimate(), before)
        for n in range(code.first_threshold, code.N):
            dec.push(n, P[n])
        est = dec.estimate().numpy()
        assert _rel(est, A @ B) < 1e-10
    with pytest.raises(ValueError):
        make_decoder("magic", code)


# ----------------------------------------------------------------- cache

def test_decode_weight_cache_hits_and_eviction():
    code = code_from_reference(ref_core.MatDotCode(
        4, 10, ref_core.chebyshev_roots(10)))
    rng = np.random.default_rng(7)
    P = torch.from_numpy(code.run_workers(rng.standard_normal((12, 32)),
                                          rng.standard_normal((32, 8))))
    cache = DecodeWeightCache(maxsize=2)
    dec1 = IncrementalDecoder(code, cache=cache)
    for n in range(10):
        dec1.push(n, P[n])
    est1 = dec1.estimate()
    assert (cache.misses, cache.hits) == (1, 0)
    perm = np.concatenate([np.random.default_rng(5).permutation(7),
                           [7, 8, 9]])
    dec2 = IncrementalDecoder(code, cache=cache)
    for n in perm:
        dec2.push(int(n), P[n])
    est2 = dec2.estimate()
    assert cache.hits == 1 and dec2.stats["cache_hit"] == 1
    assert _rel(est2.numpy(), est1.numpy()) <= 1e-8
    for key in [("a",), ("b",), ("c",)]:
        cache.put(key, (np.zeros(1), None))
    assert len(cache) == 2 and cache.get(("a",)) is None
    assert cache.stats()["size"] == 2 and isinstance(cache.hits, int)


def test_cache_key_matches_reference():
    from repro.serving import DecodeWeightCache as RefCache
    ref = ref_core.MatDotCode(3, 8, ref_core.chebyshev_roots(8))
    code = code_from_reference(ref)
    done = np.array([4, 2, 0, 1, 3])
    assert DecodeWeightCache.key(code, done, 5, "one") == \
        RefCache.key(ref, done, 5, "one")


# ------------------------------------------------------------- scheduler

def _run_sched(decoder, backend, seed=9, stream=False,
               deadlines=(1.1, 1.5, 2.0, 3.0), package="port"):
    ref = ref_core.GroupSACCode(K, N, ref_core.x_complex(N, 0.1), [5, 3])
    rng = np.random.default_rng(seed)
    reqs = [(rng.standard_normal((16, 80)), rng.standard_normal((80, 16)))
            for _ in range(5)]
    if package == "ref":
        from repro.serving import MasterScheduler as RefScheduler
        from repro.serving import ServeConfig as RefConfig
        cfg = RefConfig(deadlines=deadlines, stream=stream, batch_size=3,
                        decoder=decoder, seed=seed)
        sched = RefScheduler(ref, RefSimulatedBackend(straggler_frac=0.2),
                             cfg)
    else:
        cfg = ServeConfig(deadlines=deadlines, stream=stream, batch_size=3,
                          decoder=decoder, seed=seed)
        sched = MasterScheduler(code_from_reference(ref), backend, cfg)
    for A, B in reqs:
        sched.submit(A, B)
    return sched.run()


def test_scheduler_deterministic_and_matches_recompute_baseline():
    sim = SimulatedBackend(straggler_frac=0.2, device="cpu")
    a = _run_sched("incremental", sim)
    b = _run_sched("incremental", sim)
    c = _run_sched("recompute", sim)
    assert len(a) == len(b) == len(c) == 5
    for ra, rb, rc in zip(a, b, c):
        for x, y, z in zip(ra.answers, rb.answers, rc.answers):
            assert (x.t, x.m, x.rel_err) == (y.t, y.m, y.rel_err)
            assert x.m == z.m and x.exact == z.exact
            if z.rel_err is None:
                assert x.rel_err is None
            else:
                assert abs(x.rel_err - z.rel_err) <= 1e-10 * max(z.rel_err,
                                                                 1e-12)


def test_scheduler_matches_reference_scheduler():
    """Same requests, same latency draws: same answer stream."""
    port = _run_sched("incremental", SimulatedBackend(straggler_frac=0.2,
                                                      device="cpu"),
                      stream=True)
    ref = _run_sched("incremental", None, stream=True, package="ref")
    for rp, rr in zip(port, ref):
        assert (rp.req_id, rp.ttfa, rp.t_exact) == \
            (rr.req_id, rr.ttfa, rr.t_exact)
        assert [(a.t, a.m, a.exact, a.kind) for a in rp.answers] == \
            [(a.t, a.m, a.exact, a.kind) for a in rr.answers]
        for a, b in zip(rp.answers, rr.answers):
            assert (a.rel_err is None) == (b.rel_err is None)
            if b.rel_err is not None and a.m < 13:   # below the ill-
                # conditioned second-group fit of G-SAC [5, 3]
                assert abs(a.rel_err - b.rel_err) <= 1e-10 * b.rel_err


def test_scheduler_stream_answers_and_thresholds():
    results = _run_sched("incremental",
                         SimulatedBackend(straggler_frac=0.2, device="cpu"),
                         stream=True)
    for res in results:
        events = [a for a in res.answers if a.kind == "event"]
        assert len(events) == N
        assert [a.m for a in events] == sorted(a.m for a in events)
        first = next(a for a in events if a.rel_err is not None)
        assert first.m == 5 and res.ttfa == pytest.approx(first.t)
        exact = next(a for a in events if a.exact)
        assert exact.m == 15 and res.t_exact == pytest.approx(exact.t)


def test_scheduler_batching_shares_solves():
    results = _run_sched("incremental",
                         SimulatedBackend(straggler_frac=0.2, device="cpu"))
    assert sum(r.decode_stats["cache_hit"] for r in results) > 0
    assert all(len(r.answers) == 4 for r in results)
    assert [r.batch for r in results] == [1, 1, 1, 2, 2]


def test_scheduler_mixed_shapes_and_submit_validation():
    code = code_from_reference(ref_core.MatDotCode(
        4, 12, ref_core.chebyshev_roots(12)))
    sched = MasterScheduler(code, SimulatedBackend(device="cpu"),
                            ServeConfig(deadlines=(2.0, 4.0), batch_size=4,
                                        seed=1))
    rng = np.random.default_rng(6)
    for nx, nz in [(8, 16), (8, 16), (12, 32), (8, 16)]:
        sched.submit(rng.standard_normal((nx, nz)),
                     rng.standard_normal((nz, nx)))
    assert sched.pending == 4
    results = sched.run()
    assert [r.req_id for r in results] == [0, 1, 2, 3]
    assert all(len(r.answers) == 2 for r in results)
    with pytest.raises(ValueError, match="divisible by K"):
        sched.submit(rng.standard_normal((8, 18)),
                     rng.standard_normal((18, 8)))
    with pytest.raises(ValueError, match="matching inner dim"):
        sched.submit(rng.standard_normal((8, 16)),
                     rng.standard_normal((20, 8)))
    with pytest.raises(ValueError, match="batch_size"):
        MasterScheduler(code, SimulatedBackend(device="cpu"),
                        ServeConfig(batch_size=0))


def test_scheduler_keeps_operands_on_the_backend_device():
    code = code_from_reference(_registry_code("layer_sac_ortho"))
    sched = MasterScheduler(code, TorchDeviceBackend(device="cpu"))
    sched.submit(np.ones((4, 8)), np.ones((8, 4)))
    req = sched._queue[0]
    assert req.A.device == CPU and req.A.dtype == torch.float64


def test_serve_request_matches_reference_legacy_shape():
    from repro.serving import serve_request as ref_serve_request
    ref = ref_core.GroupSACCode(K, N, ref_core.x_complex(N, 0.1), [5, 3])
    rng = np.random.default_rng(1)
    A, B = rng.standard_normal((16, 80)), rng.standard_normal((80, 16))
    got = serve_request(code_from_reference(ref), A, B,
                        np.random.default_rng(2), deadlines=[0.5, 1.5, 3.0],
                        straggler_frac=0.2, device="cpu")
    want = ref_serve_request(ref, A, B, np.random.default_rng(2),
                             deadlines=[0.5, 1.5, 3.0], straggler_frac=0.2)
    assert [(t, m) for t, m, _ in got] == [(t, m) for t, m, _ in want]
    assert got[0][2] is None


# ----------------------------------------------------------------- slice

def _serve_pair(backend, code, extra=()):
    argv = ["--rows", "32", "--inner", "256", "--requests", "4",
            "--backend", backend, "--code", code, *extra]
    ref = ref_serve.run_serve(ref_serve.build_parser().parse_args(argv))
    port = port_serve.run_serve(port_serve.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    return ref.to_dict(), port.to_dict()


def _assert_same_report_shape(ref, port):
    assert set(port) == set(ref)
    assert set(port["config"]) == set(ref["config"]) | {"device"}
    for k in ref["config"]:
        if k != "backend":
            assert port["config"][k] == ref["config"][k], k
    assert port["code"] == ref["code"]
    assert port["cache"] == ref["cache"]
    for k in ("autotune", "cluster", "observability"):
        assert port[k] is None
    assert set(port["summary"]) == set(ref["summary"])
    assert port["summary"]["requests"] == ref["summary"]["requests"]
    assert port["summary"]["mean_ttfa"] == ref["summary"]["mean_ttfa"]
    assert [(d["deadline"], d["answers"]) for d in
            port["summary"]["deadlines"]] == \
        [(d["deadline"], d["answers"]) for d in ref["summary"]["deadlines"]]
    for rr, rp in zip(ref["requests"], port["requests"], strict=True):
        assert set(rp) == set(rr)
        for k in ("req_id", "batch", "ttfa", "t_exact"):
            assert rp[k] == rr[k], k
        assert [(a["t"], a["m"], a["kind"], a["rel_err"] is None)
                for a in rp["answers"]] == \
            [(a["t"], a["m"], a["kind"], a["rel_err"] is None)
             for a in rr["answers"]]


def _answer_pairs(ref, port):
    for rr, rp in zip(ref["requests"], port["requests"]):
        for a, b in zip(rr["answers"], rp["answers"]):
            if a["rel_err"] is not None:
                yield a["m"], a["rel_err"], b["rel_err"]


@pytest.mark.parametrize("code", ["lsac_ortho", "lsac_lagrange",
                                  "gsac_k1_5", "eps_matdot", "matdot"])
def test_slice_sim_report_matches_reference(code):
    """``--backend sim``: the same report, answer for answer.  The two
    estimates of C agree to 1e-4·‖C‖ (|√e_port − √e_ref|): both decode
    bit-equal float64 products with bit-equal weights and differ only in
    the recombine's and the norm's summation order, which the monomial
    codes' ill-conditioned exact fits amplify; the well-conditioned L-SAC
    approximate layers agree to 1e-10 relative."""
    ref, port = _serve_pair("sim", code, ["--stream"])
    _assert_same_report_shape(ref, port)
    R = ref["code"]["R"]
    for m, e_ref, e_port in _answer_pairs(ref, port):
        assert abs(np.sqrt(e_port) - np.sqrt(e_ref)) <= 1e-4
        if code.startswith("lsac") and m < R:
            assert abs(e_port - e_ref) <= 1e-10 * e_ref


def test_slice_device_report_matches_reference_lsac_ortho():
    """``--backend device`` on L-SAC (ortho): identical (t, m) per answer;
    float32 products encoded on the device (port) vs on the host in
    float64 (reference) give estimates that agree to 1e-5·‖C‖, and to 1e-6
    relative on the approximate layers."""
    ref, port = _serve_pair("device", "lsac_ortho", ["--stream"])
    _assert_same_report_shape(ref, port)
    R = ref["code"]["R"]
    for m, e_ref, e_port in _answer_pairs(ref, port):
        assert abs(np.sqrt(e_port) - np.sqrt(e_ref)) <= 1e-5
        if m < R:
            assert abs(e_port - e_ref) <= 1e-6 * e_ref


def test_slice_device_gsac_blows_up_like_the_reference():
    """The complex-point monomial code's exact state amplifies float32
    rounding past use in both packages (a reference property, not a port
    fault); the approximate first-group layers still agree."""
    ref, port = _serve_pair("device", "gsac_k1_5", ["--stream"])
    _assert_same_report_shape(ref, port)
    for m, e_ref, e_port in _answer_pairs(ref, port):
        if m < 13:
            assert abs(np.sqrt(e_port) - np.sqrt(e_ref)) <= 1e-3
        if m >= 15:
            assert e_ref > 1.0 and e_port > 1.0


def test_cli_json_and_text(capsys):
    port_serve.main(["--device", "cpu", "--rows", "16", "--inner", "64",
                     "--requests", "2", "--code", "lsac_ortho", "--json"])
    rep = port_serve.ServeReport.from_json(capsys.readouterr().out)
    assert rep.summary["requests"] == 2 and rep.config["device"] == "cpu"
    assert port_serve.ServeReport.from_dict(rep.to_dict()) == rep
    port_serve.main(["--device", "cpu", "--backend", "sim", "--rows", "16",
                     "--inner", "64", "--requests", "2"])
    out = capsys.readouterr().out
    assert out.startswith("[serve] config ")
    assert json.loads(out.splitlines()[0][len("[serve] config "):])[
        "backend"] == "sim"
    assert "[serve] req 1:" in out and "requests in" in out


@pytest.mark.parametrize("argv,flag", [
    (["--inner", "100", "--K", "8"], "--inner"),
    (["--batch-size", "0"], "--batch-size"),
    (["--code", "gsac_k1_5", "--K", "4"], "gsac_auto"),
    (["--code", "lsac_ortho", "--N", "20"], "K | N"),
])
def test_cli_rejects_bad_arguments(argv, flag):
    with pytest.raises(SystemExit, match="invalid arguments") as e:
        port_serve.run_serve(port_serve.build_parser().parse_args(
            argv + ["--device", "cpu"]))
    assert flag in str(e.value)


def test_slice_lsac_exact_state_depends_on_completion_order():
    """A reference property the chip check is built around: with seed 0 the
    second batch's first R completions make L-SAC's exact fit far worse
    conditioned, so float32 products leave its exact state well above 1e-7
    in the reference as in the port, while batch 1 stays near 1e-11."""
    argv = ["--rows", "64", "--inner", "1024", "--requests", "8",
            "--backend", "device", "--code", "lsac_ortho",
            "--deadlines", "1.1,1.6,3.0,9.0"]
    ref = ref_serve.run_serve(ref_serve.build_parser().parse_args(argv))
    port = port_serve.run_serve(port_serve.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    for rep in (ref.to_dict(), port.to_dict()):
        exact = {1: [], 2: []}
        for r in rep["requests"]:
            exact[r["batch"]] += [a["rel_err"] for a in r["answers"]
                                  if a["m"] >= rep["code"]["R"]]
        assert exact[1] and exact[2]
        assert max(exact[1]) < 1e-9
        assert min(exact[2]) > 1e-7
