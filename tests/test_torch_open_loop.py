"""Open-loop serving in the port against the reference.

The same seeded workloads go through the reference ``MasterScheduler
.run_open`` on its ``SimulatedBackend`` and through the port's on the
``sim`` and ``device`` backends (``device="cpu"``: the kernels' plain
versions).  Everything runs on the virtual clock: no process, no sleep, no
wall-clock bound.  Tolerances, with their reasons:

* scheduling — shed lists, drops, batch members, answer times, ``m``,
  kinds and the target crossings ``t_target`` — must be equal;
* ``sim`` errors (float64 products bit-equal to the reference's, decoded
  with torch) agree to 1e-10 relative on the approximate layers, and at the
  exact states (values of 1e-25 and below, float64 rounding noise) to 1e-10
  in the norm, ``|√e_port − √e_ref|``;
* ``device`` errors (float32 products) to the bound
  ``tests/test_torch_serving.py`` states for the device slice: the two
  estimates of C agree to 1e-5·‖C‖, ``|√e_port − √e_ref| ≤ 1e-5``.

Inside the port two contracts are bit-identical: an unbounded FIFO open
loop with no tenants and every arrival at 0 reduces to ``run()``, and
``set_fleet(N')`` serves as ``restrict_code(code, N')`` does.
"""
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.obs import MetricsRegistry as RefRegistry
from repro.serving import MasterScheduler as RefScheduler
from repro.serving import OpenRequest as RefOpenRequest
from repro.serving import ServeConfig as RefConfig
from repro.serving import SimulatedBackend as RefSimulatedBackend
from repro.serving import TenantSpec as RefTenantSpec
from repro.serving import build_workload as ref_build_workload
from repro.serving import run_load as ref_run_load
from repro_torch.convert import code_from_reference
from repro_torch.core import CODE_NAMES, restrict_code
from repro_torch.design import default_spec
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import (MasterScheduler, OpenRequest, ServeConfig,
                                 SimulatedBackend, TenantSpec,
                                 TorchDeviceBackend, build_workload,
                                 make_arrivals, run_load)

SEED = 29
DEADLINES = (0.6, 1.2, 2.4)
TENANTS = (dict(name="interactive", rows=24, inner=96, target_error=3e-1,
                deadline=3.0, weight=2.0),
           dict(name="batch", rows=32, inner=128, target_error=1e-2,
                deadline=8.0, weight=1.0))


def lsac48():
    return ref_core.LayerSACCode(4, 8, base="ortho", eps=6.25e-3)


def _backend(kind, straggler_frac=0.15):
    if kind == "sim":
        return SimulatedBackend(straggler_frac=straggler_frac, device="cpu")
    return TorchDeviceBackend(straggler_frac=straggler_frac, device="cpu")


def _workloads(rate=3.0, horizon=12.0, seed=SEED + 1, **kw):
    ref = ref_build_workload([RefTenantSpec(**t) for t in TENANTS],
                             rate=rate, horizon=horizon, seed=seed, **kw)
    port = build_workload([TenantSpec(**t) for t in TENANTS], rate=rate,
                          horizon=horizon, seed=seed, **kw)
    return ref, port


def _sched_pair(backend, **cfg_kw):
    cfg_kw.setdefault("deadlines", DEADLINES)
    cfg_kw.setdefault("batch_size", 4)
    cfg_kw.setdefault("seed", SEED)
    ref = lsac48()
    rs = RefScheduler(ref, RefSimulatedBackend(straggler_frac=0.15),
                      RefConfig(**cfg_kw))
    ps = MasterScheduler(code_from_reference(ref), _backend(backend),
                         ServeConfig(**cfg_kw))
    return rs, ps


def _schedule(res):
    return (res.req_id, res.batch, res.tenant, res.arrival, res.dropped,
            res.t_dispatch, res.t_target, res.t_done, res.slo_ok, res.ttfa,
            res.t_exact)


def _assert_same_run(rs, rr, ps, pr, backend, R):
    assert ps.shed == rs.shed
    assert ps.depth_series == rs.depth_series
    assert [_schedule(r) for r in pr] == [_schedule(r) for r in rr]
    for a, b in zip(pr, rr, strict=True):
        assert [(x.t, x.m, x.kind, x.exact) for x in a.answers] == \
            [(y.t, y.m, y.kind, y.exact) for y in b.answers]
        for x, y in zip(a.answers, b.answers):
            assert (x.rel_err is None) == (y.rel_err is None)
            if y.rel_err is None:
                continue
            d = abs(np.sqrt(x.rel_err) - np.sqrt(y.rel_err))
            if backend == "sim":
                if x.m < R:
                    assert abs(x.rel_err - y.rel_err) <= 1e-10 * y.rel_err
                assert d <= 1e-10
            else:
                assert d <= 1e-5


# ------------------------------------------------------------- workloads

@pytest.mark.parametrize("process,kw", [
    ("poisson", {}), ("bursty", {"process_kw": {"burst": 4.0}}),
    ("trace", {"process_kw": {"times": [0.0, 0.3, 0.31, 1.7, 2.2]}})])
def test_build_workload_matches_reference(process, kw):
    ref, port = _workloads(process=process, **kw)
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert a.arrival == b.arrival and a.tenant.name == b.tenant.name
        np.testing.assert_array_equal(a.A, b.A)
        np.testing.assert_array_equal(a.B, b.B)


def test_arrivals_match_reference_processes():
    from repro.serving import make_arrivals as ref_make_arrivals
    for name in ("poisson", "bursty"):
        np.testing.assert_array_equal(
            make_arrivals(name, np.random.default_rng(5), 4.0, 20.0),
            ref_make_arrivals(name, np.random.default_rng(5), 4.0, 20.0))


# ------------------------------------------------------------- run_open

@pytest.mark.parametrize("backend", ["sim", "device"])
@pytest.mark.parametrize("policy", ["fifo", "edf"])
@pytest.mark.parametrize("bounded", [False, True], ids=["unbounded",
                                                         "limit-shed"])
def test_run_open_matches_reference(backend, policy, bounded):
    """3x overload, two tenants: the same admissions, sheds, drops, batches
    and target crossings as the reference, answer for answer."""
    kw = dict(queue_policy=policy, queue_limit=6 if bounded else None,
              shed_expired=bounded)
    rs, ps = _sched_pair(backend, **kw)
    rwl, pwl = _workloads()
    rr, pr = rs.run_open(rwl), ps.run_open(pwl)
    _assert_same_run(rs, rr, ps, pr, backend, lsac48().recovery_threshold)
    if bounded:
        assert ps.shed or any(r.dropped for r in pr)
    assert any(r.t_target is not None for r in pr)


@pytest.mark.parametrize("backend", ["sim", "device"])
def test_run_open_stream_answers_match_reference(backend):
    """Answers at every completion event too (``stream``)."""
    rs, ps = _sched_pair(backend, queue_policy="edf", queue_limit=6,
                         shed_expired=True, stream=True)
    rwl, pwl = _workloads(rate=2.0, horizon=6.0)
    _assert_same_run(rs, rs.run_open(rwl), ps, ps.run_open(pwl), backend,
                     lsac48().recovery_threshold)


def test_load_report_and_registry_match_reference():
    """``run_load``'s per-tenant p99 time-to-target, goodput and shed
    counts, and the obs registry's serve counters, equal the reference's."""
    kw = dict(deadlines=DEADLINES, batch_size=2, seed=7, queue_policy="edf",
              queue_limit=2, shed_expired=True)
    ref_reg, reg = RefRegistry(), MetricsRegistry()
    rs = RefScheduler(lsac48(), RefSimulatedBackend(), RefConfig(**kw),
                      metrics=ref_reg)
    ps = MasterScheduler(code_from_reference(lsac48()),
                         SimulatedBackend(device="cpu"), ServeConfig(**kw),
                         metrics=reg)
    rwl, pwl = _workloads(rate=12.0, horizon=4.0, seed=5)
    want = ref_run_load(rs, rwl, horizon=4.0).to_dict()
    got = run_load(ps, pwl, horizon=4.0).to_dict()
    assert got == want and got["shed"] > 0
    counters = {k: v for k, v in reg.snapshot()["counters"].items()
                if k.startswith("serve.")}
    assert counters == {k: v for k, v in
                        ref_reg.snapshot()["counters"].items()
                        if k.startswith("serve.")}


def test_open_loop_reduces_bit_identically_to_closed_loop():
    """Inside the port: unbounded FIFO, no tenants, every arrival at 0 —
    ``run_open`` answers as ``run`` does, bit for bit, on both backends."""
    rng = np.random.default_rng(3)
    reqs = [(rng.standard_normal((16, 64)), rng.standard_normal((64, 16)))
            for _ in range(6)]
    code = code_from_reference(lsac48())
    for backend in ("sim", "device"):
        cfg = ServeConfig(deadlines=(1.1, 1.6), batch_size=2, seed=7)
        closed = MasterScheduler(code, _backend(backend), cfg)
        for A, B in reqs:
            closed.submit(A, B)
        r_closed = closed.run()
        r_open = MasterScheduler(code, _backend(backend), cfg).run_open(
            [OpenRequest(0.0, A, B) for A, B in reqs])
        assert len(r_closed) == len(r_open) == 6
        for a, b in zip(r_closed, r_open):
            assert (a.req_id, a.batch, a.ttfa, a.t_exact) == \
                (b.req_id, b.batch, b.ttfa, b.t_exact)
            assert [(x.t, x.m, x.kind, x.rel_err) for x in a.answers] == \
                [(y.t, y.m, y.kind, y.rel_err) for y in b.answers]


def test_arrival_tied_with_release_sees_the_freed_queue_slot():
    """The tie rule (completions and the dispatches they trigger precede
    arrivals), as the reference pins it."""
    rng = np.random.default_rng(4)
    A, B = rng.standard_normal((16, 64)), rng.standard_normal((64, 16))
    code = code_from_reference(lsac48())

    def sched():
        return MasterScheduler(code, _backend("sim", 0.0),
                               ServeConfig(deadlines=(1.1, 1.6), seed=7,
                                           batch_size=1, queue_limit=1))

    t_rel = sched().run_open([OpenRequest(0.0, A, B)])[0].t_done
    for arrival, shed in ((t_rel, []), (t_rel - 1e-6, ["tie"])):
        s = sched()
        out = s.run_open([OpenRequest(0.0, A, B, tenant="first"),
                          OpenRequest(0.1, A, B, tenant="queued"),
                          OpenRequest(arrival, A, B, tenant="tie")])
        assert [t for t, _ in s.shed] == shed
        rs = RefScheduler(lsac48(), RefSimulatedBackend(straggler_frac=0.0),
                          RefConfig(deadlines=(1.1, 1.6), seed=7,
                                    batch_size=1, queue_limit=1))
        want = rs.run_open([RefOpenRequest(0.0, A, B, tenant="first"),
                            RefOpenRequest(0.1, A, B, tenant="queued"),
                            RefOpenRequest(arrival, A, B, tenant="tie")])
        assert [_schedule(r) for r in out] == [_schedule(r) for r in want]


def test_shed_request_is_not_copied_and_validation_comes_first():
    """A full queue sheds before the operands are copied; malformed
    operands raise even against a full queue."""
    s = MasterScheduler(code_from_reference(lsac48()), _backend("sim"),
                        ServeConfig(queue_limit=1))
    A, B = np.ones((4, 8)), np.ones((8, 4))
    assert s.submit(A, B) == 0
    assert s.submit(A, B, tenant="t", arrival=2.0) is None
    assert s.shed == [("t", 2.0)] and s.pending == 1
    with pytest.raises(ValueError, match="divisible by K"):
        s.submit(np.ones((4, 6)), np.ones((6, 4)))


def test_realtime_open_loop_needs_a_live_backend():
    """Wall-clock pacing is the default only on a live backend (the
    cluster): on the modeled sim backend ``run_open`` keeps the virtual
    clock, so an arrival at t = 1e6 dispatches at exactly 1e6 unwaited."""
    from repro_torch.cluster.backend import ClusterBackend
    from repro_torch.serving import OpenRequest
    s = MasterScheduler(code_from_reference(lsac48()), _backend("sim"))
    assert not s.backend.live and ClusterBackend.live
    assert s.run_open([], realtime=True) == []
    assert s.run_open([]) == []
    A, B = np.ones((4, 8)), np.ones((8, 4))
    (res,) = s.run_open([OpenRequest(1e6, A, B)])
    assert res.t_dispatch == 1e6 and res.arrival == 1e6


def test_edf_batches_and_accuracy_slo_rejection():
    rng = np.random.default_rng(1)
    A1, B1 = rng.standard_normal((8, 32)), rng.standard_normal((32, 8))
    A2, B2 = rng.standard_normal((12, 48)), rng.standard_normal((48, 12))
    s = MasterScheduler(code_from_reference(lsac48()), _backend("sim"),
                        ServeConfig(queue_policy="edf", batch_size=2))
    s.submit(A1, B1, tenant="slack", deadline=10.0)
    s.submit(A2, B2, tenant="tight", deadline=1.0)
    s.submit(A2, B2, tenant="tight2", deadline=5.0)
    assert [r.tenant for r in s._next_batch()] == ["tight", "tight2"]
    assert [r.tenant for r in s._next_batch()] == ["slack"]
    with pytest.raises(ValueError, match="unknown queue policy 'lifo'"):
        MasterScheduler(code_from_reference(lsac48()), _backend("sim"),
                        ServeConfig(queue_policy="lifo"))
    bad = MasterScheduler(code_from_reference(lsac48()), _backend("sim"),
                          ServeConfig(track_errors=False))
    ten = TenantSpec("t", rows=8, inner=32, target_error=0.5)
    with pytest.raises(ValueError, match="track_errors"):
        bad.run_open([OpenRequest(0.0, A1, B1, tenant=ten)])


# ------------------------------------------------------------- set_fleet

def _serve_answers(sched, reqs, seed):
    sched.rng = np.random.default_rng(seed)
    for A, B in reqs:
        sched.submit(A, B)
    return [(r.ttfa, r.t_exact,
             [(a.t, a.m, a.rel_err, a.exact, a.kind) for a in r.answers])
            for r in sched.run()]


def _min_restrict_N(code):
    """Smallest N' ``restrict_code`` supports for this code."""
    if code.name.startswith("layer_sac"):
        return code.N - int(code.n_sizes[-1]) + 1
    return code.recovery_threshold


@pytest.mark.parametrize("family", CODE_NAMES)
def test_set_fleet_bit_identical_to_restricted_code(family):
    """``set_fleet(N')`` serves bit-identically to a scheduler running
    ``restrict_code(code, N')``, at the smallest, a middle and the full
    N', with two latency seeds each (fixed draws, no property search)."""
    K, N = 4, 12
    code = default_spec(family, K, N).build(np.random.default_rng(3))
    lo = _min_restrict_N(code)
    rng = np.random.default_rng(11)
    reqs = [(rng.standard_normal((6, 4 * K)), rng.standard_normal((4 * K, 6)))
            for _ in range(3)]
    cfg = ServeConfig(deadlines=(1.2, 1.8, 2.5), batch_size=2, seed=0)
    for N_prime in sorted({lo, (lo + N) // 2, N}):
        for seed in (0, 1):
            fleet = MasterScheduler(code, _backend("sim", 0.0), cfg)
            fleet.set_fleet(N_prime)
            direct = MasterScheduler(restrict_code(code, N_prime),
                                     _backend("sim", 0.0), cfg)
            assert _serve_answers(fleet, reqs, seed) == \
                _serve_answers(direct, reqs, seed), (N_prime, seed)


@pytest.mark.parametrize("name", ["matdot", "group_sac", "layer_sac_ortho",
                                  "lagrange"])
@pytest.mark.parametrize("n_shards", [None, 10])
def test_sim_products_in_torch_float64_match_the_numpy_oracle(name,
                                                               n_shards):
    """The ``sim`` backend's card path (torch float64 / complex128
    contractions), run here on CPU tensors, against its numpy path: float64
    rounding only, 1e-13 relative."""
    pts = {"matdot": ref_core.chebyshev_roots(12),
           "group_sac": ref_core.x_complex(12, 0.1)}.get(name)
    kw = {"group_sizes": [2, 2]} if name == "group_sac" else {}
    code = code_from_reference(ref_core.make_code(name, 4, 12,
                                                  eval_points=pts, **kw))
    rng = np.random.default_rng(8)
    As = [rng.standard_normal((10, 40)) for _ in range(3)]
    Bs = [rng.standard_normal((40, 6)) for _ in range(3)]
    want = SimulatedBackend(device="cpu").compute_products(code, As, Bs,
                                                           n_shards).numpy()
    got = SimulatedBackend._products_torch(
        code, As, Bs, n_shards, torch.device("cpu")).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.linalg.norm(got - want) <= 1e-13 * np.linalg.norm(want)
