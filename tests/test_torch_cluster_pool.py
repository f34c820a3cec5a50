"""The port's worker-process cluster, with real worker processes.

Every test here spawns workers, under one discipline:

* processes start with ``spawn`` only (the pool has no other start
  method);
* every pool is closed on every exit path (``with`` blocks), which joins
  each of the pool's own children with a bound and then ``kill()``s it —
  never a process group, never a pid the pool did not spawn;
* no assertion on wall-clock time, and no ``sleep`` as synchronisation:
  waits are bounded by events (a process exit, a queue message) with
  time-outs that fail with a message;
* at most 4 workers per pool (3 for the chaos cases); a numpy-compute
  worker imports no torch, a device-compute worker limits torch to one
  thread.

Record/replay is bit-identical inside the port (``==`` on the answer
streams); a port recording replayed through the reference's
``ReplayBackend`` gives the port's per-request errors to 1e-10 relative on
the approximate layers.
"""
import contextlib
import json

import numpy as np
import pytest
import torch

from repro.cluster.backend import ReplayBackend as RefReplayBackend
from repro.cluster.events import TraceRecording as RefTraceRecording
from repro.core import GroupSACCode as RefGroupSAC
from repro.core import LayerSACCode as RefLayerSAC
from repro.core import MatDotCode as RefMatDot
from repro.core import x_complex as ref_x_complex
from repro.serving import MasterScheduler as RefScheduler
from repro.serving import ServeConfig as RefServeConfig
from repro_torch.analysis.attribution import attribution_report
from repro_torch.cluster import ComputeSpec, TraceRecording, WorkerPool
from repro_torch.cluster.backend import ClusterBackend, ReplayBackend
from repro_torch.convert import code_from_reference
from repro_torch.design import SpeculationPolicy
from repro_torch.launch import serve as port_serve
from repro_torch.obs import Tracer
from repro_torch.serving import (MasterScheduler, OpenRequest, ServeConfig,
                                 SimulatedBackend, TenantSpec,
                                 build_workload, make_backend, run_load)

WAIT = 30.0                 # bound on any single event wait


def matdot(K, N):
    return code_from_reference(RefMatDot(K, N, ref_x_complex(N, 0.1)))


CODES4 = {
    "matdot": lambda: RefMatDot(2, 4, ref_x_complex(4, 0.1)),
    "lsac_ortho": lambda: RefLayerSAC(2, 4, base="ortho", eps=6.25e-3),
    "gsac": lambda: RefGroupSAC(2, 4, ref_x_complex(4, 0.1), [1, 1]),
}


@contextlib.contextmanager
def cluster(**kw):
    """A CPU cluster backend that is closed on every exit path."""
    be = ClusterBackend(device="cpu", **kw)
    try:
        yield be
    finally:
        be.close()


def _reqs(rng, n, rows=8, inner=8):
    return [(rng.standard_normal((rows, inner)),
             rng.standard_normal((inner, rows))) for _ in range(n)]


def _serve(sched, reqs):
    for A, B in reqs:
        sched.submit(A, B)
    return [(res.ttfa, res.t_exact,
             [(a.t, a.m, a.rel_err, a.exact, a.kind) for a in res.answers])
            for res in sched.run()]


# -------------------------------------------------------------------- pool

def test_pool_acquire_release_warm_spares_and_byes():
    with WorkerPool(2, compute="numpy", spares=1, seed=0) as pool:
        assert pool.wait_ready(timeout=WAIT), "workers never came up"
        spawned = pool.stats["spawned"]
        pool.release(pool.active[1:])          # one goes warm
        assert pool.size == 1 and pool.spares == 1
        assert len(pool.acquire(1)) == 1       # the warm spare: no spawn
        assert pool.stats["spawned"] == spawned
        pool.release(pool.active)              # beyond the spare budget
        assert pool.size == 0 and pool.spares == 1
        fleet = pool.lease(3)
        assert len(fleet) == 3 and pool.lease(2) == fleet[:2]
        beats = pool.heartbeat(timeout=WAIT)
        assert set(beats) == set(pool.active)
        spawned = pool.stats["spawned"]
    # every cleanly stopped worker said goodbye (numpy: no kernel counts)
    assert len(pool.worker_counters) == spawned
    assert pool.kernel_launches() == {} and pool.spares == 0


def test_pool_replaces_crashed_worker_in_its_slot():
    with WorkerPool(2, compute="numpy", chaos="crash:1", seed=0) as pool:
        assert pool.wait_ready(timeout=WAIT)
        victim, survivor = pool.active
        proc = pool._active[victim].proc
        pool.send(victim, ("task", 1, 0, (("x", (1,), "<f8"),
                                          ("x", (1,), "<f8"))))
        proc.join(WAIT)                        # the chaos exit, as an event
        assert proc.exitcode == 13, "the crash worker did not exit"
        dead = pool.reap(replace=True)
        assert dead == [(victim, {(1, 0)})]
        assert pool.size == 2 and pool.active[1] == survivor
        assert pool.active[0] != victim
        assert (pool.stats["replaced"], pool.stats["crashed"],
                pool.stats["shards_lost"]) == (1, 1, 1)


def test_worker_without_a_card_fails_loudly(monkeypatch):
    """A device worker asked for the card on a host whose card it cannot
    see reports the failure, and the pool raises it: no CPU fallback."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    spec = ComputeSpec(kind="device", device="cuda")
    with cluster(workers=1, compute=spec) as be:
        with pytest.raises(RuntimeError, match="failed to start.*no CUDA"):
            be.pool.wait_ready(timeout=WAIT)


# --------------------------------------------------------- products / seams

def test_numpy_products_bit_match_sim():
    code = matdot(2, 4)
    As, Bs = zip(*_reqs(np.random.default_rng(0), 3))
    with cluster(compute="numpy", workers=4, seed=0) as be:
        d = be.dispatch_batch(code, As, Bs)
        d.drain(WAIT)
        got, times = d.product_stack(), d.latency_row()
        d.finalize()
        assert be.pool.transport.live_operands == 0
    want = SimulatedBackend(device="cpu").compute_products(code, As, Bs)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert np.all(np.isfinite(times)) and len(times) == 4
    assert np.all(np.diff(np.sort(times)) > 0)


def test_device_products_within_1e5_of_sim():
    """``compute="device"`` on the CPU: the master's device encode plus
    each worker's float32 plain-version products, against the float64
    oracle — 1e-5 relative per shard, for a real and a complex code."""
    rng = np.random.default_rng(1)
    As, Bs = zip(*_reqs(rng, 2))
    with cluster(workers=4, seed=0, compute="device") as be:
        for name in ("lsac_ortho", "gsac"):
            code = code_from_reference(CODES4[name]())
            d = be.dispatch_batch(code, As, Bs)
            d.drain(WAIT)
            got = d.product_stack().numpy()
            d.finalize()
            want = SimulatedBackend(device="cpu").compute_products(
                code, As, Bs).numpy()
            assert not d.lost, d.lost
            for shard in range(code.N):
                rel = np.linalg.norm(got[:, shard] - want[:, shard]) \
                    / np.linalg.norm(want[:, shard])
                assert rel < 1e-5, (name, shard, rel)
    counters = be.pool.worker_counters
    assert counters and all(c == {"coded_matmul": 0}
                            for c in counters.values())


# ------------------------------------------------------------ record/replay

@pytest.mark.parametrize("name", sorted(CODES4))
def test_record_replay_bit_identity(name):
    code = code_from_reference(CODES4[name]())
    reqs = _reqs(np.random.default_rng(7), 4)
    cfg = ServeConfig(deadlines=(0.05, 0.2, 0.6), stream=True, batch_size=2,
                      seed=0)
    with cluster(compute="numpy", workers=4, chaos="sleep:0.005:0.02", seed=1,
                 record=True) as be:
        live = _serve(MasterScheduler(code, be, cfg), reqs)
        rec = be.recording
    assert len(rec) == 2
    replay = _serve(MasterScheduler(code, ReplayBackend(rec, compute="numpy",
                                                        device="cpu"),
                                    cfg), reqs)
    assert live == replay
    rec2 = TraceRecording.from_dict(json.loads(json.dumps(rec.to_dict())))
    assert live == _serve(MasterScheduler(
        code, ReplayBackend(rec2, compute="numpy", device="cpu"), cfg), reqs)


def test_record_replay_bit_identity_with_lost_shards():
    code = matdot(2, 3)
    reqs = _reqs(np.random.default_rng(11), 4)
    cfg = ServeConfig(deadlines=(0.3, 0.8), stream=True, batch_size=2,
                      seed=0)
    with cluster(compute="numpy",
                 workers=3, chaos="crash:1,sleep:0.005:0.02", seed=6,
                 grace=10.0, record=True) as be:
        sched = MasterScheduler(code, be, cfg)
        live = _serve(sched, reqs)
        rec = be.recording
    assert sched.losses and sched.losses[0][2] == "crash"
    assert rec.batches[0].lost == {0: "crash"}
    assert np.isinf(rec.batches[0].latency_row()[0])
    assert live == _serve(MasterScheduler(
        code, ReplayBackend(rec, compute="numpy", device="cpu"), cfg), reqs)


def test_device_compute_record_replay_bit_identity():
    """A device-compute trace replays bit for bit only through a
    device-compute replay; the numpy replay differs in the float32 low
    bits, so the trace pins the compute seam too."""
    code = matdot(2, 4)
    reqs = _reqs(np.random.default_rng(31), 2)
    cfg = ServeConfig(deadlines=(1.0,), stream=True, batch_size=2, seed=0)
    with cluster(workers=4, chaos="sleep:0.005:0.02", seed=8, record=True,
                 compute="device") as be:
        live = _serve(MasterScheduler(code, be, cfg), reqs)
        rec = be.recording
    dev = _serve(MasterScheduler(code, ReplayBackend(
        rec, compute="device", device="cpu"), cfg), reqs)
    assert live == dev
    host = _serve(MasterScheduler(code, ReplayBackend(rec, compute="numpy",
                                                      device="cpu"),
                                  cfg), reqs)
    assert live != host


def test_port_trace_replays_through_reference_replay_backend(tmp_path):
    """Across packages: a port recording (numpy compute) saved to a file and
    replayed through the reference's ``ReplayBackend`` and scheduler gives
    the port's answers — the same (t, m) per answer and the per-request
    errors to 1e-10 relative on the approximate layers (float64 rounding of
    the two decoders' summation orders)."""
    ref_code = CODES4["lsac_ortho"]()
    code = code_from_reference(ref_code)
    reqs = _reqs(np.random.default_rng(5), 4)
    deadlines = (0.05, 0.2, 0.6)
    cfg = ServeConfig(deadlines=deadlines, stream=True, batch_size=2, seed=0)
    with cluster(compute="numpy", workers=4, chaos="sleep:0.005:0.02", seed=3,
                 record=True) as be:
        live = _serve(MasterScheduler(code, be, cfg), reqs)
        path = be.recording.save(str(tmp_path / "trace.json"))
    ref_rec = RefTraceRecording.load(path)
    ref = _serve(RefScheduler(ref_code, RefReplayBackend(ref_rec),
                              RefServeConfig(deadlines=deadlines,
                                             stream=True, batch_size=2,
                                             seed=0)), reqs)
    R = code.recovery_threshold
    n = 0
    for (_, te_p, ans_p), (_, te_r, ans_r) in zip(live, ref, strict=True):
        assert te_p == te_r
        assert [(a[0], a[1], a[3], a[4]) for a in ans_p] == \
            [(a[0], a[1], a[3], a[4]) for a in ans_r]
        for a, b in zip(ans_p, ans_r):
            if a[2] is None or b[2] is None:
                assert a[2] is b[2]
            elif a[1] < R:
                assert abs(a[2] - b[2]) <= 1e-10 * b[2], (a, b)
                n += 1
            else:
                assert a[2] < 1e-20 and b[2] < 1e-20
    assert n > 0


# -------------------------------------------------------------------- chaos

def test_crash_mid_batch_loses_one_shard_and_heals():
    code = matdot(2, 3)
    cfg = ServeConfig(deadlines=(1.0,), batch_size=2, seed=0)
    with cluster(compute="numpy",
                 workers=3, chaos="crash:1,sleep:0.005:0.02", seed=2,
                 grace=10.0) as be:
        sched = MasterScheduler(code, be, cfg)
        out = _serve(sched, _reqs(np.random.default_rng(3), 4))
        stats = dict(be.pool.stats)
        assert be.pool.transport.live_operands == 0
    assert sched.losses == [(0, 0, "crash")]
    assert stats["replaced"] == 1 and stats["crashed"] == 1
    for _, t_exact, answers in out[:2]:        # batch 0: 2 of R = 3
        assert t_exact is None and answers[-1][1] == 2
    for _, t_exact, answers in out[2:]:        # batch 1: healed and exact
        assert t_exact is not None and answers[-1][1] == 3
        assert answers[-1][3] and answers[-1][2] < 1e-20


def test_hang_past_deadline_is_abandoned_and_retired():
    code = matdot(2, 3)
    cfg = ServeConfig(deadlines=(0.4,), batch_size=2, seed=0)
    with cluster(compute="numpy",
                 workers=3, chaos="hang:1,sleep:0.005:0.02", seed=4,
                 grace=0.5) as be:
        sched = MasterScheduler(code, be, cfg)
        out = _serve(sched, _reqs(np.random.default_rng(5), 2))
        stats = dict(be.pool.stats)
    assert [(s, why) for _, s, why in sched.losses] == [(0, "timeout")]
    assert stats["retired"] == 1 and stats["replaced"] == 1
    assert stats["shards_lost"] == 1
    (_, t_exact, answers), _ = out
    assert t_exact is None and answers[-1][1] == 2


def test_speculate_requeues_crashed_shard_without_loss():
    code = matdot(2, 3)
    cfg = ServeConfig(deadlines=(1.0,), batch_size=2, seed=0)
    with cluster(compute="numpy",
                 workers=3, chaos="crash:1,sleep:0.005:0.02", seed=2,
                 grace=10.0, speculate=True) as be:
        sched = MasterScheduler(code, be, cfg,
                                speculation=SpeculationPolicy())
        out = _serve(sched, _reqs(np.random.default_rng(3), 4))
        stats = dict(be.pool.stats)
    assert sched.losses == []
    assert "crash" in {why for _, _, why in sched.speculations}
    assert stats["shards_requeued"] >= 1 and stats["shards_lost"] == 0
    # the hedge may also race the re-queued copy; a cancelled copy whose
    # duplicate result is not reaped by the next dispatch is retired as
    # stale, which replaces it a second time
    assert stats["crashed"] == 1 and stats["retired"] <= 1
    assert stats["replaced"] == stats["crashed"] + stats["retired"]
    for _, t_exact, answers in out:
        assert t_exact is not None


def test_speculate_hedge_backup_wins_hung_shard():
    """Zero-slack MatDot (N = R = 3) with a hung worker: the hedging policy
    re-dispatches the lagging shard to a warm backup, the backup's copy
    wins, and the hung primary is cancelled — counted apart from losses."""
    code = matdot(2, 3)
    cfg = ServeConfig(deadlines=(0.5,), batch_size=2, seed=0)
    tracer = Tracer()
    with cluster(compute="numpy",
                 workers=3, spares=1, chaos="hang:1,sleep:0.005:0.02",
                 seed=4, grace=10.0, speculate=True) as be:
        sched = MasterScheduler(code, be, cfg, tracer=tracer,
                                speculation=SpeculationPolicy())
        out = _serve(sched, _reqs(np.random.default_rng(5), 2))
        stats = dict(be.pool.stats)
    assert "hedge" in {why for _, _, why in sched.speculations}
    assert sched.losses == []
    assert stats["backups_leased"] >= 1 and stats["shards_cancelled"] >= 1
    assert stats["shards_lost"] == 0
    for _, t_exact, _ in out:
        assert t_exact is not None
    spans = [e for e in tracer.to_dict()["traceEvents"]
             if e.get("args", {}).get("speculative")]
    assert spans, "no completion was won by a speculative copy"


def test_replicate_pins_upfront_copies():
    """``replicate=2``: every shard gets a second copy at dispatch, so the
    crashed primary's shard is served by its replica."""
    code = matdot(1, 2)
    cfg = ServeConfig(deadlines=(0.5,), batch_size=2, seed=0)
    with cluster(compute="numpy",
                 workers=2, chaos="crash:1,sleep:0.005:0.02", seed=10,
                 grace=10.0, replicate=2) as be:
        sched = MasterScheduler(code, be, cfg)
        out = _serve(sched, _reqs(np.random.default_rng(19), 2))
        stats = dict(be.pool.stats)
    assert [why for _, _, why in sched.speculations] == ["replicate"] * 2
    assert sched.losses == [] and stats["backups_leased"] >= 2
    for _, t_exact, answers in out:
        assert t_exact is not None and answers[-1][3]


def test_replicate_serves_shard_whose_primary_died_before_dispatch():
    """A primary whose channel is dead when the task is sent (it died after
    the lease's reap) is covered by the shard's replica, as a primary that
    crashes mid-batch is: no loss (the channel failure is injected on the
    batch's first send, the primary of shard 0)."""
    code = matdot(1, 2)
    cfg = ServeConfig(deadlines=(0.5,), batch_size=2, seed=0)
    with cluster(compute="numpy", workers=2, seed=10, grace=10.0,
                 replicate=2) as be:
        send, failed = be.pool.send, []

        def flaky_send(wid, msg, operands=None):
            if msg[0] == "task" and not failed:
                failed.append(wid)
                return False
            return send(wid, msg, operands=operands)

        be.pool.send = flaky_send
        sched = MasterScheduler(code, be, cfg)
        out = _serve(sched, _reqs(np.random.default_rng(19), 2))
    assert len(failed) == 1
    assert sched.losses == []
    assert [why for _, _, why in sched.speculations] == ["replicate"] * 2
    for _, t_exact, answers in out:
        assert t_exact is not None and answers[-1][3]


def test_socket_transport_crash_loss_and_replay_bit_identity():
    code = matdot(2, 3)
    reqs = _reqs(np.random.default_rng(3), 4)
    cfg = ServeConfig(deadlines=(1.0,), stream=True, batch_size=2, seed=0)
    with cluster(compute="numpy",
                 workers=3, chaos="crash:1,sleep:0.005:0.02", seed=2,
                 grace=10.0, record=True, transport="socket",
                 hosts=("127.0.0.1", "127.0.0.1")) as be:
        sched = MasterScheduler(code, be, cfg)
        live = _serve(sched, reqs)
        rec = be.recording
        stats = dict(be.pool.stats)
    assert sched.losses == [(0, 0, "crash")]
    assert stats["replaced"] == 1 and stats["crashed"] == 1
    assert live == _serve(MasterScheduler(
        code, ReplayBackend(rec, compute="numpy", device="cpu"), cfg), reqs)


# ---------------------------------------------------- real-time open loop

def test_realtime_open_loop_on_the_cluster():
    """Wall-clock arrivals against the worker pool (``run_open`` picks the
    wall clock on a live backend)."""
    ten = TenantSpec("rt", rows=8, inner=32, target_error=0.8, deadline=5.0)
    wl = build_workload((ten,), rate=8.0, horizon=0.8, seed=9)
    backend = make_backend("cluster", compute="numpy",
                           workers=2, seed=9, device="cpu")
    try:
        sched = MasterScheduler(
            matdot(2, 4), backend,
            ServeConfig(deadlines=(0.5, 1.0), batch_size=2, seed=9,
                        queue_policy="edf", queue_limit=4))
        report = run_load(sched, wl, horizon=0.8)
        assert sched.run_open([]) == []
    finally:
        backend.close()
    assert report.served + report.shed + report.dropped == report.offered
    assert report.served > 0


def test_realtime_open_loop_replays_admission_and_shedding():
    """A burst past the queue limit sheds the same arrivals live and in a
    ``sim`` replay of the recorded trace, and the served requests get the
    same batches and answers."""
    rng = np.random.default_rng(2)
    ten = TenantSpec("b", rows=8, inner=8, deadline=30.0)
    arrivals = [0.0] * 6 + [0.2]
    work = [OpenRequest(t, *_reqs(rng, 1)[0], ten) for t in arrivals]
    cfg = ServeConfig(deadlines=(0.3, 0.6), batch_size=2, seed=1,
                      queue_limit=4, shed_expired=True)
    code = matdot(2, 3)
    with cluster(compute="numpy", workers=3, chaos="sleep:0.005:0.02", seed=5,
                 record=True) as be:
        assert be.pool.wait_ready(timeout=WAIT), "workers never came up"
        live = MasterScheduler(code, be, cfg)
        got = live.run_open(work)
        rec = be.recording
    replay = MasterScheduler(code, ReplayBackend(rec, compute="numpy",
                                                 device="cpu"), cfg)
    want = replay.run_open(work, realtime=False)
    assert live.shed == replay.shed and len(live.shed) == 2
    assert [(r.req_id, r.batch, r.dropped) for r in got] == \
        [(r.req_id, r.batch, r.dropped) for r in want]
    assert [[(a.t, a.m, a.rel_err) for a in r.answers] for r in got] == \
        [[(a.t, a.m, a.rel_err) for a in r.answers] for r in want]


# -------------------------------------------------------------- CLI, analysis

def test_cli_record_then_replay_gives_the_same_report(tmp_path):
    trace = str(tmp_path / "trace.json")
    common = ["--device", "cpu", "--code", "matdot", "--K", "2", "--N", "4",
              "--requests", "4", "--rows", "16", "--inner", "64",
              "--batch-size", "2", "--deadlines", "0.2,0.6", "--stream",
              "--compute", "numpy"]
    live = port_serve.run_serve(port_serve.build_parser().parse_args(
        common + ["--backend", "cluster", "--workers", "4", "--chaos",
                  "sleep:0.005:0.02", "--record", trace]))
    replay = port_serve.run_serve(port_serve.build_parser().parse_args(
        common + ["--replay", trace]))
    assert live.cluster["recorded"] == {"path": trace, "batches": 2}
    assert live.cluster["kernel_launches"] == {}
    assert replay.config["backend"] == "replay" and replay.cluster is None
    assert live.requests == replay.requests


def test_attribution_names_slow_worker_compute():
    """Slow-worker chaos lands in the workers' compute phase; attribution
    (read from the workers' timing triples) names a slow worker's
    compute."""
    code = matdot(2, 4)
    tracer = Tracer()
    cfg = ServeConfig(deadlines=(3.0,), batch_size=2, seed=0)
    with cluster(compute="numpy",
                 workers=4, chaos="slow:2:0.4,sleep:0.005:0.02", seed=6,
                 grace=10.0) as be:
        sched = MasterScheduler(code, be, cfg, tracer=tracer)
        for A, B in _reqs(np.random.default_rng(11), 2):
            sched.submit(A, B)
        results = sched.run()
    reqs = [{"req_id": r.req_id, "tenant": r.tenant, "arrival": r.arrival,
             "batch": r.batch, "t_dispatch": r.t_dispatch,
             "t_target": r.t_target, "t_done": r.t_done,
             "t_exact": r.t_exact, "slo_ok": r.slo_ok,
             "dropped": r.dropped} for r in results]
    rep = attribution_report(tracer, reqs, tail_q=0.5)
    assert rep["top_worker"]["worker"] in (0, 1), rep["top_worker"]
    assert rep["top_worker"]["dominant_phase"] == "compute"
    assert rep["dominant_phase"] == "compute"
