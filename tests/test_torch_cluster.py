"""The port's cluster runtime against the reference, without processes.

Nothing here starts a worker process (``tests/test_torch_cluster_pool.py``
does): the chaos plans, the configuration, the trace format, the shard
computers, the socket framing, the speculation hooks, attribution and the
CLI's flag checks are compared with the reference's on the same inputs.

Tolerances: the numpy shard computer and every host float64 path are
bit-identical; ``TorchShardComputer`` (float32, the kernel's plain version
on the CPU) is held to the reference's per-family 1e-5 relative
(``tests/test_cluster.py``) against the reference's ``DeviceShardComputer``
on jax's CPU and against the float64 numpy products.
"""
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from repro.analysis.attribution import attribution_report as ref_attribution
from repro.cluster import config as ref_config
from repro.cluster import events as ref_events
from repro.cluster import transport as ref_transport
from repro.cluster import worker as ref_worker
from repro.core import GroupSACCode as RefGroupSAC
from repro.core import LayerSACCode as RefLayerSAC
from repro.core import MatDotCode as RefMatDot
from repro.core import x_complex as ref_x_complex
from repro.design.policy import SpeculationPolicy as RefSpeculationPolicy
from repro.serving import MasterScheduler as RefScheduler
from repro.serving.backends import ExecutionBackend as RefExecutionBackend
from repro_torch.analysis.attribution import attribution_report
from repro_torch.cluster import events as port_events
from repro_torch.cluster import (BatchRecord, ChaosSpec, ClusterConfig,
                                 ComputeSpec, NumpyShardComputer, ShardEvent,
                                 TorchShardComputer, TraceRecording,
                                 make_computer)
from repro_torch.cluster.backend import ClusterBackend, ReplayBackend
from repro_torch.cluster.config import global_config
from repro_torch.cluster.transport import recv_frame, send_frame
from repro_torch.convert import code_from_reference
from repro_torch.design import SpeculationPolicy
from repro_torch.launch import serve as port_serve
from repro_torch.obs import Tracer
from repro_torch.serving import (ExecutionBackend, MasterScheduler,
                                 ServeConfig, SimulatedBackend,
                                 SyntheticDispatch, TenantSpec,
                                 build_workload, make_backend)

FAMILIES = [
    ("matdot_complex", lambda: RefMatDot(2, 6, ref_x_complex(6, 0.1))),
    ("gsac_complex",
     lambda: RefGroupSAC(2, 6, ref_x_complex(6, 0.1), [1, 1])),
    ("lsac_ortho_real", lambda: RefLayerSAC(2, 6, base="ortho",
                                            eps=6.25e-3)),
]
FAMILY_IDS = [f[0] for f in FAMILIES]


def _reqs(rng, n, rows=8, inner=8):
    return [(rng.standard_normal((rows, inner)),
             rng.standard_normal((inner, rows))) for _ in range(n)]


def _encoded(make_code, seed=23):
    """The reference's float64 encode of two requests."""
    code = make_code()
    As, Bs = zip(*_reqs(np.random.default_rng(seed), 2))
    return code, RefExecutionBackend._encode_batch(code, As, Bs)


# ------------------------------------------------------------- chaos plans

CHAOS = ["crash:1,sleep:0.01:0.05,slow:3:0.4,hang:2", "sleep:0.2",
         "hang:1,slow:1:1.0", "crash:4", "", None,
         " crash:2 , hang:1 ,"]


@pytest.mark.parametrize("text", CHAOS)
def test_chaos_spec_plans_match_reference(text):
    spec, ref = ChaosSpec.parse(text), ref_worker.ChaosSpec.parse(text)
    assert (spec.sleep, spec.crash, spec.hang, spec.slow,
            spec.slow_delay) == (ref.sleep, ref.crash, ref.hang, ref.slow,
                                 ref.slow_delay)
    for wid in range(10):
        p, r = spec.plan_for(wid), ref.plan_for(wid)
        assert (p.sleep, p.crash, p.hang, p.slow_delay) == \
            (r.sleep, r.crash, r.hang, r.slow_delay), wid


@pytest.mark.parametrize("text,match", [
    ("explode:1", "unknown chaos kind"), ("crash:lots", "malformed"),
    ("sleep:0.5:0.1", "sleep"), ("crash:-1", "counts"),
])
def test_chaos_spec_rejects_like_reference(text, match):
    with pytest.raises(ValueError, match=match):
        ChaosSpec.parse(text)
    with pytest.raises(ValueError, match=match):
        ref_worker.ChaosSpec.parse(text)


# ------------------------------------------------------------------ config

ENV_KEYS = ("compute", "host_device_count", "device_dtype", "transport",
            "socket_hosts", "socket_port", "connect_timeout",
            "frame_max_bytes", "operand_cache_batches")


@pytest.mark.parametrize("env", [
    {},
    {"SAC_CLUSTER_COMPUTE": "device", "SAC_CLUSTER_HOST_DEVICES": "4",
     "SAC_CLUSTER_DEVICE_DTYPE": "bfloat16",
     "SAC_CLUSTER_TRANSPORT": "socket",
     "SAC_CLUSTER_HOSTS": " 10.0.0.1 ,10.0.0.2,,",
     "SAC_CLUSTER_PORT": "4242", "SAC_CLUSTER_CONNECT_TIMEOUT": "2.5",
     "SAC_CLUSTER_FRAME_MAX": "1024", "SAC_CLUSTER_OPERAND_CACHE": "2"},
])
def test_cluster_config_reads_reference_environment(monkeypatch, env):
    for k in [k for k in list(os.environ) if k.startswith("SAC_CLUSTER_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = ClusterConfig(), ref_config.ClusterConfig()
    want = {key: getattr(ref, key) for key in ENV_KEYS}
    if "SAC_CLUSTER_COMPUTE" not in env:
        # the one default that differs: the port computes on the card
        assert want["compute"] == "numpy"
        want["compute"] = "device"
    assert {key: getattr(port, key) for key in ENV_KEYS} == want
    other = ClusterConfig()
    other.backup_from(port)
    assert vars(other) == vars(port)


# ------------------------------------------------------------ trace format

def _recording(module):
    rec = module.TraceRecording()
    rec.append(module.BatchRecord(n_shards=4, times={0: 0.25, 2: 0.125,
                                                     3: 1.5},
                                  lost={1: "crash"}))
    rec.append(module.BatchRecord(n_shards=4, times={0: 0.1, 1: 0.2,
                                                     2: 0.3, 3: 0.4},
                                  redispatches=[[1, "hedge"],
                                                [3, "crash"]]))
    return rec


def test_trace_recording_crosses_packages(tmp_path):
    """A port trace loads in the reference and back, to equal dicts (and
    the other way round), through files."""
    port = _recording(port_events)
    path = port.save(str(tmp_path / "port.json"))
    ref = ref_events.TraceRecording.load(path)
    assert ref.to_dict() == port.to_dict()
    back = TraceRecording.load(ref.save(str(tmp_path / "ref.json")))
    assert back.to_dict() == port.to_dict()
    assert json.loads(open(path).read()) == ref.to_dict()
    for b_ref, b_port in zip(ref.batches, back.batches):
        np.testing.assert_array_equal(b_ref.latency_row(),
                                      b_port.latency_row())
    assert np.isinf(back.batches[0].latency_row()[1])
    with pytest.raises(ValueError, match="version"):
        TraceRecording.from_dict(dict(port.to_dict(), version=2))
    with pytest.raises(ValueError, match="not a cluster trace"):
        TraceRecording.from_dict({"kind": "other"})


def test_shard_event_and_backend_flags():
    ev = ShardEvent(kind="done", shard=1, t=0.5, worker=3,
                    products=torch.zeros(2, 3, 3))
    assert not ev.speculative and ev.timings is None and ev.reason is None
    assert ExecutionBackend.live is False and ClusterBackend.live is True
    d = SyntheticDispatch(torch.zeros(1, 2, 1, 1), np.array([0.2, np.inf]))
    d.set_abandon(1.0)                       # a no-op on a modeled stream
    assert [d.next_event().kind for _ in range(2)] == ["done", "lost"]


# ---------------------------------------------------------- shard computers

@pytest.mark.parametrize("family,make_code", FAMILIES, ids=FAMILY_IDS)
def test_numpy_shard_computer_bit_identical_to_reference(family, make_code):
    code, (E_A, E_B) = _encoded(make_code)
    ref = ref_worker.NumpyShardComputer()
    port = make_computer("numpy")
    assert isinstance(port, NumpyShardComputer)
    for shard in range(code.N):
        want = ref.shard_products(E_A, E_B, shard)
        got = port.shard_products(E_A, E_B, shard)
        assert got.dtype == want.dtype and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family,make_code", FAMILIES, ids=FAMILY_IDS)
def test_torch_shard_computer_matches_reference_device_computer(family,
                                                                make_code):
    """``TorchShardComputer(device="cpu")`` (float32, the kernel's plain
    version) against the reference's ``DeviceShardComputer`` run in-process
    on jax's CPU, and against the float64 numpy products: 1e-5 relative per
    shard, per family."""
    code, (E_A, E_B) = _encoded(make_code)
    ref = ref_worker.DeviceShardComputer(device_index=0, host_device_count=0,
                                         use_pallas=False)
    port = TorchShardComputer(device="cpu")
    port.warmup()
    base = ref_worker.NumpyShardComputer()
    for shard in range(code.N):
        want = ref.shard_products(E_A, E_B, shard)
        got = port.shard_products(E_A, E_B, shard)
        exact = base.shard_products(E_A, E_B, shard)
        assert got.shape == want.shape and got.dtype == want.dtype
        for other in (want, exact):
            rel = np.linalg.norm(got - other) / max(np.linalg.norm(other),
                                                    1e-30)
            assert rel < 1e-5, (family, shard, rel)
    # the plain version launches nothing; the counters say so
    assert port.counters() == {"coded_matmul": 0}


def test_compute_spec_pins_workers_and_rejects_unknown(monkeypatch):
    spec = ComputeSpec.parse("device", device="cpu")
    assert (spec.kind, spec.device) == ("device", "cpu")
    assert ComputeSpec.parse(None) == ComputeSpec() \
        and ComputeSpec().kind == "device"
    assert spec.for_worker(11).device_index == 11 % spec.host_device_count
    assert ComputeSpec.parse("numpy").for_worker(5).device_index == 0
    assert ComputeSpec.parse(spec) is spec
    with pytest.raises(ValueError, match="unknown compute kind 'gpu'"):
        ComputeSpec.parse("gpu")
    with pytest.raises(ValueError, match="unsupported compute device"):
        ComputeSpec.parse("device", device="tpu")
    # the dtype variable is read for parity, but device compute is float32
    monkeypatch.setattr(global_config, "device_dtype", "bfloat16")
    with pytest.raises(ValueError, match="must be float32.*'bfloat16'"):
        ComputeSpec.parse("device", device="cpu")


def test_torch_shard_computer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchShardComputer(device="cuda")


# ------------------------------------------------------------------ framing

@pytest.mark.parametrize("size", [0, 1, 65536, 65537, (1 << 20) + 3])
def test_frame_roundtrip_over_socketpair(size):
    """Each frame is written by its own thread while this one reads, and
    both ends carry a time-out, so a stuck peer fails instead of hanging."""
    payload = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    a, b = socket.socketpair()
    a.settimeout(10.0)
    b.settimeout(10.0)
    errors = []

    def write():
        try:
            send_frame(a, payload)
            send_frame(a, b"tail")
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    try:
        got = recv_frame(b)
        tail = recv_frame(b)
    finally:
        writer.join(10.0)
        a.close()
        b.close()
    assert not writer.is_alive(), "writer thread did not finish"
    assert not errors, errors
    assert got == payload and tail == b"tail"
    # the reference reads the port's frames and vice versa
    a, b = socket.socketpair()
    a.settimeout(10.0)
    b.settimeout(10.0)
    try:
        ref_transport.send_frame(a, b"ab")
        send_frame(a, b"cd")
        assert recv_frame(b) == b"ab"
        assert ref_transport.recv_frame(b) == b"cd"
    finally:
        a.close()
        b.close()


def test_recv_frame_rejects_oversized_and_truncated():
    from repro_torch.cluster.transport import TransportClosed
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    try:
        send_frame(a, b"x" * 64)
        with pytest.raises(TransportClosed, match="exceeds cap"):
            recv_frame(b, max_bytes=16)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    b.settimeout(5.0)
    try:
        a.sendall((100).to_bytes(8, "big") + b"short")
        a.close()
        with pytest.raises(TransportClosed, match="peer closed mid-frame"):
            recv_frame(b)
    finally:
        b.close()


# --------------------------------------------------------- pool / backends

@pytest.mark.parametrize("argv", [["--backend", "cluster"],
                                  ["--replay", "t.json"]])
def test_cli_cluster_and_replay_default_to_device_compute(argv):
    """Without ``--compute``, the cluster's workers and the replay compute
    in the ``coded_matmul`` kernel; numpy is an explicit choice."""
    args = port_serve.build_parser().parse_args(argv + ["--device", "cpu"])
    assert not port_serve._collect_problems(args)
    assert json.loads(port_serve._effective_config(
        args, (1.0,)))["compute"] == "device"


def test_make_backend_knows_cluster_and_replay():
    with pytest.raises(ValueError,
                       match="unknown backend 'gpu'; valid: cluster, "
                       "device, replay, sim"):
        make_backend("gpu")
    rb = make_backend("replay", recording=TraceRecording(), device="cpu")
    assert isinstance(rb, ReplayBackend) and rb.compute == "device"


def test_replay_backend_guards():
    rec = TraceRecording()
    rec.append(BatchRecord(n_shards=4, times={0: 0.1}))
    rb = ReplayBackend(rec, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        rb.draw_latencies(np.random.default_rng(0), 6)
    rb = ReplayBackend(rec, device="cpu")
    row = rb.draw_latencies(np.random.default_rng(0), 4)
    assert row[0] == 0.1 and np.isinf(row[1:]).all()
    with pytest.raises(ValueError, match="exhausted"):
        rb.draw_latencies(np.random.default_rng(0), 4)
    with pytest.raises(ValueError, match="unknown compute kind"):
        ReplayBackend(rec, compute="gpu", device="cpu")


@pytest.mark.parametrize("family,make_code", FAMILIES, ids=FAMILY_IDS)
@pytest.mark.parametrize("compute", ["numpy", "device"])
def test_replay_products_match_simulated(family, make_code, compute):
    """The replay's numpy products are the sim oracle's, bit for bit; its
    device products (the device encode + the float32 shard computer) are
    within 1e-5 relative of them."""
    ref = make_code()
    code = code_from_reference(ref)
    As, Bs = zip(*_reqs(np.random.default_rng(3), 2))
    want = SimulatedBackend(device="cpu").compute_products(code, As, Bs)
    got = ReplayBackend(TraceRecording(), compute=compute,
                        device="cpu").compute_products(code, As, Bs)
    assert got.shape == want.shape
    if compute == "numpy":
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    else:
        w = want.numpy()
        for shard in range(code.N):
            rel = np.linalg.norm(got[:, shard].numpy() - w[:, shard]) \
                / np.linalg.norm(w[:, shard])
            assert rel < 1e-5, (family, shard, rel)


# ---------------------------------------------------------- speculation hook

class _FakeDispatch:
    """The speculation surface of a live dispatch, with no processes."""

    def __init__(self, pending, elapsed, copies=()):
        self.pending = dict.fromkeys(pending, 0)
        self._elapsed = elapsed
        self.n_speculated = 0
        self._copies = set(copies)
        self.hedged = []

    def elapsed(self):
        return self._elapsed

    def copies_of(self, shard):
        return 2 if shard in self._copies else 1

    def speculate(self, shard, reason="hedge"):
        self.hedged.append((shard, reason))
        self.n_speculated += 1
        return True


@pytest.mark.parametrize("rows,elapsed,pending,cap", [
    ([], 0.2, [0, 3], None),                       # cold start: Spark rule
    ([], 0.01, [0, 3], None),                      # too early to hedge
    ([[0.1, 0.12, 0.3, 0.11]] * 6, 0.5, [2], None),  # fitted profile
    ([[0.1, 0.12, 0.3, 0.11]] * 6, 0.5, [1, 2], 1),  # capped per batch
    ([[0.1, 0.2], [0.1, 0.12, 0.15]], 0.9, [0, 2], None),  # lossy rows
])
def test_maybe_speculate_matches_reference(rows, elapsed, pending, cap):
    """``_hedge_profile`` + ``_maybe_speculate`` hedge the same shards as
    the reference scheduler's on the same observation window."""
    ref_code = RefMatDot(2, 4, ref_x_complex(4, 0.1))
    code = code_from_reference(ref_code)
    done = {s: 0.1 + 0.01 * s for s in range(4) if s not in pending}
    got, want = _FakeDispatch(pending, elapsed, copies=[3]), \
        _FakeDispatch(pending, elapsed, copies=[3])
    port = MasterScheduler(code, SimulatedBackend(device="cpu"),
                           speculation=SpeculationPolicy(max_per_batch=cap))
    ref = RefScheduler(ref_code, speculation=RefSpeculationPolicy(
        max_per_batch=cap))
    for r in rows:
        port._hedge_rows.append(np.asarray(r))
        ref._hedge_rows.append(np.asarray(r))
    port._maybe_speculate(got, code, len(done), done, [0.3, 0.6])
    ref._maybe_speculate(want, ref_code, len(done), done, [0.3, 0.6])
    assert got.hedged == want.hedged
    assert (port._hedge_profile() is None) == (ref._hedge_profile() is None)
    assert port.speculations == [] and port.speculation is not None


# ------------------------------------------------------------- attribution

def test_attribution_report_matches_reference():
    """The port's attribution of a port open-loop run (trace document and
    request records) equals the reference's on the same inputs."""
    tenants = (TenantSpec("t", rows=16, inner=64, target_error=0.5,
                          deadline=30.0),
               TenantSpec("u", rows=16, inner=64, target_error=0.05,
                          deadline=3.0))
    code = code_from_reference(RefLayerSAC(4, 8, base="ortho",
                                           eps=6.25e-3))
    tracer = Tracer()
    sched = MasterScheduler(code, SimulatedBackend(device="cpu"),
                            ServeConfig(deadlines=(1.1, 1.6), seed=7,
                                        batch_size=2), tracer=tracer)
    results = sched.run_open(build_workload(tenants, rate=30.0,
                                            horizon=1.0, seed=5))
    reqs = [{"req_id": r.req_id, "tenant": r.tenant, "arrival": r.arrival,
             "batch": r.batch, "t_dispatch": r.t_dispatch,
             "t_target": r.t_target, "t_done": r.t_done,
             "t_exact": r.t_exact, "slo_ok": r.slo_ok,
             "dropped": r.dropped} for r in results]
    doc = json.loads(json.dumps(tracer.to_dict()))
    got = attribution_report(doc, reqs, tail_q=0.9)
    assert got == ref_attribution(doc, reqs, tail_q=0.9)
    assert got["n_requests"] == len(reqs) and got["dominant_phase"]


# --------------------------------------------------------------- CLI checks

@pytest.mark.parametrize("argv,needle", [
    (["--chaos", "crash:1"], "--chaos requires --backend cluster"),
    (["--record", "x.json"], "--record requires --backend cluster"),
    (["--spares", "1"], "--spares requires --backend cluster"),
    (["--backend", "cluster", "--hosts", "a"],
     "--hosts requires --transport socket"),
    (["--compute", "device"], "--compute device requires"),
    (["--backend", "replay"], "--backend replay needs --replay PATH"),
    (["--backend", "cluster", "--replay", "x.json"],
     "drop --backend cluster"),
    (["--speculate"], "--speculate requires --backend cluster"),
    (["--replicate", "2"], "--replicate requires --backend cluster"),
    (["--replicate", "0"], "--replicate must be >= 1"),
    (["--backend", "cluster", "--hedge-threshold", "0.3"],
     "--hedge-threshold requires --speculate"),
    (["--backend", "cluster", "--max-speculations", "2"],
     "--max-speculations requires --speculate"),
    (["--backend", "cluster", "--max-requeue", "0"],
     "--max-requeue must be >= 1"),
    (["--backend", "cluster", "--grace", "0"], "--grace must be > 0"),
    (["--autotune", "--N-options", "4,48"], "only the cluster backend"),
])
def test_cli_rejects_bad_cluster_flags(argv, needle):
    with pytest.raises(SystemExit, match="invalid arguments") as e:
        port_serve.run_serve(port_serve.build_parser().parse_args(
            argv + ["--device", "cpu", "--rows", "8", "--inner", "16"]))
    assert needle in str(e.value)


def test_cli_config_keys_match_reference_for_cluster_flags():
    """The effective config of a cluster/replay/speculation invocation has
    the reference's keys and values, plus ``device``."""
    from repro.launch import serve as ref_serve
    for argv, port_extra in [
            (["--backend", "cluster", "--workers", "3", "--chaos",
              "crash:1", "--speculate", "--max-speculations", "2",
              "--transport", "socket", "--compute", "device"], []),
            (["--replay", "t.json", "--compute", "device"], []),
            (["--replay", "t.json", "--compute", "numpy"], []),
            (["--backend", "sim", "--replay", "t.json"], []),
            (["--replay", "t.json"], ["--backend", "replay"])]:
        ref_args = ref_serve.build_parser().parse_args(argv)
        port_args = port_serve.build_parser().parse_args(
            argv + port_extra + ["--device", "cpu"])
        assert not port_serve._collect_problems(port_args), argv
        ref = json.loads(ref_serve._effective_config(ref_args, (1.0,)))
        port = json.loads(port_serve._effective_config(port_args, (1.0,)))
        if "--compute" not in argv:
            # the one default that differs: the port computes on the card
            assert ref["compute"] == "numpy"
            ref["compute"] = "device"
        assert port == dict(ref, device="cpu"), argv
