"""The port's observability layer (``repro_torch.obs``, copies of the
reference's stdlib/numpy modules) against the reference.

The same instrument operations give the same snapshots, Prometheus text,
time series, burn-rate alerts, flight-recorder dumps and trace events in
both packages; a served open loop on the port records the same counters,
series and alerts as the reference's on the virtual clock.  The exporter
binds port 0 on 127.0.0.1 and every request carries a time-out.  Values
derived from decoded errors (the ``serve.last_rel_err`` gauge) agree to
1e-10 relative: the port decodes the same float64 products with torch.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.obs as ro
import repro_torch.obs as po
from repro.core import LayerSACCode
from repro.serving import MasterScheduler as RefScheduler
from repro.serving import ServeConfig as RefConfig
from repro.serving import SimulatedBackend as RefSimulatedBackend
from repro.serving import TenantSpec as RefTenantSpec
from repro.serving import build_workload as ref_build_workload
from repro_torch.convert import code_from_reference
from repro_torch.serving import (MasterScheduler, ServeConfig,
                                 SimulatedBackend, TenantSpec,
                                 build_workload)

TIMEOUT = 5.0


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve.slo_hit.interactive").inc(10)
    reg.counter("cache.hits").inc()
    reg.gauge("serve.queue_depth").set(3)
    h = reg.histogram("lat", buckets=tuple(np.linspace(0.01, 2.0, 50)))
    for v in np.random.default_rng(17).uniform(0.02, 2.5, size=300):
        h.observe(float(v))
    return reg


def test_registry_snapshot_and_prometheus_text_match_reference():
    a, b = _drive_registry(po), _drive_registry(ro)
    assert a.snapshot() == b.snapshot()
    assert po.prometheus_text(a.snapshot()) == \
        ro.prometheus_text(b.snapshot())
    h = a.histogram("lat")
    assert [h.quantile(q) for q in (0.0, 0.5, 0.99, 1.0)] == \
        [b.histogram("lat").quantile(q) for q in (0.0, 0.5, 0.99, 1.0)]
    with pytest.raises(ValueError):
        a.gauge("lat")                     # kind mismatch, as the reference
    assert not po.NULL_REGISTRY.enabled
    assert po.NULL_REGISTRY.counter("x") is po.NULL_REGISTRY.counter("y")


def test_registry_save_round_trips(tmp_path):
    reg = _drive_registry(po)
    path = reg.save(str(tmp_path / "m.json"))
    doc = json.loads(open(path).read())
    assert doc["kind"] == "metrics-snapshot"
    assert {k: doc[k] for k in ("counters", "gauges")} == \
        {k: reg.snapshot()[k] for k in ("counters", "gauges")}


def _drive_sampler(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("serve.slo_hit.a")
    s = mod.TimeSeriesSampler(reg, interval=0.25, capacity=4)
    ticks = []
    for i, t in enumerate((0.0, 0.125, 0.25, 0.5, 0.75, 1.0, 1.25)):
        c.inc(i)
        if i == 3:
            reg.counter("late").inc(4)
        ticks.append(s.tick(t))
    return s, ticks


def test_sampler_series_match_reference():
    (a, ta), (b, tb) = _drive_sampler(po), _drive_sampler(ro)
    assert ta == tb
    assert (len(a), a.n_samples) == (len(b), b.n_samples)
    assert a.series() == b.series()
    assert a.samples() == b.samples()
    with pytest.raises(ValueError, match="interval"):
        po.TimeSeriesSampler(po.MetricsRegistry(), interval=0.0)


def _drive_burn(mod, tmp_path):
    reg = mod.MetricsRegistry()
    fr = mod.FlightRecorder(str(tmp_path / f"{mod.__name__}.json"),
                            capacity=8)
    bt = mod.BurnRateTracker(objective=0.9, window=2.0, min_events=4,
                             threshold=1.0, clear_frac=0.5, metrics=reg,
                             flight=fr)
    t, alerts = 0.0, []
    for hit in [False] * 6 + [True] * 40:
        a = bt.observe("vip", hit, t)
        if a is not None:
            alerts.append((a.kind, a.tenant, a.t, a.burn_long, a.burn_short))
        t += 0.1
    return bt, alerts, reg, fr


def test_burn_tracker_alerts_match_reference(tmp_path):
    a, b = _drive_burn(po, tmp_path), _drive_burn(ro, tmp_path)
    assert a[1] == b[1] and [k for k, *_ in a[1]] == ["fire", "clear"]
    assert a[0].to_dict() == b[0].to_dict()
    assert a[2].snapshot() == b[2].snapshot()
    assert [e["kind"] for e in json.load(open(a[3].dump("exception")))[
        "events"]] == [e["kind"] for e in json.load(open(
            b[3].dump("exception")))["events"]]


def test_flight_recorder_ring_and_series_tail(tmp_path):
    out = []
    for mod in (po, ro):
        reg = mod.MetricsRegistry()
        c = reg.counter("x")
        fr = mod.FlightRecorder(str(tmp_path / f"{mod.__name__}.json"),
                                capacity=4, series_tail=3)
        sampler = mod.TimeSeriesSampler(reg, interval=0.1)
        fr.bind_sampler(sampler)
        for i in range(6):
            c.inc()
            sampler.tick(i * 0.1)
            fr.record("tick", i=i)
        dump = json.load(open(fr.dump("all-shards-lost", reg)))
        out.append((len(fr), [e.get("i") for e in dump["events"]],
                    dump["reason"], dump["series"],
                    dump["metrics"]["counters"]))
    assert out[0] == out[1]
    assert out[0][1] == [2, 3, 4, 5]


def _drive_tracer(mod):
    tr = mod.Tracer()
    tr.batch_begin(1, 4)
    tr.done(1, 0, 0, 1.2, timings=(0.1, 0.2, 0.3))
    tr.done(1, 2, 2, 1.5)
    tr.lost(1, 3, 3, float("inf"), "missing")
    tr.decode_apply(1, 0, 1.2)
    tr.milestone(1, "first-threshold", 1.2, m=1)
    return tr


def test_tracer_events_match_reference():
    a, b = _drive_tracer(po), _drive_tracer(ro)
    assert a.n_events == b.n_events
    assert a.raw_events("done") == b.raw_events("done")

    def shape(tr):
        return [(e["name"], e["ph"], e.get("args")) for e in
                tr.to_dict()["traceEvents"]]
    assert shape(a) == shape(b)


def test_exporter_serves_the_registry_on_an_ephemeral_port():
    reg = _drive_registry(po)
    sampler = po.TimeSeriesSampler(reg, interval=0.1)
    sampler.tick(0.0)
    burn = po.BurnRateTracker(metrics=reg)
    with po.MetricsExporter(reg, sampler=sampler, burn=burn,
                            host="127.0.0.1", port=0) as exp:
        assert exp.port > 0 and exp.url.startswith("http://127.0.0.1:")
        with urllib.request.urlopen(f"{exp.url}/metrics",
                                    timeout=TIMEOUT) as r:
            assert "version=0.0.4" in r.headers["Content-Type"]
            text = r.read().decode()
        assert text == po.prometheus_text(reg.snapshot())
        with urllib.request.urlopen(f"{exp.url}/json",
                                    timeout=TIMEOUT) as r:
            doc = json.load(r)
        ref = ro.MetricsExporter(_drive_registry(ro)).json_payload()
        assert set(doc) == set(ref)
        assert doc["snapshot"]["counters"] == ref["snapshot"]["counters"]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{exp.url}/nope", timeout=TIMEOUT)
        assert exp.scrapes == 2
    assert exp._server is None


# ------------------------------------------------- scheduler integration

def _open_loop(pkg):
    tenants = [dict(name="interactive", rows=16, inner=64, target_error=0.5,
                    deadline=0.02, weight=1.0),
               dict(name="batch", rows=24, inner=64, target_error=1e-2,
                    deadline=6.0, weight=1.0)]
    cfg = dict(deadlines=(1.1, 1.6), seed=7, batch_size=2,
               queue_policy="edf", queue_limit=4, shed_expired=True)
    mod = po if pkg == "port" else ro
    reg = mod.MetricsRegistry()
    sampler = mod.TimeSeriesSampler(reg, interval=0.05)
    burn = mod.BurnRateTracker(objective=0.9, window=2.0, min_events=4,
                               metrics=reg)
    tracer = mod.Tracer()
    code = LayerSACCode(4, 8, base="ortho", eps=6.25e-3)
    if pkg == "port":
        sched = MasterScheduler(code_from_reference(code),
                                SimulatedBackend(device="cpu"),
                                ServeConfig(**cfg), metrics=reg,
                                sampler=sampler, burn=burn, tracer=tracer)
        wl = build_workload([TenantSpec(**t) for t in tenants], rate=10.0,
                            horizon=3.0, seed=5)
    else:
        sched = RefScheduler(code, RefSimulatedBackend(), RefConfig(**cfg),
                             metrics=reg, sampler=sampler, burn=burn,
                             tracer=tracer)
        wl = ref_build_workload([RefTenantSpec(**t) for t in tenants],
                                rate=10.0, horizon=3.0, seed=5)
    sched.run_open(wl)
    return reg, sampler, burn, tracer


def test_open_loop_telemetry_matches_reference():
    (reg, sampler, burn, tracer), (rreg, rsampler, rburn, rtracer) = \
        _open_loop("port"), _open_loop("ref")
    assert reg.snapshot()["counters"] == rreg.snapshot()["counters"]
    assert burn.to_dict() == rburn.to_dict() and burn.alerts
    a, b = sampler.series(), rsampler.series()
    assert a["t"] == b["t"] and len(a["t"]) > 5
    assert a["counters"] == b["counters"]
    assert set(a["gauges"]) == set(b["gauges"])
    for name in a["gauges"]:
        x, y = np.asarray(a["gauges"][name]), np.asarray(b["gauges"][name])
        assert np.all(np.abs(x - y) <= 1e-10 * np.abs(y)), name
    assert tracer.raw_events("done") == rtracer.raw_events("done")
    assert [e[:3] for e in tracer.raw_events("milestone")] == \
        [e[:3] for e in rtracer.raw_events("milestone")]


# --------------------------------------------------------------- spans
SERVING_SPANS = {"sac.batch", "sac.cast", "sac.products", "sac.decode",
                 "sac.decode.resolve", "sync.generator",
                 "sync.recombine_weights"}
TRAINING_SPANS = {"train.step", "train.forward", "train.backward",
                  "train.clip", "train.optimizer", "train.apply"}
PREFIXES = ("sac.", "sync.", "train.")


def _profiled():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def _host_spans(prof):
    return [e for e in prof.events() if e.name.startswith(PREFIXES)]


@pytest.fixture
def spans():
    from repro_torch.obs import spans as mod
    mod.clear_spans()
    yield mod
    mod.clear_spans()


def test_span_without_a_profiler_is_the_shared_noop(spans):
    s = po.span("sac.decode", device="cpu")
    assert s is spans.NULL_SPAN and po.span("train.step") is s
    with s as inside:
        assert inside is s
    assert po.span_records() == []


def test_span_is_a_function_scope_host_event_under_the_profiler(spans):
    import torch
    with _profiled() as prof:
        with po.span("sac.batch"):
            with po.span("sac.decode", device="cpu"):
                torch.ones(4).add_(1)
    got = _host_spans(prof)
    assert sorted(e.name for e in got) == ["sac.batch", "sac.decode"]
    # scope 0 (FUNCTION), never 7 (USER_SCOPE, which the profiler would
    # also draw on the device's timeline)
    assert all(e.scope == 0 for e in got)
    assert all(str(e.device_type).endswith("CPU") for e in got)


def test_host_spans_nest_on_the_profilers_clock(spans):
    """What the idle readers rely on: a span opened inside another is its
    child in the trace and lies within it."""
    with _profiled() as prof:
        with po.span("sac.decode", device="cpu"):
            with po.span("sac.decode.resolve"):
                with po.span("sync.recombine_weights"):
                    pass
    by = {e.name: e for e in _host_spans(prof)}
    for child, parent in (("sync.recombine_weights", "sac.decode.resolve"),
                          ("sac.decode.resolve", "sac.decode")):
        c, p = by[child], by[parent]
        assert c.cpu_parent is not None and c.cpu_parent.name == parent
        assert p.time_range.start <= c.time_range.start
        assert c.time_range.end <= p.time_range.end


def test_only_a_span_given_a_device_is_recorded_and_the_ring_is_bounded(
        spans):
    rec = spans.SpanRecorder(size=3)
    with _profiled():
        with rec.span("sac.batch"):
            for name in ("sac.cast", "sac.products", "sac.decode"):
                with rec.span(name, device="cpu"):
                    pass
        with rec.span("train.step"):
            with rec.span("train.forward", device="cpu"):
                with rec.span("sync.generator"):
                    pass
    rows = rec.records()
    # the oldest record left the ring; on the CPU there are no events
    assert rows == [{"name": n, "stream_ms": None}
                    for n in ("sac.products", "sac.decode", "train.forward")]
    rec.clear()
    assert rec.records() == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_an_lsac_batch_records_the_serving_vocabulary(spans, dtype):
    import torch
    from repro_torch.core.registry import make_code
    from repro_torch.serving import TorchDeviceBackend
    code = make_code("layer_sac_ortho", 4, 8, eps=6.25e-3)
    sched = MasterScheduler(
        code, TorchDeviceBackend(device="cpu", dtype=getattr(torch, dtype),
                                 straggler_frac=0.2),
        ServeConfig(deadlines=(1.1, 1.6, 3.0, 9.0), batch_size=2, seed=3))
    rng = np.random.default_rng(4)
    for _ in range(2):
        sched.submit(rng.standard_normal((8, 16)),
                     rng.standard_normal((16, 6)))
    with _profiled() as prof:
        sched.run()
    names = [e.name for e in _host_spans(prof)]
    assert set(names) == SERVING_SPANS
    # one batch, one decode over its event loop, a cast of the requests
    # and one of the encoded operands; one generator upload an operand,
    # and the rest of the transfers the exact resolve's weights
    assert names.count("sac.batch") == names.count("sac.decode") == 1
    assert names.count("sac.cast") == 2
    assert names.count("sync.generator") == 2
    assert names.count("sync.recombine_weights") == \
        names.count("sac.decode.resolve") > 0
    assert sorted(r["name"] for r in po.span_records()) == \
        ["sac.cast", "sac.cast", "sac.decode", "sac.products"]


def test_a_train_step_records_the_training_vocabulary(spans):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import make_train_step
    cfg = get_arch("hymba-1.5b", smoke=True).replace(dtype="float32")
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    opt = adamw_init(dict(params.named_parameters()))
    step = make_train_step(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with _profiled() as prof:
        step(params, opt, {"tokens": tokens}, 5)
    got = _host_spans(prof)
    assert sorted(e.name for e in got) == sorted(TRAINING_SPANS)
    assert all(e.cpu_parent.name == "train.step" for e in got
               if e.name != "train.step")
    assert sorted(r["name"] for r in po.span_records()) == \
        sorted(TRAINING_SPANS - {"train.step"})
