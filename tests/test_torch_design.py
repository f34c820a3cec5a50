"""The port's straggler-aware autotuner (``repro_torch.design``) and the
serve CLI's tune and observability flags, against the reference.

The design modules are copies of the reference's; the sweep runs on the
port's numpy ``SimulationEngine``, which is bit-identical to the
reference's, so frontiers agree to 1e-10 in every objective (they are in
fact equal), and an ``AdaptivePolicy`` fed the same latencies makes the same
retunes.  A policy snapshot written by either package loads in the other.
The CLI runs ``--backend sim`` on the CPU; its JSON report equals the
reference's except for wall-clock fields and the paths it was given, and
its errors (float64 products decoded with torch instead of numpy) agree to
1e-10 relative on the approximate layers.
"""
import json

import numpy as np
import pytest

import repro.design as rd
from repro.core.straggler import (heterogeneous_exp_times_batch,
                                  shifted_exp_times_batch)
from repro.launch import serve as ref_serve
from repro.serving import MasterScheduler as RefScheduler
from repro.serving import ServeConfig as RefConfig
from repro.serving import SimulatedBackend as RefSimulatedBackend
from repro_torch import design as pd
from repro_torch.launch import serve as port_serve
from repro_torch.serving import (MasterScheduler, ServeConfig,
                                 SimulatedBackend, TorchDeviceBackend)

K, N = 4, 12


def _points_equal(got, want):
    assert [p.spec.label() for p in got] == [p.spec.label() for p in want]
    for a, b in zip(got, want):
        for attr in ("err_at_deadline", "tta", "reach_frac"):
            x, y = getattr(a, attr), getattr(b, attr)
            assert abs(x - y) <= 1e-10 * max(abs(y), 1e-300), attr
        assert a.cost == b.cost


def _history(policy):
    return [(ev.n_seen, ev.cls.label() if ev.cls is not None else None,
             ev.trigger, ev.switched, ev.point.spec.label(),
             ev.profile.kind, ev.profile.ks, ev.point.err_at_deadline,
             ev.point.tta, ev.point.cost) for ev in policy.history]


# ------------------------------------------------------ space and profile

def test_code_space_matches_reference():
    for args, kw in (((K, N), {}), ((8, 24), {"N_options": (12, 16, 24)}),
                     ((K, N), {"beta_modes": ("one", "unbiased")})):
        got = [s.label() for s in pd.CodeSpace(*args, **kw)]
        want = [s.label() for s in rd.CodeSpace(*args, **kw)]
        assert got == want and got
    assert [s.label() for s in pd.CodeSpace.tiny(K, N)] == \
        [s.label() for s in rd.CodeSpace.tiny(K, N)]
    assert list(pd.group_compositions(6, 3)) == \
        list(rd.group_compositions(6, 3))


@pytest.mark.parametrize("kind", ["shifted_exp", "heterogeneous", "small"])
def test_profile_fit_matches_reference(kind):
    rng = np.random.default_rng(3)
    if kind == "heterogeneous":
        rows = heterogeneous_exp_times_batch(rng, N, 40, slow_frac=0.3,
                                             slow_shift=4.0, slow_rate=0.3)
    else:
        rows = shifted_exp_times_batch(rng, N, 3 if kind == "small" else 40)
    got, want = pd.StragglerProfile.fit(rows), rd.StragglerProfile.fit(rows)
    assert (got.kind, got.n_obs, got.cache_key()) == \
        (want.kind, want.n_obs, want.cache_key())
    assert got.ks == want.ks and got.shift == want.shift
    b1 = got.sample_batch(np.random.default_rng(1), N, 5)
    b2 = want.sample_batch(np.random.default_rng(1), N, 5)
    np.testing.assert_array_equal(b1.orders, b2.orders)


# --------------------------------------------------------------- sweeps

@pytest.mark.parametrize("profile", ["generator", "fitted"])
def test_pareto_search_frontier_matches_reference(profile):
    if profile == "generator":
        kw = dict(slow_frac=0.3, slow_shift=4.0, slow_rate=0.3)
        prof = (pd.GeneratorProfile("heterogeneous", **kw),
                rd.GeneratorProfile("heterogeneous", **kw))
    else:
        rows = shifted_exp_times_batch(np.random.default_rng(2), N, 16)
        prof = (pd.StragglerProfile.fit(rows), rd.StragglerProfile.fit(rows))
    searches = [mod.ParetoSearch(mod.CodeSpace.tiny(K, N), p, deadline=1.8,
                                 target_error=1e-2, trials=24, seed=0)
                for mod, p in ((pd, prof[0]), (rd, prof[1]))]
    got, want = (s.run() for s in searches)
    _points_equal(got, want)
    _points_equal(searches[0].frontier(), searches[1].frontier())
    assert searches[0].best().spec.label() == \
        searches[1].best().spec.label()
    assert searches[0].best_for_target().spec.label() == \
        searches[1].best_for_target().spec.label()


def test_cost_aware_pick_matches_reference():
    picks = []
    for mod in (pd, rd):
        search = mod.ParetoSearch(mod.CodeSpace(K, 24, N_options=(8, 12, 24)),
                                  mod.GeneratorProfile("shifted_exp"),
                                  deadline=3.0, target_error=1e-2, trials=16,
                                  seed=0)
        picks.append(search.best_for_target())
    _points_equal([picks[0]], [picks[1]])


# ---------------------------------------------------------------- policy

def _feed(policy, stream, per_class=False):
    """Feed (cls, row) observations, retuning after each like the master
    does between batches."""
    for cls, row in stream:
        if per_class:
            policy.observe(row, cls=cls)
            policy.maybe_retune(cls)
        else:
            policy.observe(row)
            policy.maybe_retune()


def _stream(mod, per_class):
    rng = np.random.default_rng(21)
    fast = mod.RequestClass(rows=32, inner=128, dtype="f8")
    slow = mod.RequestClass(rows=512, inner=2048, dtype="f8")
    out = []
    for i in range(24):
        if i < 12:
            row = shifted_exp_times_batch(rng, N, 1)[0]
        else:
            row = shifted_exp_times_batch(rng, N, 1, shift=4.0, rate=0.3)[0]
        out.append((slow if per_class and i % 3 == 0 else fast, row))
    return out


@pytest.mark.parametrize("case", ["window", "ks", "page_hinkley", "per_class",
                                  "cost_aware"])
def test_adaptive_policy_retune_history_matches_reference(case):
    kw = dict(deadline=1.5, target_error=1e-2, window=4, trials=8, seed=0)
    space_kw = {}
    if case in ("ks", "page_hinkley"):
        kw.update(drift=case, drift_kw={"alpha": 0.01, "min_rows": 4}
                  if case == "ks" else {})
    if case == "per_class":
        kw.update(per_class=True)
    if case == "cost_aware":
        kw.update(cost_aware=True)
        space_kw = {"N_options": (8, 10, 12)}
    hist = []
    for mod in (pd, rd):
        policy = mod.AdaptivePolicy(mod.CodeSpace(K, N, **space_kw), **kw)
        _feed(policy, _stream(mod, case == "per_class"),
              per_class=case == "per_class")
        hist.append(_history(policy))
    assert hist[0] == hist[1] and hist[0]
    if case == "ks":
        assert "drift" in [h[2] for h in hist[0]]
    if case == "per_class":
        assert len({h[1] for h in hist[0]}) == 2


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_save_state_loads_in_the_other_package(writer, tmp_path):
    src, dst = (pd, rd) if writer == "port" else (rd, pd)

    def make(mod):
        return mod.AdaptivePolicy(mod.CodeSpace.tiny(K, N), deadline=1.5,
                                  target_error=1e-2, window=4, trials=8,
                                  seed=0, drift="ks", per_class=True)

    policy = make(src)
    for cls, row in _stream(src, True)[:12]:
        policy.observe(row, cls=cls)
        policy.maybe_retune(cls)
    path = tmp_path / "state.json"
    src.save_state(policy, str(path))
    restored = make(dst)
    warm = dst.load_state(restored, str(path))
    assert sorted(c.label() for c in warm) == \
        sorted(c.label() for c in policy.classes())
    for cls in policy.classes():
        dcls = dst.RequestClass(cls.rows, cls.inner, cls.dtype)
        assert restored._state(dcls).current_spec.label() == \
            policy._state(cls).current_spec.label()
        assert restored._state(dcls).seen == policy._state(cls).seen
    # the restored policy writes back the snapshot it read
    again = tmp_path / "again.json"
    dst.save_state(restored, str(again))
    assert json.loads(again.read_text()) == json.loads(path.read_text())


# ------------------------------------------------- serving with a policy

def _requests(rng, shapes):
    return [(rng.standard_normal((r, z)), rng.standard_normal((z, r)))
            for r, z in shapes]


@pytest.mark.parametrize("backend", ["sim", "device"])
def test_scheduler_switches_match_reference(backend):
    """A per-class policy on the port's scheduler switches codes at the same
    requests, to the same codes, as on the reference's; the device backend
    draws the latencies the simulated one does."""
    shapes = [(24, 64)] * 6 + [(40, 128)] * 6
    reqs = _requests(np.random.default_rng(5), shapes)
    cfg = dict(deadlines=(1.5, 2.5), batch_size=2, seed=0)
    kw = dict(deadline=1.5, target_error=1e-2, window=4, trials=8, seed=1,
              per_class=True)
    ref_pol = rd.AdaptivePolicy(rd.CodeSpace.tiny(K, N), **kw)
    rs = RefScheduler(rd.default_spec("matdot", K, N).build(),
                      RefSimulatedBackend(straggler_frac=0.2),
                      RefConfig(**cfg), policy=ref_pol)
    pol = pd.AdaptivePolicy(pd.CodeSpace.tiny(K, N), **kw)
    be = SimulatedBackend(straggler_frac=0.2, device="cpu") \
        if backend == "sim" else TorchDeviceBackend(straggler_frac=0.2,
                                                    device="cpu")
    ps = MasterScheduler(pd.default_spec("matdot", K, N).build(), be,
                         ServeConfig(**cfg), policy=pol)
    for A, B in reqs:
        rs.submit(A, B)
        ps.submit(A, B)
    rr, pr = rs.run(), ps.run()
    assert ps.switches == rs.switches and ps.switches
    assert _history(pol) == _history(ref_pol)
    assert sorted(c.label() for c in ps.class_codes) == \
        sorted(c.label() for c in rs.class_codes)
    assert [(r.req_id, r.batch, r.ttfa, r.t_exact) for r in pr] == \
        [(r.req_id, r.batch, r.ttfa, r.t_exact) for r in rr]


def test_policy_switch_bit_identical_to_direct_code():
    """Inside the port: after an adaptive switch, the scheduler serves as a
    fresh scheduler running the chosen code (same rng, same requests)."""
    backend_kw = dict(model="heterogeneous", slow_frac=0.3, slow_shift=4.0,
                      slow_rate=0.3)
    cfg = ServeConfig(deadlines=(1.5, 2.5), batch_size=2, seed=0)
    policy = pd.AdaptivePolicy(pd.CodeSpace.tiny(K, N), deadline=1.5,
                               target_error=1e-2, window=4, trials=16,
                               seed=1)
    start = pd.default_spec("matdot", K, N).build()
    sched = MasterScheduler(start, SimulatedBackend(device="cpu",
                                                    **backend_kw),
                            cfg, policy=policy)
    for A, B in _requests(np.random.default_rng(5), [(24, 256)] * 6):
        sched.submit(A, B)
    sched.run()
    assert sched.switches and sched.code is not start
    reqs = _requests(np.random.default_rng(7), [(24, 256)] * 3)
    runs = []
    for s in (sched, MasterScheduler(sched.code, SimulatedBackend(
            device="cpu", **backend_kw), cfg)):
        s.rng = np.random.default_rng(99)
        for A, B in reqs:
            s.submit(A, B)
        runs.append([(r.ttfa, r.t_exact,
                      [(a.t, a.m, a.kind, a.rel_err) for a in r.answers])
                     for r in s.run()])
    assert runs[0] == runs[1]


# ------------------------------------------------------------------ CLI

WALL = {"wall_s", "rps"}


def _serve_pair(tmp_path, extra):
    out = {}
    for name, mod, dev in (("ref", ref_serve, []),
                           ("port", port_serve, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        argv = ["--rows", "32", "--inner", "256", "--requests", "16",
                "--backend", "sim", "--code", "lsac_ortho", "--autotune",
                "--target-error", "1e-2", "--profile-window", "4",
                "--metrics-out", str(d / "metrics.json"),
                "--trace-out", str(d / "trace.json"),
                "--flight-recorder", str(d / "flight.json"),
                "--sample-interval", "0.5", "--burn-alerts",
                "--profile-state", str(d / "state.json"), *extra, *dev]
        rep = mod.run_serve(mod.build_parser().parse_args(argv)).to_dict()
        out[name] = (rep, d)
    return out


def _strip_paths(obj, d):
    if isinstance(obj, dict):
        return {k: _strip_paths(v, d) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_strip_paths(v, d) for v in obj]
    if isinstance(obj, str):
        return obj.replace(str(d), "<dir>")
    return obj


@pytest.mark.parametrize("extra", [
    ["--per-class", "--class-cache", "8"],
    ["--drift", "ks", "--cost-aware", "--N-options", "16,24"],
    ["--drift", "page_hinkley", "--fleet", "20"],
], ids=["per-class", "ks-cost-aware", "page-hinkley-fleet"])
def test_cli_tune_and_observability_report_matches_reference(tmp_path,
                                                             extra):
    """The same JSON report as the reference CLI, key for key, except the
    wall-clock fields and the paths given; the saved metrics counters and
    profile state are equal too; a second run restores the state."""
    runs = _serve_pair(tmp_path, extra)
    (ref, rdir), (port, pdir) = runs["ref"], runs["port"]
    ref, port = _strip_paths(ref, rdir), _strip_paths(port, pdir)
    assert port["autotune"]["retunes"]
    for key in ("code", "cache", "autotune", "observability", "cluster"):
        assert port[key] == ref[key], key
    assert port["config"] == dict(ref["config"], device="cpu")
    ps, rs = port["summary"], ref["summary"]
    assert set(ps) == set(rs)
    assert {k: v for k, v in ps.items() if k not in WALL | {"deadlines"}} \
        == {k: v for k, v in rs.items() if k not in WALL | {"deadlines"}}
    for a, b in zip(ps["deadlines"], rs["deadlines"], strict=True):
        assert (a["deadline"], a["answers"]) == (b["deadline"], b["answers"])
        assert abs(a["mean_err"] - b["mean_err"]) <= 1e-10 * b["mean_err"]
    for a, b in zip(port["requests"], ref["requests"], strict=True):
        assert [(x["t"], x["m"], x["kind"]) for x in a["answers"]] == \
            [(x["t"], x["m"], x["kind"]) for x in b["answers"]]
        for x, y in zip(a["answers"], b["answers"]):
            if y["rel_err"] is not None and x["m"] < port["code"]["R"]:
                assert abs(x["rel_err"] - y["rel_err"]) <= \
                    1e-10 * y["rel_err"]
        assert {k: v for k, v in a.items() if k != "answers"} == \
            {k: v for k, v in b.items() if k != "answers"}
    counters = [json.loads((d / "metrics.json").read_text())["counters"]
                for d in (pdir, rdir)]
    assert counters[0] == counters[1]
    assert json.loads((pdir / "state.json").read_text()) == \
        json.loads((rdir / "state.json").read_text())
    again = port_serve.run_serve(port_serve.build_parser().parse_args(
        ["--rows", "32", "--inner", "256", "--requests", "4", "--backend",
         "sim", "--code", "lsac_ortho", "--autotune", "--device", "cpu",
         "--profile-state", str(pdir / "state.json"), *extra])).to_dict()
    assert again["autotune"]["restored"]


@pytest.mark.parametrize("argv,msg", [
    (["--drift", "ks"], "--drift requires --autotune"),
    (["--autotune", "--N-options", "8,30"], "--N-options entry"),
    (["--autotune", "--profile-window", "0"], "--profile-window"),
    (["--burn-window", "5"], "--burn-window requires --burn-alerts"),
    (["--sample-interval", "0"], "--sample-interval must be > 0"),
    (["--class-cache", "-1"], "--class-cache"),
    (["--fleet", "30"], "--fleet"),
])
def test_cli_rejects_illegal_tune_and_observability_flags(argv, msg):
    with pytest.raises(SystemExit, match="invalid arguments") as e:
        port_serve.run_serve(port_serve.build_parser().parse_args(
            ["--rows", "16", "--inner", "64", "--requests", "1",
             "--device", "cpu", *argv]))
    assert msg in str(e.value)


def test_cli_text_renders_retunes(capsys, tmp_path):
    port_serve.main(["--rows", "32", "--inner", "256", "--requests", "8",
                     "--backend", "sim", "--device", "cpu", "--code",
                     "lsac_ortho", "--autotune", "--profile-window", "4",
                     "--metrics-out", str(tmp_path / "m.json")])
    out = capsys.readouterr().out
    assert "[serve] retune @4 req" in out and "autotune(target=0.01" in out
    assert "metrics snapshot saved to" in out
