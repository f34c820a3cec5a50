"""The harness end to end at tiny sizes on the CPU: every cell runs and is
judged correct, each fault planted in the program is judged not correct,
each control fails one of its cell's numbers, nothing loads JAX or the JAX
package, and ``BENCHMARK.json`` keeps to its contract."""
import json
import math
import re
import subprocess
import sys

import pytest
import torch

from h100bench import checks, core
from h100bench import run as harness
from h100bench.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def tiny(root, name, **kw):
    got = {}
    out = harness.run(name, 2**31 + 11, 0.05, False, device="cpu",
                      root=root, hook=lambda d: got.setdefault("d", d), **kw)
    return out, got["d"]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_and_is_correct(tiny_root, name):
    out, _ = tiny(tiny_root, name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in SPEC["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_every_control_fails_a_number(tiny_root, name):
    out, drv = tiny(tiny_root, name)
    limits = core.cell(name, tiny_root)["limits"]
    ctl = drv.check(core.cell(name, tiny_root)["traffic"]["control"])
    assert any(v > limits[k] for k, v in ctl.items()), ctl


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_on_the_card_and_its_control_fails(tiny_root, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = {}
    out = harness.run(name, 2**31 + 13, 0.05, True, device="cuda",
                      root=tiny_root, hook=lambda d: got.setdefault("d", d))
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    limits = core.cell(name, tiny_root)["limits"]
    ctl = got["d"].check(core.cell(name, tiny_root)["traffic"]["control"])
    assert any(v > limits[k] for k, v in ctl.items()), ctl


def test_a_traced_run_prints_its_trace(tiny_root):
    out = harness.run("sac-lsac-k8n24.f32-closed4", 5, 0.05, True,
                      device="cpu", root=tiny_root)
    assert out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _plant(monkeypatch, fault):
    from repro_torch.runtime import steps
    from repro_torch.serving.incremental import IncrementalDecoder
    if fault == "decoder_state_unchanged":
        monkeypatch.setattr(IncrementalDecoder, "push", lambda *a: None)
    elif fault == "answer_altered":
        est = IncrementalDecoder.estimate
        monkeypatch.setattr(IncrementalDecoder, "estimate", lambda self: (
            None if est(self) is None else est(self) * 1.1))
    elif fault == "answer_nan":
        est = IncrementalDecoder.estimate
        monkeypatch.setattr(IncrementalDecoder, "estimate", lambda self: (
            None if est(self) is None else est(self) * float("nan")))
    elif fault == "state_unchanged":
        update = steps.adamw_update

        def unchanged(grads, state, params, **kw):
            return dict(params), update(grads, state, params, **kw)[1]
        monkeypatch.setattr(steps, "adamw_update", unchanged)


@pytest.mark.parametrize("name,fault", [
    ("sac-lsac-k8n24.f32-closed4", "decoder_state_unchanged"),
    ("sac-lsac-k8n24.f32-closed4", "answer_altered"),
    ("sac-lsac-k8n24.bf16-closed4", "answer_altered"),
    ("sac-lsac-k8n24.f32-closed4", "answer_nan"),
    ("sac-lsac-k8n24.bf16-closed4", "answer_nan"),
    ("hymba-1.5b.train-8x4096", "state_unchanged"),
    ("hymba-1.5b.train-8x4096", "half_batch"),
])
def test_a_fault_in_the_program_is_not_correct(tiny_root, monkeypatch, name,
                                               fault):
    if fault == "half_batch":
        with checks.planted(fault):
            out, _ = tiny(tiny_root, name)
    else:
        _plant(monkeypatch, fault)
        out, _ = tiny(tiny_root, name)
    assert not out["correct"], out["checks"]


def test_nothing_loads_jax_or_the_jax_package(tiny_root):
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from h100bench import core, run\n"
        f"root = Path({str(tiny_root)!r})\n"
        f"for name in {CELLS!r}:\n"
        "    run.run(name, 3, 0.01, False, device='cpu', root=root)\n"
        "    for m in core.cell(name, root)['per_layer']:\n"
        "        core.reader(m['name'])\n"
        "print(json.dumps([core.forbidden_modules(),\n"
        "                  'repro_torch' in sys.modules]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny_root,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert res.returncode == 0, res.stderr[-3000:]
    forbidden, ported = json.loads(res.stdout.strip().splitlines()[-1])
    assert forbidden == [] and ported


def test_a_small_leaf_moved_double_fails_by_its_own_norm():
    train = core.driver("lm_train").Cell.__new__(core.driver("lm_train").Cell)
    # a norm's weight moved double, beside seven large leaves; "still" is
    # left where it was by both sides, "tiny" has no gradient to speak of
    g1 = {**{f"big.{i}": 1.0 + i for i in range(7)}, "norm": 1e-2,
          "still": 1e-2, "tiny": 1e-9}
    change = {**{f"big.{i}": 1.0 for i in range(7)}, "norm": 1e-3,
              "still": 0.0, "tiny": 0.0}
    train._ref = {"plain": {"losses": [1.0], "g1": g1, "change": change}}
    train.losses, train.g1 = [1.0], dict(g1)
    train.change = {**change, "norm": 2e-3}
    got = train.check()
    limits = core.load_json(ROOT / "h100bench/limits"
                            / "hymba-1.5b.train-8x4096.json")
    assert got["change_gap"] < limits["change_gap"]
    assert got["leaf_change_gap"] == pytest.approx(1.0)
    assert got["leaf_grad_gap"] == 0.0


@pytest.mark.parametrize("values,want", [
    ([], 0.0), ([0.5, 2.0, 1.0], 2.0), ([float("nan"), 1.0], math.inf),
    ([1.0, float("nan")], math.inf), ([1.0, -math.inf], math.inf)])
def test_worst_keeps_what_is_not_finite(values, want):
    assert core.worst(iter(values)) == want


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert core.forbidden_modules() == ["jaxlib.fake"]


def test_no_file_reads_the_jax_packages_benchmark():
    needles = ("benchmarks", "results/bench", "import jax", "from jax",
               "import repro\n", "from repro ", "from repro.")
    here = ROOT / "h100bench"
    for p in here.rglob("*.py"):
        if p.name == "test_h100bench_harness.py":
            continue
        text = p.read_text()
        assert not any(n in text for n in needles), p


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    res = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


def test_the_spec_keeps_to_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["h100bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
        assert (ROOT / "h100bench/reference" / f"{c['name']}.py").is_file()
    metrics = {m["name"]: m for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert len(metrics) == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert "setup_s" in metrics and metrics["setup_s"]["bound"] <= 0.25
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (ROOT / "h100bench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "h100bench/limits" / f"{w['name']}.json").is_file()
        e2e = [m for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in SPEC["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2 and layer
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert (ROOT / "h100bench/metrics" / f"{m['name']}.py").is_file()
        assert metrics[m["moves"]] in SPEC["end_to_end"]
        assert set(m["workloads"]) <= set(
            metrics[m["moves"]].get("workloads", m["workloads"]))
    for name in list(metrics) + names + CELLS:
        assert NAME.match(name), name
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert not any(math.isnan(m.get("bound", 0.0)) for m in metrics.values())
