"""The port's examples, ``sac_top``, ``PAPER_JOB`` and ``jit_batch``.

Each example runs on the CPU.  Where both packages compute in host float64
(the quickstart and the two services on the simulated backend) its output
must equal the reference example's line for line.  The reference examples
run at import, so this file runs their source; a full-size run takes tens
of seconds (``quickstart`` recomputes the products 72 times, the services
run complex float64 einsums), so their size constants (the contraction,
and the autotuner's requests and window) are changed alike in both
packages: in the reference's source, and by ``monkeypatch`` on the port
module's constants.  ``train_lm_coded`` runs 2 steps (the reference's 30),
``fault_tolerance`` 4; each must print its summary lines and pass its own
check.  Each test runs on one torch thread and one BLAS thread: the
suite's parallel workers share the host's cores, and the default of one
thread a core slowed these tests and their neighbours several times
over.
``sac_top attribution`` is held to the reference tool's output on one
report and trace, as text and as JSON.
"""
import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import sac_top as ref_sac_top
from repro.configs import PAPER_JOB as REF_PAPER_JOB
from repro.core import LayerSACCode as RefLayerSAC
from repro_torch.configs import PAPER_JOB, PaperJobConfig
from repro_torch.convert import code_from_reference
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.examples import (autotune_service, coded_matmul_service,
                                  fault_tolerance, quickstart,
                                  train_lm_coded)
from repro_torch.obs import Tracer
from repro_torch.serving import (MasterScheduler, ServeConfig,
                                 SimulatedBackend, TenantSpec,
                                 build_workload)
from repro_torch.tools import sac_top

try:
    from threadpoolctl import threadpool_limits
except ImportError:                    # no limit: slower, the same results
    def threadpool_limits(limits):
        return contextlib.nullcontext()

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _reference_example(name: str, capsys, subs=()) -> str:
    """Run ``examples/<name>.py`` of the reference (it runs at import),
    with each ``(old, new)`` of ``subs`` replaced in its source; returns
    what it printed."""
    path = ROOT / "examples" / f"{name}.py"
    src = path.read_text()
    for old, new in subs:
        assert src.count(old) >= 1, (name, old)
        src = src.replace(old, new)
    capsys.readouterr()
    exec(compile(src, str(path), "exec"), {"__name__": f"ref_{name}"})
    return capsys.readouterr().out


def _port_example(module, capsys, monkeypatch, **sizes) -> str:
    """Run the port example ``module`` on the CPU with each of its size
    constants in ``sizes`` set; returns what it printed."""
    for name, value in sizes.items():
        assert hasattr(module, name), (module.__name__, name)
        monkeypatch.setattr(module, name, value)
    capsys.readouterr()
    module.main(["--device", "cpu"])
    return capsys.readouterr().out


# ------------------------------------------------------------- configs/data

def test_paper_job_matches_reference():
    assert dataclasses.asdict(PAPER_JOB) == dataclasses.asdict(REF_PAPER_JOB)
    assert [f.name for f in dataclasses.fields(PaperJobConfig)] == \
        [f.name for f in dataclasses.fields(type(REF_PAPER_JOB))]
    with pytest.raises(dataclasses.FrozenInstanceError):
        PAPER_JOB.N = 12


@pytest.mark.parametrize("kw", [
    {}, {"n_codebooks": 4}, {"vision_tokens": 5, "d_model": 16}],
    ids=["tokens", "codebooks", "vision"])
def test_jit_batch_shapes_dtypes_ranges_and_determinism(kw):
    """The reference's shapes, dtypes and ranges (int32 tokens in
    [0, vocab), float32 vision embeds); the same (seed, step) gives the
    same batch, other steps and seeds other batches."""
    data = SyntheticTokens(vocab_size=97, seq_len=64, global_batch=3,
                           seed=4, **kw)
    b = data.jit_batch(5, device="cpu")
    toks = b["tokens"]
    assert toks.dtype == torch.int32 and toks.device.type == "cpu"
    assert tuple(toks.shape) == data.batch_shape()
    assert int(toks.min()) >= 0 and int(toks.max()) < 97
    assert len(torch.unique(toks)) > 50          # spread over the vocab
    if kw.get("vision_tokens"):
        v = b["vision_embeds"]
        assert v.dtype == torch.float32 and tuple(v.shape) == (3, 5, 16)
        assert abs(float(v.mean())) < 0.5 and 0.5 < float(v.std()) < 1.5
    else:
        assert set(b) == {"tokens"}
    again = data.jit_batch(5, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(toks, data.jit_batch(6, device="cpu")["tokens"])
    other = dataclasses.replace(data, seed=5)
    assert not torch.equal(toks, other.jit_batch(5, device="cpu")["tokens"])


# ---------------------------------------------------------------- examples

def test_quickstart_matches_reference(capsys, monkeypatch):
    """The error table line for line, at a contraction of 400 (the
    reference's 4000 recomputes the products for every m and code)."""
    want = _reference_example("quickstart", capsys,
                              [("(100, 4000)", "(100, 400)"),
                               ("(4000, 100)", "(400, 100)")])
    got = _port_example(quickstart, capsys, monkeypatch, INNER=400)
    assert got == want and len(got.splitlines()) == 25
    assert "EXACT" in got


INNER_512 = [("(100, 2000)", "(100, 512)"), ("(2000, 100)", "(512, 100)")]


def test_coded_matmul_service_matches_reference(capsys, monkeypatch):
    """At a contraction of 512 (the reference's 2000)."""
    want = _reference_example("coded_matmul_service", capsys, INNER_512)
    got = _port_example(coded_matmul_service, capsys, monkeypatch,
                        INNER=512)
    assert got == want
    assert "mean time-to-first-answer: SAC" in got


def test_autotune_service_matches_reference(capsys, monkeypatch):
    """8 requests of contraction 512 with a refit every 4 (the reference's
    48, 2000 and 16): the same retune history, tail errors and switch."""
    want = _reference_example("autotune_service", capsys,
                              [("WINDOW = 16", "WINDOW = 4"),
                               ("REQUESTS = 48", "REQUESTS = 8"),
                               *INNER_512])
    got = _port_example(autotune_service, capsys, monkeypatch, REQUESTS=8,
                        WINDOW=4, INNER=512)
    assert got == want
    assert " retune @  4 req" in got and "post-switch tail" in got


def test_train_lm_coded_runs_on_the_cpu(capsys, monkeypatch):
    """At 2 steps (the reference's 30): the example's own check that the
    coded run's last loss is below its first passes."""
    out = _port_example(train_lm_coded, capsys, monkeypatch, STEPS=2)
    assert "== coded MLP, 1 dead worker ==" in out
    assert "[train] coded MLP: K=" in out
    assert "max |loss gap| over 2 steps:" in out


def test_fault_tolerance_resumes_on_the_same_trajectory(capsys,
                                                        monkeypatch):
    out = _port_example(fault_tolerance, capsys, monkeypatch, STEPS=4,
                        CRASH_AT=2, CKPT_EVERY=1)
    assert "(crashed with exit code 42, as scheduled)" in out
    assert "[train] resumed from step 2" in out
    assert "OK: restart reproduces the uninterrupted run." in out


def test_examples_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coded_matmul_service.main([])


# ----------------------------------------------------------------- sac_top

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port open-loop serve: its request records and its trace file."""
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
    d = tmp_path_factory.mktemp("sac_top")
    report = d / "report.json"
    report.write_text(json.dumps({"requests": reqs}))
    return str(report), tracer.save(str(d / "trace.json"))


@pytest.mark.parametrize("extra", [[], ["--json"], ["--hosts", "a,b",
                                                    "--tail-q", "0.5"]],
                         ids=["text", "json", "hosts"])
def test_sac_top_attribution_matches_reference_tool(served, extra, capsys):
    argv = ["attribution", *served, *extra]
    capsys.readouterr()
    assert ref_sac_top.main(argv) == 0
    want = capsys.readouterr().out
    assert sac_top.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    if "--json" in extra:
        doc = json.loads(got)
        assert doc["kind"] == "attribution-report" and doc["n_requests"]
        assert doc["phase_seconds"]["queue_wait"] > 0


def test_sac_top_live_frame_matches_reference_tool(tmp_path, capsys):
    scrape = {"snapshot": {"counters": {"serve.slo_hit.a": 3,
                                        "serve.slo_miss.a": 1},
                           "histograms": {}},
              "series": {"t": [0.0, 1.0],
                         "gauges": {"serve.queue_depth": [1, 2]},
                         "rates": {"serve.slo_hit.a": [0.0, 3.0]}},
              "burn": {"firing": ["a"], "alerts": []}}
    path = tmp_path / "scrape.json"
    path.write_text(json.dumps(scrape))
    argv = ["live", "--file", str(path), "--once"]
    capsys.readouterr()
    assert ref_sac_top.main(argv) == 0
    want = capsys.readouterr().out
    assert sac_top.main(argv) == 0
    assert capsys.readouterr().out == want and "FIRING" in want


def test_paper_job_shape_serves_on_the_cpu():
    """PAPER_JOB's sizes through the port's device backend on the CPU: its
    N workers' products for one request, against the float64 oracle."""
    from repro_torch.launch.serve import build_code
    from repro_torch.serving import TorchDeviceBackend
    job = PAPER_JOB
    code = build_code("lsac_ortho", job.K, job.N)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((job.Nx, job.Nz))
    B = rng.standard_normal((job.Nz, job.Ny))
    got = TorchDeviceBackend(device="cpu").compute_products(code, [A], [B])
    want = SimulatedBackend(device="cpu").compute_products(code, [A], [B])
    assert tuple(got.shape) == (1, job.N, job.Nx, job.Ny)
    rel = torch.linalg.vector_norm(got.double() - want) \
        / torch.linalg.vector_norm(want)
    assert float(rel) < 1e-5
