"""The readers of the program's spans on a hand-built trace and ring of
span records, whose stream ms, launches and idle gaps are known; each
returns ``None`` where the spans are absent, as against a program that
records none."""
import sys
import types

import pytest

from h100bench import core, program_spans
from h100bench import run as harness
from h100bench.traces import Trace

CODED = ("coded.decode_stream_ms_per_batch", "coded.cast_stream_ms_per_batch",
         "coded.syncs_per_batch", "coded.sync_idle_ms_per_batch")
TRAIN = ("train.forward_stream_ms_per_step",
         "train.backward_stream_ms_per_step",
         "train.optimizer_stream_ms_per_step",
         "train.optimizer_launches_per_step",
         "train.optimizer_idle_ms_per_step")


def rec(name, ms):
    return {"name": name, "stream_ms": ms}


# two batches' timed spans; the products' own is read by no reader here
CODED_RECORDS = [
    rec("sac.cast", 2.0), rec("sac.cast", 0.5), rec("sac.products", 9.0),
    rec("sac.decode", 7.0), rec("sac.cast", 1.0), rec("sac.products", 8.0),
    rec("sac.decode", 5.0)]
# kernels leave gaps at 10 (10 us), 30 (5 us) and 50 (10 us): the first
# opens in a generator upload, the second in a weight upload inside a
# decode's resolve, the third under a host op inside the second batch alone
CODED_TRACE = Trace(
    kernels=[("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 35.0, 50.0),
             ("k", 60.0, 70.0)],
    spans=[("h100bench.serve_round", 0.0, 100.0), ("sac.batch", 0.0, 45.0),
           ("sync.generator", 8.0, 15.0), ("sac.decode", 25.0, 40.0),
           ("sac.decode.resolve", 27.0, 34.0),
           ("sync.recombine_weights", 28.0, 33.0),
           ("sac.batch", 46.0, 100.0), ("cudaStreamSynchronize", 49.0, 55.0)],
    window_s=1e-4, units=2)
CODED_WANT = {"coded.decode_stream_ms_per_batch": 6.0,
              "coded.cast_stream_ms_per_batch": 1.75,
              "coded.syncs_per_batch": 1.0,
              "coded.sync_idle_ms_per_batch": 0.0075}

TRAIN_RECORDS = [
    rec("train.forward", 30.0), rec("train.backward", 50.0),
    rec("train.clip", 2.0), rec("train.optimizer", 10.0),
    rec("train.apply", 1.0), rec("train.forward", 28.0),
    rec("train.backward", 48.0), rec("train.clip", 2.0),
    rec("train.optimizer", 8.0), rec("train.apply", 1.0)]
# the optimizer's spans hold four launches (one before them does not
# count) and the gaps at 65 (5 us) and 92 (3 us); the gap at 40 (10 us)
# opens in the backward
TRAIN_TRACE = Trace(
    kernels=[("k", 0.0, 40.0), ("k", 50.0, 65.0), ("k", 70.0, 92.0),
             ("k", 95.0, 99.0)],
    spans=[("h100bench.train_step", 0.0, 100.0), ("train.step", 0.0, 99.0),
           ("train.forward", 1.0, 20.0), ("train.backward", 20.0, 60.0),
           ("cudaLaunchKernel", 45.0, 46.0), ("train.clip", 60.0, 68.0),
           ("cudaLaunchKernel", 61.0, 62.0), ("train.optimizer", 68.0, 90.0),
           ("cudaLaunchKernelExC", 72.0, 73.0), ("cuLaunchKernel", 80.0, 81.0),
           ("train.apply", 90.0, 96.0), ("cudaLaunchKernel", 91.0, 92.0),
           ("aten::copy_", 91.5, 93.0), ("train.step", 100.0, 110.0)],
    window_s=1.1e-4, units=2)
TRAIN_WANT = {"train.forward_stream_ms_per_step": 29.0,
              "train.backward_stream_ms_per_step": 49.0,
              "train.optimizer_stream_ms_per_step": 12.0,
              "train.optimizer_launches_per_step": 2.0,
              "train.optimizer_idle_ms_per_step": 0.004}


def _ctx(trace):
    return types.SimpleNamespace(trace=trace,
                                 profiled={"batches": trace.units})


@pytest.mark.parametrize("metric,records,trace", [
    (m, CODED_RECORDS, CODED_TRACE) for m in CODED] + [
    (m, TRAIN_RECORDS, TRAIN_TRACE) for m in TRAIN])
def test_each_reader_reads_the_hand_computed_value(monkeypatch, metric,
                                                   records, trace):
    monkeypatch.setattr(program_spans, "records", lambda: records)
    want = {**CODED_WANT, **TRAIN_WANT}[metric]
    assert core.reader(metric).read(_ctx(trace)) == pytest.approx(want)


@pytest.mark.parametrize("metric", CODED + TRAIN)
@pytest.mark.parametrize("absent", ["spans", "unit"])
def test_each_reader_is_none_without_its_spans(monkeypatch, metric, absent):
    coded = metric.startswith("coded")
    records, trace = (CODED_RECORDS, CODED_TRACE) if coded else (
        TRAIN_RECORDS, TRAIN_TRACE)
    if absent == "spans":                    # a program without spans
        records, keep = None, lambda n: not n.startswith(
            program_spans.PREFIXES)
    else:                                    # the unit's spans left out
        unit = "sac.batch" if coded else "train.step"
        keep = lambda n: n != unit           # noqa: E731
    trace = Trace(trace.kernels, [s for s in trace.spans if keep(s[0])],
                  trace.window_s, trace.units)
    monkeypatch.setattr(program_spans, "records", lambda: records)
    assert core.reader(metric).read(_ctx(trace)) is None


def test_a_program_without_the_ring_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs",
                        types.ModuleType("repro_torch.obs"))
    assert program_spans.records() is None


def test_a_traced_cpu_batch_counts_its_transfers(tiny_root):
    """The program's spans through the harness: one profiled round of four
    requests makes two generator uploads and one weight upload a request's
    exact resolve; the stream readers have no events on the CPU."""
    from repro_torch import obs
    obs.clear_spans()
    try:
        out = harness.run("sac-lsac-k8n24.bf16-closed4", 2**31 + 17, 0.05,
                          True, device="cpu", root=tiny_root)
    finally:
        obs.clear_spans()
    assert out["correct"]
    assert out["metrics"]["coded.syncs_per_batch"]["value"] == 6.0
    assert "coded.decode_stream_ms_per_batch" not in out["metrics"]
