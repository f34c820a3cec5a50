"""The frozen yardstick: every count is a function of shapes alone, and the
counts reproduce the hand counts they were taken from."""
import json
import math

import pytest

from h100bench import roofline, traces
from h100bench.conftest import ROOT

HYMBA = json.loads((ROOT / "h100bench/configs/hymba-1.5b.json").read_text())


def test_counts_are_functions_of_shapes_alone():
    a = roofline.lm_forward_flops(HYMBA, 8, 4096, 8 * 4095)
    b = roofline.lm_forward_flops(dict(HYMBA), 8, 4096, 8 * 4095)
    assert a == b
    assert roofline.coded_products_s(96, 2048, 4096, 2048, "float32") == \
        roofline.coded_products_s(96, 2048, 4096, 2048, "float32")


def test_hymba_forward_count_matches_the_hand_count():
    # 3.42 GFLOP a token: 3.11 in the projections and FFN, 0.21 in flash's
    # 4·d a pair, 0.10 in the head
    per_token = roofline.lm_forward_flops(HYMBA, 8, 4096, 8 * 4096) / (
        8 * 4096)
    assert per_token == pytest.approx(3.42e9, rel=5e-3)
    attn = roofline.flash_flops(HYMBA, 8, 4096, 4) / (8 * 4096)
    assert attn == pytest.approx(0.205e9, rel=1e-2)
    # the prefill at 4 x 8192, the head at the last position only
    prefill = roofline.lm_forward_flops(HYMBA, 4, 8192, 4) / (4 * 8192)
    assert prefill == pytest.approx(3.37e9, rel=5e-3)


def test_flash_pairs_counts_the_mask():
    def brute(L, w):
        return sum(1 for q in range(L) for k in range(q + 1)
                   if w <= 0 or q - k < w)
    for L, w in ((1, 0), (7, 0), (7, 3), (64, 16), (50, 64), (33, 33)):
        assert roofline.flash_pairs(L, w) == brute(L, w)


@pytest.mark.parametrize("dtype,want_ms", [("float32", 19.99),
                                           ("bfloat16", 3.34)])
def test_products_bound_matches_the_kernel_table(dtype, want_ms):
    # PERF.md's table: 96 workers of 2048 x 4096 @ 4096 x 2048
    got = roofline.coded_products_s(96, 2048, 4096, 2048, dtype) * 1e3
    assert got == pytest.approx(want_ms, rel=2e-3)


def test_encode_and_scan_bounds_match_the_kernel_table():
    assert roofline.encode_s(4, 24, 8, 2048, 4096) * 1e3 == pytest.approx(
        1.282, rel=2e-3)
    assert roofline.scan_fwd_s(4, 8192, 3200, 16) * 1e3 == pytest.approx(
        0.401, rel=5e-3)
    assert roofline.scan_bwd_s(8, 4096, 3200, 16) * 1e3 == pytest.approx(
        0.401, rel=5e-3)
    # the clock is the published boost clock, not the card's
    assert roofline.EXP_RATE == 16 * 132 * 1.98e9


def test_busy_time_is_the_union_of_intervals():
    ks = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0),
          ("d", 21.0, 22.0)]
    assert traces.union_s(ks) == pytest.approx(17e-6)
    tr = traces.Trace(ks, [("h100bench.step", 0.0, 30.0),
                           ("aten::mm", 12.0, 19.0)], 30e-6, 1)
    assert tr.busy_s <= tr.window_s
    bd = traces.breakdown(tr)
    assert bd["idle_gaps"] == [["step / aten::mm", pytest.approx(8e-6)]]
    assert [n for n, _ in bd["device_ops"]][0] == "a"
    assert math.isclose(sum(v for _, v in bd["device_ops"]), 23e-6)


def test_kinds():
    assert traces.kind("void flash_fwd_wg_kernel<64>(...)") == "flash"
    assert traces.kind("ssm_scan_bwd_kernel") == "scan"
    assert traces.kind("nvjet_tst_128x256") == "other_gemm"
    assert traces.kind("coded_matmul_tf32x3_kernel<true>") == "coded_matmul"
    assert traces.kind("vectorized_elementwise_kernel") == \
        "elementwise_other"


def test_the_harness_spans_are_not_device_operations():
    from types import SimpleNamespace as NS

    def ev(name, s, e, dev):
        return NS(name=name, time_range=NS(start=s, end=e),
                  device_type=f"DeviceType.{dev}")
    prof = NS(events=lambda: [
        ev("h100bench.step", 0.0, 10.0, "CPU"),
        ev("h100bench.step", 0.0, 10.0, "CUDA"),     # its annotation
        ev("gemm", 1.0, 3.0, "CUDA"), ev("add", 5.0, 6.0, "CUDA")])
    tr = traces.from_profile(prof, 10e-6, 1)
    assert [k[0] for k in tr.kernels] == ["gemm", "add"]
    assert tr.busy_s == pytest.approx(3e-6)
