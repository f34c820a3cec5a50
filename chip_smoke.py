#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--out results.json]

Phases (any failed check exits non-zero; nothing is caught and skipped):

1. Build the four kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the compiler's registers and spills for
   every kernel instance; the main path's tensor-core instances must not
   spill (checked at the end, with the serve's accuracy).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at the non-divisible sweep shapes of the tests,
   with the reference's tolerance (the float32 worker products also to
   1e-5 relative Frobenius of the 3xTF32 emulation); time kernel, plain
   version and one library call with CUDA events, beside the card's bound
   and the kernel's earlier time.
3. A small serve on the card against the same serve with the plain
   versions on the CPU: same answer stream, agreeing errors.
4. Serve at full width through ``run_serve`` (2048 x 32768 operands, K=8,
   N=24, batches of 4): L-SAC (ortho) for 8 requests, and the CLI default
   G-SAC [5, 3] (complex points, the four-GEMM path) for 4.  The kernels'
   launch counts are zeroed just before each run and must grow in it.
5. Profile one full-width L-SAC batch and print device time by kernel.
6. The language model's kernels against their plain versions on the card:
   flash attention at the sweep shapes and at hymba-1.5b's prefill
   (4 x 25/5 heads x 8192 x 64, bf16, window 1024 and full causal; to 1e-2
   elementwise and in relative Frobenius error), the
   selective scan at the sweep shapes and at hymba's (4 x 8192 x 3200 x 16,
   bf16, B and C strided), then at falcon-mamba-7b's channel width (Dm
   8192, the same 4 x 8192; checked on the first 512 steps), and the
   scan's design named; kernel, plain version and library call (SDPA; none
   for the scan) timed with CUDA events beside the card's bound.
7. hymba-smoke in float32: the same weights on the card and on the CPU,
   prefill and decode logits within 2e-4 and 2e-3.
8. hymba-1.5b at full width (bf16, seeded random weights): a 1 x 2048
   prefill with the kernels against the plain versions (relative Frobenius
   error of the logits <= 5e-2), then the served run — a 4 x 8192 prefill
   and 32 greedy decode steps — with the launch counts zeroed before it:
   32 launches of each kernel, all in the prefill.
9. Profile one full-width hymba prefill, and 4 decode steps after it, and
   print device time by kernel.
10. Open-loop serving at full width (``MasterScheduler.run_open``): two
    tenants shaped like ``benchmarks/load_slo.py``'s (1024 x 16384 with
    target 3e-1 and deadline 3 s, 2048 x 32768 with 1e-2 and 8 s), L-SAC
    (ortho) K=8, N=24, EDF batches of 4, a queue of 6 that sheds, expired
    requests dropped, Poisson arrivals at 3x the closed-loop capacity on
    the virtual clock; the device backend held against the ``sim`` run of
    the same workload (same sheds, drops and batches; a differing target
    crossing only within 1e-4 of the target; exact states <= 1e-3).
11. ``repro_torch.launch.serve --autotune --per-class`` at 2048 x 32768 for
    16 requests on the device backend and, in a second process started
    before phase 10, on ``sim``: the same retune history, at least one
    retune.
12. ``SimulationEngine(backend="torch")`` on the card at the paper's Fig. 3a
    problem, every code of ``paper_fig3a_codes``, both norms, 100 trials,
    against the numpy backend (1e-10 relative plus twice the float64
    rounding bound of the evaluation); both times.
13. Print the card's name and power limit, one ``{"kernels": [...]}`` line,
    and as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (dense, at the full 700 W power limit)
PEAK_FLOPS = {"float32": 67e12,        # FP32 on the CUDA cores
              "tf32": 495e12,          # TF32 on the tensor cores
              "bfloat16": 989e12,      # bf16 on the tensor cores
              "float64": 67e12}
# The float32 worker products run three TF32 tensor-core passes per output
# (3xTF32), so their bound counts 3 x 2*M*N*Z operations at the TF32 rate.
TF32_PASSES = 3
# The float32 kernel against the emulation of its own arithmetic
# (coded_matmul_3xtf32_ref): relative Frobenius error.
TF32X3_EMU_TOL = 1e-5
PEAK_BYTES = 3.35e12                   # HBM3
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
# Flash attention at hymba's prefill length: with N(0, 1) q and k most
# outputs are about sqrt(e / keys), 0.02-0.05, so the sweep's bf16 5e-2
# would pass a kernel wrong by a typical value.  Elementwise atol = rtol and
# the relative Frobenius error of each batch row are held to this, between
# the kernel's measured max error (3.9e-3, one bf16 ulp; PERF.md) and the
# output scale.
FLASH_LONG_TOL = 1e-2
# bf16 flash in the sweep: besides the elementwise 5e-2, the relative
# Frobenius error of every block of FLASH_ROWS query rows of each head, so
# that a mask off by one key in a few rows shows (it moves those rows by
# about 1 / keys); the rounding of P and of the output to bf16 stays well
# inside it.
FLASH_ROWS, FLASH_ROWS_TOL = 16, 1e-2

# (W, M, Z, N): the reference's sweep, then the 3xTF32 kernel's edges (M, N
# off its 128 tile, Z off its 32 k-step, Z < 8, Z % 4 != 0 and == 0)
MATMUL_SWEEP = [(1, 64, 64, 64), (3, 100, 200, 60), (2, 96, 200, 64),
                (4, 33, 77, 129), (1, 128, 1024, 128),
                (2, 1, 1, 1), (1, 3, 5, 7), (2, 64, 4, 64), (3, 129, 4, 131),
                (1, 200, 36, 200), (2, 130, 33, 129), (1, 257, 100, 250)]
ENCODE_SWEEP = [(24, 8, 100, 1000), (5, 3, 70, 33), (2, 1, 16, 16),
                (7, 11, 129, 65)]
SERVE_ARGS = ["--rows", "2048", "--inner", "32768", "--K", "8", "--N", "24",
              "--batch-size", "4", "--device", "cuda", "--backend", "device",
              "--deadlines", "1.1,1.6,3.0,9.0", "--json"]
# (B, H, Hkv, Lq, Lkv, d): the reference's flash sweep, hymba's heads, the
# other head dims the kernels are built for, then the bf16 tensor-core
# kernel's edges: Lq, Lkv off its query and key tiles (Lkv < Lq too),
# groups of 1, 5 and 8
FLASH_SWEEP = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 64, 64, 32),
               (1, 8, 1, 32, 32, 16), (1, 2, 1, 16, 80, 16),
               (1, 2, 2, 50, 70, 16), (1, 25, 5, 300, 300, 64),
               (2, 4, 1, 70, 70, 128), (1, 8, 1, 40, 40, 256),
               (1, 2, 2, 1, 1, 64), (1, 4, 4, 7, 130, 64),
               (1, 10, 2, 129, 129, 128), (2, 10, 2, 200, 333, 256),
               (1, 16, 2, 300, 97, 16), (1, 16, 2, 65, 64, 32)]
# (Bt, L, Dm, S): the reference's scan sweep plus odd state sizes
SCAN_SWEEP = [(1, 32, 16, 4), (2, 48, 24, 16), (2, 100, 40, 8),
              (1, 33, 17, 16), (2, 40, 70, 5), (1, 20, 9, 32)]
# hymba-1.5b serving: a cut of the repo's prefill_32k (32 x 32768) that fits
# the script's time limit, then greedy decode
LM_ARCH, LM_BATCH, LM_PROMPT, LM_DECODE = "hymba-1.5b", 4, 8192, 32
SFU_PER_SM_CLOCK = 16        # exp results per SM per clock (compute 9.0)
# falcon-mamba-7b's channels (src/repro_torch/configs/falcon_mamba_7b.py)
# and the length the scan's check against the plain loop is cut to there
FALCON_D_INNER, SCAN_CUT_L = 8192, 512
CARD = ""                    # nvidia-smi's name and power limit, set by main


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"[chip_smoke] FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(fn, iters: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sm_count_and_max_clock() -> tuple[int, float]:
    """SMs and the maximum SM clock (Hz) of card 0."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count, \
        mhz * 1e6


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time the card could take: the larger of operations over
    the peak rate for the type and bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_fro(got, want) -> float:
    """Relative Frobenius error ||got - want|| / ||want|| in float32."""
    g, w = got.float(), want.float()
    return float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w))


def check_close(got, want, rtol: float, atol: float, what: str):
    """Elementwise |got - want| <= atol + rtol |want|; returns max abs err."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: non-finite kernel output")
    err = (g - w).abs()
    bad = int((err > atol + rtol * w.abs()).sum())
    max_err = float(err.max()) if err.numel() else 0.0
    if bad:
        fail(f"{what}: {bad} elements outside rtol={rtol} atol={atol} "
             f"(max abs err {max_err:.3e})")
    return max_err


def check_rows_fro(got, want, what: str) -> float:
    """Relative Frobenius error of each block of FLASH_ROWS query rows of
    each (batch, head) of a (B, H, L, d) output, held to FLASH_ROWS_TOL (a
    block that should be 0, rows that see no key, must be 0); returns the
    largest."""
    B, H, L, d = want.shape
    pad = (0, 0, 0, -L % FLASH_ROWS)
    g, w = (torch.nn.functional.pad(x.float(), pad).reshape(B, H, -1,
                                                              FLASH_ROWS * d)
            for x in (got, want))
    err = torch.linalg.vector_norm(g - w, dim=-1)
    ref = torch.linalg.vector_norm(w, dim=-1)
    bad = err > FLASH_ROWS_TOL * ref
    worst = float((err / ref.clamp_min(1e-30)).max())
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} blocks of {FLASH_ROWS} query rows "
             f"outside relative Frobenius error {FLASH_ROWS_TOL} (worst "
             f"{worst:.3e})")
    return worst


def ptxas_report(text: str) -> dict:
    """{mangled kernel instance: registers, stack and spill bytes} from the
    output of ``nvcc -Xptxas -v``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    return out


# instances on the main paths, which must not spill (flash at d = 256 may:
# its spill is reported), by a substring of their mangled names:
# flash_mma_kernel<64>, coded_matmul_tf32x3_kernel<true> and every instance
# of the selective scan (its states live in registers)
NO_SPILL = ("flash_mma_kernelILi64E", "coded_matmul_tf32x3_kernelILb1E",
            "ssm_scan_kernel")


def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"built {', '.join(sorted(paths))} for sm_90a in "
        f"{time.perf_counter() - t0:.1f}s")
    report = {}
    for name in sorted(paths):
        for inst, r in sorted(ptxas_report(_build.build_log(name)).items()):
            report[inst] = r
            log(f"  {name}: {inst}: {r.get('registers')} registers, "
                f"{r.get('stack')} B stack, {r.get('spill_stores')} B spill "
                f"stores, {r.get('spill_loads')} B spill loads")
    return report


def check_no_spill(report: dict) -> None:
    """The main path's tensor-core instances hold their accumulators, and
    the scan its states, in registers: ptxas must report them, with no
    spill."""
    for key in NO_SPILL:
        found = {n: r for n, r in report.items() if key in n}
        if not found or any("registers" not in r for r in found.values()):
            fail(f"ptxas report shows no {key}")
        for name, r in found.items():
            if r.get("spill_stores") or r.get("spill_loads"):
                fail(f"{name} spills: {r}")


def _product_bound(flops: float, nbytes: float, dt: str):
    """Bound of a worker product: float32 runs TF32_PASSES tensor-core
    passes at the TF32 rate, bf16 one pass at the bf16 rate."""
    if dt == "float32":
        return bound_ms(TF32_PASSES * flops, nbytes, "tf32")
    return bound_ms(flops, nbytes, dt)


def phase_coded_matmul(dev, gen) -> dict:
    from repro_torch.kernels import worker_products, worker_products_complex
    from repro_torch.kernels.coded_matmul.ref import (
        coded_matmul_3xtf32_ref, coded_matmul_complex_ref, coded_matmul_ref)
    out = {}
    emu_worst = 0.0
    for W, M, Z, N in MATMUL_SWEEP:
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            A = torch.randn(W, M, Z, device=dev, generator=gen).to(tdt)
            B = torch.randn(W, Z, N, device=dev, generator=gen).to(tdt)
            got = worker_products(A, B)
            check_close(got, coded_matmul_ref(A, B), TOL[dt],
                        TOL[dt] * Z ** 0.5,
                        f"coded_matmul {dt} {(W, M, Z, N)}")
            if dt == "float32":
                emu = rel_fro(got, coded_matmul_3xtf32_ref(A, B))
                emu_worst = max(emu_worst, emu)
                if emu > TF32X3_EMU_TOL:
                    fail(f"coded_matmul float32 {(W, M, Z, N)}: relative "
                         f"Frobenius error {emu:.3e} against the 3xTF32 "
                         f"emulation (limit {TF32X3_EMU_TOL})")
    log("coded_matmul: sweep shapes agree with the plain version "
        f"(float32, bfloat16); float32 within {emu_worst:.2e} of the 3xTF32 "
        f"emulation (limit {TF32X3_EMU_TOL})")
    W, M, Z, N = 96, 2048, 4096, 2048            # the serving main path
    flops = 2.0 * W * M * N * Z
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        A = torch.randn(W, M, Z, device=dev, generator=gen).to(tdt)
        B = torch.randn(W, Z, N, device=dev, generator=gen).to(tdt)
        got = worker_products(A, B)
        err = check_close(got, coded_matmul_ref(A, B), TOL[dt],
                          TOL[dt] * Z ** 0.5, f"coded_matmul {dt} main")
        item = A.element_size()
        b_ms, b_by = _product_bound(flops, item * (W * M * Z + W * Z * N
                                                   + W * M * N), dt)
        row = {"shape": [W, M, Z, N], "dtype": dt, "max_abs_err": err}
        if dt == "float32":
            row["emulation_rel_fro"] = emu = rel_fro(
                got, coded_matmul_3xtf32_ref(A, B))
            if emu > TF32X3_EMU_TOL:
                fail(f"coded_matmul float32 main: relative Frobenius error "
                     f"{emu:.3e} against the 3xTF32 emulation (limit "
                     f"{TF32X3_EMU_TOL})")
            # what the bound assumes: one TF32 pass would be 3x faster
            # but misses float32 accuracy (so do two; tests pin both)
            row["tf32_one_pass_ms"] = bound_ms(flops, 0.0, "tf32")[0]
        del got
        row.update({"ms": time_ms(lambda: worker_products(A, B)),
                    "plain_ms": time_ms(lambda: coded_matmul_ref(A, B)),
                    "library_ms": time_ms(lambda: torch.bmm(A, B)),
                    "bound_ms": b_ms, "bound_by": b_by})
        row["tflops"] = flops / row["ms"] / 1e9
        out[dt] = row
        passes = (f", {TF32_PASSES} TF32 passes; one pass "
                  f"{row['tf32_one_pass_ms']:.2f} ms" if dt == "float32"
                  else "")
        extra = (f", 3xTF32 emulation rel. Frobenius "
                 f"{row['emulation_rel_fro']:.2e}" if dt == "float32" else "")
        log(f"coded_matmul {dt} {W}x{M}x{Z}x{N}: kernel {row['ms']:.2f} ms "
            f"({row['tflops']:.1f} TFLOP/s), plain {row['plain_ms']:.2f} ms, "
            f"torch.bmm {row['library_ms']:.2f} ms, bound {b_ms:.2f} ms "
            f"({b_by}{passes}), max abs err {err:.3e}{extra}")
        del A, B
        torch.cuda.empty_cache()
    # the complex wrapper: four launches into two outputs
    ops = [torch.randn(W, M, Z, device=dev, generator=gen) for _ in range(2)]
    ops += [torch.randn(W, Z, N, device=dev, generator=gen) for _ in range(2)]
    re_, im = worker_products_complex(*ops)
    want_re, want_im = coded_matmul_complex_ref(*ops)
    err = max(check_close(re_, want_re, 2e-4, 4e-4 * Z ** 0.5,
                          "complex re"),
              check_close(im, want_im, 2e-4, 4e-4 * Z ** 0.5,
                          "complex im"))
    del re_, im, want_re, want_im
    b_ms, b_by = _product_bound(4 * flops, 4 * (2 * W * M * Z + 2 * W * Z * N
                                                + 2 * W * M * N), "float32")
    row = {"shape": [W, M, Z, N], "dtype": "complex(float32)",
           "max_abs_err": err,
           "ms": time_ms(lambda: worker_products_complex(*ops), 2),
           "plain_ms": time_ms(lambda: coded_matmul_complex_ref(*ops), 2),
           "bound_ms": b_ms, "bound_by": b_by}
    out["complex"] = row
    log(f"worker_products_complex {W}x{M}x{Z}x{N}: kernel {row['ms']:.2f} ms,"
        f" plain {row['plain_ms']:.2f} ms, bound {b_ms:.2f} ms, "
        f"max abs err {err:.3e}")
    del ops
    torch.cuda.empty_cache()
    return out


def phase_poly_encode(dev, gen) -> dict:
    from repro_torch.core import split_contraction
    from repro_torch.kernels import poly_encode
    from repro_torch.kernels.poly_encode.ref import poly_encode_ref
    for W, K, R, C in ENCODE_SWEEP:
        for dt in ("float32", "bfloat16"):
            G = torch.randn(W, K, device=dev, generator=gen)
            X = torch.randn(K, R, C, device=dev, generator=gen).to(
                getattr(torch, dt))
            check_close(poly_encode(G, X), poly_encode_ref(G, X),
                        TOL[dt], TOL[dt] * K, f"poly_encode {dt} "
                        f"{(W, K, R, C)}")
    log("poly_encode: sweep shapes agree with the plain version "
        "(float32, bfloat16)")
    out = {}
    K, R, C = 8, 2048, 4096
    for W in (24, 48):                  # real points, and [re; im] rows
        for dt in ("float32", "bfloat16"):
            G = torch.randn(W, K, device=dev, generator=gen)
            X = torch.randn(K, R, C, device=dev, generator=gen).to(
                getattr(torch, dt))
            err = check_close(poly_encode(G, X), poly_encode_ref(G, X),
                              TOL[dt], TOL[dt] * K, f"poly_encode {dt} "
                              f"{(W, K, R, C)}")
            item = X.element_size()
            b_ms, b_by = bound_ms(2.0 * W * K * R * C,
                                  item * (K * R * C + W * R * C) + 4 * W * K,
                                  dt)
            row = {"shape": [W, K, R, C], "dtype": dt, "max_abs_err": err,
                   "ms": time_ms(lambda: poly_encode(G, X), 5),
                   "plain_ms": time_ms(lambda: poly_encode_ref(G, X), 5),
                   "bound_ms": b_ms, "bound_by": b_by}
            out[f"W{W}_{dt}"] = row
            log(f"poly_encode {dt} {W}x{K}x{R}x{C}: kernel {row['ms']:.3f} "
                f"ms, plain {row['plain_ms']:.3f} ms, bound {b_ms:.3f} ms "
                f"({b_by}), max abs err {err:.3e}")
    # the main path's call: the A side of a batch of 4 requests, through
    # the strided split_contraction view, real (W=24) and [re; im] (48 rows)
    A = torch.randn(4, 2048, 32768, device=dev, generator=gen)
    Ab, _ = split_contraction(A, A.new_empty(4, 32768, 1), K)
    for rows, parts in ((24, 1), (48, 2)):
        G = torch.randn(rows, K, device=dev, generator=gen)
        err = check_close(poly_encode(G, Ab, parts=parts),
                          poly_encode_ref(G, Ab, parts=parts), 2e-4, 2e-4 * K,
                          f"poly_encode batch rows={rows}")
        nbytes = 4 * (4 * K * R * C + 4 * rows * R * C + rows * K)
        b_ms, b_by = bound_ms(2.0 * 4 * rows * K * R * C, nbytes, "float32")
        row = {"shape": [4, rows, K, R, C], "dtype": "float32",
               "max_abs_err": err,
               "ms": time_ms(lambda: poly_encode(G, Ab, parts=parts), 5),
               "plain_ms": time_ms(lambda: poly_encode_ref(
                   G, Ab, parts=parts), 5),
               "library_ms": time_ms(lambda: torch.einsum(
                   "wk,bkrc->bwrc", G, Ab), 5),
               "bound_ms": b_ms, "bound_by": b_by}
        row["gbps"] = nbytes / row["ms"] / 1e6
        out[f"batch_rows{rows}"] = row
        log(f"poly_encode batch 4x{rows}x{K}x{R}x{C} (strided view): kernel "
            f"{row['ms']:.3f} ms ({row['gbps']:.0f} GB/s), plain "
            f"{row['plain_ms']:.3f} ms, einsum {row['library_ms']:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by}), max abs err {err:.3e}")
    del A, Ab
    torch.cuda.empty_cache()
    return out


def _flash_pairs(Lq: int, Lkv: int, q_offset: int, window: int) -> int:
    """Unmasked (query, key) pairs of one causal head."""
    total = 0
    for i in range(Lq):
        hi = min(Lkv - 1, q_offset + i)
        lo = max(0, q_offset + i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def _sdpa(q, k, v, window: int):
    """One PyTorch call computing the same attention — the yardstick, never
    used by the port: SDPA with ``enable_gqa`` and the causal or window
    mask, on its fused backends only (the math backend would materialize
    the scores)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    mask = None
    if window:
        pos = torch.arange(q.shape[2], device=q.device)
        dist = pos[:, None] - pos[None, :]
        mask = (dist >= 0) & (dist < window)

    def call():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
    return call


def phase_flash(dev, gen) -> dict:
    """The flash kernel against its plain version: the sweep shapes, then
    hymba's prefill (B=4, H=25, Hkv=5, L=8192, d=64, bf16) with the window
    of 29 layers (1024) and full causal attention (3 layers).  The plain
    version runs batch row by batch row so its (H, L, L) scores fit."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rows_worst = 0.0
    for B, H, Hkv, Lq, Lkv, d in FLASH_SWEEP:
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            q = torch.randn(B, H, Lq, d, device=dev, generator=gen).to(tdt)
            k = torch.randn(B, Hkv, Lkv, d, device=dev, generator=gen).to(tdt)
            v = torch.randn(B, Hkv, Lkv, d, device=dev, generator=gen).to(tdt)
            for causal, window in ((True, 0), (True, 8), (False, 24)):
                off = max(0, Lkv - Lq)
                what = (f"flash {dt} {(B, H, Hkv, Lq, Lkv, d)} causal="
                        f"{causal} window={window}")
                got = flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=off)
                want = attention_ref(q, k, v, causal=causal,
                                     window=window or None, q_offset=off)
                check_close(got, want, TOL[dt], TOL[dt], what)
                if dt == "bfloat16":
                    rows_worst = max(rows_worst,
                                     check_rows_fro(got, want, what))
    # bf16 rows that do not start on 16 bytes (odd position stride,
    # unaligned base) are copied once by the wrapper
    flat = torch.randn(2 * 70 * 257 + 1, device=dev, generator=gen).to(
        torch.bfloat16)
    x = flat[1:].view(2, 70, 257)[..., :256].view(2, 70, 4, 64).transpose(1, 2)
    got, want = flash_attention(x, x, x, window=16), attention_ref(
        x, x, x, window=16)
    check_close(got, want, TOL["bfloat16"], TOL["bfloat16"],
                "flash bf16 unaligned view")
    rows_worst = max(rows_worst, check_rows_fro(got, want,
                                                "flash bf16 unaligned view"))
    log("flash_attention: sweep shapes agree with the plain version "
        "(float32, bfloat16; causal, window 8, non-causal window 24), and "
        f"an unaligned bf16 view; bf16 worst relative Frobenius error of a "
        f"block of {FLASH_ROWS} query rows {rows_worst:.2e} (limit "
        f"{FLASH_ROWS_TOL})")
    B, H, Hkv, L, d = 4, 25, 5, LM_PROMPT, 64
    q, k, v = (torch.randn(B, n, L, d, device=dev, generator=gen)
               .to(torch.bfloat16) for n in (H, Hkv, Hkv))
    out = {}
    for window in (1024, 0):
        got = flash_attention(q, k, v, window=window)
        err = fro = 0.0
        for b in range(B):
            want = attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                 window=window or None)
            what = f"flash hymba b={b} window={window}"
            err = max(err, check_close(got[b:b + 1], want, FLASH_LONG_TOL,
                                       FLASH_LONG_TOL, what))
            fro = max(fro, rel_fro(got[b:b + 1], want))
            if fro > FLASH_LONG_TOL:
                fail(f"{what}: relative Frobenius error {fro:.3e} (limit "
                     f"{FLASH_LONG_TOL})")
            del want
        lib = _sdpa(q, k, v, window)
        lib_err = rel_fro(got, lib())
        pairs = B * H * _flash_pairs(L, L, 0, window)
        flops = 4.0 * d * pairs
        nbytes = 2 * (2 * B * H * L * d + 2 * B * Hkv * L * d)
        b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
        row = {"shape": [B, H, Hkv, L, d], "dtype": "bfloat16",
               "window": window, "max_abs_err": err, "rel_fro": fro,
               "unmasked_pairs": pairs,
               "flops": flops,
               "ms": time_ms(lambda: flash_attention(q, k, v, window=window)),
               "plain_ms": time_ms(lambda: [attention_ref(
                   q[b:b + 1], k[b:b + 1], v[b:b + 1], window=window or None)
                   for b in range(B)], 1),
               "library_ms": time_ms(lib), "library_rel_fro": lib_err,
               "bound_ms": b_ms, "bound_by": b_by}
        row["tflops"] = flops / row["ms"] / 1e9
        key = f"window{window}" if window else "causal"
        out[key] = row
        log(f"flash hymba {B}x{H}/{Hkv}x{L}x{d} bf16 "
            f"{'window ' + str(window) if window else 'full causal'}: "
            f"kernel {row['ms']:.2f} ms ({row['tflops']:.1f} TFLOP/s over "
            f"unmasked pairs), plain "
            f"{row['plain_ms']:.2f} ms (4 batch rows),"
            f" SDPA {row['library_ms']:.2f} ms, bound {b_ms:.3f} ms "
            f"({b_by}); vs plain: max abs err {err:.3e}, rel. Frobenius "
            f"{fro:.3e} (limits {FLASH_LONG_TOL}); rel. Frobenius vs SDPA "
            f"{lib_err:.2e}")
        del got
    del q, k, v
    torch.cuda.empty_cache()
    return out


def _scan_bound(Bt, L, Dm, S, elem=2) -> dict:
    """The scan's bound: its exps on the special-function units against
    its bytes (x, dt, B, C read once, y written once; A, D, h_final)."""
    nbytes = elem * (3 * Bt * L * Dm + 2 * Bt * L * S) + 4 * (
        Dm * S + Dm + Bt * Dm * S)
    exps = Bt * L * Dm * S
    sms, clock = sm_count_and_max_clock()
    t_exp = exps / (SFU_PER_SM_CLOCK * sms * clock) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    b_ms, b_by = (t_exp, "operations") if t_exp >= t_bytes else \
        (t_bytes, "bytes")
    return {"bytes": nbytes, "exps": exps, "sm_count": sms,
            "max_sm_clock_hz": clock, "exp_bound_ms": t_exp,
            "byte_bound_ms": t_bytes, "bound_ms": b_ms, "bound_by": b_by}


def phase_scan(dev, gen) -> dict:
    """The scan kernel against its plain version: the sweep shapes (float32
    and bfloat16, B and C as column views of one projection), then hymba's
    prefill shape (Bt=4, L=8192, Dm=3200, S=16, bf16) and falcon-mamba-7b's
    channel width (Dm=8192, the same 4 x 8192; checked on a cut length)."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    def inputs(Bt, L, Dm, S, tdt):
        x = torch.randn(Bt, L, Dm, device=dev, generator=gen).to(tdt)
        dt = (0.01 + 0.19 * torch.rand(Bt, L, Dm, device=dev,
                                       generator=gen)).to(tdt)
        A = -(0.1 + 0.9 * torch.rand(Dm, S, device=dev, generator=gen))
        xp = torch.randn(Bt, L, 100 + 2 * S, device=dev,
                         generator=gen).to(tdt)
        D = torch.randn(Dm, device=dev, generator=gen)
        return x, dt, A, xp[..., 100:100 + S], xp[..., 100 + S:], D

    for shape in SCAN_SWEEP:
        for dt in ("float32", "bfloat16"):
            args = inputs(*shape, getattr(torch, dt))
            y, h = ssm_scan(*args, return_final=True)
            want_y, want_h = ssm_scan_ref(*args, return_final=True)
            tol = 1e-4 if dt == "float32" else 5e-2
            check_close(y, want_y, tol, tol, f"ssm_scan y {dt} {shape}")
            check_close(h, want_h, 1e-4, 1e-4, f"ssm_scan h {dt} {shape}")
    log("ssm_scan: sweep shapes agree with the plain version (y: float32 "
        "1e-4, bfloat16 5e-2; final state 1e-4)")

    Bt, L, Dm, S = LM_BATCH, LM_PROMPT, 3200, 16
    args = inputs(Bt, L, Dm, S, torch.bfloat16)
    y, h = ssm_scan(*args, return_final=True)
    want_y, want_h = ssm_scan_ref(*args, return_final=True)
    err = check_close(y, want_y, 5e-2, 5e-2, "ssm_scan hymba y")
    h_err = check_close(h, want_h, 1e-4, 1e-4, "ssm_scan hymba h_final")
    bound = _scan_bound(Bt, L, Dm, S)
    b_ms, b_by = bound["bound_ms"], bound["bound_by"]
    row = {"shape": [Bt, L, Dm, S], "dtype": "bfloat16", "max_abs_err": err,
           "h_final_max_abs_err": h_err, **bound,
           "ms": time_ms(lambda: ssm_scan(*args, return_final=True), 5),
           "plain_ms": time_ms(lambda: ssm_scan_ref(*args,
                                                    return_final=True), 1),
           "library_ms": None}
    log(f"ssm_scan hymba {Bt}x{L}x{Dm}x{S} bf16 (B, C strided): kernel "
        f"{row['ms']:.3f} ms, plain {row['plain_ms']:.1f} ms, library none, "
        f"bound {b_ms:.3f} ms "
        f"({b_by}; bytes {bound['byte_bound_ms']:.3f} ms, "
        f"{bound['exps']:.3g} exps {bound['exp_bound_ms']:.3f} ms at "
        f"{SFU_PER_SM_CLOCK}/SM/clock x {bound['sm_count']} SMs x "
        f"{bound['max_sm_clock_hz'] / 1e9:.2f} GHz); max abs err y "
        f"{err:.3e}, h_final {h_err:.3e}")
    del args, y, h, want_y, want_h
    torch.cuda.empty_cache()

    # falcon-mamba-7b's channels: checked on the first SCAN_CUT_L steps
    # (the plain loop over 8192 steps would take seconds), timed in full
    Dm = FALCON_D_INNER
    args = inputs(Bt, L, Dm, S, torch.bfloat16)
    cut = [t[:, :SCAN_CUT_L] if t.ndim == 3 else t for t in args]
    want_y, want_h = ssm_scan_ref(*cut, return_final=True)
    y, h = ssm_scan(*cut, return_final=True)
    f_err = check_close(y, want_y, 5e-2, 5e-2, "ssm_scan falcon y (cut)")
    f_h = check_close(h, want_h, 1e-4, 1e-4, "ssm_scan falcon h (cut)")
    bound = _scan_bound(Bt, L, Dm, S)
    falcon = {"shape": [Bt, L, Dm, S], "dtype": "bfloat16",
              "checked_length": SCAN_CUT_L, "max_abs_err": f_err,
              "h_final_max_abs_err": f_h, **bound,
              "ms": time_ms(lambda: ssm_scan(*args, return_final=True), 5)}
    log(f"ssm_scan falcon-mamba-7b {Bt}x{L}x{Dm}x{S} bf16: kernel "
        f"{falcon['ms']:.3f} ms, bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}); first "
        f"{SCAN_CUT_L} steps vs plain: max abs err y {f_err:.3e}, h_final "
        f"{f_h:.3e}")
    log("ssm_scan design: 2 lanes per channel hold its states in registers; "
        "software-pipelined steps (next step's loads and ex2.approx exps in "
        "flight), full chunks unrolled; 128-channel x 32-step chunks, x/dt "
        "by 16-byte cp.async, B/C through registers, y as 16-byte rows; one "
        "barrier a chunk")
    del args, cut, y, h, want_y, want_h
    torch.cuda.empty_cache()
    row["falcon"] = falcon
    return row


def phase_small_lm() -> dict:
    """hymba-smoke in float32, the same weights on the card (kernels) and
    on the CPU (plain versions): prefill logits to 2e-4, decode to 2e-3."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cfg = get_arch(LM_ARCH, smoke=True)
    cpu = init_params(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    gpu = init_params(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    worst = {}
    for name, model, dev in (("card", gpu, "cuda"), ("cpu", cpu, "cpu")):
        logits, state = make_prefill_step(cfg, 48, device=dev)(
            model, {"tokens": tokens[:, :40]})
        step = make_decode_step(cfg, device=dev)
        outs = [logits]
        for t in range(40, 48):
            logits, state = step(model, tokens[:, t:t + 1], state)
            outs.append(logits)
        worst[name] = [o.cpu() for o in outs]
    pre = check_close(worst["card"][0], worst["cpu"][0], 2e-4, 2e-4,
                      "hymba-smoke prefill logits card vs CPU")
    dec = max(check_close(a, b, 2e-3, 2e-3, "hymba-smoke decode logits")
              for a, b in zip(worst["card"][1:], worst["cpu"][1:]))
    log(f"hymba-smoke float32: card (kernels) == CPU (plain versions); "
        f"prefill logits max abs err {pre:.2e} (2e-4), decode {dec:.2e} "
        "(2e-3)")
    return {"prefill_max_abs_err": pre, "decode_max_abs_err": dec}


def phase_full_lm(dev) -> tuple:
    """hymba-1.5b at full width, bf16, random weights from a seed: (1) a
    1 x 2048 prefill with the kernels against the same prefill with the
    plain versions; (2) the served run, a 4 x 8192 prefill and 32 greedy
    decode steps, with the kernels' launch counts zeroed just before it."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention, ssm_scan
    from repro_torch.models import init_params
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cfg = get_arch(LM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    model = init_params(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    log(f"{cfg.name}: {n_params / 1e9:.3f} B parameters, "
        f"{weight_bytes / 1e9:.2f} GB on the card, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    tok_gen = torch.Generator(device=dev)
    tok_gen.manual_seed(13)

    # (1) kernels against plain versions on one 2048-token prompt
    prompt = torch.randint(0, cfg.vocab_size, (1, 2048), device=dev,
                           generator=tok_gen)
    with_k, _ = make_prefill_step(cfg, 2048)(model, {"tokens": prompt})
    t0 = time.perf_counter()
    plain, _ = make_prefill_step(cfg, 2048, use_kernels=False)(
        model, {"tokens": prompt})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    fro = rel_fro(with_k, plain)
    if not (bool(torch.isfinite(with_k).all()) and fro <= 5e-2):
        fail(f"{cfg.name} 1x2048 prefill: kernels vs plain relative "
             f"Frobenius error {fro:.3e} (limit 5e-2) or non-finite logits")
    log(f"{cfg.name} 1x2048 prefill, kernels vs plain versions: last-position"
        f" logits relative Frobenius error {fro:.3e} (limit 5e-2; plain "
        f"prefill {plain_s:.1f} s)")
    del with_k, plain, prompt

    # (2) the served run
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           device=dev, generator=tok_gen)
    prefill_step = make_prefill_step(cfg, LM_PROMPT + LM_DECODE)
    decode = make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in (flash_attention, ssm_scan):
        fn.launches = 0
    t0 = time.perf_counter()
    logits, state = prefill_step(model, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "ssm_scan": ssm_scan.launches}
    finite = bool(torch.isfinite(logits).all())
    generated = []
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        generated.append(nxt)
        logits, state = decode(model, nxt, state)
        finite &= bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    served = {"flash_attention": flash_attention.launches,
              "ssm_scan": ssm_scan.launches}
    if launches != {"flash_attention": cfg.n_layers,
                    "ssm_scan": cfg.n_layers} or served != launches:
        fail(f"{cfg.name} served run: launches {launches} in the prefill, "
             f"{served} in all (want {cfg.n_layers} of each, none in decode)")
    if not finite or state.pos != LM_PROMPT + LM_DECODE:
        fail(f"{cfg.name} served run: non-finite logits or state at "
             f"{state.pos}")
    row = {"arch": cfg.name, "params": n_params, "weight_bytes": weight_bytes,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": LM_DECODE,
           "max_seq": LM_PROMPT + LM_DECODE, "prefill_s": prefill_s,
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
           "decode_s": decode_s,
           "decode_ms_per_token": decode_s / LM_DECODE * 1e3,
           "decode_tokens_per_s": LM_BATCH * LM_DECODE / decode_s,
           "peak_bytes": peak, "launches": served,
           "plain_vs_kernels_rel_fro": fro, "plain_prefill_1x2048_s": plain_s,
           "first_generated": torch.cat(generated, 1)[0, :8].tolist()}
    log(f"{cfg.name} served (cut of prefill_32k: {LM_BATCH} x {LM_PROMPT} "
        f"prompt, max_seq {LM_PROMPT + LM_DECODE}): prefill {prefill_s:.2f} s"
        f" ({row['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{row['decode_ms_per_token']:.1f} ms per step of {LM_BATCH} tokens "
        f"({row['decode_tokens_per_s']:.0f} tokens/s), peak device memory "
        f"{peak / 2**30:.2f} GiB, launches {served}; every logit finite")
    del state, logits
    torch.cuda.empty_cache()
    return row, model, prompt


def phase_lm_breakdown(model, prompt) -> dict:
    """Device time by kernel over one full-width hymba prefill and over 4
    decode steps after it, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cfg = get_arch(LM_ARCH)
    step = make_prefill_step(cfg, LM_PROMPT + LM_DECODE)
    decode = make_decode_step(cfg)
    torch.cuda.synchronize()
    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, state = step(model, {"tokens": prompt})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["prefill"] = _device_rows(prof, wall_ms, f"breakdown ({cfg.name} "
                                  f"prefill {LM_BATCH}x{LM_PROMPT}, "
                                  "profiled)")
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    logits, state = decode(model, nxt, state)             # warm-up step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            logits, state = decode(model, logits[:, -1].argmax(
                -1, keepdim=True), state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["decode"] = _device_rows(prof, wall_ms, f"breakdown ({cfg.name} 4 "
                                 "decode steps after the prefill, profiled)")
    host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()),
                  key=lambda r: -r[2])[:8]
    for name, count, ms in host:
        log(f"  host {ms:9.2f} ms  x{count:<5d} {name[:80]}")
    out["decode"]["host_top"] = [{"name": n, "count": c, "ms": ms}
                                 for n, c, ms in host]
    return out


def _device_rows(prof, wall_ms: float, what: str) -> dict:
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[2])
    if not rows:
        log(f"{what}: the profiler saw no device time (not measured)")
        return {"wall_ms": wall_ms, "kernels": []}
    busy_ms = sum(r[2] for r in rows)
    log(f"{what}: {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %)")
    for name, count, ms in rows[:12]:
        log(f"  {ms:9.2f} ms  x{count:<5d} {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "kernels": [{"name": n, "count": c, "ms": ms}
                        for n, c, ms in rows]}


def _serve(argv):
    from repro_torch.launch.serve import build_parser, run_serve
    return run_serve(build_parser().parse_args(argv)).to_dict()


def phase_small_serve() -> dict:
    """The port on the card against the plain versions on the CPU."""
    argv = ["--rows", "64", "--inner", "1024", "--requests", "4", "--code",
            "lsac_ortho", "--deadlines", "1.1,1.6,3.0,9.0", "--stream",
            "--json"]
    gpu = _serve(argv + ["--device", "cuda"])
    cpu = _serve(argv + ["--device", "cpu"])
    worst = 0.0
    for rg, rc in zip(gpu["requests"], cpu["requests"], strict=True):
        for a, b in zip(rg["answers"], rc["answers"], strict=True):
            if (a["t"], a["m"], a["kind"]) != (b["t"], b["m"], b["kind"]):
                fail(f"small serve: answer stream differs {a} vs {b}")
            if (a["rel_err"] is None) != (b["rel_err"] is None):
                fail("small serve: estimate availability differs")
            if a["rel_err"] is not None:
                d = abs(math.sqrt(a["rel_err"]) - math.sqrt(b["rel_err"]))
                worst = max(worst, d)
    if worst > 1e-5:
        fail(f"small serve: card and CPU estimates differ by {worst:.3e} "
             "of ||C|| (limit 1e-5)")
    log(f"small serve (lsac_ortho 64x1024, 4 requests): card == CPU answer "
        f"stream; estimates agree to {worst:.2e} of ||C||")
    return {"max_norm_diff": worst}


def phase_full_serve(code: str, requests: int) -> dict:
    from repro_torch.kernels import coded_matmul, poly_encode
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    coded_matmul.launches = 0
    poly_encode.launches = 0
    t0 = time.perf_counter()
    rep = _serve(SERVE_ARGS + ["--code", code, "--requests",
                                      str(requests)])
    total = time.perf_counter() - t0
    launches = {"coded_matmul": coded_matmul.launches,
                "poly_encode": poly_encode.launches}
    peak = torch.cuda.max_memory_allocated()
    s = rep["summary"]
    if s["requests"] != requests:
        fail(f"{code}: served {s['requests']} of {requests}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{code}: the {name} kernel was not launched")
    errs = [a["rel_err"] for r in rep["requests"] for a in r["answers"]
            if a["rel_err"] is not None]
    if not errs or not all(math.isfinite(e) for e in errs):
        fail(f"{code}: missing or non-finite errors")
    R = rep["code"]["R"]
    exact = {}                                   # batch -> exact-state errs
    for r in rep["requests"]:
        for a in r["answers"]:
            if a["rel_err"] is not None and a["m"] >= R:
                exact.setdefault(r["batch"], []).append(a["rel_err"])
    rows = s["deadlines"]
    out = {"code": code, "requests": requests, "launches": launches,
           "wall_s": s["wall_s"], "rps": s["rps"], "total_s": total,
           "peak_bytes": peak, "deadlines": rows,
           "exact_max_err_by_batch": {b: max(e) for b, e in exact.items()},
           "cache": rep["cache"]}
    log(f"serve {code} x{requests}: {s['wall_s']:.2f} s serve loop "
        f"({s['rps']:.2f} req/s; {total:.1f} s with operand drawing), peak "
        f"device memory {peak / 2**30:.2f} GiB, launches {launches}")
    for row in rows:
        log(f"  deadline {row['deadline']:.1f}: mean rel err "
            f"{row['mean_err']:.3e} over {row['answers']} answers")
    for b, e in sorted(out["exact_max_err_by_batch"].items()):
        log(f"  batch {b}: exact-state max squared rel err {e:.3e}")
    return out


def phase_breakdown() -> dict:
    """Device time by kernel over one full-width L-SAC batch, from
    ``torch.profiler`` around ``MasterScheduler.run`` (operands made on the
    card, so the window holds the serve loop only)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import CODES
    from repro_torch.serving import (MasterScheduler, ServeConfig,
                                     TorchDeviceBackend)
    code = CODES["lsac_ortho"].build(8, 24)
    sched = MasterScheduler(code, TorchDeviceBackend(straggler_frac=0.15),
                            ServeConfig(deadlines=(1.1, 1.6, 3.0, 9.0)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for _ in range(4):
        sched.submit(torch.randn(2048, 32768, dtype=torch.float64,
                                 device="cuda", generator=gen),
                     torch.randn(32768, 2048, dtype=torch.float64,
                                 device="cuda", generator=gen))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_rows(prof, wall_ms, "breakdown (lsac_ortho, one batch "
                        "of 4, profiled): loop")


# Open-loop serving at the paper job's width: the two tenants of
# benchmarks/load_slo.py (an interactive class with a loose accuracy target
# and a tight deadline, a batch class the other way round), L-SAC (ortho)
# K = 8, N = 24, 15 % stragglers, EDF batches of 4 behind a queue of 6 that
# sheds, expired requests dropped, Poisson arrivals at 3x the closed-loop
# capacity (measured on the virtual clock as load_slo.closed_loop_capacity
# does, from OPEN_CAPACITY_N requests all arriving at 0).
OPEN_TENANTS = (("interactive", 1024, 16384, 3e-1, 3.0, 2.0),
                ("batch", 2048, 32768, 1e-2, 8.0, 1.0))
OPEN_SEED, OPEN_OVERLOAD, OPEN_ARRIVALS, OPEN_CAPACITY_N = 29, 3.0, 24, 8
OPEN_DEADLINES, OPEN_POOL = (0.6, 1.2, 2.4), 2
# A target crossing may differ between the float32 card run and the float64
# oracle only where the error at that tick lies this close to the target.
CROSSING_TOL = 1e-4
OPEN_TARGETS = {t[0]: t[3] for t in OPEN_TENANTS}
AUTOTUNE = {"rows": 2048, "inner": 32768, "K": 8, "N": 24, "requests": 16,
            "window": 4, "target": 1e-2}
AUTOTUNE_ARGS = ["--rows", str(AUTOTUNE["rows"]), "--inner",
                 str(AUTOTUNE["inner"]), "--K", str(AUTOTUNE["K"]), "--N",
                 str(AUTOTUNE["N"]), "--device", "cuda", "--autotune",
                 "--per-class", "--target-error", str(AUTOTUNE["target"]),
                 "--profile-window", str(AUTOTUNE["window"]), "--requests",
                 str(AUTOTUNE["requests"]), "--json"]
# The engine at the paper's Fig. 3a problem, as benchmarks/engine_speedup.py
ENGINE_TRIALS, ENGINE_SEEDS = 100, (5, 6)


def _zero_launches() -> None:
    from repro_torch.kernels import coded_matmul, poly_encode
    torch.cuda.synchronize()
    coded_matmul.launches = 0
    poly_encode.launches = 0


def _read_launches() -> dict:
    from repro_torch.kernels import coded_matmul, poly_encode
    return {"coded_matmul": coded_matmul.launches,
            "poly_encode": poly_encode.launches}


def _open_sched(backend: str, policy: bool):
    from repro_torch.launch.serve import CODES
    from repro_torch.serving import MasterScheduler, ServeConfig, make_backend
    cfg = ServeConfig(deadlines=OPEN_DEADLINES, batch_size=4, seed=OPEN_SEED,
                      queue_policy="edf" if policy else "fifo",
                      queue_limit=6 if policy else None,
                      shed_expired=policy, stream=policy)
    return MasterScheduler(CODES["lsac_ortho"].build(8, 24),
                           make_backend(backend, device="cuda",
                                        straggler_frac=0.15), cfg)


def _crossing_error(res, t_cross):
    """The estimate's error at the completion event at global ``t_cross``
    (a ``stream`` answer), or ``None``."""
    for a in res.answers:
        if a.kind == "event" and a.rel_err is not None \
                and abs(res.t_dispatch + a.t - t_cross) <= 1e-12:
            return a.rel_err
    return None


def phase_open_loop() -> dict:
    """``MasterScheduler.run_open`` at full width on the device backend,
    held against the port's own ``sim`` run (float64 products) of the same
    workload and seed."""
    from dataclasses import replace

    from repro_torch.serving import TenantSpec, build_workload, summarize_load
    tenants = [TenantSpec(n, rows=r, inner=z, target_error=e, deadline=d,
                          weight=w) for n, r, z, e, d, w in OPEN_TENANTS]
    t0 = time.perf_counter()
    probe = build_workload(tenants, rate=1.0, horizon=float(OPEN_CAPACITY_N),
                           seed=OPEN_SEED, operand_pool=OPEN_POOL)
    probe = [replace(r, arrival=0.0) for r in probe[:OPEN_CAPACITY_N]]
    res = _open_sched("device", False).run_open(probe)
    capacity = len(res) / max(r.t_done for r in res)
    rate = OPEN_OVERLOAD * capacity
    horizon = OPEN_ARRIVALS / rate
    wl = build_workload(tenants, rate=rate, horizon=horizon,
                        seed=OPEN_SEED + 1, operand_pool=OPEN_POOL)
    del probe, res
    setup_s = time.perf_counter() - t0
    runs = {}
    for name in ("device", "sim"):
        sched = _open_sched(name, True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        results = sched.run_open(wl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        rep = summarize_load(sched, wl, results, horizon=horizon).to_dict()
        runs[name] = {"sched": sched, "results": results, "wall_s": wall,
                      "launches": launches, "report": rep,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
    dev, sim = runs["device"], runs["sim"]
    R = dev["sched"].code.recovery_threshold
    if dev["launches"]["coded_matmul"] <= 0 \
            or dev["launches"]["poly_encode"] <= 0:
        fail(f"open loop: kernels not launched {dev['launches']}")
    if any(sim["launches"].values()):
        fail(f"open loop: the sim run launched kernels {sim['launches']}")
    # target crossings first: a crossing that differs makes the two
    # schedules part ways, and is allowed only at a tick whose error lies
    # within CROSSING_TOL of the target
    by_id = {r.req_id: r for r in sim["results"]}
    diverge, crossings = math.inf, []
    for r in dev["results"]:
        s = by_id.get(r.req_id)
        if s is None or r.t_target == s.t_target or r.dropped:
            continue
        t_cross = min(t for t in (r.t_target, s.t_target) if t is not None)
        errs = (_crossing_error(r, t_cross), _crossing_error(s, t_cross))
        target = OPEN_TARGETS[r.tenant]
        crossings.append({"req_id": r.req_id, "t": t_cross, "target": target,
                          "err_device": errs[0], "err_sim": errs[1]})
        log(f"  open loop: request {r.req_id} crosses its target {target} "
            f"at different ticks; errors at t={t_cross:.6f}: device "
            f"{errs[0]}, sim {errs[1]}")
        if any(e is None or abs(e - target) > CROSSING_TOL * target
               for e in errs):
            fail(f"open loop: request {r.req_id}'s target crossing differs "
                 f"from the oracle's by more than {CROSSING_TOL} of the "
                 "target")
        diverge = min(diverge, t_cross)

    def schedule(run):
        shed = [x for x in run["sched"].shed if x[1] <= diverge]
        drops = [(r.req_id, r.tenant) for r in run["results"]
                 if r.dropped and r.t_done <= diverge]
        batches = {}
        for r in run["results"]:
            if r.batch is not None and r.t_dispatch <= diverge:
                batches.setdefault(r.batch, []).append(r.req_id)
        return shed, drops, batches

    for what, a, b in zip(("shed list", "drops", "batch members"),
                          schedule(dev), schedule(sim)):
        if a != b:
            fail(f"open loop: {what} differ from the sim run: {a} vs {b}")
    exact = [a.rel_err for r in dev["results"] for a in r.answers
             if a.m >= R and a.rel_err is not None]
    errs = [a.rel_err for r in dev["results"] for a in r.answers
            if a.rel_err is not None]
    if not errs or not all(math.isfinite(e) for e in errs):
        fail("open loop: missing or non-finite errors")
    if exact and max(exact) > 1e-3:
        fail(f"open loop: exact-state error {max(exact):.3e} (limit 1e-3)")
    out = {"capacity_rps": capacity, "offered_rps": rate,
           "horizon": horizon, "arrivals": len(wl), "setup_s": setup_s,
           "crossings_differing": crossings,
           "exact_max_err": max(exact) if exact else None}
    for name, run in runs.items():
        rep = run["report"]
        out[name] = {"wall_s": run["wall_s"], "launches": run["launches"],
                     "peak_bytes": run["peak_bytes"],
                     "batches": len({r.batch for r in run["results"]
                                     if r.batch is not None}),
                     "report": rep}
        log(f"open loop ({name}): {len(wl)} arrivals at {rate:.4f} req/s "
            f"(3x capacity {capacity:.4f}) over {horizon:.3f} s virtual; "
            f"served {rep['served']}, shed {rep['shed']}, dropped "
            f"{rep['dropped']}; serve loop {run['wall_s']:.2f} s wall "
            f"({CARD}); "
            f"launches {run['launches']}; peak device memory "
            f"{run['peak_bytes'] / 2**30:.2f} GiB")
        for tname, t in sorted(rep["tenants"].items()):
            log(f"  {name} {tname}: p99 time-to-target {t['p99_tta']} s, "
                f"goodput {t['goodput']:.4f} SLO hits/s (virtual clock), "
                f"shed {t['shed']}, dropped {t['dropped']}")
    log(f"open loop: device == sim schedule; exact-state max error "
        f"{out['exact_max_err']}")
    out["breakdown"] = _open_loop_breakdown(wl)
    return out


def _open_loop_breakdown(wl) -> dict:
    """Device time by kernel over the device arm served again under
    ``torch.profiler`` (the same workload and seed)."""
    from torch.profiler import ProfilerActivity, profile
    sched = _open_sched("device", True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.run_open(wl)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = _device_rows(prof, wall_ms, f"breakdown (open loop, device arm, "
                       f"profiled; {CARD}): loop")
    host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()),
                  key=lambda r: -r[2])[:6]
    for name, count, ms in host:
        log(f"  host {ms:9.2f} ms  x{count:<5d} {name[:80]}")
    out["host_top"] = [{"name": n, "count": c, "ms": ms}
                       for n, c, ms in host]
    return out


def start_autotune_sim() -> subprocess.Popen:
    """The ``--backend sim`` twin of the autotune run, in a second process:
    drawing the 16 full-width operand pairs takes most of a run's time on
    the host, so the twin draws while this process works."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *AUTOTUNE_ARGS,
         "--backend", "sim"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def phase_autotune(sim_twin: subprocess.Popen, t_twin: float) -> dict:
    """``repro_torch.launch.serve --autotune --per-class`` at full width on
    the device backend, against the same command with ``--backend sim``
    (``sim_twin``, started at ``t_twin``): the same retune history."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    rep = _serve(AUTOTUNE_ARGS + ["--backend", "device"])
    total = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    out_text, err_text = sim_twin.communicate(timeout=900)
    twin_total = time.perf_counter() - t_twin
    if sim_twin.returncode != 0:
        fail(f"autotune: the sim run exited {sim_twin.returncode}: "
             f"{err_text[-2000:]}")
    sim = json.loads(out_text.strip().splitlines()[-1])
    retunes = rep["autotune"]["retunes"]
    if not retunes:
        fail("autotune: no retune fired")
    if retunes != sim["autotune"]["retunes"]:
        fail(f"autotune: retune history differs from the sim run: "
             f"{retunes} vs {sim['autotune']['retunes']}")
    if launches["coded_matmul"] <= 0 or launches["poly_encode"] <= 0:
        fail(f"autotune: kernels not launched {launches}")
    errs = [a["rel_err"] for r in rep["requests"] for a in r["answers"]
            if a["rel_err"] is not None]
    if not errs or not all(math.isfinite(e) for e in errs):
        fail("autotune: missing or non-finite errors")
    switched = [(ev["n_seen"], ev["cls"], ev["pick"]) for ev in retunes
                if ev["switched"]]
    out = {"retunes": retunes, "switched_to": switched,
           "device": {"wall_s": rep["summary"]["wall_s"], "total_s": total,
                      "launches": launches, "peak_bytes": peak},
           "sim": {"wall_s": sim["summary"]["wall_s"],
                   "total_s": twin_total}}
    log(f"autotune (device): {rep['summary']['requests']} requests, serve "
        f"loop {rep['summary']['wall_s']:.2f} s ({total:.1f} s with operand "
        f"drawing; {CARD}); launches {launches}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"autotune (sim, second process): serve loop "
        f"{sim['summary']['wall_s']:.2f} s ({twin_total:.1f} s from its "
        f"start; {CARD})")
    for n, cls, pick in switched:
        log(f"  retune @{n} [{cls}]: switch -> {pick}")
    log(f"autotune: {len(retunes)} retunes, the same on device and sim")
    out["policy_s"] = _autotune_policy_seconds(retunes)
    log(f"autotune: the policy's refits and sweeps take "
        f"{out['policy_s']:.2f} s of the device run's "
        f"{rep['summary']['wall_s']:.2f} s serve loop (host; {CARD})")
    return out


def _autotune_policy_seconds(retunes) -> float:
    """Host seconds of the autotune run's refits and sweeps: the CLI's
    policy fed again the latency rows its scheduler drew (seed 0, one row
    per batch of 4, every shard done), timed, and held to the same retune
    history."""
    import numpy as np

    from repro_torch.core import shifted_exp_times
    from repro_torch.design import AdaptivePolicy, CodeSpace, RequestClass
    at = AUTOTUNE
    policy = AdaptivePolicy(CodeSpace(at["K"], at["N"], beta_modes=("one",)),
                            deadline=1.1, target_error=at["target"],
                            window=at["window"], seed=0, per_class=True)
    cls = RequestClass(rows=at["rows"], inner=at["inner"], dtype="f8")
    N = at["N"]
    rng = np.random.default_rng(0)
    spent = 0.0
    for _ in range(at["requests"] // 4):
        row = shifted_exp_times(rng, N, straggler_frac=0.15)
        t0 = time.perf_counter()
        policy.observe(row, n_requests=4, cls=cls)
        policy.maybe_retune(cls)
        spent += time.perf_counter() - t0
    if [ev.point.spec.label() for ev in policy.history] != \
            [ev["pick"] for ev in retunes]:
        fail("autotune: the policy fed the run's latency rows picks "
             "differently; its time would not be the run's")
    return spent


def _trial_groups(factory, trials: int, seed: int):
    """``average_curves``' draws: one code and one completion order per
    trial, grouped by code identity (one engine per group)."""
    import numpy as np

    from repro_torch.core import simulate_completion
    rng = np.random.default_rng(seed)
    groups = {}
    for _ in range(trials):
        code = factory(rng)
        order = simulate_completion(rng, code.N).order
        groups.setdefault(code.cache_key(), (code, []))[1].append(order)
    products = "cross" if len(groups) > 4 else "direct"
    return [(c, np.stack(o)) for c, o in groups.values()], products


def phase_engine() -> dict:
    """``SimulationEngine(backend="torch")`` on the card at the paper's
    Fig. 3a problem for every code of ``paper_fig3a_codes`` in both norms,
    against the numpy backend: 1e-10 relative plus twice the float64
    rounding bound of the evaluation (``rounding_bound``) on every finite
    entry of every trial's curves."""
    import numpy as np

    from repro_torch.core import (ProblemContext, SimulationEngine,
                                  paper_fig3a_codes, random_problem)
    A, B = random_problem(np.random.default_rng(ENGINE_SEEDS[0]))
    problem = ProblemContext.build(A, B, 8)
    out = {}
    for name, factory in paper_fig3a_codes().items():
        groups, products = _trial_groups(factory, ENGINE_TRIALS,
                                         ENGINE_SEEDS[1])
        t0 = time.perf_counter()
        engines = [(SimulationEngine(code, A, B, products=products,
                                     problem=problem), orders)
                   for code, orders in groups]
        row = {"engines": len(engines), "products": products,
               "init_s": time.perf_counter() - t0}
        for norms in ("exact", "gram"):
            cur, times = {}, {}
            for backend in ("numpy", "torch"):
                evs = [(e.variant(backend=backend, norms=norms,
                                  device="cuda"), o) for e, o in engines]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cur[backend] = [ev.run_batch(o) for ev, o in evs]
                times[backend] = time.perf_counter() - t0
            worst, strict, n = 0.0, 0, 0
            for (e, o), a, b in zip(engines, cur["numpy"], cur["torch"]):
                bound = e.variant(norms=norms).rounding_bound(o)
                for attr in ("total", "approx", "comp"):
                    r, g, bd = (getattr(c, attr) for c in (a, b, bound))
                    if not np.array_equal(np.isnan(r), np.isnan(g)):
                        fail(f"engine {name}/{norms}/{attr}: defined "
                             "entries differ")
                    ok = ~np.isnan(r)
                    d = np.abs(g[ok] - r[ok])
                    tol = 1e-10 * np.abs(r[ok]) + 2 * bd[ok]
                    if np.any(d > tol):
                        fail(f"engine {name}/{norms}/{attr}: torch differs "
                             f"from numpy by {d.max():.3e} beyond the "
                             "bound")
                    rel = d / np.maximum(np.abs(r[ok]), 1e-300)
                    strict += int((rel <= 1e-10).sum())
                    n += int(ok.sum())
                    worst = max(worst, float((d / tol).max(initial=0.0)))
            row[norms] = {"numpy_s": times["numpy"],
                          "torch_s": times["torch"],
                          "entries": n, "within_1e-10_rel": strict,
                          "worst_over_tol": worst}
            log(f"engine {name} {norms}: numpy {times['numpy']:.3f} s, "
                f"torch on the card {times['torch']:.3f} s ({CARD}; "
                f"{len(engines)} engines, {products} products); "
                f"{strict}/{n} entries within 1e-10 relative, the rest "
                f"within the rounding bound (worst {worst:.2e} of it)")
        out[name] = row
    return out


def main(argv=None) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA card: nothing to drive", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("[chip_smoke] run from a checkout of the repository (no "
              "src/repro_torch next to this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    global CARD
    t_start = time.perf_counter()
    card = CARD = card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    ptxas = phase_build()
    mm = phase_coded_matmul(dev, gen)
    enc = phase_poly_encode(dev, gen)
    small = phase_small_serve()
    lsac = phase_full_serve("lsac_ortho", 8)
    gsac = phase_full_serve("gsac_k1_5", 4)
    breakdown = phase_breakdown()
    flash = phase_flash(dev, gen)
    scan = phase_scan(dev, gen)
    small_lm = phase_small_lm()
    lm, model, prompt = phase_full_lm(dev)
    lm_breakdown = phase_lm_breakdown(model, prompt)
    del model, prompt
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    sim_twin = start_autotune_sim()
    try:
        open_loop = phase_open_loop()
        autotune = phase_autotune(sim_twin, t_new)
        engine = phase_engine()
    finally:
        if sim_twin.poll() is None:
            sim_twin.kill()
            sim_twin.wait()
    log(f"open loop, autotune and engine phases: "
        f"{time.perf_counter() - t_new:.1f} s ({card})")

    # The exact L-SAC fit reads the first R completions.  Batch 1's
    # completion order gives a well-conditioned fit: its exact state is held
    # to 1e-7.  Batch 2's order clusters the first R points so that float32
    # product rounding is amplified far more (the reference's own float32
    # device path shows it too); every exact state is held to 1e-3, far
    # below the approximate layers' errors.
    check_no_spill(ptxas)
    by_batch = lsac["exact_max_err_by_batch"]
    if 1 not in by_batch or by_batch[1] > 1e-7:
        fail(f"lsac_ortho batch 1 exact-state error {by_batch.get(1)} "
             "(limit 1e-7)")
    if len(by_batch) != 2 or max(by_batch.values()) > 1e-3:
        fail(f"lsac_ortho exact-state errors {by_batch} (limit 1e-3)")
    rows = lsac["deadlines"]
    if not rows[-1]["mean_err"] < rows[0]["mean_err"]:
        fail(f"lsac_ortho: last deadline error {rows[-1]['mean_err']:.3e} "
             f"not below the first {rows[0]['mean_err']:.3e}")

    log(f"done in {time.perf_counter() - t_start:.1f} s")

    runs = {"lsac_ortho": lsac, "gsac_k1_5": gsac,
            "open_loop": open_loop["device"],
            "autotune": autotune["device"]}
    mm32, enc_main = mm["float32"], enc["batch_rows24"]
    kernels = [
        {"name": "coded_matmul", "status": "ported", "route": "cuda",
         "source": "src/repro_torch/csrc/coded_matmul.cu",
         "replaces": "src/repro/kernels/coded_matmul/kernel.py:50",
         "launches": sum(r["launches"]["coded_matmul"]
                         for r in runs.values()),
         "launches_by_run": {k: r["launches"]["coded_matmul"]
                             for k, r in runs.items()},
         "shape": mm32["shape"], "max_abs_err": mm32["max_abs_err"],
         "ms": mm32["ms"], "plain_ms": mm32["plain_ms"],
         "bound_ms": mm32["bound_ms"], "bound_by": mm32["bound_by"],
         "library_ms": mm32["library_ms"]},
        {"name": "poly_encode", "status": "ported", "route": "cuda",
         "source": "src/repro_torch/csrc/poly_encode.cu",
         "replaces": "src/repro/kernels/poly_encode/kernel.py:41",
         "launches": sum(r["launches"]["poly_encode"]
                         for r in runs.values()),
         "launches_by_run": {k: r["launches"]["poly_encode"]
                             for k, r in runs.items()},
         "shape": enc_main["shape"], "max_abs_err": enc_main["max_abs_err"],
         "ms": enc_main["ms"], "plain_ms": enc_main["plain_ms"],
         "bound_ms": enc_main["bound_ms"], "bound_by": enc_main["bound_by"],
         "library_ms": enc_main["library_ms"]},
    ]
    win = flash["window1024"]
    kernels += [
        {"name": "flash_attention", "status": "ported", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
         "launches": lm["launches"]["flash_attention"],
         "launches_by_run": {"hymba_served": lm["launches"][
             "flash_attention"]},
         "shape": win["shape"], "window": win["window"],
         "max_abs_err": win["max_abs_err"], "ms": win["ms"],
         "plain_ms": win["plain_ms"], "bound_ms": win["bound_ms"],
         "bound_by": win["bound_by"], "library_ms": win["library_ms"]},
        {"name": "ssm_scan", "status": "ported", "route": "cuda",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan/kernel.py:55",
         "launches": lm["launches"]["ssm_scan"],
         "launches_by_run": {"hymba_served": lm["launches"]["ssm_scan"]},
         "shape": scan["shape"], "max_abs_err": scan["max_abs_err"],
         "ms": scan["ms"], "plain_ms": scan["plain_ms"],
         "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"],
         "library_ms": None},
    ]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "ptxas": ptxas, "coded_matmul": mm, "poly_encode": enc,
             "small_serve": small, "serve": runs, "breakdown": breakdown,
             "flash_attention": flash, "ssm_scan": scan,
             "small_lm": small_lm, "lm": lm, "lm_breakdown": lm_breakdown,
             "open_loop": open_loop, "autotune": autotune,
             "engine": engine, "kernels": kernels},
            indent=2))
    print(card)
    print(json.dumps({"kernels": kernels, "not_ported": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
