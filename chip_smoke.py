#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--out results.json]

Phases (any failed check exits non-zero; nothing is caught and skipped):

1. Build the kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the compiler's register report.
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at the non-divisible sweep shapes of the tests,
   with the reference's tolerance; time kernel, plain version and one
   library call with CUDA events, beside the card's bound.
3. A small serve on the card against the same serve with the plain
   versions on the CPU: same answer stream, agreeing errors.
4. Serve at full width through ``run_serve`` (2048 x 32768 operands, K=8,
   N=24, batches of 4): L-SAC (ortho) for 8 requests, and the CLI default
   G-SAC [5, 3] (complex points, the four-GEMM path) for 4.  The kernels'
   launch counts are zeroed just before each run and must grow in it.
5. Profile one full-width L-SAC batch and print device time by kernel.
6. Print the card's name and power limit, one ``{"kernels": [...]}`` line,
   and as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (dense, at the full 700 W power limit)
PEAK_FLOPS = {"float32": 67e12,        # FP32 on the CUDA cores (no TF32)
              "bfloat16": 989e12,      # bf16 on the tensor cores
              "float64": 67e12}
PEAK_BYTES = 3.35e12                   # HBM3
TOL = {"float32": 2e-4, "bfloat16": 5e-2}

MATMUL_SWEEP = [(1, 64, 64, 64), (3, 100, 200, 60), (2, 96, 200, 64),
                (4, 33, 77, 129), (1, 128, 1024, 128)]
ENCODE_SWEEP = [(24, 8, 100, 1000), (5, 3, 70, 33), (2, 1, 16, 16),
                (7, 11, 129, 65)]
SERVE_ARGS = ["--rows", "2048", "--inner", "32768", "--K", "8", "--N", "24",
              "--batch-size", "4", "--device", "cuda", "--backend", "device",
              "--deadlines", "1.1,1.6,3.0,9.0", "--json"]


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


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time the card could take: the larger of operations over
    the peak rate for the type and bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"built {', '.join(sorted(paths))} for sm_90a in "
        f"{time.perf_counter() - t0:.1f}s")
    for name in sorted(paths):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_coded_matmul(dev, gen) -> dict:
    from repro_torch.kernels import worker_products, worker_products_complex
    from repro_torch.kernels.coded_matmul.ref import (
        coded_matmul_complex_ref, coded_matmul_ref)
    out = {}
    for W, M, Z, N in MATMUL_SWEEP:
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            A = torch.randn(W, M, Z, device=dev, generator=gen).to(tdt)
            B = torch.randn(W, Z, N, device=dev, generator=gen).to(tdt)
            check_close(worker_products(A, B), coded_matmul_ref(A, B),
                        TOL[dt], TOL[dt] * Z ** 0.5,
                        f"coded_matmul {dt} {(W, M, Z, N)}")
    log("coded_matmul: sweep shapes agree with the plain version "
        "(float32, bfloat16)")
    W, M, Z, N = 96, 2048, 4096, 2048            # the serving main path
    flops = 2.0 * W * M * N * Z
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        A = torch.randn(W, M, Z, device=dev, generator=gen).to(tdt)
        B = torch.randn(W, Z, N, device=dev, generator=gen).to(tdt)
        err = check_close(worker_products(A, B),
                          coded_matmul_ref(A, B), TOL[dt],
                          TOL[dt] * Z ** 0.5, f"coded_matmul {dt} main")
        item = A.element_size()
        b_ms, b_by = bound_ms(flops, item * (W * M * Z + W * Z * N
                                             + W * M * N), dt)
        row = {"shape": [W, M, Z, N], "dtype": dt, "max_abs_err": err,
               "ms": time_ms(lambda: worker_products(A, B)),
               "plain_ms": time_ms(lambda: coded_matmul_ref(A, B)),
               "library_ms": time_ms(lambda: torch.bmm(A, B)),
               "bound_ms": b_ms, "bound_by": b_by}
        row["tflops"] = flops / row["ms"] / 1e9
        out[dt] = row
        log(f"coded_matmul {dt} {W}x{M}x{Z}x{N}: kernel {row['ms']:.2f} ms "
            f"({row['tflops']:.1f} TFLOP/s), plain {row['plain_ms']:.2f} ms, "
            f"torch.bmm {row['library_ms']:.2f} ms, bound {b_ms:.2f} ms "
            f"({b_by}), max abs err {err:.3e}")
        del A, B
        torch.cuda.empty_cache()
    # the complex wrapper: four launches into two outputs
    ops = [torch.randn(W, M, Z, device=dev, generator=gen) for _ in range(2)]
    ops += [torch.randn(W, Z, N, device=dev, generator=gen) for _ in range(2)]
    re, im = worker_products_complex(*ops)
    want_re, want_im = coded_matmul_complex_ref(*ops)
    err = max(check_close(re, want_re, 2e-4, 4e-4 * Z ** 0.5,
                          "complex re"),
              check_close(im, want_im, 2e-4, 4e-4 * Z ** 0.5,
                          "complex im"))
    del re, im, want_re, want_im
    b_ms, b_by = bound_ms(4 * flops, 4 * (2 * W * M * Z + 2 * W * Z * N
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
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    if not rows:
        log("breakdown: the profiler saw no device time (not measured)")
        return {"wall_ms": wall_ms, "kernels": []}
    log(f"breakdown (lsac_ortho, one batch of 4, profiled): loop "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %)")
    for name, count, ms in rows[:10]:
        log(f"  {ms:9.2f} ms  x{count:<5d} {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "kernels": [{"name": n, "count": c, "ms": ms}
                        for n, c, ms in rows]}


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
    t_start = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    mm = phase_coded_matmul(dev, gen)
    enc = phase_poly_encode(dev, gen)
    small = phase_small_serve()
    lsac = phase_full_serve("lsac_ortho", 8)
    gsac = phase_full_serve("gsac_k1_5", 4)
    breakdown = phase_breakdown()

    # The exact L-SAC fit reads the first R completions.  Batch 1's
    # completion order gives a well-conditioned fit: its exact state is held
    # to 1e-7.  Batch 2's order clusters the first R points so that float32
    # product rounding is amplified far more (the reference's own float32
    # device path shows it too); every exact state is held to 1e-3, far
    # below the approximate layers' errors.
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

    runs = {"lsac_ortho": lsac, "gsac_k1_5": gsac}
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
    not_ported = [
        {"name": "flash_attention", "status": "not_ported",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:96"},
        {"name": "ssm_scan", "status": "not_ported",
         "replaces": "src/repro/kernels/ssm_scan/kernel.py:55"},
    ]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "coded_matmul": mm, "poly_encode": enc,
             "small_serve": small, "serve": runs, "breakdown": breakdown,
             "kernels": kernels},
            indent=2))
    print(card)
    print(json.dumps({"kernels": kernels, "not_ported": not_ported}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
