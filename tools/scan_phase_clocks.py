#!/usr/bin/env python
"""Where the selective-scan kernel's cycles go, by phase of its chunk loop.

The card's profilers (``ncu``, ``nsys``) may be unavailable, so this reads
the SM clock inside the kernel instead.  It copies
``src/repro_torch/csrc/ssm_scan.cu`` into ``build/scan_phase_clocks/``,
inserts ``clock64()`` marks for thread 0 of every block between the phases
of the chunk loop, builds the copy with the port's ``nvcc`` flags and runs
it at hymba-1.5b's prefill shape (4 x 8192 x 3200 x 16, bf16, B and C
column views of one projection) and at falcon-mamba-7b's channel width
(Dm 8192).  The shipped kernel is not changed; the marks add a few
instructions a chunk, so the script also times the instrumented kernel
beside the shipped one.

Phases, each summed over the chunks of a block: ``prologue`` (setup and
the first chunk's staging), ``wait`` (``cp.async`` wait for the chunk),
``barrier`` (the chunk's ``__syncthreads``), ``issue`` (the next chunk's
x/dt copies and B/C loads issued), ``y_rows`` (the previous chunk's y rows
stored), ``steps`` (the chunk's time steps), ``bc_store`` (the next
chunk's B/C written to shared memory), ``epilogue`` (the last y rows).

Usage, on a machine with the card and ``nvcc``:
``python tools/scan_phase_clocks.py [--out FILE.json]``.  Prints one line a
shape and, last, the JSON it writes.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import ssm_scan  # noqa: E402
from repro_torch.kernels._build import (CSRC, NVCC_FLAGS,  # noqa: E402
                                        SIGNATURES, _nvcc)

PHASES = ("prologue", "wait", "barrier", "issue", "y_rows", "steps",
          "bc_store", "epilogue")
MAX_BLOCKS = 4096
SHAPES = {"hymba-1.5b": (4, 8192, 3200, 16),
          "falcon-mamba-7b": (4, 8192, 8192, 16)}
DT_RANK = 100            # B and C start at this column of the projection
OUT_DIR = ROOT / "build" / "scan_phase_clocks"

HEADER = f"""
#define SCAN_MARK(p) if (threadIdx.x == 0) {{ \\
    const long long now_ = clock64(); ph_[p] += now_ - last_; last_ = now_; }}
__device__ long long scan_phase_cycles[{MAX_BLOCKS}][{len(PHASES)}];
"""
FOOTER = """
extern "C" int scan_phase_read(void* dst) {
    return (int)cudaMemcpyFromSymbol(dst, scan_phase_cycles,
                                     sizeof(scan_phase_cycles));
}
"""
SAVE = f"""
    if (threadIdx.x == 0) {{
        const int blk = blockIdx.y * gridDim.x + blockIdx.x;
        if (blk < {MAX_BLOCKS})
            for (int p = 0; p < {len(PHASES)}; ++p)
                scan_phase_cycles[blk][p] = ph_[p];
    }}
"""
# (anchor in the kernel source, text put before it, text put after it)
EDITS = [
    ("#include <stdint.h>\n", "", HEADER),
    ("    const int tid = threadIdx.x;\n", "",
     f"    long long ph_[{len(PHASES)}] = {{}}, last_ = clock64();\n"),
    ("        store_bc(0);\n    }\n", "", "    SCAN_MARK(0)\n"),
    ("        cp_async_wait_all();    // this thread's copies of chunk k "
     "landed\n", "", "        SCAN_MARK(1)\n"),
    ("        __syncthreads();\n        if (k + 1 < chunks) {", "",
     "\n        SCAN_MARK(2)"),
    ("            load_bc(k + 1);\n        }\n", "", "        SCAN_MARK(3)\n"),
    ("        if (k > 0) emit(k - 1, cur ^ 1);\n", "",
     "        SCAN_MARK(4)\n"),
    ("        // B/C of chunk k+1 go to the buffer", "        SCAN_MARK(5)\n",
     ""),
    ("        if (k + 1 < chunks) store_bc(cur ^ 1);\n", "",
     "        SCAN_MARK(6)\n"),
    ("        emit(chunks - 1, (chunks - 1) & 1);\n    }\n", "",
     "    SCAN_MARK(7)\n" + SAVE),
]


def instrumented_source() -> str:
    """The kernel's source with the phase marks in; fails if the kernel
    changed so that an anchor is gone or no longer unique."""
    src = (CSRC / "ssm_scan.cu").read_text()
    for anchor, before, after in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in ssm_scan.cu: "
                             f"{anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    return src + FOOTER


def build() -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT_DIR / "ssm_scan_phases.cu", OUT_DIR / "libscan_phases.so"
    cu.write_text(instrumented_source())
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{out.stdout}{out.stderr}")
    so = ctypes.CDLL(str(lib))
    argtypes, restype = SIGNATURES["ssm_scan"]["ssm_scan_bf16"]
    so.ssm_scan_bf16.argtypes, so.ssm_scan_bf16.restype = argtypes, restype
    so.scan_phase_read.argtypes = [ctypes.c_void_p]
    so.scan_phase_read.restype = ctypes.c_int
    return so


def inputs(Bt, L, Dm, S, gen):
    dev = "cuda"
    x = torch.randn(Bt, L, Dm, device=dev, generator=gen).bfloat16()
    dt = (0.01 + 0.19 * torch.rand(Bt, L, Dm, device=dev,
                                   generator=gen)).bfloat16()
    A = -(0.1 + 0.9 * torch.rand(Dm, S, device=dev, generator=gen))
    xp = torch.randn(Bt, L, DT_RANK + 2 * S, device=dev,
                     generator=gen).bfloat16()
    D = torch.randn(Dm, device=dev, generator=gen)
    return (x, dt, A, xp[..., DT_RANK:DT_RANK + S], xp[..., DT_RANK + S:],
            D)


def time_ms(fn, iters=5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(so, name, shape, gen) -> dict:
    Bt, L, Dm, S = shape
    x, dt, A, B, C, D = inputs(*shape, gen)
    y = torch.empty_like(x)
    h = torch.empty(Bt, Dm, S, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = so.ssm_scan_bf16(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(), Bt, L,
            Dm, S, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1), stream)
        if rc != 0:
            raise SystemExit(f"instrumented scan failed: {rc}")

    ms_marked = time_ms(run)
    ms_shipped = time_ms(lambda: ssm_scan(x, dt, A, B, C, D,
                                          return_final=True))
    want_y, want_h = ssm_scan(x, dt, A, B, C, D, return_final=True)
    run()
    torch.cuda.synchronize()
    if not (torch.equal(y, want_y) and torch.equal(h, want_h)):
        raise SystemExit(f"{name}: the instrumented kernel's output differs "
                         "from the shipped kernel's")
    cycles = torch.empty(MAX_BLOCKS, len(PHASES), dtype=torch.int64)
    rc = so.scan_phase_read(cycles.data_ptr())
    if rc != 0:
        raise SystemExit(f"reading the phase cycles failed: {rc}")
    blocks = -(-Dm // 128) * Bt
    per_block = cycles[:blocks].tolist()
    totals = [sum(r) for r in per_block]
    median_total = statistics.median(totals)
    phases = {p: statistics.median(r[i] for r in per_block)
              for i, p in enumerate(PHASES)}
    return {"name": name, "shape": list(shape), "blocks": blocks,
            "kernel_ms": ms_shipped, "instrumented_ms": ms_marked,
            "block_cycles_median": median_total,
            "block_cycles_max": max(totals),
            "phase_cycles_median": phases,
            "phase_share": {p: c / median_total for p, c in phases.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    so = build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for name, shape in SHAPES.items():
        r = measure(so, name, shape, gen)
        rows.append(r)
        print(f"{name} {'x'.join(map(str, shape))} bf16: kernel "
              f"{r['kernel_ms']:.3f} ms, instrumented "
              f"{r['instrumented_ms']:.3f} ms; {r['blocks']} blocks, median "
              f"{r['block_cycles_median']:.0f} cycles (max "
              f"{r['block_cycles_max']}); shares: " + ", ".join(
                  f"{p} {s:.3f}" for p, s in r["phase_share"].items()),
              flush=True)
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = res.stdout.strip().splitlines()[0] if res.stdout else "unknown"
    result = {"card": card, "shapes": rows}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
