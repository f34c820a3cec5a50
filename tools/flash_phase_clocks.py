#!/usr/bin/env python
"""Where bf16 flash's forward spends its cycles, by phase of a consumer
warpgroup's key-tile loop.

The card's profilers (``ncu``, ``nsys``) may be unavailable, so this reads
the SM clock inside the kernel instead.  It copies
``src/repro_torch/csrc/flash_attention.cu`` into
``build/flash_phase_clocks/``, inserts ``clock64()`` marks for the first
thread of each consumer warpgroup of ``flash_fwd_wg_kernel`` between the
phases of its loop, builds the copy with the port's ``nvcc`` flags and
runs it, full causal, at qwen2-moe-a2.7b's prefill (4 x 16 x 8192 x 128),
minicpm-2b's (4 x 36 x 8192 x 64), gemma-2b's (4 x 8/1 x 8192 x 256),
musicgen-large's (4 x 32 x 2048 x 64) and qwen1.5-32b's (1 x 40 x 2048 x
128), and at hymba-1.5b's with the window of 1024 (4 x 25/5 x 8192 x
64).  The
shipped kernel is not changed; the marks add a few instructions a tile,
so the script also times the instrumented kernel beside the shipped one
(both called through ``ctypes``, and the shipped one also through the
wrapper, whose host work shows at a short kernel) and checks that both
give the same output.

Phases, each summed over a warpgroup's tiles: ``start`` (from the block's
first instruction through the barriers' set-up and the wait for Q),
``pass`` (tiles none of its rows sees), ``k_wait`` (the ``mbarrier``s of
the K tile and of the last tile's V), ``s_issue`` (the warpgroup's turn
waited for, QKᵀ and the last tile's P·V issued), ``s_wait`` (the turn
handed on, the wait for QKᵀ), ``softmax`` (masks
and the online softmax), ``pv_wait`` (the wait for the previous P·V),
``rescale`` (O rescaled, P packed to bf16), ``tail`` (the last P·V and the
tiles past the last), ``epilogue`` (O and the LSE stored).

Usage, on a machine with the card and ``nvcc``:
``python tools/flash_phase_clocks.py [--out FILE.json]``.  Prints one line
a shape and, last, the JSON it writes.
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

from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.kernels._build import (CSRC, NVCC_FLAGS,  # noqa: E402
                                        SIGNATURES, _nvcc, load)

PHASES = ("start", "pass", "k_wait", "s_issue", "s_wait", "softmax",
          "pv_wait", "rescale", "tail", "epilogue")
MAX_BLOCKS = 16384
# name: (B, H, Hkv, L, d, window)
SHAPES = {"qwen2-moe-a2.7b": (4, 16, 16, 8192, 128, 0),
          "minicpm-2b": (4, 36, 36, 8192, 64, 0),
          "gemma-2b": (4, 8, 1, 8192, 256, 0),
          "hymba-1.5b window 1024": (4, 25, 5, 8192, 64, 1024),
          "musicgen-large": (4, 32, 32, 2048, 64, 0),
          "qwen1.5-32b": (1, 40, 40, 2048, 128, 0)}
OUT_DIR = ROOT / "build" / "flash_phase_clocks"

HEADER = f"""
#define FLASH_MARK(p) if ((threadIdx.x & 127) == 0) {{ \\
    const long long now_ = clock64(); ph_[p] += now_ - last_; last_ = now_; }}
__device__ long long flash_phase_cycles[{MAX_BLOCKS}][2][{len(PHASES)}];
"""
FOOTER = """
extern "C" int flash_phase_read(void* dst) {
    return (int)cudaMemcpyFromSymbol(dst, flash_phase_cycles,
                                     sizeof(flash_phase_cycles));
}
"""
SAVE = f"""    FLASH_MARK(9)
    if ((threadIdx.x & 127) == 0 && blockIdx.x < {MAX_BLOCKS})
        for (int p = 0; p < {len(PHASES)}; ++p)
            flash_phase_cycles[blockIdx.x][wg][p] = ph_[p];
"""
LOOP = "    if (t_lo <= t_hi) {\n        tile(t_lo, std::false_type{});\n"
# (anchor in the kernel source, text put before it, text put after it)
EDITS = [
    ("#include <stdint.h>\n", "", HEADER),
    ("    const int n_qt = (Lq + BQ - 1) / BQ;\n",
     f"    long long ph_[{len(PHASES)}] = {{}}, last_ = clock64();\n", ""),
    ("    mbar_wait(q_full, 0);                // every TMA load is waited "
     "for\n", "", "    FLASH_MARK(0)\n"),
    (LOOP, "    FLASH_MARK(1)\n", ""),
    ("        if constexpr (PEND) mbar_wait(&v_full[sp], ((it - 1) / STAGES) "
     "& 1);\n", "", "        FLASH_MARK(2)\n"),
    ("        if constexpr (PEND) pv(sp);\n", "", "        FLASH_MARK(3)\n"),
    ("        hold(s);\n        release(&k_empty[st]);\n", "",
     "        FLASH_MARK(4)\n"),
    ("        if constexpr (PEND) {\n            wg_wait<0>();\n",
     "        FLASH_MARK(5)\n", ""),
    ("            release(&v_empty[sp]);\n        }\n", "",
     "        FLASH_MARK(6)\n"),
    ("        to_frags<BKV>(pf, s);            // P rounded to bf16, as SDPA "
     "does\n", "", "        FLASH_MARK(7)\n"),
    ("    for (int it = max(t_hi + 1, t_lo); it < n_tiles; ++it) pass(it);\n",
     "", "    FLASH_MARK(8)\n"),
    ("                                          acc[4 * j + 2 * r + 1] * "
     "inv);\n        }\n    }\n}\n", "", ""),
]


def instrumented_source() -> str:
    """The kernel's source with the phase marks in; fails if the kernel
    changed so that an anchor is gone or no longer unique."""
    src = (CSRC / "flash_attention.cu").read_text()
    for anchor, before, after in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in flash_attention.cu: "
                             f"{anchor!r}")
        if anchor.endswith("    }\n}\n"):          # the kernel's last line
            src = src.replace(anchor, anchor[:-2] + SAVE + "}\n")
        else:
            src = src.replace(anchor, before + anchor + after)
    return src + FOOTER


def build() -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu = OUT_DIR / "flash_attention_phases.cu"
    lib = OUT_DIR / "libflash_phases.so"
    cu.write_text(instrumented_source())
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{out.stdout}{out.stderr}")
    so = ctypes.CDLL(str(lib))
    argtypes, restype = SIGNATURES["flash_attention"]["flash_attention_bf16"]
    so.flash_attention_bf16.argtypes = argtypes
    so.flash_attention_bf16.restype = restype
    so.flash_phase_read.argtypes = [ctypes.c_void_p]
    so.flash_phase_read.restype = ctypes.c_int
    return so


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


def measure(so, shipped, name, shape, gen) -> dict:
    B, H, Hkv, L, d, window = shape
    q, k, v = (torch.randn(B, n, L, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for n in (H, Hkv, Hkv))
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]

    def run(lib=so):
        rc = lib.flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, B,
            H, Hkv, L, L, d, 1, window, 0, d ** -0.5, *strides, stream)
        if rc != 0:
            raise SystemExit(f"flash failed: {rc}")

    ms_marked = time_ms(run)
    ms_shipped = time_ms(lambda: run(shipped))
    ms_wrapper = time_ms(lambda: flash_attention(q, k, v, window=window))
    want = flash_attention(q, k, v, window=window)
    run()
    torch.cuda.synchronize()
    if not torch.equal(o, want):
        raise SystemExit(f"{name}: the instrumented kernel's output differs "
                         "from the shipped kernel's")
    cycles = torch.empty(MAX_BLOCKS, 2, len(PHASES), dtype=torch.int64)
    rc = so.flash_phase_read(cycles.data_ptr())
    if rc != 0:
        raise SystemExit(f"reading the phase cycles failed: {rc}")
    blocks = min(MAX_BLOCKS, B * H * -(-L // 128))
    per_wg = cycles[:blocks].reshape(-1, len(PHASES)).tolist()
    totals = [sum(r) for r in per_wg]
    total = sum(totals)
    phases = {p: sum(r[i] for r in per_wg) for i, p in enumerate(PHASES)}
    return {"name": name, "shape": list(shape), "blocks": blocks,
            "kernel_ms": ms_shipped, "wrapper_ms": ms_wrapper,
            "instrumented_ms": ms_marked,
            "warpgroup_cycles_median": statistics.median(totals),
            "warpgroup_cycles_max": max(totals),
            "phase_share": {p: c / total for p, c in phases.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    so, shipped = build(), load("flash_attention")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for name, shape in SHAPES.items():
        r = measure(so, shipped, name, shape, gen)
        rows.append(r)
        print(f"{name} {'x'.join(map(str, shape[:5]))} window {shape[5]} "
              f"bf16: kernel {r['kernel_ms']:.3f} ms (through the wrapper "
              f"{r['wrapper_ms']:.3f}), instrumented "
              f"{r['instrumented_ms']:.3f} ms; {r['blocks']} blocks, median "
              f"{r['warpgroup_cycles_median']:.0f} cycles a warpgroup (max "
              f"{r['warpgroup_cycles_max']}); shares of all warpgroups' "
              "cycles: " + ", ".join(f"{p} {s:.3f}"
                                     for p, s in r["phase_share"].items()),
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
