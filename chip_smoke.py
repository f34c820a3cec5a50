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
   N=24, batches of 4): L-SAC (ortho) for 8 requests (operands drawn from
   the CLI's seed while phase 1 builds; phase 13 serves them too), and the
   CLI default
   G-SAC [5, 3] (complex points, the four-GEMM path) for 4.  The kernels'
   launch counts are zeroed just before each run and must grow in it.
5. Profile one full-width L-SAC batch and print device time by kernel.
6. The language model's kernels against their plain versions on the card:
   flash attention at the sweep shapes and at hymba-1.5b's prefill
   (4 x 25/5 heads x 8192 x 64, bf16, window 1024 and full causal; to 1e-2
   elementwise and in relative Frobenius error), the
   selective scan at the sweep shapes and at hymba's (4 x 8192 x 3200 x 16,
   bf16, B and C strided), then at falcon-mamba-7b's (Dm 8192, the same
   4 x 8192, checked the same way), and the scan's design named; kernel, plain version and library call (SDPA; none
   for the scan) timed with CUDA events beside the card's bound.
7. hymba-smoke in float32: the same weights on the card and on the CPU,
   prefill and decode logits within 2e-4 and 2e-3.
8. hymba-1.5b at full width (bf16, seeded random weights): a 1 x 2048
   prefill with the kernels against the plain versions (relative Frobenius
   error of the logits <= 5e-2; each layer's output hidden state between
   the two runs printed; each layer run with the kernels on the plain
   run's input to it, against the plain run's output, to OWN_LAYER_TOL),
   then the served run — a 4 x 8192 prefill
   and 32 greedy decode steps — with the launch counts zeroed before it:
   32 launches of each kernel, all in the prefill.
9. Profile one full-width hymba prefill, and 4 decode steps after it, and
   print device time by kernel and by kind (GEMMs, flash, the scan,
   dispatch, elementwise; each kernel once, summing to the busy time).
9b. The MoE, vlm and audio families: flash at qwen2-moe-a2.7b's prefill
    (4 x 16 x 8192 x 128) and at musicgen-large's (4 x 32 x 2048 x 64),
    full causal, bf16, against its plain version per batch row and per
    block of 16 query rows, timed beside SDPA and its bound, with the
    ``flash_mma_kernel<128>`` and ``<64>`` instances' registers and
    spills; then qwen2-moe-a2.7b at full width and depth (bf16, seeded
    weights): a 1 x 2048 prefill with the kernels against the plain
    versions (5e-2, with the share of (token, layer) top-4 expert sets
    that agree, a repeat of the kernel prefill that must be bit-identical,
    and by layer the dropped share, recounted on the host from the float32
    router logits, and the router inputs' mean cosine similarity), the
    served 4 x 8192 prefill
    and 32 greedy decode steps (launch counts zeroed before it: 24 flash
    launches, all in the prefill; the dropped share of routed
    assignments), a profiled prefill and 4 decode steps by kind (expert
    products, other GEMMs, flash, dispatch/scatter, elementwise: each
    kernel once, summing to the busy time); musicgen-large at full width
    (1 x 2048 kernels vs plain, a 4 x 2048 prompt with 16 decode steps of
    (B, 1, 4) tokens, 48 flash launches); and the smoke configs of
    qwen2-moe, kimi-k2, llava and musicgen in float32, card against CPU
    (prefill 2e-4, decode 2e-3, lm_loss 1e-5 relative, 3 train steps 1e-4
    as in 14c), each then trained 2 steps by the training driver on the
    card.
9c. The dense, ssm and vlm families: flash at the served prefills of
    gemma-2b (4 x 8/1 x 8192 x 256), qwen2.5-3b (4 x 16/2 x 8192 x 128),
    minicpm-2b (4 x 36/36 x 8192 x 64), llava-next-mistral-7b (4 x
    32/8 x 8192 x 128) and qwen1.5-32b (1 x 40/40 x 2048 x 128) and at
    kimi-k2's heads (2 x 64/8 x 4096 x 112, run
    zero-padded in the head-dim-128 instance), as in 9b; the smoke configs
    of gemma, qwen2.5, minicpm (head dim 18), falcon-mamba and qwen1.5 card
    against CPU as in 9b; then gemma-2b, qwen2.5-3b, minicpm-2b,
    falcon-mamba-7b and llava-next-mistral-7b (its text stream) at full
    width and depth (bf16, seeded weights): a 1 x 2048 prefill with the
    kernels against the plain versions (5e-2, and each layer's own error),
    the served 4 x 8192 prefill
    and 32 greedy decode steps (launch counts zeroed before it: one flash
    or scan launch per layer, all in the prefill), the computed bounds,
    and for falcon-mamba and llava a profiled prefill and 4 decode steps
    by kind; last, on a card that holds nothing else, qwen1.5-32b (65.6 GiB
    of weights) with 1 x 2048 and 16 decode steps, the card's free memory
    printed before its draw.
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
13. The worker-process cluster (``--backend cluster --compute device``):
    phase 4's L-SAC job (2048 x 32768, K=8, N=24, 8 requests, batches of 4
    when ``/dev/shm`` holds two batches' float32 stacks) on 24 worker
    processes, each computing its shard in the ``coded_matmul`` kernel on
    the card, with its trace recorded and an answer at every completion;
    the trace replayed in this process through ``ReplayBackend(compute=
    "device")`` on the same operands with every estimate bit-identical, the
    replay's shard products (the workers' ``TorchShardComputer`` path)
    within 1e-5 relative of the float64 oracle, every exact state decoded
    again in float64 from those products (the served squared error within
    1e-6 relative of it) and its error within the bound its decode weights
    put on the products' errors (which workers finish first is measured
    here, so phase 4's fixed limits do not apply); the host's copy rates,
    the workers' timing split, the master's encode, publish and decode, the
    card's memory from ``nvidia-smi`` and its compute mode (MPS is
    reported, never started).
    Then, at 128 x 2048 on zero-slack MatDot (K=2, N=3), three serve
    processes at once: ``crash:1,hang:1`` chaos with ``--speculate`` (no
    loss, the hung worker retired, every request exact), ``--replicate
    2``, the socket transport over two 127.0.0.1 hosts with a crash; and
    meanwhile in this process, with L-SAC (K=2, N=6), ``run_open``
    in real time against a ``sim`` replay of its trace (same sheds, drops,
    batches and answers).  The coded_matmul launches come from the
    workers' own counters.
14. The coded runtime and training: (a) ``distributed_coded_matmul`` with
    NCCL at world size 1 on phase 4's L-SAC job (its first drawn pair; K=8,
    N=24), the kernel's launch count growing, its products within 1e-5 of
    the float64 oracle and its estimate within 1e-6 of float64 ``Σ w_n
    P_n`` of the same products, then ``TorchDeviceBackend.decode_on_mesh``
    with an incremental decoder's weights at an exact state, held the same
    way; (b) repro-100m at full width (12 x 768 / 2048, vocab 32,000,
    bf16) at the training CLI's batch 8 x 512: 30 steps uncoded and 20
    with the coded MLP (K=8, N=16, one dead worker), finite losses and a
    held-out loss that falls, the coded run's loss within 3x the
    reference's measured gap of the uncoded run's (also at the reference's
    cut, batch 2 x 128), step ms, tokens/s, peak memory and a profiled
    step; one coded contraction at full width (4096 x 2048 x 768, float32)
    within 1e-3 of ``h @ w_down`` for every tolerated dead count (bf16
    reported); the training CLI stopped by ``--simulate-failure-at 28`` in
    a process of its own, then resumed here from its step-25 checkpoint:
    losses within 1e-6 of the uninterrupted run, bit-identity reported;
    (c) repro-10m (float32) trained 3 steps on the card and on the CPU
    from the same weights, loss and grad norm within 1e-4 relative.  The
    train steps run flash attention's backward kernel (one launch a layer
    a step, counted).
16. The device mesh (run after 14): (a) qwen2-moe-a2.7b at full width
    and depth, phase 9b's 4 x 8192 prefill unsharded and then with the same
    weights placed (in place) on a one-rank NCCL mesh, through the mesh
    branches (the MoE's at model size 1): logits bit-identical, one flash
    launch per layer, and the mesh run's ``max_memory_allocated``; (b) four
    processes on the one card, a 2 x 2 (data, model) mesh over gloo, with
    DTensor's functional collectives staged through host memory (gloo's
    own collectives take CUDA tensors, the functional ones crash on them):
    hymba-1.5b at full width and depth and qwen2-moe-a2.7b at full width
    and 6 of its layers, drop-free, served without FSDP (the cut planned
    with the dry run), a 2 x 2048 prefill (the query-chunk flash branch)
    and 8 decode steps of fixed tokens against the unsharded card run of
    the same weights (hymba's logits to 5e-2 relative Frobenius; each
    qwen2-moe layer on the unsharded run's input to it to OWN_LAYER_TOL,
    its logits and the share of top-k expert sets that agree reported),
    every rank's flash and scan launches counted, and
    ``distributed_coded_matmul`` on the mesh's model axis on phase 4's
    first pair (L-SAC K=8, N=24) within 1e-6 of float64 ``Σ w_n P_n`` of
    the kernel's products; (c) the smoke configs of qwen2-moe, kimi-k2,
    hymba and repro-10m in float32 on the same mesh against one CPU
    process (prefill 2e-4, decode 2e-3, two train steps' loss and gradient
    norm 1e-4 relative) and the reference test's MoE block against
    ``moe_ref`` (1e-4); (d) the dry run (``repro_torch.launch.dryrun``, a
    fake process group on the CPU, in a process of its own started first):
    the served qwen2-moe prefill's per-device peak on a 1 x 1 mesh beside
    (a)'s measured peak (failing if below the weights and KV cache
    allocated), and kimi-k2-1t-a32b's cells on 16 x 16 H100s printed.
    The four ranks' times measure nothing.  Its train steps run the
    kernels' backward kernels inside the ``local_map`` bodies.
17. Training through the kernels (run after 16): (a) under autograd the
    backward kernels of flash attention (the forward sweep's shapes,
    float32 and bf16, causal, window 8 and non-causal window 24) and of
    the scan (its sweep, then hymba's and falcon-mamba-7b's channels at 1
    x 2048) against their plain backward and autograd of the plain
    forward (relative Frobenius 1e-4 float32, 2e-2 bf16), then each timed
    at hymba's training shapes (8 x 4096; flash windowed and full causal,
    beside the SDPA backward) with its bound and plain time; (b)
    hymba-1.5b at full width, 2 layers (global, windowed), 1 x 4096: loss
    and every parameter's gradient with the kernels against the plain
    path (5e-2), and each of the 32 layers' own gradients on the plain
    forward's input at 1 x 1088 (5e-2); (c) a repeat of the first step's
    loss and gradients bit-identical; (d) hymba-1.5b trained at 32 layers
    x 8 x 4096 in bf16 (train_4k's global batch 256 cut to 8): a warm-up
    step and 4 timed steps (step ms, tokens/s, peak memory, launches a
    step: 64 flash and 64 scan forwards with the remat, 32 of each
    backward), a profiled step (device busy share), finite losses that
    fall.
15. Print the card's name and power limit, one ``{"kernels": [...]}`` line,
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
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (dense, at the full 700 W power limit):
# the port's one table, which the dry run's roofline reads too
from repro_torch.analysis.roofline import HW  # noqa: E402

PEAK_FLOPS = {"float32": HW["peak_flops_fp32"],  # FP32 on the CUDA cores
              "tf32": HW["peak_flops_tf32"],     # TF32 on the tensor cores
              "bfloat16": HW["peak_flops"],      # bf16 on the tensor cores
              "float64": HW["peak_flops_fp64"]}
# The float32 worker products run three TF32 tensor-core passes per output
# (3xTF32), so their bound counts 3 x 2*M*N*Z operations at the TF32 rate.
TF32_PASSES = 3
# The float32 kernel against the emulation of its own arithmetic
# (coded_matmul_3xtf32_ref): relative Frobenius error.
TF32X3_EMU_TOL = 1e-5
PEAK_BYTES = HW["hbm_bw"]              # HBM3
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
# the paper job phases 4 and 13 both serve, on the same drawn operands
PAPER_JOB = ["--code", "lsac_ortho", "--requests", "8"]
# (B, H, Hkv, Lq, Lkv, d): the reference's flash sweep, hymba's heads, the
# other head dims the kernels are built for, then the bf16 tensor-core
# kernel's edges: Lq, Lkv off its query and key tiles (Lkv < Lq too),
# groups of 1, 5 and 8; then head dims without an instance (minicpm-smoke's
# 18, kimi-k2's 112, zero-padded to 32 and 128), tile-aligned and off the
# tiles with a group of 8
FLASH_SWEEP = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 64, 64, 32),
               (1, 8, 1, 32, 32, 16), (1, 2, 1, 16, 80, 16),
               (1, 2, 2, 50, 70, 16), (1, 25, 5, 300, 300, 64),
               (2, 4, 1, 70, 70, 128), (1, 8, 1, 40, 40, 256),
               (1, 2, 2, 1, 1, 64), (1, 4, 4, 7, 130, 64),
               (1, 10, 2, 129, 129, 128), (2, 10, 2, 200, 333, 256),
               (1, 16, 2, 300, 97, 16), (1, 16, 2, 65, 64, 32),
               (2, 4, 4, 128, 128, 18), (1, 16, 2, 129, 200, 18),
               (2, 4, 4, 128, 128, 112), (1, 16, 2, 129, 200, 112)]
# (Bt, L, Dm, S): the reference's scan sweep plus odd state sizes
SCAN_SWEEP = [(1, 32, 16, 4), (2, 48, 24, 16), (2, 100, 40, 8),
              (1, 33, 17, 16), (2, 40, 70, 5), (1, 20, 9, 32)]
# hymba-1.5b serving: a cut of the repo's prefill_32k (32 x 32768) that fits
# the script's time limit, then greedy decode
LM_ARCH, LM_BATCH, LM_PROMPT, LM_DECODE = "hymba-1.5b", 4, 8192, 32
SFU_PER_SM_CLOCK = 16        # exp results per SM per clock (compute 9.0)
# falcon-mamba-7b's channels (src/repro_torch/configs/falcon_mamba_7b.py)
FALCON_D_INNER = 8192
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


# instances on the main paths, which must not spill, by a substring of
# their mangled names: flash_mma_kernel<64> (hymba, musicgen, minicpm),
# flash_mma_kernel<128> (qwen2-moe, qwen2.5, llava, qwen1.5; 171 registers,
# no spill on the H100), flash_mma_kernel<256> (gemma; 239 registers, no
# spill), coded_matmul_tf32x3_kernel<true> and every instance of the
# selective scan (its states live in registers)
NO_SPILL = ("flash_mma_kernelILi64E", "flash_mma_kernelILi128E",
            "flash_mma_kernelILi256E", "coded_matmul_tf32x3_kernelILb1E",
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


def check_flash_instances(report: dict) -> list:
    """Each flash kernel's instances in the ptxas report are the head dims
    the library reports: the wrapper pads against what was built."""
    from repro_torch.kernels.flash_attention.ops import head_dims
    dims = list(head_dims())
    for kernel in ("flash_mma_kernel", "flash_simt_kernel"):
        built = sorted(int(m[1]) for m in (
            re.search(kernel + r"ILi(\d+)E", n) for n in report) if m)
        if built != dims:
            fail(f"{kernel} is built for head dims {built}; the library "
                 f"reports {dims}")
    log(f"flash instances: head dims {dims} in both kernels, as the library "
        "reports them")
    return dims


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
    """Unmasked (query, key) pairs of one causal head (the wrapper's count,
    which its backward's FLOP formula reads)."""
    from repro_torch.kernels.flash_attention.ops import unmasked_pairs
    return unmasked_pairs(Lq, Lkv, True, window, q_offset)


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
    (Dm=8192, the same 4 x 8192)."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    def inputs(Bt, L, Dm, S, tdt):
        return _scan_args(dev, gen, Bt, L, Dm, S, tdt, grad=False)

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

    # falcon-mamba-7b's channels over the whole served length, checked as
    # hymba's shape is
    Dm = FALCON_D_INNER
    args = inputs(Bt, L, Dm, S, torch.bfloat16)
    want_y, want_h = ssm_scan_ref(*args, return_final=True)
    y, h = ssm_scan(*args, return_final=True)
    f_err = check_close(y, want_y, 5e-2, 5e-2, "ssm_scan falcon y")
    f_h = check_close(h, want_h, 1e-4, 1e-4, "ssm_scan falcon h_final")
    bound = _scan_bound(Bt, L, Dm, S)
    falcon = {"shape": [Bt, L, Dm, S], "dtype": "bfloat16",
              "max_abs_err": f_err, "h_final_max_abs_err": f_h, **bound,
              "ms": time_ms(lambda: ssm_scan(*args, return_final=True), 5)}
    log(f"ssm_scan falcon-mamba-7b {Bt}x{L}x{Dm}x{S} bf16: kernel "
        f"{falcon['ms']:.3f} ms, bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}); vs plain: max abs err y {f_err:.3e}, "
        f"h_final {f_h:.3e}")
    log("ssm_scan design: 2 lanes per channel hold its states in registers; "
        "software-pipelined steps (next step's loads and ex2.approx exps in "
        "flight), full chunks unrolled; 128-channel x 32-step chunks, x/dt "
        "by 16-byte cp.async, B/C through registers, y as 16-byte rows; one "
        "barrier a chunk")
    del args, y, h, want_y, want_h
    torch.cuda.empty_cache()
    row["falcon"] = falcon
    return row


def _smoke_card_vs_cpu(name: str) -> tuple:
    """``name``'s smoke config in float32, the same weights on the card
    (kernels) and on the CPU (plain versions): a 2 x 40 prefill and 8
    decode steps, prefill logits to 2e-4, decode to 2e-3.  Returns (cfg,
    {"card": model, "cpu": model}, row)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cfg = get_arch(name, smoke=True)
    cpu = init_params(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    gpu = init_params(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    shape = (2, 48) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    tokens = torch.randint(0, cfg.vocab_size, shape,
                           generator=torch.Generator().manual_seed(1))
    runs = {}
    for where, model, dev in (("card", gpu, "cuda"), ("cpu", cpu, "cpu")):
        logits, state = make_prefill_step(cfg, 48, device=dev)(
            model, {"tokens": tokens[:, :40]})
        step = make_decode_step(cfg, device=dev)
        outs = [logits]
        for t in range(40, 48):
            logits, state = step(model, tokens[:, t:t + 1], state)
            outs.append(logits)
        runs[where] = [o.cpu() for o in outs]
    pre = check_close(runs["card"][0], runs["cpu"][0], 2e-4, 2e-4,
                      f"{cfg.name} prefill logits card vs CPU")
    dec = max(check_close(a, b, 2e-3, 2e-3, f"{cfg.name} decode logits")
              for a, b in zip(runs["card"][1:], runs["cpu"][1:]))
    log(f"{cfg.name} float32: card (kernels) == CPU (plain versions); "
        f"prefill logits max abs err {pre:.2e} (2e-4), decode {dec:.2e} "
        "(2e-3)")
    return cfg, {"card": gpu, "cpu": cpu}, {"prefill_max_abs_err": pre,
                                            "decode_max_abs_err": dec}


def phase_small_lm() -> dict:
    """hymba-smoke in float32, card against CPU (:func:`_smoke_card_vs_cpu`)."""
    return _smoke_card_vs_cpu(LM_ARCH)[2]


class _Routing:
    """While active, records each MoE layer's top-k expert ids (T, k) in
    call order, by wrapping ``repro_torch.models.moe._top_k_gates``; with
    ``witness``, also each layer's float32 router logits (on the host) and
    the mean cosine similarity of its router inputs, by wrapping
    ``_router_logits``.  The model code is unchanged; without ``witness``
    nothing waits for the card."""

    def __init__(self, witness: bool = False):
        self.witness = witness

    def __enter__(self):
        from repro_torch.models import moe
        self._moe = moe
        self._orig = (moe._router_logits, moe._top_k_gates)
        self.ids, self.logits, self.cosine = [], [], []

        def logits_of(p, x):
            out = self._orig[0](p, x)
            if self.witness:
                u = torch.nn.functional.normalize(x.float(), dim=-1)
                s, T = u.sum(0), len(u)
                self.cosine.append(float((s @ s - T) / (T * (T - 1))))
                self.logits.append(out.cpu())
            return out

        def record(logits, k):
            out = self._orig[1](logits, k)
            self.ids.append(out[1])
            return out
        moe._router_logits, moe._top_k_gates = logits_of, record
        return self

    def __exit__(self, *exc):
        self._moe._router_logits, self._moe._top_k_gates = self._orig

    def loads(self, cfg) -> list:
        """Each layer's count of assignments per expert (E,)."""
        return [torch.bincount(i.reshape(-1), minlength=cfg.n_experts)
                for i in self.ids]

    def dropped(self, cfg, T: int) -> list:
        """Each layer's share of routed assignments past their expert's
        capacity."""
        from repro_torch.models.moe import capacity
        C = capacity(cfg, T)
        return [int((n - C).clamp_min(0).sum()) / (T * cfg.experts_per_token)
                for n in self.loads(cfg)]

    def dropped_host(self, cfg, T: int) -> list:
        """The same shares recounted on the host, in float64, from each
        layer's recorded float32 router logits (their top k, which the
        softmax keeps in order)."""
        from repro_torch.models.moe import capacity
        C, k = capacity(cfg, T), cfg.experts_per_token
        return [int((torch.bincount(torch.topk(lg.double(), k).indices
                                    .reshape(-1), minlength=cfg.n_experts)
                     - C).clamp_min(0).sum()) / (T * k)
                for lg in self.logits]


class _LayerOutputs:
    """While active, keeps each layer's output hidden state of a prefill
    (on the host, in call order), by wrapping the ``block_forward`` that
    ``repro_torch.models.lm`` calls.  The model code is unchanged."""

    def __enter__(self):
        from repro_torch.models import lm
        self._lm, self._orig, self.outs = lm, lm.block_forward, []

        def record(*args, **kw):
            out = self._orig(*args, **kw)
            self.outs.append(out[0].cpu())
            return out
        lm.block_forward = record
        return self

    def __exit__(self, *exc):
        self._lm.block_forward = self._orig


def _agreement(a: _Routing, b: _Routing) -> list:
    """Share of tokens whose top-k expert sets are equal between two runs,
    layer by layer."""
    if len(a.ids) != len(b.ids) or not a.ids:
        fail(f"routing records of {len(a.ids)} and {len(b.ids)} layers")
    return [float((x.sort(-1).values == y.sort(-1).values).all(-1)
                  .float().mean()) for x, y in zip(a.ids, b.ids)]


def _lm_model(name: str, dev, seed: int):
    """A full-width model of ``name`` from a seed: (cfg, model, params,
    bytes, draw s)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    cfg = get_arch(name)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = init_params(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"{cfg.name}: {n / 1e9:.3f} B parameters (analytic "
        f"{cfg.param_count() / 1e9:.3f} B), {nbytes / 1e9:.2f} GB on the "
        f"card, drawn in {draw_s:.1f} s")
    return cfg, model, n, nbytes, draw_s


# each layer's own error, kernels vs plain on the same input (the plain
# run's input to that layer), relative Frobenius, by what the layer holds:
# a Mamba layer alone (the scan), an attention layer (flash's bf16
# products; a hybrid layer runs both), an MoE layer (a token whose top-k
# expert set flips moves by whole experts' outputs).  Set from H100
# readings at 1 x 2048: at most 1.1e-4 (falcon-mamba-7b), 2.7e-3-6.9e-3
# (the attention models), 5.4e-2 (qwen2-moe-a2.7b), each at layer 0 and
# falling with depth; a scan without D reads 0.97 (falcon) and 0.69 (hymba)
OWN_LAYER_TOL = {"ssm": 1e-3, "attention": 2e-2, "moe": 2e-1}


def _own_layer_tol(cfg) -> float:
    return OWN_LAYER_TOL["moe" if cfg.has_moe else
                         "attention" if cfg.has_attention else "ssm"]


def _own_layer_errors(cfg, model, prompt, plain_outs, layers=None) -> list:
    """Each layer of ``layers`` (all by default) run with the kernels on
    the plain prefill's input to it (the embedding, or the layer before's
    output in ``plain_outs``), against the plain prefill's output of it:
    one layer's own error at every depth, without the cascade."""
    from repro_torch.models.blocks import block_forward
    from repro_torch.models.lm import embed_tokens, layer_windows
    B, L = prompt.shape[:2]
    positions = torch.arange(L, device=prompt.device)[None].expand(B, L)
    wins = layer_windows(cfg)
    out = []
    with torch.no_grad():
        for i in range(cfg.n_layers) if layers is None else layers:
            x = embed_tokens(model, prompt, cfg) if i == 0 else \
                plain_outs[i - 1].to(prompt.device)
            y = block_forward(model.layers[i], x, cfg, positions, wins[i],
                              return_state=cfg.has_ssm)[0]
            out.append(rel_fro(y.cpu(), plain_outs[i]))
    return out


def _scan_without_d_control(cfg, model, prompt, plain_outs) -> float:
    """Layer 0's own error with the scan kernel given D = 0 (a scan that
    drops its skip term): what the own-layer limit must see."""
    from repro_torch.models import ssm
    kernel = ssm.ssm_scan
    ssm.ssm_scan = lambda x, dt, A, B, C, D, **kw: kernel(
        x, dt, A, B, C, torch.zeros_like(D), **kw)
    try:
        return _own_layer_errors(cfg, model, prompt, plain_outs, [0])[0]
    finally:
        ssm.ssm_scan = kernel


def _kernels_vs_plain(cfg, model, prompt) -> dict:
    """One prefill with the kernels and one with the plain versions on the
    same prompt: the last position's logits to 5e-2 relative Frobenius
    error (each codebook's, for audio), each layer's output hidden state
    between the two runs (layer 0's, on the same input, is one layer's own
    error; the later ones add the cascade through the layers before), and
    each layer's own error (:func:`_own_layer_errors`) to
    :data:`OWN_LAYER_TOL`; for a model with Mamba layers the same limit
    must fail a scan without its D term.  For an MoE model, also the two
    runs' routing agreement; each layer's dropped share, counted on the
    card and recounted on the host from the float32 router logits, its
    busiest expert's load over the capacity and the mean cosine similarity
    of its router inputs; and a second prefill with the kernels against
    the first, which must be bit-identical."""
    import contextlib
    from repro_torch.runtime.steps import make_prefill_step
    L = prompt.shape[1]
    rec_k, rec_p = (_Routing(witness=True), _Routing()) if cfg.has_moe \
        else (None, None)
    with rec_k or contextlib.nullcontext(), _LayerOutputs() as hid_k:
        with_k, state = make_prefill_step(cfg, L)(model, {"tokens": prompt})
    del state
    t0 = time.perf_counter()
    with rec_p or contextlib.nullcontext(), _LayerOutputs() as hid_p:
        plain, state = make_prefill_step(cfg, L, use_kernels=False)(
            model, {"tokens": prompt})
    torch.cuda.synchronize()
    del state
    row = {"prompt": list(prompt.shape),
           "plain_prefill_s": time.perf_counter() - t0,
           "rel_fro": rel_fro(with_k, plain),
           "hidden_rel_fro_by_layer": [rel_fro(a, b) for a, b in zip(
               hid_k.outs, hid_p.outs)],
           "own_layer_rel_fro": _own_layer_errors(cfg, model, prompt,
                                                  hid_p.outs),
           "own_layer_tol": _own_layer_tol(cfg)}
    if cfg.has_ssm:
        row["scan_without_d_rel_fro"] = _scan_without_d_control(
            cfg, model, prompt, hid_p.outs)
    del hid_k, hid_p
    if not (bool(torch.isfinite(with_k).all()) and row["rel_fro"] <= 5e-2):
        fail(f"{cfg.name} {L}-token prefill: kernels vs plain relative "
             f"Frobenius error {row['rel_fro']:.3e} (limit 5e-2) or "
             "non-finite logits")
    own, tol = row["own_layer_rel_fro"], row["own_layer_tol"]
    worst = max(range(len(own)), key=own.__getitem__)
    by_layer = row["hidden_rel_fro_by_layer"]
    shown = sorted({0, 1, 2, len(by_layer) // 4, len(by_layer) // 2,
                    3 * len(by_layer) // 4, len(by_layer) - 1})
    log(f"{cfg.name} {'x'.join(map(str, prompt.shape))} prefill, kernels vs "
        "plain versions: last-position logits relative Frobenius error "
        f"{row['rel_fro']:.3e} (limit 5e-2; plain prefill "
        f"{row['plain_prefill_s']:.1f} s); each layer's output hidden state "
        "apart by " + ", ".join(f"{i}: {by_layer[i]:.2e}" for i in shown)
        + "; each layer's own error on the plain run's input " + ", ".join(
            f"{i}: {own[i]:.2e}" for i in shown)
        + f", at most {own[worst]:.3e} (layer {worst}; limit {tol:g})"
        + (f"; layer 0 with a scan without D {row['scan_without_d_rel_fro']:.3e}"
           if cfg.has_ssm else ""))
    if own[worst] > tol:
        fail(f"{cfg.name}: layer {worst}'s own error, kernels vs plain on "
             f"the same input, {own[worst]:.3e} (limit {tol:g})")
    if cfg.has_ssm and not row["scan_without_d_rel_fro"] > tol:
        fail(f"{cfg.name}: a scan without D moves layer 0 by "
             f"{row['scan_without_d_rel_fro']:.3e}, within the own-layer "
             f"limit {tol:g}: the limit cannot see a scan fault")
    if cfg.has_moe:
        from repro_torch.models.moe import capacity
        rec_2 = _Routing()
        with rec_2:
            again, _ = make_prefill_step(cfg, L)(model, {"tokens": prompt})
        row["repeat_rel_fro"] = rel_fro(again, with_k)
        row["repeat_bit_identical"] = bool(torch.equal(again, with_k))
        repeat = _agreement(rec_k, rec_2)
        row["repeat_agreement"] = sum(repeat) / len(repeat)
        if not row["repeat_bit_identical"]:
            fail(f"{cfg.name}: a repeat kernel prefill differs from the first"
                 f" (logits {row['repeat_rel_fro']:.3e} apart, routing "
                 f"{100 * row['repeat_agreement']:.3f} % equal); the MoE "
                 "combine has no atomics")
        by_layer = _agreement(rec_k, rec_p)
        row["routing_agreement"] = sum(by_layer) / len(by_layer)
        row["routing_agreement_by_layer"] = by_layer
        T = L * len(prompt)
        row["capacity"] = C = capacity(cfg, T)
        row["dropped_by_layer"] = rec_k.dropped(cfg, T)
        row["dropped_share"] = sum(row["dropped_by_layer"]) / cfg.n_layers
        row["dropped_by_layer_host"] = rec_k.dropped_host(cfg, T)
        row["busiest_load_by_layer"] = [int(n.max()) / C
                                        for n in rec_k.loads(cfg)]
        row["router_input_cosine_by_layer"] = rec_k.cosine
        log(f"  top-{cfg.experts_per_token} expert sets equal in "
            f"{100 * row['routing_agreement']:.3f} % of (token, layer) "
            f"(layer 0: {100 * by_layer[0]:.3f} %, layer {cfg.n_layers - 1}:"
            f" {100 * by_layer[-1]:.3f} %); a second kernel prefill: "
            f"{100 * row['repeat_agreement']:.3f} % equal, logits "
            f"{row['repeat_rel_fro']:.3e} apart (bit-identical "
            f"{row['repeat_bit_identical']}); "
            f"{100 * row['dropped_share']:.3f} % of routed assignments "
            f"dropped at C = {C}")
        log("  by layer: cosine of router inputs / dropped on the card / "
            "recounted on the host / busiest expert's load over C: "
            + ", ".join(f"{i}: {c:.3f}/{100 * a:.1f}%/{100 * b:.1f}%/"
                        f"{m:.2f}" for i, (c, a, b, m) in enumerate(zip(
                            row["router_input_cosine_by_layer"],
                            row["dropped_by_layer"],
                            row["dropped_by_layer_host"],
                            row["busiest_load_by_layer"]))))
    return row


def _served(cfg, model, batch: int, prompt_len: int, steps: int,
            tok_gen) -> tuple:
    """The served run: a ``batch x prompt_len`` prefill then ``steps``
    greedy decode steps, every kernel's launch count zeroed just before;
    each attention layer launches flash and each Mamba layer the scan, all
    in the prefill.  The row carries the bytes of the run's decode state:
    the KV cache, and the conv tail with the SSM state."""
    from repro_torch.kernels import (coded_matmul, flash_attention,
                                     poly_encode, ssm_scan)
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len) + cb,
                           device="cuda", generator=tok_gen)
    prefill_step = make_prefill_step(cfg, prompt_len + steps)
    decode = make_decode_step(cfg)
    kernels = (flash_attention, ssm_scan, coded_matmul, poly_encode)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    rec = _Routing() if cfg.has_moe else None
    t0 = time.perf_counter()
    if rec:
        with rec:
            logits, state = prefill_step(model, {"tokens": prompt})
    else:
        logits, state = prefill_step(model, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    in_prefill = {fn.__name__: fn.launches for fn in kernels}
    finite = bool(torch.isfinite(logits).all())
    generated = []
    t0 = time.perf_counter()
    for _ in range(steps):
        nxt = logits[:, -1].argmax(-1)[:, None]
        generated.append(nxt)
        logits, state = decode(model, nxt, state)
        finite &= bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    served = {fn.__name__: fn.launches for fn in kernels}
    want = {"flash_attention": cfg.n_layers if cfg.has_attention else 0,
            "ssm_scan": cfg.n_layers if cfg.has_ssm else 0,
            "coded_matmul": 0, "poly_encode": 0}
    if in_prefill != want or served != want:
        fail(f"{cfg.name} served run: launches {in_prefill} in the prefill, "
             f"{served} in all (want {want}, none in decode)")
    want_shape = (batch, 1) + cb + (cfg.padded_vocab(),)
    if not finite or state.pos != prompt_len + steps or \
            tuple(logits.shape) != want_shape:
        fail(f"{cfg.name} served run: finite {finite}, state at "
             f"{state.pos}, logits {tuple(logits.shape)}")
    row = {"arch": cfg.name, "batch": batch, "prompt": prompt_len,
           "decode_steps": steps, "max_seq": prompt_len + steps,
           "prefill_s": prefill_s,
           "prefill_tokens_per_s": batch * prompt_len / prefill_s,
           "decode_s": decode_s, "decode_ms_per_step": decode_s / steps * 1e3,
           "decode_tokens_per_s": batch * steps / decode_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "kv_cache_bytes": _nbytes(state.kv_k, state.kv_v),
           "ssm_state_bytes": _nbytes(state.conv, state.ssm_h),
           "launches": served, "logits_shape": list(want_shape),
           "first_generated": torch.cat(generated, 1)[0, :8].tolist()}
    log(f"{cfg.name} served ({' x '.join(map(str, prompt.shape))} prompt, "
        f"max_seq {prompt_len + steps}): prefill {prefill_s:.2f} s "
        f"({row['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{row['decode_ms_per_step']:.1f} ms per step of {batch} tokens "
        f"({row['decode_tokens_per_s']:.0f} tokens/s), logits "
        f"{list(want_shape)}, peak device memory "
        f"{row['peak_bytes'] / 2**30:.2f} GiB, launches {served}; every "
        "logit finite")
    if rec:
        from repro_torch.models.moe import capacity
        row["capacity"] = capacity(cfg, batch * prompt_len)
        row["dropped_by_layer"] = rec.dropped(cfg, batch * prompt_len)
        row["dropped_share"] = sum(row["dropped_by_layer"]) / cfg.n_layers
    del state, logits
    torch.cuda.empty_cache()
    return row, prompt


def phase_full_lm(dev) -> tuple:
    """hymba-1.5b at full width, bf16, random weights from a seed: (1) a
    1 x 2048 prefill with the kernels against the same prefill with the
    plain versions; (2) the served run, a 4 x 8192 prefill and 32 greedy
    decode steps, with the kernels' launch counts zeroed just before it."""
    cfg, model, n, nbytes, draw_s = _lm_model(LM_ARCH, dev, 12)
    tok_gen = torch.Generator(device=dev)
    tok_gen.manual_seed(13)
    prompt = torch.randint(0, cfg.vocab_size, (1, 2048), device=dev,
                           generator=tok_gen)
    check = _kernels_vs_plain(cfg, model, prompt)
    del prompt
    row, prompt = _served(cfg, model, LM_BATCH, LM_PROMPT, LM_DECODE,
                          tok_gen)
    row.update(params=n, weight_bytes=nbytes, draw_s=draw_s,
               kernels_vs_plain=check)
    return row, model, prompt


def phase_lm_breakdown(model, prompt) -> dict:
    """Device time by kernel over one profiled full-width prefill of
    ``prompt`` and over 4 decode steps after it, from ``torch.profiler``,
    and by kind (:func:`_device_split`); the decode's launches and its top
    host rows."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cfg = model.cfg
    B, L = prompt.shape[:2]
    step = make_prefill_step(cfg, L + LM_DECODE)
    decode = make_decode_step(cfg)
    kw = {"activities": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
          "record_shapes": cfg.has_moe}
    torch.cuda.synchronize()
    out = {}
    with profile(**kw) as prof:
        t0 = time.perf_counter()
        logits, state = step(model, {"tokens": prompt})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["prefill"] = _device_rows(prof, wall_ms, f"breakdown ({cfg.name} "
                                  f"prefill {B}x{L}, profiled)")
    out["prefill"]["by_kind"] = _device_split(prof, cfg, out["prefill"])
    logits, state = decode(model, logits[:, -1].argmax(-1)[:, None],
                           state)                          # warm-up step
    torch.cuda.synchronize()
    with profile(**kw) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            logits, state = decode(model, logits[:, -1].argmax(-1)[:, None],
                                   state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["decode"] = _device_rows(prof, wall_ms, f"breakdown ({cfg.name} 4 "
                                 "decode steps after the prefill, profiled)")
    out["decode"]["by_kind"] = _device_split(prof, cfg, out["decode"])
    out["decode"]["launches"] = sum(
        e.count for e in prof.key_averages()
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                     "cudaLaunchKernelExC"))
    log(f"  {out['decode']['launches']} kernel launches in the 4 decode "
        "steps")
    host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()),
                  key=lambda r: -r[2])[:8]
    for name, count, ms in host:
        log(f"  host {ms:9.2f} ms  x{count:<5d} {name[:80]}")
    out["decode"]["host_top"] = [{"name": n, "count": c, "ms": ms}
                                 for n, c, ms in host]
    del state, logits
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


# ---------------------------------------------------------------------------
# Phase 9b: the MoE, vlm and audio families.  qwen2-moe-a2.7b served at full
# width and depth with hymba's cut of prefill_32k (4 x 8192 prompt, 32
# greedy decode steps); musicgen-large at full width with a 4 x 2048 prompt
# and 16 decode steps of (B, 1, 4) codebook tokens; the four families'
# smoke configs card against CPU in float32.
MOE_ARCH, AUDIO_ARCH = "qwen2-moe-a2.7b", "musicgen-large"
AUDIO_BATCH, AUDIO_PROMPT, AUDIO_DECODE = 4, 2048, 16
FAMILY_SMOKES = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                 "llava-next-mistral-7b", "musicgen-large")
# the smoke configs card vs CPU (float32): prefill and decode logits, and
# lm_loss relative (the training tests' 1e-5)
SMOKE_LOSS_TOL = 1e-5


def _lm_bounds(cfg, B: int, L: int, weight_bytes: int,
               state_bytes: int) -> dict:
    """Computed bounds of a served LM: the prefill's FLOP at the bf16 peak
    (the attention projections and flash's 4·d per unmasked pair; the
    Mamba projections; the dense FFN, or the router with the active routed
    experts and the shared ones; the last position's head left out), and a
    decode step's bytes at the memory rate: every weight (an untied
    embedding table but the rows a step gathers), and the decode state (KV
    cache, conv and SSM state), each read once."""
    from repro_torch.models.lm import layer_windows
    d, T = cfg.d_model, B * L
    per_layer = 0
    if cfg.has_attention:
        hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        per_layer += 2 * T * d * hd * (2 * H + 2 * Hkv)
    if cfg.has_ssm:
        di, r, S = cfg.resolved_d_inner, cfg.resolved_dt_rank, cfg.ssm_state
        per_layer += 2 * T * (d * 2 * di + di * (r + 2 * S) + r * di + di * d)
    if cfg.has_moe:
        f = cfg.d_ff_expert
        per_layer += 2 * 3 * T * d * f * (cfg.experts_per_token
                                          + cfg.n_shared_experts)
        per_layer += 2 * T * d * cfg.n_experts
    elif cfg.d_ff:
        per_layer += 2 * T * d * cfg.d_ff * (2 if cfg.mlp_act == "gelu" else 3)
    flash = 0
    if cfg.has_attention:
        windows = layer_windows(cfg)
        pairs = {w: _flash_pairs(L, L, 0, w) for w in set(windows)}
        flash = sum(4 * cfg.resolved_head_dim * B * cfg.n_heads * pairs[w]
                    for w in windows)
    flops = cfg.n_layers * per_layer + flash
    embed = 0 if cfg.tie_embeddings else \
        max(1, cfg.n_codebooks) * cfg.padded_vocab() * d * 2
    step_bytes = weight_bytes - embed + state_bytes
    return {"prefill_flops": flops,
            "prefill_flop_bound_s": flops / PEAK_FLOPS["bfloat16"],
            "flash_flops": flash,
            "decode_step_bytes": step_bytes,
            "decode_byte_bound_ms": step_bytes / PEAK_BYTES * 1e3}


def _kind(kernel: str) -> str:
    n = kernel.lower()
    if "flash" in n:
        return "flash"
    if "ssm_scan" in n:
        return "scan"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                            "cublas")):
        return "other_gemm"
    if any(s in n for s in ("index", "scatter", "gather", "sort", "radix",
                            "search", "bincount", "histogram")):
        return "dispatch_scatter"
    return "elementwise_other"


def _device_split(prof, cfg, rows: dict) -> dict:
    """Device ms of a profiled run by kind, each kernel counted once by its
    own device time: for an MoE model the expert products (the kernels
    launched by an ``aten::bmm`` on the (E, d, f) or (E, f, d) expert
    weights, moved out of the kind their name gives), the other GEMMs and
    GEMVs (cuBLAS's ``nvjet`` kernels among them), flash, the scan,
    dispatch and scatter (index / scatter / gather / sort / search /
    bincount kernels) and the rest (elementwise and copies).  Fails unless
    every kind is non-negative, an MoE model's expert products were found,
    and the kinds sum to the run's busy time (:func:`_device_rows`)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    out = dict.fromkeys(("expert_products", "other_gemm", "flash", "scan",
                         "dispatch_scatter", "elementwise_other"), 0.0)
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            if e.self_device_time_total > 0:
                out[_kind(e.name)] += e.self_device_time_total / 1e3
        elif cfg.has_moe and e.name == "aten::bmm" and \
                len(e.input_shapes) > 1 and \
                list(e.input_shapes[1]) in ([E, d, f], [E, f, d]):
            for k in e.kernels:
                out[_kind(k.name)] -= k.duration / 1e3
                out["expert_products"] += k.duration / 1e3
    total = sum(out.values())
    log("  by kind: " + ", ".join(f"{k} {v:.2f} ms" for k, v in out.items())
        + f" (sum {total:.2f} ms)")
    if min(out.values()) < 0 or (cfg.has_moe and out["expert_products"] <= 0) \
            or abs(total - rows.get("busy_ms", 0.0)) > 1e-6 * total:
        fail(f"{cfg.name} device time by kind {out} does not split the busy "
             f"time {rows.get('busy_ms')} ms")
    return out


def _flash_served(dev, gen, ptxas: dict, arch: str, B: int, L: int) -> dict:
    """Flash at ``arch``'s served prefill (B x H/Hkv x L x head dim, full
    causal, bf16): checked against the plain version per batch row
    (elementwise and per block of FLASH_ROWS query rows), timed beside SDPA
    and the bound (of the true head dim's work); the registers and spills
    of the ``flash_mma_kernel`` instance it runs in (the next built head
    dim up for a dim without one)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ops import (head_dims,
                                                         instance_dim)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    cfg = get_arch(arch)
    H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    D = instance_dim(d, head_dims())
    q, k, v = (torch.randn(B, n, L, d, device=dev, generator=gen)
               .to(torch.bfloat16) for n in (H, Hkv, Hkv))
    got = flash_attention(q, k, v)
    err = fro = rows = 0.0
    for b in range(B):
        want = attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1])
        what = f"flash {cfg.name} b={b} causal"
        err = max(err, check_close(got[b:b + 1], want, FLASH_LONG_TOL,
                                   FLASH_LONG_TOL, what))
        rows = max(rows, check_rows_fro(got[b:b + 1], want, what))
        fro = max(fro, rel_fro(got[b:b + 1], want))
        del want
    lib = _sdpa(q, k, v, 0)
    pairs = B * H * _flash_pairs(L, L, 0, 0)
    flops = 4.0 * d * pairs
    nbytes = 2 * (2 * B * H * L * d + 2 * B * Hkv * L * d)
    b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
    inst = {n: r for n, r in ptxas.items() if f"flash_mma_kernelILi{D}E" in n}
    if not inst:
        fail(f"ptxas report shows no flash_mma_kernel<{D}>")
    row = {"arch": cfg.name, "shape": [B, H, Hkv, L, d], "dtype": "bfloat16",
           "window": 0, "max_abs_err": err, "rel_fro": fro,
           "rows_rel_fro": rows, "unmasked_pairs": pairs, "flops": flops,
           "flops_all_layers": cfg.n_layers * flops,
           "ms": time_ms(lambda: flash_attention(q, k, v)),
           "plain_ms": time_ms(lambda: [attention_ref(
               q[b:b + 1], k[b:b + 1], v[b:b + 1]) for b in range(B)], 1),
           "library_ms": time_ms(lib), "library_rel_fro": rel_fro(got, lib()),
           "bound_ms": b_ms, "bound_by": b_by, "instance_head_dim": D,
           "ptxas": inst}
    row["tflops"] = flops / row["ms"] / 1e9
    spills = any(r.get("spill_stores") or r.get("spill_loads")
                 for r in inst.values())
    log(f"flash {cfg.name} {B}x{H}/{Hkv}x{L}x{d} bf16 full causal: kernel "
        f"{row['ms']:.3f} ms ({row['tflops']:.1f} TFLOP/s over unmasked "
        f"pairs), plain {row['plain_ms']:.1f} ms ({B} batch rows), SDPA "
        f"{row['library_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
        f"{cfg.n_layers} layers {row['flops_all_layers'] / 1e12:.1f} TFLOP); "
        f"vs plain: max abs err {err:.3e}, rel. Frobenius {fro:.3e}, worst "
        f"block of {FLASH_ROWS} rows {rows:.3e}; rel. Frobenius vs SDPA "
        f"{row['library_rel_fro']:.2e}; flash_mma_kernel<{D}>"
        + (f" (head dim {d} zero-padded to {D}) " if D != d else " ")
        + "; ".join(f"{r.get('registers')} registers, {r.get('spill_stores')}"
                    f" B spill stores, {r.get('spill_loads')} B spill loads"
                    for r in inst.values())
        + (" (SPILLS: reported, not a failure)" if spills else ""))
    del q, k, v, got
    torch.cuda.empty_cache()
    return row


def _nbytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors`` (a state field of an absent
    kind is ``()``)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _lm_full(dev, name: str, seed: int, batch: int = LM_BATCH,
             prompt_len: int = LM_PROMPT, steps: int = LM_DECODE,
             profile: bool = True) -> dict:
    """``name`` at full width and depth, bf16, weights from a seed: kernels
    vs plain on a 1 x 2048 prompt (for MoE with the routing witness; for
    audio of codebook tokens), the served ``batch x prompt_len + steps``
    run, the computed bounds, and with ``profile`` a profiled prefill and
    decode."""
    cfg, model, n, nbytes, draw_s = _lm_model(name, dev, seed)
    tok_gen = torch.Generator(device=dev)
    tok_gen.manual_seed(seed + 1)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompt = torch.randint(0, cfg.vocab_size, (1, 2048) + cb, device=dev,
                           generator=tok_gen)
    check = _kernels_vs_plain(cfg, model, prompt)
    del prompt
    row, prompt = _served(cfg, model, batch, prompt_len, steps, tok_gen)
    kv_bytes, state_bytes = row["kv_cache_bytes"], row["ssm_state_bytes"]
    row.update(params=n, weight_bytes=nbytes, draw_s=draw_s,
               kernels_vs_plain=check,
               **_lm_bounds(cfg, batch, prompt_len, nbytes,
                            kv_bytes + state_bytes))
    log(f"  bounds: prefill {row['prefill_flop_bound_s']:.3f} s (FLOP), "
        f"decode step {row['decode_byte_bound_ms']:.2f} ms (bytes); weights "
        f"{nbytes / 2**30:.2f} GiB, KV cache {kv_bytes / 2**30:.2f} GiB, "
        f"conv and SSM state {state_bytes / 2**30:.3f} GiB"
        + (f"; {100 * row['dropped_share']:.3f} % of routed assignments "
           f"dropped at C = {row['capacity']} (layer 0: "
           f"{100 * row['dropped_by_layer'][0]:.3f} %, layer "
           f"{cfg.n_layers - 1}: {100 * row['dropped_by_layer'][-1]:.3f} %)"
           if cfg.has_moe else ""))
    if profile:
        row["profile"] = phase_lm_breakdown(model, prompt)
    del model, prompt
    torch.cuda.empty_cache()
    return row


def _families_small(names) -> dict:
    """The smoke configs of ``names`` in float32 card against CPU
    (:func:`_smoke_card_vs_cpu`), then on the same weights lm_loss (llava
    with vision embeddings, the MoE configs with their load-balance term)
    to SMOKE_LOSS_TOL relative and SMALL_TRAIN_STEPS train steps (loss and
    grad norm to SMALL_TRAIN_TOL relative, as phase 14c); then two steps of
    the training driver on the card (what ``--arch <name> --smoke`` runs),
    with finite losses."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import train
    from repro_torch.models import lm_loss
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import make_train_step
    out = {}
    for name in names:
        cfg, models, row = _smoke_card_vs_cpu(name)
        batch = SyntheticTokens(
            vocab_size=cfg.vocab_size, seq_len=32, global_batch=2, seed=2,
            n_codebooks=cfg.n_codebooks, vision_tokens=cfg.vision_tokens
            if cfg.family == "vlm" else 0, d_model=cfg.d_model)(0)
        losses, steps = {}, {}
        for where, dev in (("card", "cuda"), ("cpu", "cpu")):
            model = models[where]
            losses[where] = float(lm_loss(model, {
                k: torch.as_tensor(v, device=dev, dtype=torch.long
                                   if k == "tokens" else None)
                for k, v in batch.items()}, cfg))
            train_step = make_train_step(cfg, device=dev)
            opt = adamw_init(dict(model.named_parameters()))
            steps[where] = []
            for s in range(SMALL_TRAIN_STEPS):
                model, opt, m = train_step(model, opt, batch, s)
                steps[where].append((float(m["loss"]),
                                     float(m["grad_norm"])))
        loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        if not loss_rel <= SMOKE_LOSS_TOL:
            fail(f"{cfg.name} lm_loss card {losses['card']} vs CPU "
                 f"{losses['cpu']}: relative {loss_rel:.2e} (limit "
                 f"{SMOKE_LOSS_TOL})")
        step_rel = max(abs(a - b) / abs(b) for card, cpu_ in zip(
            steps["card"], steps["cpu"]) for a, b in zip(card, cpu_))
        if not step_rel <= SMALL_TRAIN_TOL:
            fail(f"{cfg.name} train steps card {steps['card']} vs CPU "
                 f"{steps['cpu']} (limit {SMALL_TRAIN_TOL} relative)")
        log(f"{cfg.name} float32: lm_loss card vs CPU relative "
            f"{loss_rel:.2e} ({SMOKE_LOSS_TOL}); {SMALL_TRAIN_STEPS} train "
            f"steps, loss and grad norm within {step_rel:.2e} relative "
            f"({SMALL_TRAIN_TOL})")
        losses_2 = train(cfg, steps=2, batch=2, seq=32, ckpt_dir=None,
                         resume=False, device="cuda")[2]
        if not all(math.isfinite(x) for x in losses_2):
            fail(f"{cfg.name}: the training driver's losses {losses_2}")
        out[cfg.name] = dict(row, loss_card=losses["card"],
                             loss_cpu=losses["cpu"], loss_rel=loss_rel,
                             train_steps=steps, train_max_rel=step_rel,
                             driver_losses=losses_2)
    return out


def phase_families(dev, gen, ptxas: dict) -> dict:
    """Phase 9b: flash at qwen2-moe-a2.7b's and musicgen-large's served
    prefills, the two models at full width, and the four families' smoke
    configs card vs CPU."""
    t0 = time.perf_counter()
    out = {"flash_qwen2_moe": _flash_served(dev, gen, ptxas, MOE_ARCH,
                                            LM_BATCH, LM_PROMPT),
           "flash_musicgen": _flash_served(dev, gen, ptxas, AUDIO_ARCH,
                                           AUDIO_BATCH, AUDIO_PROMPT),
           "qwen2_moe": _lm_full(dev, MOE_ARCH, 14),
           "musicgen": _lm_full(dev, AUDIO_ARCH, 16, AUDIO_BATCH,
                                AUDIO_PROMPT, AUDIO_DECODE, profile=False),
           "smoke": _families_small(FAMILY_SMOKES)}
    out["seconds"] = time.perf_counter() - t0
    log(f"MoE, vlm and audio phase: {out['seconds']:.1f} s ({CARD})")
    return out


# ---------------------------------------------------------------------------
# Phase 9c: the dense, ssm and vlm architectures at full width and depth.
# Five served with hymba's cut (4 x 8192 prompt, 32 greedy decode steps);
# qwen1.5-32b (65.6 GiB of bf16 weights) with 1 x 2048 and 16, last, on a
# card that holds nothing else.  llava-next-mistral-7b prefills its text
# stream, as the reference's serving step does.
DENSE_ARCHS = ("gemma-2b", "qwen2.5-3b", "minicpm-2b", "falcon-mamba-7b",
               "llava-next-mistral-7b")
DENSE_PROFILED = ("falcon-mamba-7b", "llava-next-mistral-7b")
BIG_ARCH, BIG_BATCH, BIG_PROMPT, BIG_DECODE = "qwen1.5-32b", 1, 2048, 16
# flash at the new served prefills (arch, B, L), full causal, and at
# kimi-k2's heads (head dim 112, run zero-padded in the <128> instance)
DENSE_FLASH = (("gemma-2b", LM_BATCH, LM_PROMPT),
               ("qwen2.5-3b", LM_BATCH, LM_PROMPT),
               ("minicpm-2b", LM_BATCH, LM_PROMPT),
               ("llava-next-mistral-7b", LM_BATCH, LM_PROMPT),
               ("qwen1.5-32b", BIG_BATCH, BIG_PROMPT),
               ("kimi-k2-1t-a32b", 2, 4096))
# the dense and ssm smoke configs, card vs CPU (minicpm-smoke's head dim is
# 18: float32 flash zero-padded to its 32 instance)
DENSE_SMOKES = ("gemma-2b", "qwen2.5-3b", "minicpm-2b", "falcon-mamba-7b",
                "qwen1.5-32b")


def phase_dense(dev, gen, ptxas: dict) -> dict:
    """Phase 9c: flash at the dense models' served prefills and kimi-k2's
    head dim, the dense and ssm smoke configs card vs CPU, then each
    architecture of DENSE_ARCHS and BIG_ARCH at full width
    (:func:`_lm_full`), the free memory printed before BIG_ARCH's draw."""
    t0 = time.perf_counter()
    out = {f"flash_{a}": _flash_served(dev, gen, ptxas, a, B, L)
           for a, B, L in DENSE_FLASH}
    out["smoke"] = _families_small(DENSE_SMOKES)
    for i, name in enumerate(DENSE_ARCHS):
        out[name] = _lm_full(dev, name, 18 + 2 * i,
                             profile=name in DENSE_PROFILED)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    out["free_before_" + BIG_ARCH] = free
    log(f"before {BIG_ARCH}'s draw: {free / 2**30:.2f} GiB free of "
        f"{total / 2**30:.2f} GiB, {torch.cuda.memory_allocated() / 2**30:.2f}"
        " GiB allocated by this process")
    out[BIG_ARCH] = _lm_full(dev, BIG_ARCH, 30, BIG_BATCH, BIG_PROMPT,
                             BIG_DECODE, profile=False)
    out["seconds"] = time.perf_counter() - t0
    log(f"dense, ssm and vlm phase: {out['seconds']:.1f} s ({CARD})")
    return out


def _serve(argv, operands=None):
    from repro_torch.launch.serve import build_parser, run_serve
    return run_serve(build_parser().parse_args(argv), operands).to_dict()


def _child_env() -> dict:
    """This process's environment with the checkout's ``src`` on the path,
    for the serve CLI started as a second process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    return env


def start_paper_operands():
    """Draw phase 4's L-SAC operands (8 pairs of 2048 x 32768, from the
    CLI's ``--seed``) in a thread while the kernels build: phases 4 and 13
    serve this one list."""
    import threading

    from repro_torch.launch.serve import build_parser, draw_operands
    args = build_parser().parse_args(SERVE_ARGS + PAPER_JOB)
    out: list = []
    thread = threading.Thread(target=lambda: out.extend(draw_operands(args)),
                              daemon=True)
    thread.start()
    return thread, out


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


def phase_full_serve(code: str, requests: int, operands=None) -> dict:
    from repro_torch.kernels import coded_matmul, poly_encode
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    coded_matmul.launches = 0
    poly_encode.launches = 0
    t0 = time.perf_counter()
    rep = _serve(SERVE_ARGS + ["--code", code, "--requests",
                                      str(requests)], operands)
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
    drawn = "with operand drawing" if operands is None \
        else "operands drawn beforehand"
    log(f"serve {code} x{requests}: {s['wall_s']:.2f} s serve loop "
        f"({s['rps']:.2f} req/s; {total:.1f} s {drawn}), peak "
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
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *AUTOTUNE_ARGS,
         "--backend", "sim"], cwd=ROOT, env=_child_env(),
        stdout=subprocess.PIPE,
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


# Phase 13: the worker-process cluster.  The full-width job is phase 4's
# L-SAC serve (same operands, code and deadlines) on CLUSTER_WORKERS worker
# processes, each computing its shard in the coded_matmul kernel on the card;
# the chaos, replication and socket runs (SIDE_ARGS, each a serve CLI in a
# process of its own, all three at once) and the real-time run
# (CLUSTER_SIDE) are cut in width and fleet: they check fault and clock
# semantics, and the host moves their bytes slowly (PERF.md §4, §5).
CLUSTER_WORKERS, CLUSTER_REQUESTS = 24, 8
CLUSTER_ARGS = ["--rows", "2048", "--inner", "32768", "--K", "8", "--N",
                "24", "--code", "lsac_ortho", "--device", "cuda",
                "--backend", "cluster", "--compute", "device", "--workers",
                str(CLUSTER_WORKERS), "--deadlines", "1.1,1.6,3.0,9.0",
                "--grace", "120", "--stream", "--requests",
                str(CLUSTER_REQUESTS), "--json"]
# a batch of B requests publishes B x CLUSTER_BATCH_BYTES of float32 stacks
CLUSTER_BATCH_BYTES = 24 * (2048 * 4096 + 4096 * 2048) * 4
CLUSTER_SIDE = {"rows": 128, "inner": 2048, "K": 2, "N": 6}
SIDE_WIDTH = "128x2048"
# --grace is slack for a replacement worker that starts while the other
# runs start theirs: an expected run never waits for it
SIDE_ARGS = ["--rows", "128", "--inner", "2048", "--K", "2", "--N", "3",
             "--code", "matdot", "--device", "cuda", "--backend",
             "cluster", "--compute", "device", "--workers", "3",
             "--requests", "8", "--batch-size", "4", "--deadlines",
             "0.2,0.5,2.0", "--grace", "30", "--json"]
SIDE_RUNS = {
    "chaos_speculate": ["--chaos", "crash:1,hang:1,sleep:0.005:0.02",
                        "--speculate", "--spares", "2"],
    "replicate": ["--chaos", "crash:1,sleep:0.005:0.02", "--replicate", "2",
                  "--spares", "3"],
    "socket": ["--chaos", "crash:1,sleep:0.005:0.02", "--transport",
               "socket", "--hosts", "127.0.0.1,127.0.0.1"]}
SIDE_TIMEOUT = 300.0
# the product check: the reference's per-family tolerance for float32
# device products against the float64 oracle (tests/test_cluster.py)
CLUSTER_PRODUCT_TOL = 1e-5
# the decode check: each exact state decoded again here in float64 from the
# same float32 products, weights and completion order; the served squared
# error must agree to this relative (float64 summation order moves it by
# about 1e-9)
CLUSTER_DECODE_TOL = 1e-6
# the real-time open loop: a burst at 0 past the queue limit, then a
# Poisson stream from this many seconds on
REALTIME_TAIL_START = 1.5


def _nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _mps_running() -> bool:
    """Whether an MPS control or server process is running (it is never
    started here)."""
    for comm in Path("/proc").glob("[0-9]*/comm"):
        try:
            if comm.read_text().strip().startswith("nvidia-cuda-mps"):
                return True
        except OSError:
            continue
    return False


class _MemoryPoll:
    """The card's ``memory.used`` (MiB, every process's contexts together)
    sampled from ``nvidia-smi`` every half second while a run is going."""

    def __init__(self):
        import threading
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while True:
            self.samples.append(float(_nvidia_smi("memory.used")))
            if self._stop.wait(0.5):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(60)


def _host_copy_rates(nbytes: int = 1 << 28) -> dict:
    """GB/s of the host copies the cluster's data path makes, on ``nbytes``
    of float32: into a fresh shared-memory block (the master's publish) and
    into the same block again, into fresh and touched anonymous memory,
    between the card and pageable or pinned host memory, and through a pipe
    (``nbytes / 4``: one worker's products of a full-width batch of 4, as
    the local transport's result queue carries them)."""
    import numpy as np
    from multiprocessing import shared_memory
    src = np.ones(nbytes // 4, np.float32)

    def rate(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return nbytes / (time.perf_counter() - t0) / 1e9

    def fill(dst):
        dst[...] = src

    out = {}
    shm = shared_memory.SharedMemory(create=True, size=nbytes)
    try:
        dst = np.ndarray(src.shape, src.dtype, buffer=shm.buf)
        out["shm_fresh"] = rate(lambda: fill(dst))
        out["shm_touched"] = rate(lambda: fill(dst))
        del dst
    finally:
        shm.close()
        shm.unlink()
    anon = np.empty_like(src)
    out["anon_fresh"] = rate(lambda: fill(anon))
    out["anon_touched"] = rate(lambda: fill(anon))
    card = torch.from_numpy(src).cuda()
    out["d2h_pageable_fresh"] = rate(lambda: card.cpu())
    pinned = torch.empty(card.shape, dtype=card.dtype, pin_memory=True)
    out["d2h_pinned"] = rate(lambda: pinned.copy_(card))
    out["h2d_pageable"] = rate(lambda: torch.from_numpy(anon).cuda())
    out["h2d_pinned"] = rate(lambda: card.copy_(pinned))
    del card, pinned
    torch.cuda.empty_cache()
    import multiprocessing as mp
    import threading
    recv, send = mp.Pipe(duplex=False)
    payload = bytes(nbytes // 4)
    writer = threading.Thread(target=send.send_bytes, args=(payload,))
    t0 = time.perf_counter()
    writer.start()
    got = recv.recv_bytes()
    writer.join()
    out["pipe"] = len(got) / (time.perf_counter() - t0) / 1e9
    recv.close()
    send.close()
    return out


def _exact_checks(code, beta_mode: str, order, P, diff, results, operands,
                  device) -> dict:
    """Check the decode of each exact state of one cluster batch, and hold
    its error to the bound its weights put on the products' errors.

    An exact state's estimate is ``β Σ_j w_j P_j`` over the first ``m``
    completions (weights solved on the host).  The decode is checked
    directly: each exact state is decoded again here, in float64 from the
    replay's float32 products ``P`` ``(B, N, Nx, Ny)`` with the same
    weights and completion order, and the served squared error must match
    that decode's to :data:`CLUSTER_DECODE_TOL` relative, whatever the
    weights' size.  The bound: with the float32 shard products off the
    float64 oracle's by ``diff[r, n]`` (Frobenius, per request and shard),
    ``‖est − C‖ ≤ |β| Σ_j |w_j| diff[r, order[j]]`` plus the float64
    decode's own residual (floored at 1e-9 ‖C‖).  Which workers finish
    first sets ``w``, so this bound, not a fixed error, is what a measured
    completion order can be held to.
    """
    import numpy as np
    R = code.recovery_threshold
    w, _ = code.estimate_weights(order[:R], R)
    out = {"first_R": [int(n) for n in order[:R]], "worst_ratio": 0.0,
           "sum_abs_w": float(np.abs(w).sum()), "decode_rel_dev": 0.0,
           "exact_states": 0}
    for r, (res, (A, B)) in enumerate(zip(results, operands)):
        C = torch.from_numpy(A).to(device) @ torch.from_numpy(B).to(device)
        c_norm = float(torch.linalg.vector_norm(C))
        for a in res.answers:
            if a.rel_err is None or a.m < R:
                continue
            w, info = code.estimate_weights(order[:a.m], a.m)
            beta = complex(code.beta(info, a.m, beta_mode, None))
            wt = torch.as_tensor(np.asarray(w), device=device)
            stack = P[r].index_select(0, torch.as_tensor(
                np.asarray(order[:len(w)]), device=device))
            dt = torch.promote_types(torch.promote_types(
                wt.dtype, stack.dtype), torch.float64)
            est = torch.tensordot(wt.to(dt), stack.to(dt), dims=1)
            est = est * (beta if est.is_complex() else beta.real)
            if est.is_complex():
                est = est.real
            err = float(torch.linalg.vector_norm(est - C)) ** 2 / c_norm ** 2
            out["decode_rel_dev"] = max(out["decode_rel_dev"],
                                        abs(a.rel_err - err) / err)
            out["exact_states"] += 1
            bound = abs(beta) * float(np.abs(w) @ diff[r, order[:len(w)]]) \
                + 1e-9 * c_norm
            out["worst_ratio"] = max(out["worst_ratio"],
                                     math.sqrt(a.rel_err) * c_norm / bound)
            del est, stack
        del C
    return out


def _hist(snap: dict, name: str) -> dict:
    h = snap["histograms"].get(name) or {"count": 0, "total": 0.0,
                                         "max": 0.0}
    return {"count": h["count"], "total_s": h["total"],
            "mean_s": h["total"] / h["count"] if h["count"] else None,
            "max_s": h["max"] if h["count"] else None}


def _answers(rep_requests) -> list:
    return [[(a["t"], a["m"], a["kind"], a["rel_err"]) for a in r["answers"]]
            for r in rep_requests]


def _start_side_runs(out_dir: Path) -> dict:
    """Start the chaos, replication and socket serves, each as the serve CLI
    in a process of its own, all at once; their output goes to files."""
    procs = {}
    for name, extra in SIDE_RUNS.items():
        out = open(out_dir / f"side_{name}.json", "w")
        err = open(out_dir / f"side_{name}.err", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *SIDE_ARGS,
             *extra], cwd=ROOT, env=_child_env(), stdout=out, stderr=err,
            text=True)
        out.close()
        err.close()
        procs[name] = (proc, time.perf_counter())
    return procs


def _stop(procs: dict) -> None:
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finish_side_runs(procs: dict, out_dir: Path) -> dict:
    """Wait for the side serves and check each against what its chaos and
    flags must give."""
    side, ended = {}, {}
    deadline = time.perf_counter() + SIDE_TIMEOUT
    while len(ended) < len(procs):        # each run's own end, as it comes
        for name, (proc, _) in procs.items():
            if name not in ended and proc.poll() is not None:
                ended[name] = time.perf_counter()
        running = [p for n, (p, _) in procs.items() if n not in ended]
        if running and time.perf_counter() > deadline:
            _stop(procs)
            fail(f"cluster side runs: no result within {SIDE_TIMEOUT:.0f} "
                 f"s from {sorted(set(procs) - set(ended))}")
        if running:
            try:
                running[0].wait(timeout=0.1)
            except subprocess.TimeoutExpired:
                pass
    for name, (proc, t0) in procs.items():
        total = ended[name] - t0
        if proc.returncode != 0:
            tail = (out_dir / f"side_{name}.err").read_text()[-2000:]
            fail(f"cluster {name}: the serve exited {proc.returncode}: "
                 f"{tail}")
        text = (out_dir / f"side_{name}.json").read_text()
        rep = json.loads(text.strip().splitlines()[-1])
        cl = rep["cluster"]
        side[name] = {"pool": cl["pool"], "losses": cl["losses"],
                      "re_dispatch": (cl["speculation"] or {}).get(
                          "by_reason"),
                      "launches": cl["kernel_launches"],
                      "exact": all(r["t_exact"] is not None
                                   for r in rep["requests"]),
                      "wall_s": rep["summary"]["wall_s"],
                      "startup_s": cl["startup_s"], "total_s": total}
        if not cl["kernel_launches"].get("coded_matmul"):
            fail(f"cluster {name}: the workers launched no kernel")
    chaos, repl, sock = (side["chaos_speculate"], side["replicate"],
                         side["socket"])
    cp, reasons = chaos["pool"], chaos["re_dispatch"]
    if chaos["losses"] or cp["crashed"] != 1 or cp["retired"] < 1 \
            or "crash" not in reasons or "hedge" not in reasons \
            or not chaos["exact"]:
        fail(f"cluster chaos+speculate: {chaos}")
    if repl["losses"] or repl["re_dispatch"] != {"replicate": 3 * 2} \
            or not repl["exact"]:
        fail(f"cluster --replicate 2: {repl}")
    if sock["losses"] != [[0, 0, "crash"]] or sock["pool"]["replaced"] != 1:
        fail(f"cluster socket transport: {sock}")
    log(f"  {SIDE_WIDTH}, matdot K=2, N=3, 8 requests in batches of 4, "
        f"three serve processes at once: crash:1,hang:1 + --speculate: no "
        f"loss, re-dispatch {reasons}, {cp['retired']} retired, every "
        f"request exact; --replicate 2 with crash:1: no loss, "
        f"{sum(repl['re_dispatch'].values())} pinned copies; socket "
        f"transport (two 127.0.0.1 hosts) with crash:1: shard 0 of batch 0 "
        f"lost, the fleet healed")
    for name, row in side.items():
        log(f"    {name}: {row['total_s']:.1f} s from its start (fleet "
            f"start {row['startup_s']:.1f} s, serve loop {row['wall_s']:.1f}"
            f" s); pool {row['pool']}")
    return side


def phase_cluster(device_serve: dict, operands: list) -> dict:
    """The worker-process cluster on the card: the full-width serve through
    the CLI on phase 4's operands with its trace recorded, the trace
    replayed bit for bit in this process, the shard products held to the
    float64 oracle and every exact state's decode checked; at a smaller
    width, the real-time open loop, and chaos with speculation, replication
    and the socket transport (three serve processes, started once the
    real-time run is done, while the full-width trace is replayed)."""
    from repro_torch.launch.serve import build_parser
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "cluster"     # ignored by git
    out_dir.mkdir(parents=True, exist_ok=True)
    shm = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    log("df -h /dev/shm:\n" + shm.rstrip())
    shm_free = os.statvfs("/dev/shm")
    shm_bytes = shm_free.f_bavail * shm_free.f_frsize
    batch = 4
    while batch > 1 and shm_bytes < 2 * batch * CLUSTER_BATCH_BYTES:
        batch //= 2
    compute_mode = _nvidia_smi("compute_mode")
    mps = _mps_running()
    log(f"cluster: /dev/shm has {shm_bytes / 2**30:.1f} GiB free, a batch "
        f"of {batch} publishes {batch * CLUSTER_BATCH_BYTES / 2**30:.2f} GiB"
        f" (local transport, shared memory); compute mode {compute_mode}, "
        f"MPS {'running' if mps else 'not running'} (not started here)")

    t0 = time.perf_counter()
    rates = _host_copy_rates()
    log(f"  host copies of 256 MiB (the pipe: 64 MiB) in "
        f"{time.perf_counter() - t0:.1f} s, GB/s: " + ", ".join(
            f"{k} {v:.2f}" for k, v in rates.items()))

    # (1) the full-width serve on phase 4's operands, its trace recorded
    trace = str(out_dir / "trace.json")
    metrics = str(out_dir / "metrics.json")
    argv = CLUSTER_ARGS + ["--batch-size", str(batch), "--record", trace,
                           "--metrics-out", metrics]
    args = build_parser().parse_args(argv)
    if len(operands) != CLUSTER_REQUESTS:
        fail("cluster: phase 4's operands were not drawn")
    torch.cuda.empty_cache()
    mem_before = float(_nvidia_smi("memory.used"))
    _zero_launches()
    t0 = time.perf_counter()
    with _MemoryPoll() as mem:
        rep = _serve(argv, operands)
    total = time.perf_counter() - t0
    master = _read_launches()
    # (4) the real-time open loop and a sim replay of its trace, alone: its
    # wall-clock admissions must not wait on other processes' startup
    side_rt = _cluster_realtime("cuda")
    # (5) the side serves run while this process replays the full-width
    # trace and checks it (steps 2 and 3)
    procs = _start_side_runs(out_dir)
    try:
        out = _cluster_full_width(rep, args, batch, operands, trace, metrics,
                                  total, master, mem, mem_before,
                                  device_serve)
        side = _finish_side_runs(procs, out_dir)
    finally:
        _stop(procs)
    side["realtime"] = side_rt
    elapsed = time.perf_counter() - t_phase
    log(f"cluster phase: {elapsed:.1f} s ({CARD})")
    out.update(batch=batch, shm_free_bytes=shm_bytes,
               host_copy_gb_s=rates, compute_mode=compute_mode, mps=mps,
               side=side, phase_s=elapsed)
    return out


def _cluster_full_width(rep, args, batch, operands, trace, metrics, total,
                        master, mem, mem_before, device_serve) -> dict:
    """Check the full-width cluster serve, print its breakdown, and replay
    its trace in this process (steps 1 to 3 of phase 13)."""
    import numpy as np

    from repro_torch.cluster.backend import ReplayBackend
    from repro_torch.cluster.events import TraceRecording
    from repro_torch.launch.serve import CODES
    from repro_torch.serving import (DecodeWeightCache, MasterScheduler,
                                     ServeConfig, SimulatedBackend)
    cl = rep["cluster"]
    workers = cl["kernel_launches"]
    s = rep["summary"]
    n_batches = -(-CLUSTER_REQUESTS // batch)
    if s["requests"] != CLUSTER_REQUESTS:
        fail(f"cluster: served {s['requests']} of {CLUSTER_REQUESTS}")
    if cl["losses"] or cl["pool"]["crashed"] or cl["pool"]["retired"]:
        fail(f"cluster: a clean fleet lost work {cl['losses']} "
             f"{cl['pool']}")
    if workers.get("coded_matmul", 0) < CLUSTER_WORKERS * n_batches:
        fail(f"cluster: the workers report {workers} kernel launches, "
             f"need {CLUSTER_WORKERS * n_batches} coded_matmul")
    if master["coded_matmul"] != 0 or master["poly_encode"] <= 0:
        fail(f"cluster: the master launched {master} (products belong to "
             "the workers, the encode to the master)")
    R = rep["code"]["R"]
    exact = {}
    for r in rep["requests"]:
        # deadlines are wall-clock here: an early tick may come before the
        # first threshold, but the last answer must carry an estimate
        if r["answers"][-1]["rel_err"] is None:
            fail(f"cluster: request {r['req_id']} ends without an estimate")
        for a in r["answers"]:
            if a["rel_err"] is not None and not math.isfinite(a["rel_err"]):
                fail(f"cluster: request {r['req_id']} has a non-finite "
                     f"error at t={a['t']}")
            if a["rel_err"] is not None and a["m"] >= R:
                exact.setdefault(r["batch"], []).append(a["rel_err"])
    exact_max = {b: max(e) for b, e in exact.items()}
    if len(exact_max) != n_batches:
        fail(f"cluster: exact states in batches {sorted(exact_max)} of "
             f"{n_batches}")
    snap = json.loads(Path(metrics).read_text())
    split = {k: _hist(snap, f"backend.shard_{k}_seconds")
             for k in ("wait", "operand", "compute")}
    master_s = {"encode": _hist(snap, "backend.encode_seconds"),
                "publish": _hist(snap, "backend.publish_seconds"),
                "decode_push": _hist(snap, "serve.decode_push_seconds")}
    mem_peak = max(mem.samples) if mem.samples else None
    arrivals = []                     # per batch: first, median, last (s)
    for rec in TraceRecording.load(trace).batches:
        t = sorted(rec.times.values())
        arrivals.append([t[0], t[len(t) // 2], t[-1]])
    wall_batch = s["wall_s"] / n_batches
    dev_batch = device_serve["wall_s"] / n_batches
    log(f"cluster serve lsac_ortho 2048x32768 x{CLUSTER_REQUESTS} on "
        f"{CLUSTER_WORKERS} worker processes, batches of {batch}: "
        f"{s['wall_s']:.2f} s serve loop = {wall_batch:.3f} s per batch "
        f"(phase 4's device backend on the same job: {dev_batch:.3f} s per "
        f"batch); fleet start {cl['startup_s']:.1f} s; {total:.1f} s in all"
        f" (operands drawn beforehand) ({CARD})")
    log(f"  worker timing triples over {split['compute']['count']} shards, "
        f"mean / max s: wait {split['wait']['mean_s']:.4f} / "
        f"{split['wait']['max_s']:.4f}, operands "
        f"{split['operand']['mean_s']:.4f} / {split['operand']['max_s']:.4f}"
        f", compute {split['compute']['mean_s']:.4f} / "
        f"{split['compute']['max_s']:.4f}")
    log("  shard results arrive, s after dispatch (first / median / last):"
        " " + "; ".join(" / ".join(f"{x:.2f}" for x in a) for a in arrivals))
    log(f"  master per batch, mean s: encode (device, to the host) "
        f"{master_s['encode']['mean_s']:.3f}, publish (shared memory) "
        f"{master_s['publish']['mean_s']:.3f}; decode pushes (host time) "
        f"{master_s['decode_push']['total_s']:.3f} s in all")
    log(f"  card memory used (nvidia-smi, all contexts): {mem_before:.0f} "
        f"MiB before, peak {mem_peak:.0f} MiB during the serve; launches: "
        f"workers {workers}, master {master}")
    for row in s["deadlines"]:
        log(f"  deadline {row['deadline']:.1f} s (wall clock): mean rel err "
            f"{row['mean_err']:.3e} over {row['answers']} answers")
    for b, e in sorted(exact_max.items()):
        log(f"  batch {b}: exact-state max squared rel err {e:.3e}")

    # (2) the trace replayed through ReplayBackend(compute="device") in
    # this process on the same operands: every estimate bit-identical; the
    # replay's products (the workers' TorchShardComputer path) held to the
    # float64 oracle; (3) every exact state's decode checked
    code = CODES[args.code].build(args.K, args.N)
    kept = []

    class _KeepingReplay(ReplayBackend):
        def compute_products(self, *a, **kw):
            P = super().compute_products(*a, **kw)
            kept.append(P)
            return P

    t0 = time.perf_counter()
    replay = _KeepingReplay(TraceRecording.load(trace), compute="device",
                            device=args.device)
    cfg = ServeConfig(deadlines=tuple(float(x) for x in
                                      args.deadlines.split(",")),
                      stream=args.stream, batch_size=args.batch_size,
                      beta_mode=args.beta, decoder=args.decoder,
                      seed=args.seed)
    sched = MasterScheduler(code, replay, cfg,
                            DecodeWeightCache(args.cache_size))
    for A, B in operands:
        sched.submit(A, B)
    got = sched.run()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    want = _answers(rep["requests"])
    mine = [[(a.t, a.m, a.kind, a.rel_err) for a in r.answers] for r in got]
    if mine != want:
        fail("cluster: the device replay's estimates differ from the "
             "cluster run's")
    t0 = time.perf_counter()
    worst, ratio, dev_worst, amp = 0.0, 0.0, 0.0, {}
    recorded = TraceRecording.load(trace).batches
    by_batch = {}
    for res in got:
        by_batch.setdefault(res.batch, []).append(res)
    for i, P in enumerate(kept):
        part = operands[i * batch:(i + 1) * batch]
        P64 = SimulatedBackend._products_torch(
            code, [a for a, _ in part], [b for _, b in part], None, P.device)
        diff = torch.linalg.vector_norm(P.double() - P64, dim=(-2, -1))
        den = torch.linalg.vector_norm(P64, dim=(-2, -1))
        worst = max(worst, float((diff / den).max()))
        diff = diff.cpu().numpy()                       # (B, N) absolute
        del P64, den
        times = recorded[i].times
        order = np.array(sorted(times, key=times.get))  # arrival order
        amp[i + 1] = _exact_checks(code, args.beta, order, P, diff,
                                   by_batch[i + 1], part, P.device)
        ratio = max(ratio, amp[i + 1]["worst_ratio"])
        dev_worst = max(dev_worst, amp[i + 1]["decode_rel_dev"])
    del kept
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    if worst > CLUSTER_PRODUCT_TOL:
        fail(f"cluster: shard products {worst:.3e} from the float64 oracle "
             f"(limit {CLUSTER_PRODUCT_TOL})")
    log(f"  replay (ReplayBackend compute=device, this process): all "
        f"{len(mine)} answer streams bit-identical in {replay_s:.1f} s; "
        f"every shard's products within {worst:.2e} relative of the float64"
        f" oracle (limit {CLUSTER_PRODUCT_TOL}; checks {check_s:.1f} s)")
    for b, row in sorted(amp.items()):
        log(f"  batch {b}: first R = {row['first_R']}: sum |w| of the exact "
            f"decode {row['sum_abs_w']:.4g}; {row['exact_states']} exact "
            f"states, each decoded again in float64: served squared error "
            f"within {row['decode_rel_dev']:.2e} relative (limit "
            f"{CLUSTER_DECODE_TOL}); error at most {row['worst_ratio']:.3f} "
            f"of its bound")
    if not all(row["exact_states"] for row in amp.values()):
        fail("cluster: a batch has no exact state to check")
    if dev_worst > CLUSTER_DECODE_TOL:
        fail(f"cluster: an exact state's served error is {dev_worst:.3e} "
             f"relative from its float64 decode (limit "
             f"{CLUSTER_DECODE_TOL})")
    if ratio > 1.0:
        fail(f"cluster: an exact state's error exceeds its bound by "
             f"{ratio:.3f}x")
    return {"wall_s": s["wall_s"], "wall_per_batch_s": wall_batch,
            "device_backend_wall_per_batch_s": dev_batch,
            "startup_s": cl["startup_s"], "total_s": total,
            "worker_split": split, "master": master_s,
            "arrivals_s": arrivals,
            "memory_used_mib": {"before": mem_before, "peak": mem_peak},
            "launches": {"coded_matmul": workers.get("coded_matmul", 0),
                         "poly_encode": master["poly_encode"]},
            "exact_max_err_by_batch": exact_max,
            "deadlines": s["deadlines"], "replay_s": replay_s,
            "check_s": check_s, "product_max_rel_err": worst,
            "exact_checks": amp}


def _cluster_realtime(device: str) -> dict:
    """``run_open`` on the cluster paces arrivals on the wall clock: a burst
    past the queue limit, then a short Poisson stream, batches of one.  A
    ``sim``-path replay of the recorded trace must shed, drop and batch the
    same requests and give the same answers."""
    from dataclasses import replace

    import numpy as np

    from repro_torch.cluster.backend import ClusterBackend, ReplayBackend
    from repro_torch.launch.serve import CODES
    from repro_torch.serving import (MasterScheduler, OpenRequest,
                                     ServeConfig, TenantSpec, build_workload)
    side = CLUSTER_SIDE
    ten = TenantSpec("rt", rows=side["rows"], inner=side["inner"],
                     target_error=1e-2, deadline=20.0)
    rng = np.random.default_rng(41)
    burst = [OpenRequest(0.0, rng.standard_normal((side["rows"],
                                                   side["inner"])),
                         rng.standard_normal((side["inner"], side["rows"])),
                         ten) for _ in range(6)]
    # the Poisson stream starts once the burst's batches are long served,
    # so no admission hinges on how much sooner the virtual clock runs
    tail = [replace(r, arrival=REALTIME_TAIL_START + r.arrival)
            for r in build_workload((ten,), rate=2.0, horizon=2.0,
                                    seed=43)]
    work = burst + tail
    cfg = ServeConfig(deadlines=(0.2, 0.5, 2.0), batch_size=1, seed=3,
                      queue_limit=3, shed_expired=True)
    code = CODES["lsac_ortho"].build(side["K"], side["N"])
    t0 = time.perf_counter()
    with ClusterBackend(workers=side["N"], seed=3, compute="device",
                        record=True, device=device) as be:
        # the fleet starts before the first arrival: run_open's clock
        # counts dispatch spans, not a worker's CUDA start
        if not be.pool.wait_ready(timeout=120.0):
            fail("cluster real-time open loop: the fleet did not start")
        live = MasterScheduler(code, be, cfg)
        got = live.run_open(work)
        rec = be.recording
    wall = time.perf_counter() - t0
    replay = MasterScheduler(code, ReplayBackend(rec, compute="device",
                                                 device=device), cfg)
    want = replay.run_open(work, realtime=False)
    same = (live.shed == replay.shed
            and [(r.req_id, r.batch, r.dropped) for r in got]
            == [(r.req_id, r.batch, r.dropped) for r in want]
            and [[(a.t, a.m, a.rel_err) for a in r.answers] for r in got]
            == [[(a.t, a.m, a.rel_err) for a in r.answers] for r in want])
    if not same or not live.shed or not got:
        fail(f"cluster real-time open loop: live shed {live.shed}, served "
             f"{len(got)}; the sim replay shed {replay.shed}, served "
             f"{len(want)}")
    dropped = sum(1 for r in got if r.dropped)
    log(f"  real-time open loop: {len(work)} arrivals ({len(burst)} at 0, "
        f"then Poisson from {REALTIME_TAIL_START} s), {len(live.shed)} "
        f"shed, {len(got) - dropped} served, {dropped} dropped in "
        f"{wall:.1f} s of wall clock; the sim replay of its trace sheds, "
        f"drops, batches and answers the same")
    return {"arrivals": len(work), "shed": len(live.shed),
            "served": len(got) - dropped, "dropped": dropped, "wall_s": wall}


# Phase 14: the coded runtime and training.  The distributed job is phase 4's
# L-SAC (ortho) K = 8, N = 24 on its first drawn 2048 x 32768 pair; its decode
# weights come from a completion order whose first R workers are well
# conditioned (sum |w| about 7; the order 0..23 gives 2e11: ROADMAP Queue C),
# so float32 products decode to float32 accuracy.
DIST_ORDER_SEED, DIST_DECODER_SEED = 0, 3
DIST_DECODE_TOL = 1e-6        # against float64 sum w_n P_n of the same products
# repro-100m at full width, the training CLI's batch 8 x 512; the coded MLP
# with K = 8, N = 16 and one dead worker (the most it tolerates: N - 2K + 1)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "repro-100m", 8, 512
TRAIN_STEPS, CODED_STEPS, CODED_N, CODED_DEAD = 30, 20, 16, 1
# the resume check: the CLI checkpoints every 25 steps, so the failure comes
# after step 28 and the resumed run replays steps 25..29
FAIL_AT, CKPT_STEP = 28, 25
RESUME_TOL = 1e-6             # the reference test's rtol
# Each step draws new tokens and the warm-up learning rate is small (3e-6 at
# step 1, 9e-5 at step 30), so the step losses move by less than one batch's
# noise; "the loss falls" is held on one held-out batch (the pipeline's step
# HELDOUT_STEP, never trained on): its loss after the run must be below its
# loss at the initial weights.  The means of the first and last FALL_WINDOW
# step losses are reported.
HELDOUT_STEP, FALL_WINDOW = 10 ** 6, 5
# The coded run's loss gap to the uncoded run, relative to the uncoded loss,
# in the reference's own train(): at most 7.78e-3 per step over seeds 0-2 at
# repro-100m's widths and depth, bf16, batch 2 x 128, 3 steps
# (tools/coded_gap.py --package reference on the CPU; PERF.md §6).  The
# card's runs are held to CODED_GAP_FACTOR times it, at that cut and at
# full size.
CODED_GAP_REF, CODED_GAP_FACTOR = 7.78e-3, 3.0
GAP_CUT = {"batch": 2, "seq": 128, "steps": 3}
# one coded contraction at full width (float32) against h @ w_down: the
# reference test's limit
CONTRACTION_SHAPE, CONTRACTION_TOL = (4096, 2048, 768), 1e-3
# repro-10m (float32) on the card against the CPU from the same weights
SMALL_TRAIN_STEPS, SMALL_TRAIN_TOL = 3, 1e-4


def _init_dist_world1(store_dir: Path) -> None:
    """A one-rank NCCL group on card 0, with a file store in ``store_dir``."""
    import datetime
    import shutil

    import torch.distributed as dist
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(store_dir / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))


def _phase_distributed(A, B) -> dict:
    """(a) ``distributed_coded_matmul`` with NCCL at world size 1, then
    ``TorchDeviceBackend.decode_on_mesh`` with an incremental decoder's
    weights at an exact state."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.core import split_contraction
    from repro_torch.kernels import coded_matmul, worker_products
    from repro_torch.launch.serve import CODES
    from repro_torch.runtime.coded import (decode_weight_vector,
                                           distributed_coded_matmul,
                                           encode_operands)
    from repro_torch.serving import IncrementalDecoder, TorchDeviceBackend
    code = CODES["lsac_ortho"].build(8, 24)
    N, R = code.N, code.recovery_threshold
    t0 = time.perf_counter()
    E_A64, E_B64 = encode_operands(code, *split_contraction(A, B, code.K))
    encode_s = time.perf_counter() - t0
    ea64 = torch.from_numpy(E_A64).cuda()
    eb64 = torch.from_numpy(E_B64).cuda()
    del E_A64, E_B64
    ea, eb = ea64.float(), eb64.float()
    order = np.random.default_rng(DIST_ORDER_SEED).permutation(N)
    w = decode_weight_vector(code, order, R)
    _init_dist_world1(ROOT / "build" / "dist_store")
    try:
        _zero_launches()
        t0 = time.perf_counter()
        est = distributed_coded_matmul(ea, eb, torch.as_tensor(
            w, dtype=torch.float32, device="cuda"))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = coded_matmul.launches
        if launches <= 0:
            fail("distributed_coded_matmul did not launch coded_matmul")
        # the checks' own products (not counted)
        P = worker_products(ea, eb)
        P64 = torch.bmm(ea64, eb64)
        del ea64, eb64
        prod_err = float((torch.linalg.vector_norm(P.double() - P64,
                                                   dim=(-2, -1))
                          / torch.linalg.vector_norm(P64, dim=(-2, -1)))
                         .max())
        del P64
        Pd = P.double()

        def oracle(wv):
            return torch.einsum("w,wij->ij", torch.as_tensor(
                wv, dtype=torch.float64, device="cuda"), Pd)

        def rel(got, want):
            return float(torch.linalg.vector_norm(got.double() - want)
                         / torch.linalg.vector_norm(want))

        est_err = rel(est, oracle(w))
        C = torch.from_numpy(A).cuda() @ torch.from_numpy(B).cuda()
        exact_err = rel(est, C)
        if prod_err > CLUSTER_PRODUCT_TOL:
            fail(f"distributed products {prod_err:.3e} from the float64 "
                 f"oracle (limit {CLUSTER_PRODUCT_TOL})")
        if not est_err <= DIST_DECODE_TOL:
            fail(f"distributed_coded_matmul {est_err:.3e} from float64 "
                 f"sum w_n P_n of its products (limit {DIST_DECODE_TOL})")
        # decode_on_mesh at an incremental decoder's exact state
        dec = IncrementalDecoder(code)
        for n in np.random.default_rng(DIST_DECODER_SEED).permutation(N)[:R]:
            dec.push(int(n), P[n])
        wd = dec.weight_vector()
        before = coded_matmul.launches
        t0 = time.perf_counter()
        est2 = TorchDeviceBackend(device="cuda").decode_on_mesh(code, A, B,
                                                                wd)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        mesh_launches = coded_matmul.launches - before
        if mesh_launches <= 0:
            fail("decode_on_mesh did not launch coded_matmul")
        mesh_err = rel(est2, oracle(wd))
        mesh_exact = rel(est2, C)
        if not mesh_err <= DIST_DECODE_TOL:
            fail(f"decode_on_mesh {mesh_err:.3e} from float64 sum w_n P_n "
                 f"(limit {DIST_DECODE_TOL})")
    finally:
        dist.destroy_process_group()
    del ea, eb, P, Pd, C, est, est2
    torch.cuda.empty_cache()
    log(f"distributed_coded_matmul (NCCL, world size 1; lsac_ortho K=8 N=24 "
        f"on phase 4's first 2048x32768 pair): {launches} coded_matmul "
        f"launch, {run_s * 1e3:.1f} ms; host float64 encode {encode_s:.1f} s;"
        f" products within {prod_err:.2e} of the float64 oracle (limit "
        f"{CLUSTER_PRODUCT_TOL}); estimate {est_err:.2e} from float64 "
        f"sum w_n P_n (limit {DIST_DECODE_TOL}; sum |w| "
        f"{float(np.abs(w).sum()):.3g}), {exact_err:.2e} from A@B")
    log(f"decode_on_mesh (incremental decoder's exact state, sum |w| "
        f"{float(np.abs(wd).sum()):.3g}): {mesh_launches} launch, "
        f"{mesh_s:.1f} s with its host encode; {mesh_err:.2e} from float64 "
        f"sum w_n P_n, {mesh_exact:.2e} from A@B")
    return {"launches": {"coded_matmul": launches + mesh_launches,
                         "poly_encode": 0},
            "distributed_ms": run_s * 1e3, "host_encode_s": encode_s,
            "product_max_rel_err": prod_err, "estimate_rel_err": est_err,
            "estimate_vs_exact": exact_err, "sum_abs_w": float(
                np.abs(w).sum()), "decode_on_mesh_rel_err": mesh_err,
            "decode_on_mesh_vs_exact": mesh_exact,
            "decode_on_mesh_s": mesh_s}


def _start_failing_train(ckpt: Path) -> subprocess.Popen:
    """The training CLI at full size, stopped by ``--simulate-failure-at``
    after its step-25 checkpoint; output to a file beside the checkpoints."""
    import shutil
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    log_f = open(ckpt.parent / "train_fail.log", "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir",
             str(ckpt), "--simulate-failure-at", str(FAIL_AT), "--seed", "0"],
            cwd=ROOT, env=_child_env(), stdout=log_f,
            stderr=subprocess.STDOUT)
    finally:
        log_f.close()


def _timed_steps(cfg, params, opt, coded_w, first: int, n: int = 5) -> dict:
    """Host-clock ms of ``n`` more train steps (each ending in a
    synchronise) on the trained state, through ``make_train_step``, then
    device time by kernel over one more step (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.runtime.steps import make_train_step
    step_fn = make_train_step(cfg, device="cuda")
    gen = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    torch.cuda.synchronize()
    before = (flash_attention.launches, flash_attention_bwd.launches)
    times = []
    for s in range(first, first + n + 1):
        batch = {"tokens": torch.as_tensor(gen(s)["tokens"],
                                           dtype=torch.long, device="cuda")}
        if coded_w is not None:
            batch["coded_weights"] = coded_w
        torch.cuda.synchronize()
        if s == first + n:                        # the profiled step
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt, m = step_fn(params, opt, batch, s)
                float(m["loss"])
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            break
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, s)
        float(m["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = sum(times) / len(times)
    # the n timed steps and the profiled one: the flash kernel's forward
    # (with the remat recompute) and backward launches
    flash = {"flash_attention": flash_attention.launches - before[0],
             "flash_attention_bwd": flash_attention_bwd.launches - before[1]}
    if flash["flash_attention_bwd"] != (n + 1) * cfg.n_layers:
        fail(f"{cfg.name} train steps: {flash} flash launches in {n + 1} "
             f"steps, expected {cfg.n_layers} backward launches a step")
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    rows = _device_rows(prof, wall_ms, f"breakdown ({cfg.name} train step, "
                        f"{'coded' if coded_w is not None else 'uncoded'}, "
                        f"profiled; {launches} kernel launches)")
    return {"step_ms": ms, "step_ms_each": times,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
            "flash_launches": flash,
            "breakdown": dict(rows, launch_calls=launches)}


def _heldout(cfg, params, coded_w=None) -> float:
    """``lm_loss`` of the held-out batch (no gradient)."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import lm_loss
    batch = {"tokens": torch.as_tensor(SyntheticTokens(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)(HELDOUT_STEP)[
            "tokens"], dtype=torch.long, device="cuda")}
    if coded_w is not None:
        batch["coded_weights"] = coded_w
    with torch.no_grad():
        return float(lm_loss(params, batch, cfg))


def _mean(xs) -> float:
    return sum(xs) / len(xs)


def _gap(base, coded) -> float:
    return max(abs(c - b) / abs(b) for b, c in zip(base, coded))


def _phase_train(failing: subprocess.Popen, ckpt: Path) -> dict:
    """(b) repro-100m at full width on the card: uncoded, coded with one
    dead worker, the gap between them, one coded contraction at full width,
    and the resume after the CLI's simulated failure."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import MatDotCode, chebyshev_roots
    from repro_torch.launch.train import build_state, train
    from repro_torch.runtime.coded import (coded_contraction,
                                           coded_generators,
                                           exact_weight_vector)
    cfg = get_arch(TRAIN_ARCH)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=None, resume=False,
              seed=0, device="cuda")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ}
    # the cut the reference's gap was measured at, then full size
    cut = {k: v for k, v in kw.items() if k not in ("batch", "seq")}
    _, _, cb = train(cfg, steps=GAP_CUT["steps"], batch=GAP_CUT["batch"],
                     seq=GAP_CUT["seq"], log_every=100, **cut)
    _, _, cc = train(cfg, steps=GAP_CUT["steps"], batch=GAP_CUT["batch"],
                     seq=GAP_CUT["seq"], coded=True, coded_N=CODED_N,
                     dead_workers=CODED_DEAD, log_every=100, **cut)
    out["cut_gap"] = {"uncoded": cb, "coded": cc, "max_rel_gap": _gap(cb, cc)}
    # the CLI's failing run ends before the timed runs start
    try:
        rc = failing.wait(timeout=600)
    finally:
        if failing.poll() is None:
            failing.kill()
            failing.wait()
    if rc != 42:
        tail = (ckpt.parent / "train_fail.log").read_text()[-3000:]
        fail(f"train --simulate-failure-at {FAIL_AT}: exit {rc} (42 "
             f"expected)\n{tail}")
    code = MatDotCode(cfg.coded_K, CODED_N, chebyshev_roots(CODED_N))
    live = np.ones(CODED_N, bool)
    live[:CODED_DEAD] = False
    cw = torch.as_tensor(exact_weight_vector(code, live),
                         dtype=torch.float32, device="cuda")
    ccfg = cfg.replace(coded=True)
    init, _ = build_state(cfg, 0, device="cuda")
    h0 = (_heldout(cfg, init), _heldout(ccfg, init, cw))
    del init
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, base = train(cfg, steps=TRAIN_STEPS, log_every=10, **kw)
    torch.cuda.synchronize()
    out["uncoded"] = {"losses": base, "wall_s": time.perf_counter() - t0,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "heldout": (h0[0], _heldout(cfg, params))}
    ref_state = {k: v.clone() for k, v in params.state_dict().items()}
    out["uncoded"].update(_timed_steps(cfg, params, opt, None, TRAIN_STEPS))
    del params, opt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cparams, copt, coded = train(cfg, steps=CODED_STEPS, coded=True,
                                 coded_N=CODED_N, dead_workers=CODED_DEAD,
                                 log_every=10, **kw)
    torch.cuda.synchronize()
    out["coded"] = {"losses": coded, "wall_s": time.perf_counter() - t0,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "heldout": (h0[1], _heldout(ccfg, cparams, cw))}
    out["coded"].update(_timed_steps(ccfg, cparams, copt, cw, CODED_STEPS))
    del cparams, copt
    torch.cuda.empty_cache()
    out["coded"]["max_rel_gap"] = _gap(base[:CODED_STEPS], coded)
    for name, run in (("uncoded", base), ("coded", coded)):
        r = out[name]
        r["window_means"] = (_mean(run[:FALL_WINDOW]),
                             _mean(run[-FALL_WINDOW:]))
        if not all(math.isfinite(x) for x in run):
            fail(f"{name} training: a non-finite loss in {run}")
        if not r["heldout"][1] < r["heldout"][0]:
            fail(f"{name} training: held-out loss {r['heldout'][0]:.5f} at "
                 f"the initial weights, {r['heldout'][1]:.5f} after the run "
                 "(a fall expected)")
    limit = CODED_GAP_FACTOR * CODED_GAP_REF
    for what, g in (("cut", out["cut_gap"]["max_rel_gap"]),
                    ("full size", out["coded"]["max_rel_gap"])):
        if not g <= limit:
            fail(f"coded vs uncoded loss at {what}: relative gap {g:.3e} "
                 f"(limit {CODED_GAP_FACTOR} x the reference's "
                 f"{CODED_GAP_REF} = {limit:.3e})")

    # one coded contraction at full width, float32, every tolerated dead count
    T, F, d = CONTRACTION_SHAPE
    g = torch.Generator(device="cuda").manual_seed(7)
    h = torch.randn((T, F), generator=g, device="cuda")
    wd = torch.randn((F, d), generator=g, device="cuda") / math.sqrt(F)
    want = (h.double() @ wd.double())
    G_A, G_B = coded_generators(code, device="cuda")

    def err(got, exact):
        return float(torch.linalg.vector_norm(got.double() - exact)
                     / torch.linalg.vector_norm(exact))

    # bf16 (the training dtype) is reported beside float32, unchecked: the
    # decode weights' sum |w| multiplies bf16's rounding
    hb, wb = h.bfloat16(), wd.bfloat16()
    want_b = hb.double() @ wb.double()
    contraction, contraction_bf16 = {}, {}
    for dead in range(CODED_N - code.recovery_threshold + 1):
        live = np.ones(CODED_N, bool)
        live[:dead] = False
        w = torch.as_tensor(exact_weight_vector(code, live),
                            dtype=torch.float32, device="cuda")
        contraction[dead] = err(coded_contraction(h, wd, G_A, G_B, w), want)
        contraction_bf16[dead] = err(coded_contraction(hb, wb, G_A, G_B, w),
                                     want_b)
        if not contraction[dead] < CONTRACTION_TOL:
            fail(f"coded contraction {T}x{F}x{d} with {dead} dead: "
                 f"{contraction[dead]:.3e} from h @ w_down (limit "
                 f"{CONTRACTION_TOL})")
    plain_bf16 = err(hb @ wb, want_b)
    out["contraction_rel_err_by_dead"] = contraction
    out["contraction_bf16_rel_err_by_dead"] = contraction_bf16
    out["plain_bf16_rel_err"] = plain_bf16
    out["sum_abs_w"] = float(np.abs(exact_weight_vector(code, np.ones(
        CODED_N, bool))).sum())
    del h, wd, want, hb, wb, want_b

    # resume: the CLI failed after step FAIL_AT; resume from its checkpoint
    t0 = time.perf_counter()
    rparams, _, resumed = train(cfg, steps=TRAIN_STEPS, log_every=10,
                                **dict(kw, ckpt_dir=str(ckpt), resume=True))
    resume_s = time.perf_counter() - t0
    want = base[CKPT_STEP:]
    if len(resumed) != len(want):
        fail(f"resume ran {len(resumed)} steps, {len(want)} expected (from "
             f"the step-{CKPT_STEP} checkpoint)")
    dev_worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))
    if not dev_worst <= RESUME_TOL:
        fail(f"resumed losses {resumed} vs uninterrupted {want}: "
             f"{dev_worst:.3e} relative (limit {RESUME_TOL})")
    same_params = all(torch.equal(v, ref_state[k])
                      for k, v in rparams.state_dict().items())
    out["resume"] = {"losses": resumed, "uninterrupted": want,
                     "max_rel_dev": dev_worst,
                     "losses_bit_identical": resumed == want,
                     "final_params_bit_identical": same_params,
                     "resume_s": resume_s}
    del rparams, ref_state
    torch.cuda.empty_cache()
    u, c = out["uncoded"], out["coded"]
    log(f"train {cfg.name} ({cfg.n_layers}x{cfg.d_model}/{cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}) at batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} on {CARD}: uncoded {TRAIN_STEPS} steps, loss "
        f"{base[0]:.4f} -> {base[-1]:.4f} in {u['wall_s']:.1f} s; step "
        f"{u['step_ms']:.1f} ms, {u['tokens_per_s']:.0f} tokens/s, peak "
        f"{u['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  coded MLP (K={cfg.coded_K}, N={CODED_N}, {CODED_DEAD} dead) "
        f"{CODED_STEPS} steps: loss {coded[0]:.4f} -> {coded[-1]:.4f}; step "
        f"{c['step_ms']:.1f} ms, {c['tokens_per_s']:.0f} tokens/s, peak "
        f"{c['peak_bytes'] / 2**30:.2f} GiB; largest relative loss gap to "
        f"uncoded {c['max_rel_gap']:.3e} (at batch {GAP_CUT['batch']} x "
        f"{GAP_CUT['seq']}: {out['cut_gap']['max_rel_gap']:.3e}; limit "
        f"{limit:.3e})")
    log(f"  held-out loss (step {HELDOUT_STEP}'s batch): uncoded "
        f"{u['heldout'][0]:.5f} -> {u['heldout'][1]:.5f}, coded "
        f"{c['heldout'][0]:.5f} -> {c['heldout'][1]:.5f}; mean step loss of "
        f"the first / last {FALL_WINDOW} steps: uncoded "
        f"{u['window_means'][0]:.4f} / {u['window_means'][1]:.4f}, coded "
        f"{c['window_means'][0]:.4f} / {c['window_means'][1]:.4f}")
    log(f"  coded contraction {T}x{F}x{d} vs h @ w_down (sum |w| "
        f"{out['sum_abs_w']:.4g}): float32 " + ", ".join(
            f"{k} dead {v:.2e}" for k, v in contraction.items())
        + f" (limit {CONTRACTION_TOL}); bf16 " + ", ".join(
            f"{k} dead {v:.3g}" for k, v in contraction_bf16.items())
        + f" (plain bf16 h @ w_down {plain_bf16:.2e}; not checked)")
    log(f"  resume: the CLI exited 42 after step {FAIL_AT}; resumed from "
        f"step {CKPT_STEP}, losses within {dev_worst:.2e} of the "
        f"uninterrupted run (limit {RESUME_TOL}); bit-identical losses "
        f"{out['resume']['losses_bit_identical']}, final parameters "
        f"{same_params}")
    return out


def _phase_small_train() -> dict:
    """(c) repro-10m in float32: the same weights train on the card and on
    the CPU, uncoded and through the coded MLP (K = 8, N = CODED_N, CODED_DEAD
    dead); loss and grad norm per step within SMALL_TRAIN_TOL.  The coded
    run holds the card's coded FFN, forward and backward, to the CPU's,
    which the CPU tests hold to the reference."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import MatDotCode, chebyshev_roots
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import build_state
    from repro_torch.runtime.coded import exact_weight_vector
    from repro_torch.runtime.steps import make_train_step
    cfg = get_arch(TRAIN_ARCH, smoke=True)
    gen = SyntheticTokens(cfg.vocab_size, 128, 4, seed=1)
    live = np.ones(CODED_N, bool)
    live[:CODED_DEAD] = False
    cw = exact_weight_vector(MatDotCode(cfg.coded_K, CODED_N,
                                        chebyshev_roots(CODED_N)), live)
    cpu_params, _ = build_state(cfg, 0, device="cpu")
    out = {}
    for variant, vcfg in (("uncoded", cfg), ("coded", cfg.replace(
            coded=True))):
        runs = {}
        for dev in ("cuda", "cpu"):
            params, opt = build_state(vcfg, 0, device=dev)
            params.load_state_dict(cpu_params.state_dict())
            step = make_train_step(vcfg, device=dev)
            rows = []
            for s in range(SMALL_TRAIN_STEPS):
                batch = gen(s)
                if vcfg.coded:
                    batch["coded_weights"] = cw
                params, opt, m = step(params, opt, batch, s)
                rows.append((float(m["loss"]), float(m["grad_norm"])))
            runs[dev] = rows
        worst = {"loss": 0.0, "grad_norm": 0.0}
        for (lg, gg), (lc, gc) in zip(runs["cuda"], runs["cpu"]):
            worst["loss"] = max(worst["loss"], abs(lg - lc) / abs(lc))
            worst["grad_norm"] = max(worst["grad_norm"],
                                     abs(gg - gc) / abs(gc))
        if max(worst.values()) > SMALL_TRAIN_TOL:
            fail(f"{cfg.name} {variant} train steps card vs CPU: {worst} "
                 f"(limit {SMALL_TRAIN_TOL})")
        log(f"{cfg.name} float32 {variant}"
            + (f" (K={cfg.coded_K}, N={CODED_N}, {CODED_DEAD} dead)"
               if vcfg.coded else "")
            + f", {SMALL_TRAIN_STEPS} train steps: card == CPU, loss within "
            f"{worst['loss']:.2e}, grad norm {worst['grad_norm']:.2e} "
            f"relative (limit {SMALL_TRAIN_TOL})")
        out[variant] = {"steps": runs, "max_rel": worst}
    return out


def phase_coded_runtime(operands: list) -> dict:
    """Phase 14: (a) the coded runtime's distributed job and decode_on_mesh,
    (b) repro-100m training at full width, (c) repro-10m card vs CPU."""
    t_phase = time.perf_counter()
    ckpt = ROOT / "build" / "train_resume" / "ckpt"     # ignored by git
    failing = _start_failing_train(ckpt)
    try:
        A, B = operands[0]
        dist_out = _phase_distributed(A, B)
        train_out = _phase_train(failing, ckpt)
    finally:
        if failing.poll() is None:
            failing.kill()
            failing.wait()
    small = _phase_small_train()
    total = time.perf_counter() - t_phase
    log(f"coded runtime and training phase: {total:.1f} s ({CARD})")
    return {"distributed": dist_out, "train": train_out, "small": small,
            "launches": dist_out["launches"], "total_s": total}


# ------------------------------------------------------------ phase 16: mesh

# (a) qwen2-moe-a2.7b at full width and depth on a one-rank NCCL mesh,
# phase 9b's served 4 x 8192 prefill; (b) four ranks on the card, a 2 x 2
# gloo mesh: these models (depth, None for the config's), a 2 x 2048 prefill
# and 8 decode steps of fixed tokens, served without FSDP; (c) the smoke
# configs in float32 on the same mesh against one CPU process.  Planned
# with the dry run (PERF.md): with FSDP the weights' gathers through host
# memory took 66 of qwen2-moe's 80 s at 6 layers on the card; without it
# hymba moves 1.23 GB per rank and prefill (2.05 with FSDP).  qwen2-moe's
# depth in (b) is cut to MESH_MOE_LAYERS: at its full 24 layers each rank
# would hold 17.4 GiB (dry run) beside the whole model it draws, four
# times over on one 80 GB card; at 6, 7.0 GiB.
MESH_SEED = 16
MESH_A_ARCH, MESH_A_BATCH, MESH_A_PROMPT = "qwen2-moe-a2.7b", 4, 8192
MESH_MOE_LAYERS = 6
MESH_B = (("hymba-1.5b", None), ("qwen2-moe-a2.7b", MESH_MOE_LAYERS))
MESH_B_BATCH, MESH_B_PROMPT, MESH_B_STEPS = 2, 2048, 8
MESH_B_TOL = 5e-2             # relative Frobenius, as phases 8 and 9b
MESH_C = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "hymba-1.5b", "repro-100m")
MESH_C_PROMPT, MESH_C_STEPS = 512, 2   # 512 queries: the query-chunk branch
MESH_MOE_TOL = 1e-4           # tests/test_runtime.py's sharded MoE limit
# that test's MoE block config (ArchConfig's positional and keyword fields)
MESH_MOE_BLOCK = (("m", "moe", 1, 32, 2, 2, 0, 97),
                  {"n_experts": 4, "experts_per_token": 2, "d_ff_expert": 16,
                   "n_shared_experts": 1, "capacity_factor": 8.0})
MESH_TRAIN_TOL = 1e-4         # train steps, relative (loss and grad norm)
MESH_TIMEOUT = 600.0
MESH_KIMI_SHAPES = ("train_4k", "prefill_32k", "decode_32k")

MESH_RANK = r'''
import datetime, faulthandler, json, sys, time
from pathlib import Path
faulthandler.enable()
import numpy as np
import torch
import torch.distributed as dist
rank, io, root = int(sys.argv[1]), Path(sys.argv[2]), sys.argv[3]
sys.path[:0] = [root, root + "/src"]
import chip_smoke as cs
from repro_torch.configs import get_arch
from repro_torch.kernels import coded_matmul, flash_attention, ssm_scan
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import init_params
from repro_torch.models.hints import full, set_mesh
from repro_torch.models.moe import moe_block
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.coded import distributed_coded_matmul
from repro_torch.runtime.steps import (make_decode_step, make_prefill_step,
                                       make_train_step)
from repro_torch.compat import P, distribute_tensor, placements
spec = json.loads((io / "spec.json").read_text())
torch.cuda.set_device(0)
cs._stage_collectives_through_host("CUDA")
dist.init_process_group(
    "gloo", store=dist.FileStore(str(io / "store"), 4), rank=rank,
    world_size=4, timeout=datetime.timedelta(seconds=300))
mesh = make_local_mesh(2, 2, device_type="cuda")
out = {"rank": rank, "b": {}, "c": {}, "times": {}}


def zero():
    torch.cuda.synchronize()
    flash_attention.launches = ssm_scan.launches = coded_matmul.launches = 0


def counts():
    torch.cuda.synchronize()
    return {"flash_attention": flash_attention.launches,
            "ssm_scan": ssm_scan.launches,
            "coded_matmul": coded_matmul.launches}


# (b) full width on the card mesh
for arch, layers in spec["b"]:
    t0 = time.perf_counter()
    cfg = cs.mesh_b_config(arch, layers)

    def build():
        gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
        return shd.distribute_lm(init_params(cfg, device="cuda",
                                             generator=gen), mesh)

    model = build()
    torch.cuda.empty_cache()
    dist.barrier()
    init_s = time.perf_counter() - t0
    cs._stage_collectives_through_host.seconds = 0.0
    toks = np.load(io / f"b_{arch}_tokens.npy")
    steps = np.load(io / f"b_{arch}_steps.npy")
    ref = torch.load(io / f"b_{arch}_ref.pt")
    set_mesh(mesh)
    zero()
    with cs._Routing() as rt:
        logits, state = make_prefill_step(cfg, toks.shape[1] + len(steps))(
            model, {"tokens": toks})
        errs = [cs.rel_fro(full(logits).cpu(), ref["logits"][0])]
        step = make_decode_step(cfg)
        for t, tok in enumerate(steps):
            logits, state = step(model, tok, state)
            errs.append(cs.rel_fro(full(logits).cpu(), ref["logits"][t + 1]))
        torch.cuda.synchronize()
    row = {"rel_err": errs, "launches": counts(), "init_s": init_s,
           "s": time.perf_counter() - t0,
           "collective_s": cs._stage_collectives_through_host.seconds}
    if cfg.has_moe:
        # each layer on the unsharded prefill's input to it
        from repro_torch.models.blocks import block_forward
        from repro_torch.models.lm import layer_windows
        lay = torch.load(io / f"b_{arch}_layers.pt")
        pos = torch.arange(toks.shape[1], device="cuda")[None].expand(
            toks.shape[0], toks.shape[1])
        set_mesh(mesh)
        own = []
        with torch.no_grad():
            for p_l, win, x, y in zip(model.layers, layer_windows(cfg),
                                      lay["ins"], lay["outs"]):
                xd = distribute_tensor(x.cuda(), mesh,
                                       placements(P("data"), mesh),
                                       src_data_rank=None)
                got = block_forward(p_l, xd, cfg, pos, win)[0]
                own.append(cs.rel_fro(full(got).cpu(), y))
        set_mesh(None)
        row["own_layer_rel_err"] = own
        # this rank's data shard of the prefill's tokens, layer by layer
        B = toks.shape[0]
        d = mesh.get_local_rank("data")
        T = B * toks.shape[1]
        lo, hi = d * T // 2, (d + 1) * T // 2
        agree = []
        for got, want in zip(rt.ids[:cfg.n_layers], ref["ids"]):
            w = want[lo:hi].to(got.device)
            agree.append(float((got.sort(-1).values == w.sort(-1).values)
                               .all(-1).float().mean()))
        row["topk_agreement_by_layer"] = agree
    set_mesh(None)
    out["b"][arch] = row
    del model, state, logits
    torch.cuda.empty_cache()

# (b) the coded job on the model axis
if not spec.get("coded", True):
    (io / f"out{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    sys.exit(0)
t0 = time.perf_counter()
EA = torch.from_numpy(np.load(io / "coded_EA.npy")).cuda()
EB = torch.from_numpy(np.load(io / "coded_EB.npy")).cuda()
w = torch.from_numpy(np.load(io / "coded_w.npy")).cuda()
zero()
est = distributed_coded_matmul(EA, EB, w, mesh, axis="model")
out["coded"] = {"launches": counts(), "s": time.perf_counter() - t0}
ref = torch.from_numpy(np.load(io / "coded_ref.npy")).cuda()
out["coded"]["rel_err"] = float(torch.linalg.vector_norm(est.double() - ref)
                                / torch.linalg.vector_norm(ref))
del EA, EB, est, ref
torch.cuda.empty_cache()

# (c) the smoke configs, float32, against one CPU process
t0 = time.perf_counter()
refs = torch.load(io / "c_refs.pt")
for arch in spec["c"]:
    cfg = get_arch(arch, smoke=True).replace(dtype="float32")
    if cfg.has_moe:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    r = refs[arch]

    def card_model():
        m = init_params(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
        return shd.distribute_lm(m.to("cuda"), mesh)

    set_mesh(mesh)
    model = card_model()
    logits, state = make_prefill_step(cfg, r["tokens"].shape[1] + len(
        r["steps"]))(model, {"tokens": r["tokens"]})
    pre = cs.check_close(full(logits).cpu(), r["logits"][0], 2e-4, 2e-4,
                         f"{arch} smoke prefill, 2x2 card mesh vs CPU")
    dec = 0.0
    step = make_decode_step(cfg)
    for t, tok in enumerate(r["steps"]):
        logits, state = step(model, tok, state)
        dec = max(dec, cs.check_close(
            full(logits).cpu(), r["logits"][t + 1], 2e-3, 2e-3,
            f"{arch} smoke decode {t}, 2x2 card mesh vs CPU"))
    trained = card_model()
    opt = shd.distribute_adamw(
        adamw_init(dict(trained.named_parameters())), mesh,
        shd.param_shardings(cfg, mesh, trained))
    train = make_train_step(cfg)
    rows = []
    for i in range(2):
        trained, opt, m = train(trained, opt, {"tokens": r["train_tokens"]},
                                i)
        rows.append([float(full(m["loss"])), float(full(m["grad_norm"]))])
    set_mesh(None)
    out["c"][arch] = {"prefill_max_abs_err": pre,
                      "decode_max_abs_err": dec, "train": rows}
    del model, trained, opt, state
# the reference test's MoE block (tests/test_runtime.py) against moe_ref
mo = torch.load(io / "c_moe.pt")
from repro_torch.configs import ArchConfig
cfg = ArchConfig(*cs.MESH_MOE_BLOCK[0], **cs.MESH_MOE_BLOCK[1])
p = {}
for name, t in mo["weights"].items():
    dt = distribute_tensor(t.cuda(), mesh, placements(shd.leaf_spec(
        "layers.0.moe." + name, t.shape, cfg, mesh), mesh),
        src_data_rank=None)
    if name.startswith("shared."):
        p.setdefault("shared", {})[name[7:]] = dt
    else:
        p[name] = dt
x = distribute_tensor(mo["x"].cuda(), mesh, placements(P("data"), mesh),
                      src_data_rank=None)
set_mesh(mesh)
got, _ = moe_block(p, x, cfg)
set_mesh(None)
out["c"]["moe_block_max_abs_err"] = float(
    (full(got).cpu() - mo["want"]).abs().max())
out["times"]["c"] = time.perf_counter() - t0
(io / f"out{rank}.json").write_text(json.dumps(out))
dist.barrier()
dist.destroy_process_group()
'''

MESH_PLAN = r'''
import json, sys
from pathlib import Path
root, io = sys.argv[1], Path(sys.argv[2])
sys.path.insert(0, root + "/src")
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.launch.dryrun import run_cell
out = {"served": run_cell(
    sys.argv[3], "served_prefill", "1x1",
    shape=ShapeSpec("served_prefill", int(sys.argv[5]), int(sys.argv[4]),
                    "prefill"))}
for shape in sys.argv[6].split(","):
    out["kimi_" + shape] = run_cell("kimi-k2-1t-a32b", shape, "single")
(io / "plans.json").write_text(json.dumps(out))
'''


def _stage_collectives_through_host(key: str = "CUDA") -> None:
    """Phase 16's four ranks run over gloo, whose own collectives take CUDA
    tensors but whose functional collectives — what DTensor issues — crash
    on them in their wait (a segmentation fault, found on the card).  This
    registers ``key`` implementations of the functional collectives that
    copy the operand to the host, run gloo's own collective on it, and copy
    the result back: synchronous, so their wait has nothing to do."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}

    def host(t):
        return t.detach().to("cpu").contiguous()

    def timed(fn):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                _stage_collectives_through_host.seconds += \
                    time.perf_counter() - t0
        return run

    def gather(input, group_size, group_name):
        h = host(input)
        out = h.new_empty((group_size * h.shape[0],) + tuple(h.shape[1:]))
        dist.all_gather_into_tensor(out, h,
                                    group=_resolve_process_group(group_name))
        return out.to(input.device)

    def reduce(input, reduce_op, group_name):
        h = host(input).clone()
        dist.all_reduce(h, op=ops[reduce_op.lower()],
                        group=_resolve_process_group(group_name))
        return h.to(input.device)

    def reduce_(input, reduce_op, group_name):
        return input.copy_(reduce(input, reduce_op, group_name))

    def scatter(input, reduce_op, group_size, group_name):
        h = host(input)
        out = h.new_empty((h.shape[0] // group_size,) + tuple(h.shape[1:]))
        dist.reduce_scatter_tensor(out, h, op=ops[reduce_op.lower()],
                                   group=_resolve_process_group(group_name))
        return out.to(input.device)

    def to_all(input, output_split_sizes, input_split_sizes, group_name):
        h = host(input)
        rows = sum(output_split_sizes) if output_split_sizes else h.shape[0]
        out = h.new_empty((rows,) + tuple(h.shape[1:]))
        dist.all_to_all_single(out, h, list(output_split_sizes) or None,
                               list(input_split_sizes) or None,
                               group=_resolve_process_group(group_name))
        return out.to(input.device)

    def wait(tensor):
        return tensor

    def shard_dim_alltoall(input, gather_dim, shard_dim, group_name):
        pg = _resolve_process_group(group_name)
        n = dist.get_world_size(pg)
        full = gather(input.movedim(gather_dim, 0).contiguous(), n,
                      group_name).movedim(0, gather_dim)
        return full.chunk(n, dim=shard_dim)[dist.get_rank(pg)].contiguous()

    impls = {("_c10d_functional", "all_gather_into_tensor"): gather,
             ("_c10d_functional", "all_reduce"): reduce,
             ("_c10d_functional", "all_reduce_"): reduce_,
             ("_c10d_functional", "reduce_scatter_tensor"): scatter,
             ("_c10d_functional", "all_to_all_single"): to_all,
             ("_c10d_functional", "wait_tensor"): wait,
             ("_c10d_functional_autograd", "all_gather_into_tensor"): gather,
             ("_c10d_functional_autograd", "reduce_scatter_tensor"): scatter,
             ("_c10d_functional_autograd", "all_to_all_single"): to_all,
             ("_dtensor", "shard_dim_alltoall"): shard_dim_alltoall}
    libs = {}
    for (ns, name), fn in impls.items():
        if ns not in libs:
            libs[ns] = torch.library.Library(ns, "IMPL")
        libs[ns].impl(name, timed(fn), key)
    _stage_collectives_through_host.libs = libs   # keep them registered
    _stage_collectives_through_host.seconds = 0.0

def mesh_b_config(arch: str, layers):
    """(b)'s config of ``arch``: ``layers`` deep (its own depth for None),
    served without FSDP (``fsdp=False``: the reference's rules then split
    the weights over the model axis only), and an MoE drop-free (capacity
    factor E), since a rank's capacity comes from its own tokens, as in the
    reference, and with drops the sharded and unsharded runs would drop
    different assignments."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).replace(fsdp=False)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    if cfg.has_moe:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    return cfg


def _start_mesh_plans(io: Path) -> subprocess.Popen:
    """The dry run of (d), on the CPU in a process of its own (a fake
    process group of 1 and of 256 ranks; no card): qwen2-moe's served
    prefill on a 1 x 1 mesh and kimi-k2-1t-a32b's cells on 16 x 16."""
    env = dict(_child_env(), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c", MESH_PLAN, str(ROOT), str(io), MESH_A_ARCH,
         str(MESH_A_BATCH), str(MESH_A_PROMPT), ",".join(MESH_KIMI_SHAPES)],
        env=env, stdout=open(io / "plans.log", "w"),
        stderr=subprocess.STDOUT)


def _finish_mesh_plans(proc: subprocess.Popen, io: Path) -> dict:
    try:
        rc = proc.wait(timeout=MESH_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        fail(f"phase 16 dry run exited {rc}: "
             + (io / "plans.log").read_text()[-3000:])
    return json.loads((io / "plans.json").read_text())


def _mesh_one_rank(dev) -> dict:
    """(a) the served prefill unsharded, then the same weights placed on a
    one-rank NCCL mesh (in place) through the mesh branches: logits
    bit-identical, the peak memory of the mesh run."""
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.hints import full, set_mesh
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.steps import make_prefill_step
    cfg, model, n, nbytes, _ = _lm_model(MESH_A_ARCH, dev, MESH_SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(MESH_SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (MESH_A_BATCH, MESH_A_PROMPT),
                           device=dev, generator=gen)
    step = make_prefill_step(cfg, MESH_A_PROMPT)
    want, state = step(model, {"tokens": prompt})
    del state
    torch.cuda.synchronize()
    _init_dist_world1(ROOT / "build" / "mesh_store")
    try:
        mesh = make_local_mesh(1, 1, device_type="cuda")
        shd.distribute_lm(model, mesh)      # one rank: the same storage
        set_mesh(mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        got, state = step(model, {"tokens": prompt})
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        kv = sum(t.to_local().numel() * t.to_local().element_size()
                 for t in state[:4] if isinstance(t, torch.Tensor))
        same = bool(torch.equal(full(got), want))
        set_mesh(None)
    finally:
        set_mesh(None)
        dist.destroy_process_group()
    del model, state, got, want, prompt
    torch.cuda.empty_cache()
    if launches != cfg.n_layers:
        fail(f"mesh prefill launched flash {launches} times, not once per "
             f"layer ({cfg.n_layers})")
    if not same:
        fail(f"{MESH_A_ARCH} on a one-rank NCCL mesh: prefill logits differ "
             "from the unsharded prefill of the same weights")
    log(f"(a) {MESH_A_ARCH} {MESH_A_BATCH} x {MESH_A_PROMPT} prefill on a "
        f"one-rank NCCL mesh (mesh branches, MoE at model size 1): logits "
        f"bit-identical to the unsharded prefill; {launches} flash launches;"
        f" {run_s:.3f} s; peak {peak / 2**30:.2f} GiB (weights "
        f"{nbytes / 2**30:.2f} GiB, KV cache {kv / 2**30:.2f} GiB) ({CARD})")
    return {"bit_identical": same, "launches": {"flash_attention": launches,
                                                "ssm_scan": 0},
            "prefill_s": run_s, "peak_bytes": peak, "weight_bytes": nbytes,
            "kv_bytes": kv}


def _layer_io(cfg, model, toks) -> dict:
    """The unsharded prefill's input to and output of each layer (on the
    host): a layer run on the mesh on the same input is held to the same
    output, without the routing cascade of the layers before it."""
    from repro_torch.models.blocks import block_forward
    from repro_torch.models.lm import embed_tokens, layer_windows
    tok = torch.as_tensor(toks, device="cuda")
    B, L = tok.shape[:2]
    positions = torch.arange(L, device="cuda")[None].expand(B, L)
    ins, outs = [], []
    with torch.no_grad():
        x = embed_tokens(model, tok, cfg)
        for p_l, win in zip(model.layers, layer_windows(cfg)):
            ins.append(x.cpu())
            x = block_forward(p_l, x, cfg, positions, win)[0]
            outs.append(x.cpu())
    return {"ins": ins, "outs": outs}


def _mesh_references(dev, io: Path, pair) -> dict:
    """What the four ranks are held to: (b) each model's unsharded card run
    of the same weights and tokens (logits, and each MoE layer's top-k
    expert ids), the coded job's operands and float64 ``Σ w_n P_n`` of the
    kernel's products; (c) the smoke configs' one-CPU-process runs and the
    reference test's MoE block against ``moe_ref``."""
    import numpy as np

    from repro_torch.configs import ArchConfig, get_arch
    from repro_torch.core import split_contraction
    from repro_torch.kernels import worker_products
    from repro_torch.launch.serve import CODES
    from repro_torch.models import init_params
    from repro_torch.models.moe import moe_ref
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.coded import (decode_weight_vector,
                                           encode_operands)
    from repro_torch.runtime.steps import (make_decode_step,
                                           make_prefill_step,
                                           make_train_step)
    t0 = time.perf_counter()
    rng = np.random.default_rng(MESH_SEED)
    for arch, layers in MESH_B:
        cfg = mesh_b_config(arch, layers)
        gen = torch.Generator(device=dev)
        gen.manual_seed(MESH_SEED)
        model = init_params(cfg, device=dev, generator=gen)
        toks = rng.integers(0, cfg.vocab_size, (MESH_B_BATCH, MESH_B_PROMPT))
        steps = rng.integers(0, cfg.vocab_size,
                             (MESH_B_STEPS, MESH_B_BATCH, 1))
        np.save(io / f"b_{arch}_tokens.npy", toks)
        np.save(io / f"b_{arch}_steps.npy", steps)
        with _Routing() as rt:
            logits, state = make_prefill_step(cfg, MESH_B_PROMPT +
                                              MESH_B_STEPS)(
                model, {"tokens": toks})
            outs = [logits.float().cpu()]
            step = make_decode_step(cfg)
            for tok in steps:
                logits, state = step(model, tok, state)
                outs.append(logits.float().cpu())
        torch.save({"logits": outs,
                    "ids": [i.cpu() for i in rt.ids[:cfg.n_layers]]},
                   io / f"b_{arch}_ref.pt")
        if cfg.has_moe:                    # each layer's own input, output
            torch.save(_layer_io(cfg, model, toks), io / f"b_{arch}_layers.pt")
        del model, state, logits
        torch.cuda.empty_cache()
    # the coded job: phase 4's first pair, L-SAC (ortho) K=8, N=24
    A, B = pair
    code = CODES["lsac_ortho"].build(8, 24)
    E_A, E_B = encode_operands(code, *split_contraction(A, B, code.K))
    w = decode_weight_vector(code, np.random.default_rng(
        DIST_ORDER_SEED).permutation(code.N), code.recovery_threshold)
    ea = torch.from_numpy(E_A).float()
    eb = torch.from_numpy(E_B).float()
    del E_A, E_B
    np.save(io / "coded_EA.npy", ea.numpy())
    np.save(io / "coded_EB.npy", eb.numpy())
    np.save(io / "coded_w.npy", w.astype(np.float32))
    P = worker_products(ea.cuda(), eb.cuda()).double()   # not counted
    ref = torch.einsum("w,wij->ij", torch.as_tensor(
        w.astype(np.float32), dtype=torch.float64, device="cuda"), P)
    np.save(io / "coded_ref.npy", ref.cpu().numpy())
    del ea, eb, P, ref
    torch.cuda.empty_cache()
    # (c) one CPU process
    refs = {}
    for arch in MESH_C:
        cfg = get_arch(arch, smoke=True).replace(dtype="float32")
        if cfg.has_moe:                      # drop-free (see the tests)
            cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
        g = torch.Generator().manual_seed(MESH_SEED + 2)
        toks = torch.randint(0, cfg.vocab_size, (4, MESH_C_PROMPT),
                             generator=g)
        steps = torch.randint(0, cfg.vocab_size, (MESH_C_STEPS, 4, 1),
                              generator=g)
        train = torch.randint(0, cfg.vocab_size, (4, 64), generator=g)
        if cfg.has_moe:     # equal halves: per-shard aux == one-process aux
            train[2:] = train[:2]

        def cpu_model():
            return init_params(cfg, device="cpu", dtype=torch.float32,
                               generator=torch.Generator().manual_seed(0))

        model = cpu_model()
        logits, state = make_prefill_step(
            cfg, MESH_C_PROMPT + MESH_C_STEPS, device="cpu")(
                model, {"tokens": toks})
        outs = [logits]
        step = make_decode_step(cfg, device="cpu")
        for tok in steps:
            logits, state = step(model, tok, state)
            outs.append(logits)
        trained = cpu_model()
        opt = adamw_init(dict(trained.named_parameters()))
        tr = make_train_step(cfg, device="cpu")
        rows = []
        for i in range(2):
            trained, opt, m = tr(trained, opt, {"tokens": train}, i)
            rows.append([float(m["loss"]), float(m["grad_norm"])])
        refs[arch] = {"tokens": toks, "steps": steps, "logits": outs,
                      "train_tokens": train, "train": rows}
    torch.save(refs, io / "c_refs.pt")
    cfg = ArchConfig(*MESH_MOE_BLOCK[0], **MESH_MOE_BLOCK[1])
    small = init_params(cfg, device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(MESH_SEED))
    p = small.layers[0].moe
    x = torch.randn(32, 32, generator=torch.Generator().manual_seed(1))
    weights = {k: v.detach().clone() for k, v in p.items()
               if k != "shared"}
    weights.update({"shared." + k: v.detach().clone()
                    for k, v in p["shared"].items()})
    torch.save({"weights": weights, "x": x, "want": moe_ref(p, x, cfg)},
               io / "c_moe.pt")
    s = time.perf_counter() - t0
    log(f"phase 16 references (unsharded card runs, coded job, one CPU "
        f"process): {s:.1f} s")
    return {"s": s, "code_sum_abs_w": float(np.abs(w).sum())}


def _run_mesh_ranks(io: Path) -> list:
    """(b) and (c): four processes on the one card, a 2 x 2 gloo mesh."""
    (io / "spec.json").write_text(json.dumps(
        {"seed": MESH_SEED, "b": MESH_B, "c": MESH_C}))
    env = dict(_child_env(), OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(4):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", MESH_RANK, str(r), str(io),
                 str(ROOT)], env=env, stdout=open(io / f"rank{r}.log", "w"),
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + MESH_TIMEOUT
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0] * 4:
        fail(f"phase 16 ranks exited {rcs}: " + "".join(
            (io / f"rank{r}.log").read_text()[-2500:] for r in range(4)))
    log(f"(b, c) four ranks on the card (2 x 2 gloo mesh): "
        f"{time.perf_counter() - t0:.1f} s")
    return [json.loads((io / f"out{r}.json").read_text()) for r in range(4)]


def _check_mesh_ranks(ranks: list, io: Path):
    """(b) every rank's logits, launches and the coded job; (c) the smoke
    configs against one CPU process."""
    import numpy as np

    from repro_torch.configs import get_arch
    # (b) every rank's logits, launches and the coded job
    four = {}
    for arch, layers in MESH_B:
        rows = [r["b"][arch] for r in ranks]
        # the logits, prefill and decode; for an MoE model each layer's own
        # error instead (as phase 9c holds every layer), since flipped
        # routes move its logits by whole experts' outputs and the logits'
        # error then varies from run to run (PERF.md), and its logits and
        # routing agreement are reported
        cfg = mesh_b_config(arch, layers)
        if cfg.has_moe:
            own = max(max(r["own_layer_rel_err"]) for r in rows)
            if not own <= _own_layer_tol(cfg):
                fail(f"{arch} on the 2 x 2 card mesh: a layer on the "
                     f"unsharded run's input to it {own:.3e} from its output"
                     f" (limit {_own_layer_tol(cfg)}); by layer "
                     f"{rows[0]['own_layer_rel_err']}")
        held = [] if cfg.has_moe else [e for r in rows for e in r["rel_err"]]
        worst = max(held, default=0.0)
        if not worst <= MESH_B_TOL:
            fail(f"{arch} on the 2 x 2 card mesh: logits {worst:.3e} from "
                 f"the unsharded card run (limit {MESH_B_TOL}); by rank "
                 f"and step {[r['rel_err'] for r in rows]}; top-k "
                 f"agreement by layer "
                 f"{[r.get('topk_agreement_by_layer') for r in rows]}")
        for r, row in enumerate(rows):
            if row["launches"]["flash_attention"] <= 0:
                fail(f"{arch} rank {r}: no flash launch on the mesh")
            if get_arch(arch).has_ssm and row["launches"]["ssm_scan"] <= 0:
                fail(f"{arch} rank {r}: no scan launch on the mesh")
        agree = None
        if "topk_agreement_by_layer" in rows[0]:
            agree = float(np.mean([a for r in rows
                                   for a in r["topk_agreement_by_layer"]]))
        four[arch] = {"layers": layers, "held_max_rel_err": worst,
                      "own_layer_rel_err": rows[0].get("own_layer_rel_err"),
                      "rel_err_by_step": rows[0]["rel_err"],
                      "prefill_rel_err": max(r["rel_err"][0] for r in rows),
                      "launches_by_rank": [r["launches"] for r in rows],
                      "topk_agreement": agree,
                      "init_s": max(r["init_s"] for r in rows),
                      "s": max(r["s"] for r in rows)}
        log(f"(b) {arch}{'' if layers is None else f' ({layers} of its layers)'}"
            f" on the 2 x 2 gloo card mesh, {MESH_B_BATCH} x {MESH_B_PROMPT}"
            f" prefill (query-chunk flash) + {MESH_B_STEPS} decode steps: "
            + (f"each layer on the unsharded run's input to it at most "
               f"{max(four[arch]['own_layer_rel_err']):.3e} from its output "
               f"(limit {_own_layer_tol(cfg)}); logits (reported) "
               if cfg.has_moe else
               f"logits at most {worst:.3e} from the unsharded card run "
               f"(limit {MESH_B_TOL}); ")
            + "by step " + " ".join(f"{e:.2e}" for e in rows[0]["rel_err"])
            + (f"; top-k expert sets agree {100 * agree:.2f} %"
               if agree is not None else "")
            + "; launches by rank " + ", ".join(
                f"flash {x['flash_attention']} scan {x['ssm_scan']}"
                for x in four[arch]["launches_by_rank"])
            + f"; {four[arch]['s']:.1f} s, {four[arch]['init_s']:.1f} s of "
              f"it the draws, "
              f"{max(r['collective_s'] for r in rows):.1f} s in the host-"
              "staged collectives")
    coded = [r["coded"] for r in ranks]
    cerr = max(c["rel_err"] for c in coded)
    if not cerr <= DIST_DECODE_TOL:
        fail(f"distributed_coded_matmul on the mesh's model axis: "
             f"{cerr:.3e} from float64 sum w_n P_n (limit {DIST_DECODE_TOL})")
    if any(c["launches"]["coded_matmul"] <= 0 for c in coded):
        fail("distributed_coded_matmul on the mesh: a rank launched no "
             "coded_matmul")
    log(f"(b) distributed_coded_matmul on the 2 x 2 mesh's model axis "
        f"(lsac_ortho K=8 N=24, 12 workers per model rank): {cerr:.2e} from"
        f" float64 sum w_n P_n (limit {DIST_DECODE_TOL}); coded_matmul "
        f"launches by rank {[c['launches']['coded_matmul'] for c in coded]};"
        f" {max(c['s'] for c in coded):.1f} s")

    # (c) the smoke configs against one CPU process
    cpu = torch.load(io / "c_refs.pt")
    small = {}
    for arch in MESH_C:
        rows = [r["c"][arch] for r in ranks]
        tr_err = 0.0
        for row in rows:
            for (l1, g1), (l0, g0) in zip(row["train"], cpu[arch]["train"]):
                tr_err = max(tr_err, abs(l1 - l0) / abs(l0),
                             abs(g1 - g0) / abs(g0))
        if not tr_err <= MESH_TRAIN_TOL:
            fail(f"{arch} smoke: two train steps on the 2 x 2 card mesh "
                 f"{tr_err:.3e} from one CPU process (limit "
                 f"{MESH_TRAIN_TOL})")
        small[arch] = {"prefill_max_abs_err": max(
            r["prefill_max_abs_err"] for r in rows), "decode_max_abs_err":
            max(r["decode_max_abs_err"] for r in rows),
            "train_max_rel_err": tr_err}
    moe_err = max(r["c"]["moe_block_max_abs_err"] for r in ranks)
    if not moe_err <= MESH_MOE_TOL:
        fail(f"sharded MoE block on the 2 x 2 card mesh: {moe_err:.3e} from "
             f"moe_ref (limit {MESH_MOE_TOL})")
    log("(c) smoke configs, float32, 2 x 2 card mesh vs one CPU process "
        "(prefill 2e-4, decode 2e-3, two train steps 1e-4 relative): "
        + "; ".join(f"{a} {v['prefill_max_abs_err']:.1e} / "
                    f"{v['decode_max_abs_err']:.1e} / "
                    f"{v['train_max_rel_err']:.1e}"
                    for a, v in small.items())
        + f"; the reference test's MoE block {moe_err:.2e} from moe_ref "
          f"(limit {MESH_MOE_TOL}); "
          f"{max(r['times']['c'] for r in ranks):.1f} s")

    return four, coded, cerr, small, moe_err


def phase_mesh(dev, pair) -> dict:
    """Phase 16: the device mesh (module note)."""
    import shutil
    t_phase = time.perf_counter()
    io = ROOT / "build" / "mesh16"
    shutil.rmtree(io, ignore_errors=True)
    io.mkdir(parents=True)
    planner = _start_mesh_plans(io)
    try:
        one = _mesh_one_rank(dev)
        refs = _mesh_references(dev, io, pair)
        ranks = _run_mesh_ranks(io)
        four, coded, cerr, small, moe_err = _check_mesh_ranks(ranks, io)
    except BaseException:
        planner.kill()
        planner.wait()
        raise
    plans = _finish_mesh_plans(planner, io)

    # (d) the dry run against the card
    served = plans["served"]["memory"]
    held = one["weight_bytes"] + one["kv_bytes"]
    if served["peak_bytes_per_device"] < held:
        fail(f"dry run predicts {served['peak_bytes_per_device'] / 2**30:.2f}"
             f" GiB for {MESH_A_ARCH}'s served prefill, below the "
             f"{held / 2**30:.2f} GiB of weights and KV cache allocated")
    log(f"(d) {MESH_A_ARCH} {MESH_A_BATCH} x {MESH_A_PROMPT} prefill, 1 x 1 "
        f"mesh: dry run {served['peak_bytes_per_device'] / 2**30:.2f} GiB "
        f"per device (model prediction) against "
        f"torch.cuda.max_memory_allocated {one['peak_bytes'] / 2**30:.2f} "
        f"GiB (measured; weights + KV cache {held / 2**30:.2f} GiB) ({CARD})")
    kimi = {}
    for shape in MESH_KIMI_SHAPES:
        rec = plans["kimi_" + shape]
        if rec.get("status") != "ok":
            fail(f"kimi-k2 {shape} dry run: {rec.get('status')}")
        peak = rec["memory"]["peak_bytes_per_device"]
        rf = rec["roofline"]
        kimi[shape] = {"peak_gib": peak / 2**30,
                       "fits_80gb": peak <= 80e9,
                       "flops_per_device": rec["cost"]["flops_per_device"],
                       "wire_bytes_per_device":
                           rec["collectives"]["total_wire_bytes"],
                       "roofline": rf}
        log(f"(d) kimi-k2-1t-a32b {shape} on 16 x 16 H100s (dry run, "
            f"datasheet model): {peak / 2**30:.2f} GiB/device "
            f"({'fits' if peak <= 80e9 else 'does not fit'} 80 GB), "
            f"{rec['cost']['flops_per_device']:.3e} FLOP/device, "
            f"{rec['collectives']['total_wire_bytes'] / 1e9:.2f} GB wire/"
            f"device; compute {rf['compute_s']:.3g} s, memory "
            f"{rf['memory_s']:.3g} s, collective {rf['collective_s']:.3g} s "
            f"({rf['dominant']})")
    total = time.perf_counter() - t_phase
    log(f"mesh phase: {total:.1f} s ({CARD}); the four ranks' times measure "
        "nothing: they share one card, and gloo moves CUDA tensors through "
        "host memory")
    launches = {"one_rank": one["launches"],
                **{f"{a}_rank{r}": four[a]["launches_by_rank"][r]
                   for a, _ in MESH_B for r in range(4)},
                **{f"coded_rank{r}": c["launches"]
                   for r, c in enumerate(coded)}}
    return {"one_rank": one, "four_ranks": four, "coded_rel_err": cerr,
            "smoke": small, "moe_block_max_abs_err": moe_err,
            "served_plan": plans["served"], "kimi": kimi,
            "references": refs, "launches": launches, "total_s": total}



# ------------------------------------------- phase 17: training through kernels

# hymba-1.5b trains at its published widths and all 32 layers, bf16, seeded
# random weights, on train_4k's sequence with its global batch of 256 cut to
# 8 for one card: a warm-up step, TK_STEPS timed steps, a profiled one.
TK_ARCH, TK_BATCH, TK_SEQ, TK_STEPS = "hymba-1.5b", 8, 4096, 4
# the 2-layer cut (one global, one windowed layer) the plain path can hold,
# and the length of each layer's own gradient check at full depth: past
# the 1024 window, so that it masks keys in the windowed layers (the plain
# scan's time loop, forward and autograd, runs once a layer: 79 s for the
# 32 layers at 1 x 2048 on the card)
TK_CUT_SEQ, TK_LAYER_SEQ = 4096, 1088
# relative Frobenius error of each gradient of a backward kernel against
# the plain backward on the same inputs, and against autograd of the plain
# forward: float32 kernels compute the same float32 formulas in another
# order; the bf16 ones round P and dS (flash) to bf16 for the second
# products and every gradient to bf16.  The norm it is relative to is at
# least BWD_RMS_FLOOR an element: a gradient that cancels to ~0 (dq of a
# query that sees one key) has no relative error to speak of; the sweeps'
# inputs are N(0, 1) and their gradients O(0.1) an element.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_RMS_FLOOR = 1e-2
# hymba in bf16, kernels vs plain: the loss (relative) and each parameter's
# gradient (relative Frobenius) on the 2-layer cut, and each layer's own
# input and parameter gradients at full depth: the repo's bf16 tolerance
# (phases 8 and 9b hold the served logits to it)
TK_GRAD_TOL = 5e-2
FLASH_BWD_MASKS = ((True, 0), (True, 8), (False, 24))


def _rel(got, want) -> float:
    """Relative Frobenius error; the absolute norm where ``want`` is 0."""
    g, w = got.detach().float(), want.detach().float()
    den = float(torch.linalg.vector_norm(w))
    return float(torch.linalg.vector_norm(g - w)) / (den if den else 1.0)


def _check_grads(got, want, tol: float, what: str) -> float:
    worst = 0.0
    for name, g, w in zip("0123456789", got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{what}: gradient {name} {tuple(g.shape)} vs "
                 f"{tuple(w.shape)}, or not finite")
        diff = (g.detach().float() - w.detach().float()).norm()
        e = float(diff / max(float(w.detach().float().norm()),
                             BWD_RMS_FLOOR * w.numel() ** 0.5))
        worst = max(worst, e)
        if not e <= tol:                  # a NaN fails too
            fail(f"{what}: gradient {name} relative Frobenius error "
                 f"{e:.3e} (limit {tol})")
    return worst


def _flash_bwd_sweep(dev, gen) -> dict:
    """(a) flash: under autograd the kernel's backward against the plain
    backward and autograd of the plain forward (float32), over the forward
    sweep's shapes, causal, window 8 and non-causal window 24."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref, flash_attention_bwd_ref, flash_attention_lse_ref)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for B, H, Hkv, Lq, Lkv, d in FLASH_SWEEP:
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            leaves = [torch.randn(B, n, L, d, device=dev, generator=gen)
                      .to(tdt).requires_grad_(True)
                      for n, L in ((H, Lq), (Hkv, Lkv), (Hkv, Lkv))]
            plain = [t.detach() for t in leaves]
            for causal, window in FLASH_BWD_MASKS:
                off = max(0, Lkv - Lq)
                kw = {"causal": causal, "window": window, "q_offset": off}
                what = f"flash bwd {dt} {(B, H, Hkv, Lq, Lkv, d)} {kw}"
                n0 = flash_attention_bwd.launches
                out = flash_attention(*leaves, **kw)
                do = torch.randn(out.shape, device=dev, generator=gen).to(tdt)
                got = torch.autograd.grad(out, leaves, do)
                if flash_attention_bwd.launches != n0 + 1:
                    fail(f"{what}: no backward launch")
                o, lse = flash_attention_lse_ref(*plain, **kw)
                want = flash_attention_bwd_ref(*plain, o, lse, do, **kw)
                worst[dt] = max(worst[dt], _check_grads(got, want,
                                                        BWD_TOL[dt], what))
                qpos = off + torch.arange(Lq, device=dev)[:, None]
                kpos = torch.arange(Lkv, device=dev)[None]
                seen = ((qpos >= kpos) | (not causal)) & (
                    (qpos - kpos < window) | (window == 0))
                if bool(seen.any(-1).all()):   # autograd of the plain
                    f32 = [t.float().requires_grad_(True) for t in plain]
                    ref = attention_ref(*f32, causal=causal,
                                        window=window or None, q_offset=off)
                    want = torch.autograd.grad(ref, f32, do.float())
                    _check_grads(got, [w.to(tdt) for w in want],
                                 BWD_TOL[dt], what + " vs autograd")
    log(f"flash_attention backward: {len(FLASH_SWEEP)} sweep shapes x "
        f"(float32, bfloat16) x (causal, window 8, non-causal window 24) "
        f"agree with the plain backward and autograd of the plain forward; "
        f"worst relative Frobenius error float32 {worst['float32']:.2e}, "
        f"bf16 {worst['bfloat16']:.2e} (limits {BWD_TOL})")
    return worst


def _scan_args(dev, gen, Bt, L, Dm, S, tdt, grad: bool):
    """x, dt, A, B, C, D as the scan's phases draw them; B and C column
    views of one projection; with ``grad`` the leaves require grad."""
    x = torch.randn(Bt, L, Dm, device=dev, generator=gen).to(tdt)
    dt = (0.01 + 0.19 * torch.rand(Bt, L, Dm, device=dev,
                                   generator=gen)).to(tdt)
    A = -(0.1 + 0.9 * torch.rand(Dm, S, device=dev, generator=gen))
    xp = torch.randn(Bt, L, 100 + 2 * S, device=dev, generator=gen).to(tdt)
    D = torch.randn(Dm, device=dev, generator=gen)
    for t in (x, dt, A, xp, D):
        t.requires_grad_(grad)
    return x, dt, A, xp[..., 100:100 + S], xp[..., 100 + S:], D


def _scan_bwd_sweep(dev, gen) -> dict:
    """(a) the scan: under autograd the kernel's backward against the plain
    backward and autograd of the plain forward (float32), over the forward
    sweep, then hymba's and falcon-mamba-7b's channels at 1 x 2048."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_bwd
    from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_ref,
                                                  ssm_scan_fwd_ref,
                                                  ssm_scan_ref)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(s, dt) for s in SCAN_SWEEP for dt in ("float32", "bfloat16")]
    cases += [((1, 2048, 3200, 16), "bfloat16"),
              ((1, 2048, FALCON_D_INNER, 16), "bfloat16")]
    for shape, dt in cases:
        tdt = getattr(torch, dt)
        args = _scan_args(dev, gen, *shape, tdt, grad=True)
        what = f"ssm_scan bwd {dt} {shape}"
        n0 = ssm_scan_bwd.launches
        y = ssm_scan(*args)
        dy = torch.randn(y.shape, device=dev, generator=gen).to(tdt)
        got = torch.autograd.grad(y, args, dy)
        if ssm_scan_bwd.launches != n0 + 1:
            fail(f"{what}: no backward launch")
        plain = [t.detach() for t in args]
        _, _, ckpt = ssm_scan_fwd_ref(*plain)
        want = ssm_scan_bwd_ref(*plain, dy, ckpt)
        worst[dt] = max(worst[dt], _check_grads(got, want, BWD_TOL[dt],
                                                what))
        f32 = [t.float().requires_grad_(True) for t in plain]
        want = torch.autograd.grad(ssm_scan_ref(*f32), f32, dy.float())
        _check_grads(got, [w.to(g.dtype) for g, w in zip(got, want)],
                     BWD_TOL[dt], what + " vs autograd")
        del args, y, got, want, f32
    torch.cuda.empty_cache()
    log(f"ssm_scan backward: the sweep (float32, bfloat16) and 1 x 2048 at "
        f"Dm 3200 and {FALCON_D_INNER} (bf16) agree with the plain backward "
        f"and autograd of the plain forward; worst relative Frobenius error "
        f"float32 {worst['float32']:.2e}, bf16 {worst['bfloat16']:.2e} "
        f"(limits {BWD_TOL})")
    return worst


def _flash_bwd_timed(dev, gen) -> dict:
    """The flash backward at hymba's training shapes (8 x 25/5 x 4096 x 64,
    bf16; window 1024 and full causal): kernel, plain (batch row by row,
    each row held to BWD_TOL), the SDPA backward, and the bound."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention_bwd,
                                                         flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref)
    B, H, Hkv, L, d = TK_BATCH, 25, 5, TK_SEQ, 64
    q, k, v = (torch.randn(B, n, L, d, device=dev, generator=gen)
               .to(torch.bfloat16) for n in (H, Hkv, Hkv))
    do = torch.randn(B, H, L, d, device=dev, generator=gen).to(torch.bfloat16)
    out = {}
    for window in (1024, 0):
        o, lse = flash_attention_fwd(q, k, v, window=window)
        got = flash_attention_bwd(q, k, v, o, lse, do, window=window)
        err = mae = 0.0
        for b in range(B):
            sl = [t[b:b + 1] for t in (q, k, v)]
            o_r, lse_r = flash_attention_lse_ref(*sl, window=window or None)
            want = flash_attention_bwd_ref(*sl, o_r, lse_r, do[b:b + 1],
                                           window=window)
            mine = [g[b:b + 1] for g in got]
            err = max(err, _check_grads(mine, want, BWD_TOL["bfloat16"],
                                        f"flash bwd hymba b={b} "
                                        f"window={window}"))
            mae = max([mae] + [float((g.float() - w.float()).abs().max())
                               for g, w in zip(mine, want)])
            del want, o_r, lse_r
        pairs = B * H * _flash_pairs(L, L, 0, window)
        flops = 10.0 * d * pairs
        # q, o, dO read and dq written (B H L d each), k, v read and dk, dv
        # written (B Hkv L d each), in bf16; the float32 LSE read
        nbytes = 2 * (4 * B * H * L * d + 4 * B * Hkv * L * d) + 4 * B * H * L
        b_ms, b_by = bound_ms(flops, nbytes, "bfloat16")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref_out = _sdpa(*leaves, window)()
        row = {"shape": [B, H, Hkv, L, d], "dtype": "bfloat16",
               "window": window, "unmasked_pairs": pairs, "flops": flops,
               "rel_fro": err, "max_abs_err": mae,
               "ms": time_ms(lambda: flash_attention_bwd(
                   q, k, v, o, lse, do, window=window), 5),
               "plain_ms": time_ms(lambda: [flash_attention_bwd_ref(
                   q[b:b + 1], k[b:b + 1], v[b:b + 1], o[b:b + 1],
                   lse[b:b + 1], do[b:b + 1], window=window)
                   for b in range(B)], 1),
               "library_ms": time_ms(lambda: torch.autograd.grad(
                   ref_out, leaves, do, retain_graph=True), 5),
               "bound_ms": b_ms, "bound_by": b_by}
        row["tflops"] = flops / row["ms"] / 1e9
        out[f"window{window}" if window else "causal"] = row
        log(f"flash backward hymba train {B}x{H}/{Hkv}x{L}x{d} bf16 "
            f"{'window ' + str(window) if window else 'full causal'}: kernel "
            f"{row['ms']:.3f} ms ({row['tflops']:.1f} TFLOP/s at 10 d a "
            f"pair), plain {row['plain_ms']:.1f} ms ({B} batch rows), SDPA "
            f"backward {row['library_ms']:.3f} ms, bound {b_ms:.3f} ms "
            f"({b_by}); vs plain: relative Frobenius {err:.2e} per batch row "
            f"(limit {BWD_TOL['bfloat16']}) ({CARD})")
        del o, lse, got, leaves, ref_out
    del q, k, v, do
    torch.cuda.empty_cache()
    return out


def _scan_bwd_bound(Bt, L, Dm, S, elem=2) -> dict:
    """The scan backward's bound: one exp per (t, channel, state) (a_t, the
    least the gradient needs) against its bytes (x, dt, dy, B, C and the
    checkpoints read; dx, ddt, dB, dC written; A, D, dA, dD)."""
    nbytes = elem * (5 * Bt * L * Dm + 4 * Bt * L * S) + 4 * (
        Bt * -(-L // 256) * Dm * S + 2 * Dm * S + 2 * Dm)
    exps = Bt * L * Dm * S
    sms, clock = sm_count_and_max_clock()
    t_exp = exps / (SFU_PER_SM_CLOCK * sms * clock) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    b_ms, b_by = (t_exp, "operations") if t_exp >= t_bytes else \
        (t_bytes, "bytes")
    return {"bytes": nbytes, "exps": exps, "exp_bound_ms": t_exp,
            "byte_bound_ms": t_bytes, "bound_ms": b_ms, "bound_by": b_by}


def _scan_bwd_timed(dev, gen) -> dict:
    """The scan backward at hymba's training shape (8 x 4096 x 3200 x 16,
    bf16, B and C strided): kernel, plain (held to BWD_TOL), bound."""
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_bwd, ssm_scan_fwd
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    Bt, L, Dm, S = TK_BATCH, TK_SEQ, 3200, 16
    args = _scan_args(dev, gen, Bt, L, Dm, S, torch.bfloat16, grad=False)
    _, _, ckpt = ssm_scan_fwd(*args)
    dy = torch.randn(Bt, L, Dm, device=dev, generator=gen).to(torch.bfloat16)
    got = ssm_scan_bwd(*args, dy, ckpt)
    t0 = time.perf_counter()
    want = ssm_scan_bwd_ref(*args, dy, ckpt)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _check_grads(got, want, BWD_TOL["bfloat16"], "ssm_scan bwd hymba")
    mae = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    del want
    bound = _scan_bwd_bound(Bt, L, Dm, S)
    row = {"shape": [Bt, L, Dm, S], "dtype": "bfloat16", "rel_fro": err,
           "max_abs_err": mae, **bound,
           "ms": time_ms(lambda: ssm_scan_bwd(*args, dy, ckpt), 5),
           "plain_ms": plain_ms, "library_ms": None}
    log(f"ssm_scan backward hymba train {Bt}x{L}x{Dm}x{S} bf16: kernel "
        f"{row['ms']:.3f} ms, plain {plain_ms:.1f} ms (host clock, one "
        f"call), library none, bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}; {bound['exps']:.3g} exps "
        f"{bound['exp_bound_ms']:.3f} ms, bytes {bound['byte_bound_ms']:.3f}"
        f" ms); vs plain: relative Frobenius {err:.2e} (limit "
        f"{BWD_TOL['bfloat16']}), max abs err {mae:.3e} ({CARD})")
    del args, ckpt, dy, got
    torch.cuda.empty_cache()
    return row


def _loss_and_grads(model, cfg, batch, use_kernels: bool = True):
    """``lm_loss`` and the gradient of every parameter, by name."""
    from repro_torch.models import lm_loss
    named = dict(model.named_parameters())
    try:
        for p in named.values():
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = lm_loss(model, batch, cfg, use_kernels=use_kernels)
            grads = torch.autograd.grad(loss, list(named.values()))
    finally:
        for p in named.values():
            p.requires_grad_(False)
    return loss.detach(), dict(zip(named, grads))


def _tokens(cfg, B: int, L: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, L), device=dev, generator=g)


def _cut_vs_plain(dev) -> dict:
    """(b) hymba at full width, 2 layers (one global, one windowed), 1 x
    TK_CUT_SEQ: the loss and every parameter's gradient with the kernels
    against the plain path."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    # no per-layer recompute: the same numbers, a third less of the plain
    # scan's loop
    cfg = get_arch(TK_ARCH).replace(n_layers=2, global_attn_layers=(0,),
                                    remat=False)
    model = init_params(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(17))
    batch = {"tokens": _tokens(cfg, 1, TK_CUT_SEQ, 18, dev)}
    lk, gk = _loss_and_grads(model, cfg, batch)
    lp, gp = _loss_and_grads(model, cfg, batch, use_kernels=False)
    loss_err = abs(float(lk) - float(lp)) / abs(float(lp))
    errs = {k: _rel(gk[k], gp[k]) for k in gk}
    worst = max(errs, key=errs.get)
    if not (loss_err <= TK_GRAD_TOL and all(e <= TK_GRAD_TOL
                                            for e in errs.values())):
        fail(f"{cfg.name} 2 layers x 1 x {TK_CUT_SEQ}, kernels vs plain: "
             f"loss {float(lk):.6f} vs {float(lp):.6f}, worst gradient "
             f"{worst} {errs[worst]:.3e} (limit {TK_GRAD_TOL})")
    log(f"{cfg.name} 2 layers (global, window {cfg.sliding_window}) x 1 x "
        f"{TK_CUT_SEQ} {cfg.dtype}, kernels vs plain: loss {float(lk):.6f} vs "
        f"{float(lp):.6f} (relative {loss_err:.2e}), worst of "
        f"{len(errs)} parameter gradients {worst} {errs[worst]:.2e} (limit "
        f"{TK_GRAD_TOL})")
    del model, gk, gp
    torch.cuda.empty_cache()
    return {"loss_kernels": float(lk), "loss_plain": float(lp),
            "loss_rel_err": loss_err, "grad_rel_fro": errs,
            "worst_param": worst}


def _layer_grad_errors(cfg, model, dev) -> list:
    """(b) each of the 32 layers on the plain forward's input to it (1 x
    TK_LAYER_SEQ), its input and parameter gradients for one seeded output
    gradient, with the kernels against the plain versions: one layer's
    own backward error at every depth."""
    from repro_torch.models.blocks import block_forward
    from repro_torch.models.lm import embed_tokens, layer_windows
    tokens = _tokens(cfg, 1, TK_LAYER_SEQ, 19, dev)
    L = tokens.shape[1]
    pos = torch.arange(L, device=dev)[None]
    wins = layer_windows(cfg)
    g = torch.Generator(device=dev).manual_seed(20)
    dy = torch.randn(1, L, cfg.d_model, device=dev, generator=g).to(
        model.embed.dtype)
    with torch.no_grad():
        xs = [embed_tokens(model, tokens, cfg)]
        for i in range(cfg.n_layers - 1):
            xs.append(block_forward(model.layers[i], xs[-1], cfg, pos,
                                    wins[i], use_kernels=False)[0])
    out = []
    for i in range(cfg.n_layers):
        layer = model.layers[i]
        params = list(layer.parameters())
        grads = []
        for use_kernels in (True, False):
            x = xs[i].clone().requires_grad_(True)
            try:
                for p in params:
                    p.requires_grad_(True)
                with torch.enable_grad():
                    y = block_forward(layer, x, cfg, pos, wins[i],
                                      use_kernels=use_kernels)[0]
                    grads.append(torch.autograd.grad(y, [x] + params, dy))
            finally:
                for p in params:
                    p.requires_grad_(False)
        out.append(max(_rel(a, b) for a, b in zip(*grads)))
        del grads
    if not all(e <= TK_GRAD_TOL for e in out):
        fail(f"{cfg.name} layers' own gradients, kernels vs plain: "
             f"{['%.2e' % e for e in out]} (limit {TK_GRAD_TOL})")
    log(f"{cfg.name} each layer's own gradients (input and parameters) on "
        f"the plain forward's input, 1 x {L}, kernels vs plain: worst "
        f"relative Frobenius by layer {['%.1e' % e for e in out]} (limit "
        f"{TK_GRAD_TOL}; windowed and global layers alike)")
    return out


def _train_full(dev) -> dict:
    """(c) a repeat of the first step's loss and gradients bit-identical;
    then the training run: a warm-up step, TK_STEPS timed steps with the
    launch counts and the peak memory, a profiled step; (d) finite losses
    that fall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.kernels.ssm_scan.ops import ssm_scan, ssm_scan_bwd
    from repro_torch.launch.train import build_state
    from repro_torch.runtime.steps import make_schedule, make_train_step
    cfg = get_arch(TK_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = build_state(cfg, 0, device=dev)
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    moments = sum(t.numel() * t.element_size()
                  for t in list(opt.m.values()) + list(opt.v.values()))
    t0 = time.perf_counter()
    layer_errs = _layer_grad_errors(cfg, params, dev)
    log(f"  (each layer's own gradients: {time.perf_counter() - t0:.1f} s)")
    data = SyntheticTokens(cfg.vocab_size, TK_SEQ, TK_BATCH, seed=0)

    def batch(step):
        return {"tokens": torch.as_tensor(data(step)["tokens"],
                                          dtype=torch.long, device=dev)}
    # (c) the first step's loss and gradients twice from the same state
    l1, g1 = _loss_and_grads(params, cfg, batch(0))
    l2, g2 = _loss_and_grads(params, cfg, batch(0))
    same = bool(torch.equal(l1, l2)) and all(torch.equal(g1[k], g2[k])
                                             for k in g1)
    if not same:
        diff = [k for k in g1 if not torch.equal(g1[k], g2[k])]
        fail(f"{cfg.name}: a repeat of the first step differs: loss "
             f"{float(l1)!r} vs {float(l2)!r}, {len(diff)} gradients "
             f"(first {diff[:3]})")
    log(f"{cfg.name} {TK_BATCH} x {TK_SEQ}: a repeat of the first step's "
        f"loss and {len(g1)} gradients from the same state is bit-identical")
    del g1, g2
    torch.cuda.empty_cache()
    # every step trains on the first batch: uniform random tokens leave
    # nothing to learn past ln(vocab), which the seeded model starts within
    # 0.05 of, while one batch can be fitted; a short warm-up of a
    # learning rate small enough that each AdamW step, which moves every
    # weight by about the rate, is a descent step
    step_fn = make_train_step(cfg, make_schedule(cfg, peak_lr=3e-5,
                                                 warmup=1,
                                                 total=10 * TK_STEPS),
                              device=dev)
    losses = []
    params, opt, m = step_fn(params, opt, batch(0), 0)        # warm-up
    losses.append(float(m["loss"]))
    kernels = (flash_attention, ssm_scan, flash_attention_bwd, ssm_scan_bwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    times = []
    b = batch(0)
    for step in range(1, TK_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b, step)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in kernels}
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "ssm_scan": 2 * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers,
                "ssm_scan_bwd": cfg.n_layers}
    if launches != {k: TK_STEPS * v for k, v in per_step.items()}:
        fail(f"{cfg.name} train steps: launches {launches} in {TK_STEPS} "
             f"steps, expected {per_step} a step (forward and the remat "
             f"recompute, then the backward)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b, TK_STEPS + 1)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof, wall_ms, f"breakdown ({cfg.name} train step "
                        f"{TK_BATCH} x {TK_SEQ}, profiled)")
    busy = rows.get("busy_ms")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"{cfg.name} training losses {losses}: not finite, or not "
             "falling")
    ms = sum(times) / len(times)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": TK_BATCH,
           "seq": TK_SEQ, "dtype": cfg.dtype,
           "reduced": {"global_batch": "256 -> 8 (one card)"},
           "weight_bytes": weights, "moment_bytes": moments,
           "losses": losses, "step_ms": ms, "step_ms_each": times,
           "tokens_per_s": TK_BATCH * TK_SEQ / (ms / 1e3),
           "peak_bytes": peak, "launches": launches,
           "launches_per_step": per_step, "busy_share":
               busy / wall_ms if busy is not None else None,
           "profiled_wall_ms": wall_ms, "breakdown": rows,
           "layer_grad_rel_fro": layer_errs}
    busy_txt = "not measured" if busy is None else \
        f"{100 * out['busy_share']:.1f} % of a profiled step"
    log(f"{cfg.name} training {cfg.n_layers} layers x {TK_BATCH} x {TK_SEQ} "
        f"{cfg.dtype} (train_4k's global batch 256 cut to {TK_BATCH}): "
        f"{ms:.1f} ms a step ({', '.join('%.1f' % t for t in times)}), "
        f"{out['tokens_per_s']:.0f} tokens/s, peak "
        f"{peak / 2**30:.2f} GiB (weights {weights / 2**30:.2f}, AdamW "
        f"moments {moments / 2**30:.2f}), device busy {busy_txt}")
    log(f"  launches a step: {per_step}; losses {['%.4f' % x for x in losses]}"
        f" ({CARD})")
    del params, opt
    torch.cuda.empty_cache()
    return out


def phase_train_kernels(dev, gen) -> dict:
    """Phase 17: training through the kernels (module note)."""
    t_phase = time.perf_counter()
    parts = (("flash_bwd_sweep", lambda: _flash_bwd_sweep(dev, gen)),
             ("scan_bwd_sweep", lambda: _scan_bwd_sweep(dev, gen)),
             ("flash_bwd", lambda: _flash_bwd_timed(dev, gen)),
             ("scan_bwd", lambda: _scan_bwd_timed(dev, gen)),
             ("cut", lambda: _cut_vs_plain(dev)),
             ("train", lambda: _train_full(dev)))
    out, seconds = {}, {}
    for name, run in parts:
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    out["total_s"] = time.perf_counter() - t_phase
    log(f"training-through-kernels phase: {out['total_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f") ({CARD})")
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
    global CARD
    t_start = time.perf_counter()
    card = CARD = card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    drawer, paper_ops = start_paper_operands()
    t0 = time.perf_counter()
    ptxas = phase_build()
    check_flash_instances(ptxas)
    drawer.join()
    log(f"build and operand drawing (8 pairs of 2048x32768, in a thread "
        f"meanwhile): {time.perf_counter() - t0:.1f} s")
    mm = phase_coded_matmul(dev, gen)
    enc = phase_poly_encode(dev, gen)
    small = phase_small_serve()
    lsac = phase_full_serve("lsac_ortho", 8, paper_ops)
    gsac = phase_full_serve("gsac_k1_5", 4)
    breakdown = phase_breakdown()
    flash = phase_flash(dev, gen)
    scan = phase_scan(dev, gen)
    small_lm = phase_small_lm()
    lm, model, prompt = phase_full_lm(dev)
    lm_breakdown = phase_lm_breakdown(model, prompt)
    del model, prompt
    torch.cuda.empty_cache()
    families = phase_families(dev, gen, ptxas)
    dense = phase_dense(dev, gen, ptxas)
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
    cluster = phase_cluster(lsac, paper_ops)
    coded_runtime = phase_coded_runtime(paper_ops)
    mesh = phase_mesh(dev, paper_ops[0])
    del paper_ops
    train_k = phase_train_kernels(dev, gen)

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
            "autotune": autotune["device"], "cluster": cluster,
            "distributed": coded_runtime}
    mm32, enc_main = mm["float32"], enc["batch_rows24"]
    mesh_runs = mesh["launches"]
    coded_runs = {**{k: r["launches"]["coded_matmul"]
                     for k, r in runs.items()},
                  **{f"mesh_{k}": v["coded_matmul"]
                     for k, v in mesh_runs.items() if "coded_matmul" in v}}
    kernels = [
        {"name": "coded_matmul", "status": "ported", "route": "cuda",
         "source": "src/repro_torch/csrc/coded_matmul.cu",
         "replaces": "src/repro/kernels/coded_matmul/kernel.py:50",
         "launches": sum(coded_runs.values()),
         "launches_by_run": coded_runs,
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
    tr = train_k["train"]["launches"]
    flash_runs = {"hymba_served": lm["launches"]["flash_attention"],
                  "hymba_train": tr["flash_attention"],
                  "qwen2_moe_served": families["qwen2_moe"]["launches"][
                      "flash_attention"],
                  "musicgen_served": families["musicgen"]["launches"][
                      "flash_attention"],
                  **{f"{a}_served": dense[a]["launches"]["flash_attention"]
                     for a in DENSE_ARCHS + (BIG_ARCH,)},
                  **{f"mesh_{k}": v["flash_attention"]
                     for k, v in mesh_runs.items()
                     if "flash_attention" in v}}
    scan_runs = {"hymba_served": lm["launches"]["ssm_scan"],
                 "hymba_train": tr["ssm_scan"],
                 **{f"{a}_served": dense[a]["launches"]["ssm_scan"]
                    for a in DENSE_ARCHS + (BIG_ARCH,)},
                 **{f"mesh_{k}": v["ssm_scan"]
                    for k, v in mesh_runs.items() if "ssm_scan" in v}}
    kernels += [
        {"name": "flash_attention", "status": "ported", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
         "launches": sum(flash_runs.values()),
         "launches_by_run": flash_runs,
         "shape": win["shape"], "window": win["window"],
         "max_abs_err": win["max_abs_err"], "ms": win["ms"],
         "plain_ms": win["plain_ms"], "bound_ms": win["bound_ms"],
         "bound_by": win["bound_by"], "library_ms": win["library_ms"]},
        {"name": "ssm_scan", "status": "ported", "route": "cuda",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan/kernel.py:55",
         "launches": sum(scan_runs.values()),
         "launches_by_run": scan_runs,
         "shape": scan["shape"], "max_abs_err": scan["max_abs_err"],
         "ms": scan["ms"], "plain_ms": scan["plain_ms"],
         "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"],
         "library_ms": None},
    ]
    # the backward kernels: no TPU kernel; the reference differentiates the
    # jnp paths with jax.grad (replaces: the function it differentiates)
    fb, sb = train_k["flash_bwd"]["window1024"], train_k["scan_bwd"]
    p14 = coded_runtime["train"]
    flash_bwd_runs = {"hymba_train": tr["flash_attention_bwd"],
                      **{f"repro100m_{k}": p14[k]["flash_launches"][
                          "flash_attention_bwd"]
                         for k in ("uncoded", "coded")}}
    kernels += [
        {"name": "flash_attention_bwd", "status": "added", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/models/attention.py:60",
         "launches": sum(flash_bwd_runs.values()),
         "launches_by_run": flash_bwd_runs,
         "shape": fb["shape"], "window": fb["window"],
         "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
         "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
         "bound_by": fb["bound_by"], "library_ms": fb["library_ms"]},
        {"name": "ssm_scan_bwd", "status": "added", "route": "cuda",
         "source": "src/repro_torch/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan/ref.py:22",
         "launches": tr["ssm_scan_bwd"],
         "launches_by_run": {"hymba_train": tr["ssm_scan_bwd"]},
         "shape": sb["shape"], "max_abs_err": sb["max_abs_err"],
         "ms": sb["ms"], "plain_ms": sb["plain_ms"],
         "bound_ms": sb["bound_ms"], "bound_by": sb["bound_by"],
         "library_ms": None},
    ]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "ptxas": ptxas, "coded_matmul": mm,
             "poly_encode": enc,
             "small_serve": small, "serve": runs, "breakdown": breakdown,
             "flash_attention": flash, "ssm_scan": scan,
             "small_lm": small_lm, "lm": lm, "lm_breakdown": lm_breakdown,
             "families": families, "dense": dense,
             "open_loop": open_loop, "autotune": autotune,
             "engine": engine, "cluster": cluster,
             "coded_runtime": coded_runtime, "mesh": mesh,
             "train_kernels": train_k, "kernels": kernels},
            indent=2))
    print(card)
    print(json.dumps({"kernels": kernels, "not_ported": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
