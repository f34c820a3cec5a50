"""Run one cell of the benchmark once.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the kernels' build on a checkout's first run, the inputs and
weights made on the device from the seed, the cell's own shapes warmed)
is timed as ``setup_s``; then the cell's driver repeats its unit of work
(a round of requests, a training step) for ``--seconds``
and the end-to-end metrics are taken over the whole window.  With
``--trace 1`` a profiled sub-window follows the window and the per-layer
metrics are read from it instead.  Once the peak memory is read and the
program's state freed, the plain reference judges what the window
produced; the last line of standard output is the result, the last lines
of standard error each compared number beside its limit.

Exits non-zero, printing no result, without a CUDA card, or with JAX or
the JAX package loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

# the program builds its kernels into build/repro_torch inside the checkout
ROOT = Path(__file__).resolve().parent.parent
# the folder itself off the path: its module names are the harness's own
sys.path = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "h100bench"]

import torch  # noqa: E402

from h100bench import core, roofline, traces  # noqa: E402


def run(name: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", root: Path = ROOT, hook=None) -> dict:
    """One run of cell ``name``; returns the result line's fields with the
    compared numbers under ``checks``.  ``hook(cell)``, if given, sees the
    driver before set-up."""
    c = core.cell(name, root)
    dev = torch.device(device)
    drv = core.driver(c["traffic"]["driver"]).Cell(c, seed, dev)
    if hook is not None:
        hook(drv)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    drv.setup()
    sync()
    setup_s = time.perf_counter() - t0
    plain = contextlib.nullcontext
    units, t0 = 0, time.perf_counter()
    while True:
        drv.unit(lambda _: plain())
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    attempted, failed = drv.counts()
    metrics = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu", "count": 1}
    breakdown = None
    if not traced:
        e2e = drv.end_to_end(window_s)
        e2e["setup_s"] = setup_s
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        tr = profiled(drv, int(c["traffic"]["profile_units"]), sync)
        ctx = SimpleNamespace(trace=tr, config=c["config"],
                              traffic=c["traffic"], roofline=roofline,
                              window={"units": units, "window_s": window_s,
                                      **drv.window_info(units)},
                              profiled=drv.window_info(tr.units))
        for m in c["per_layer"]:
            v = core.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = traces.breakdown(tr)
    device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    drv.release()
    numbers = drv.check()
    limits = c["limits"]
    checks = {k: {"value": v if math.isfinite(v) else str(v),
                  "limit": limits[k]} for k, v in numbers.items()}
    out = {"correct": all(v <= limits[k] for k, v in numbers.items())
           and failed == 0, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def profiled(drv, n: int, sync):
    """``n`` units under ``torch.profiler``, each in a harness span."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            drv.unit(lambda name: record_function(traces.SPAN_PREFIX + name))
        sync()
        wall = time.perf_counter() - t0
    return traces.from_profile(prof, wall, n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = core.cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = core.forbidden_modules()
    if found:
        print("h100bench: JAX or the JAX package is loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
