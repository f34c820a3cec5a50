"""Aggregate the port's dry-run cell JSONs into the reference's tables.

Counterpart of the reference's ``analysis/report.py``: the same tables
(dry run, roofline, worst roofline fractions) from the records that
:mod:`repro_torch.launch.dryrun` writes under ``results/dryrun_torch/``.
Every figure in them is a model prediction on the H100 datasheet table
(:mod:`repro_torch.analysis.roofline`), not a measurement.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.report [--mesh single]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def load_cells(mesh: str | None = None, coded: bool | None = False,
               results_dir: str | None = None):
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir or RESULTS_DIR,
                                              "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if mesh and rec.get("mesh") != mesh:
            continue
        if coded is not None and rec.get("coded", False) != coded:
            continue
        out.append(rec)
    return out


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def fmt_s(x):
    if x >= 0.1:
        return f"{x:.2f}"
    if x >= 1e-4:
        return f"{x * 1e3:.2f}m"
    return f"{x * 1e6:.1f}µ"


def dryrun_table(cells):
    rows = ["| arch | shape | mesh | status | GiB/dev | HLO GFLOP/dev | "
            "HBM GB/dev | wire GB/dev | coll ops |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in cells:
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"{r.get('status','?')} | — | — | — | — | — |")
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{fmt_bytes(r['memory']['peak_bytes_per_device'])} | "
            f"{r['cost']['flops_per_device'] / 1e9:.1f} | "
            f"{r['cost']['bytes_accessed_per_device'] / 1e9:.1f} | "
            f"{r['collectives']['total_wire_bytes'] / 1e9:.2f} | "
            f"{r['collectives']['ops']} |")
    return "\n".join(rows)


def roofline_table(cells):
    rows = ["| arch | shape | compute_s | memory_s | collective_s | "
            "dominant | useful/HLO | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    for r in cells:
        if r.get("status") != "ok":
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"{rf['dominant'].replace('_s','')} | "
            f"{rf['useful_over_hlo_flops']:.3f} | "
            f"{rf['roofline_fraction']:.4f} |")
    return "\n".join(rows)


def worst_cells(cells, n=5):
    ok = [r for r in cells if r.get("status") == "ok"
          and r["kind"] == "train"]
    ok.sort(key=lambda r: r["roofline"]["roofline_fraction"])
    return ok[:n]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--coded", action="store_true")
    ap.add_argument("--results-dir", default=RESULTS_DIR,
                    help="the dry run's records (default "
                         "results/dryrun_torch/)")
    args = ap.parse_args()
    cells = load_cells(args.mesh, coded=args.coded or False,
                       results_dir=args.results_dir)
    print("## Dry-run\n")
    print(dryrun_table(cells))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table([c for c in cells if c.get("mesh") == "single"]))
    print("\n### Worst roofline fractions (train)\n")
    for r in worst_cells([c for c in cells if c.get("mesh") == "single"]):
        print(f"- {r['arch']} × {r['shape']}: "
              f"{r['roofline']['roofline_fraction']:.4f} "
              f"({r['roofline']['dominant']})")


if __name__ == "__main__":
    main()
