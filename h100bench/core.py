"""What the harness finds by name: a cell's entry in ``BENCHMARK.json``, its
configuration file, its traffic mix, its limits, its configuration's plain
reference and its per-layer metrics' readers, all under this folder.

A later change adds a configuration, a mix, a limit file, a reference or a
reader as new files beside these, and an entry in ``BENCHMARK.json``; no
file that is here needs an edit.  The traffic mix names its driver
(``drivers/<driver>.py``), the general generator that reads it.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "repro")


def spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell's workload entry, its configuration entry, the
    configuration file, the traffic mix and the limits, by name."""
    b = spec(root)
    work = {w["name"]: w for w in b["workloads"]}
    if name not in work:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in b["configs"]}[w["config"]]
    return {"workload": w, "config_entry": conf,
            "config": json.loads((root / conf["file"]).read_text()),
            "traffic": load_json(root / "h100bench" / "traffic"
                                 / f"{w['traffic']}.json"),
            "limits": load_json(root / "h100bench" / "limits"
                                / f"{name}.json"),
            "end_to_end": [m for m in b["end_to_end"]
                           if name in m.get("workloads", [name])],
            "per_layer": [m for m in b["per_layer"]
                          if name in m.get("workloads", [name])]}


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """A module of this folder by its file, whatever its file name holds
    (configuration and metric names carry dots and dashes)."""
    path = Path(path)
    key = "h100bench_" + "".join(c if c.isalnum() else "_" for c in name)
    if key in sys.modules:
        return sys.modules[key]
    spec_ = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec_)
    sys.modules[key] = mod
    spec_.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py", f"driver.{name}")


def reference(config_name: str):
    return load_module(HERE / "reference" / f"{config_name}.py",
                       f"reference.{config_name}")


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py", f"metric.{metric}")


def worst(values) -> float:
    """The largest of ``values`` (0 if none); one that is not finite makes it
    infinite, so a NaN answer fails its limit instead of vanishing from a
    ``max``, which keeps its first argument against a NaN."""
    out = 0.0
    for v in values:
        v = float(v)
        if not math.isfinite(v):
            return math.inf
        out = max(out, v)
    return out


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN_TOP})
