"""Import rules of the port: no JAX, nothing of the reference package, and
no silent CPU fallback when a CUDA card is asked for."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = ["repro_torch", "repro_torch.core", "repro_torch.kernels",
           "repro_torch.serving", "repro_torch.launch.serve",
           "repro_torch.convert", "repro_torch.cluster",
           "repro_torch.models", "repro_torch.models.moe",
           "repro_torch.runtime.steps",
           "repro_torch.configs", "repro_torch.core.simulate",
           "repro_torch.design", "repro_torch.obs", "repro_torch.ioutil",
           "repro_torch.serving.loadgen", "repro_torch.cluster.config",
           "repro_torch.cluster.transport", "repro_torch.cluster.worker",
           "repro_torch.cluster.pool", "repro_torch.cluster.backend",
           "repro_torch.analysis", "repro_torch.analysis.attribution",
           "repro_torch.runtime.coded", "repro_torch.optim",
           "repro_torch.data", "repro_torch.checkpoint",
           "repro_torch.launch.train", "repro_torch.compat",
           "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
           "repro_torch.models.hints", "repro_torch.runtime.sharding",
           "repro_torch.analysis.roofline", "repro_torch.analysis.op_walk",
           "repro_torch.analysis.report", "repro_torch.data.pipeline",
           "repro_torch.examples.quickstart",
           "repro_torch.examples.coded_matmul_service",
           "repro_torch.examples.autotune_service",
           "repro_torch.examples.train_lm_coded",
           "repro_torch.examples.fault_tolerance",
           "repro_torch.tools.sac_top"]


def test_port_import_loads_no_jax_and_no_reference():
    """A fresh interpreter importing every port module has no ``jax*`` and
    no ``repro`` / ``repro.*`` module loaded."""
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert "repro_torch.serving.master" in mods
    assert "repro_torch.models.lm" in mods
    for m in ("repro_torch.launch.dryrun", "repro_torch.runtime.sharding",
              "repro_torch.design.policy", "repro_torch.design.pareto",
              "repro_torch.design.state", "repro_torch.obs.exporter",
              "repro_torch.obs.slo", "repro_torch.serving.cache",
              "repro_torch.cluster.backend", "repro_torch.cluster.pool"):
        assert m in mods, m


def test_cluster_spawn_target_imports_no_torch():
    """A numpy-compute worker process starts without torch: the spawn
    target's imports load neither torch nor jax nor the reference."""
    code = ("import json, sys\n"
            "from repro_torch.cluster.worker import worker_main\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in mods
           if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro")]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(p.relative_to(PORT).as_posix()
                                        for p in PORT.rglob("*.py")))
def test_port_sources_import_nothing_of_jax_or_the_reference(path):
    tree = ast.parse((PORT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path} imports {name}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_backend_without_a_card_raises(no_card):
    from repro_torch.serving import TorchDeviceBackend
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDeviceBackend()
    assert TorchDeviceBackend(device="cpu").device.type == "cpu"


def test_serve_entry_point_without_a_card_raises(no_card):
    from repro_torch.launch.serve import build_parser, run_serve
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_serve(build_parser().parse_args(["--requests", "1", "--rows",
                                             "8", "--inner", "16"]))


def test_resolve_device_rules(no_card):
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_chip_smoke_refuses_without_a_card():
    """The chip script exits non-zero and prints no result line without a
    CUDA card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
