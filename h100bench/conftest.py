"""Fixtures of the benchmark's own tests: a checkout-shaped folder whose
cells are the benchmark's, cut to sizes a CPU test can hold."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

TINY_CONFIGS = {
    "sac-lsac-k8n24": dict(rows=32, inner=256, cols=24),
    "hymba-1.5b": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=120,
                       padded_vocab=128, ssm_state=4, d_inner=128, dt_rank=4,
                       sliding_window=8, global_attn_layers=[0, 2]),
}
TINY_TRAFFIC = {
    "train-8x4096": dict(rows=2, length=64, reference_rows=1),
    "f32-closed4": dict(sample_from=4, sample_requests=3, profile_units=1),
    "bf16-closed4": dict(sample_from=4, sample_requests=3, profile_units=1),
}


def make_tiny_root(tmp: Path, dtype: str = "float32") -> Path:
    """A copy of the benchmark's data at tiny sizes (the LM in ``dtype``);
    the drivers, references and readers are the folder's own."""
    tmp = Path(tmp)
    for d in ("traffic", "limits", "configs"):
        shutil.copytree(ROOT / "h100bench" / d, tmp / "h100bench" / d,
                        dirs_exist_ok=True)
    for name, upd in TINY_CONFIGS.items():
        p = tmp / "h100bench" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg.update(upd)
        if name == "hymba-1.5b":
            cfg["dtype"] = dtype
            cfg["init"]["embed"] = ["normal", 0.125]
        p.write_text(json.dumps(cfg))
    for name, upd in TINY_TRAFFIC.items():
        p = tmp / "h100bench" / "traffic" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **upd}))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
