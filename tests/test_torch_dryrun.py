"""The port's dry run (``repro_torch.launch.dryrun``) and its analysis
against the reference's, on a fake process group in this process.

* Per-device parameter, AdamW and decode-state bytes of a smoke cell of
  each family on a 2×4 mesh, and of kimi-k2-1t-a32b at full size on the
  16×16 mesh, equal the sum of the reference's shard shapes exactly.
* Per-device prefill matmul FLOPs of a smoke cell of each family (8 × 512
  tokens, 2×4 mesh) equal the reference's ``analyze_hlo`` of the same cell
  compiled for eight host devices (one subprocess: this process already
  holds JAX with one) to 1e-9 relative: both count the same products on
  the same local shapes — the projections, the expert products at the
  same capacity, attention as every (query chunk, key) pair, the last
  token's logits — so only the float64 sums' rounding may differ.
* The ring model per collective kind equals the reference's
  ``collective_wire_bytes`` on the same HLO op lines; ``roofline_terms``
  with the reference's table swapped in equals the reference's; the
  report's tables equal the reference's from the same records.
* kimi-k2-1t-a32b ``decode_32k`` on ``single`` runs at full size (a few
  seconds) through the CLI, and the report prints its record.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.analysis import report as ref_report
from repro.analysis import roofline as ref_roofline
from repro.configs import get_arch as ref_arch
from repro.models import lm as ref_lm
from repro.runtime import sharding as ref_shd
from repro_torch.analysis import report, roofline
from repro_torch.configs import ShapeSpec, get_arch, get_shape
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "repro-100m", "moe": "qwen2-moe-a2.7b",
            "ssm": "falcon-mamba-7b", "hybrid": "hymba-1.5b",
            "vlm": "llava-next-mistral-7b", "audio": "musicgen-large"}
PREFILL = ShapeSpec("prefill_smoke", 512, 8, "prefill")


@pytest.fixture
def fake_group():
    """Leaves no process group behind."""
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _ref_local_bytes(tree, shardings, mesh) -> int:
    """Σ over leaves of the reference's shard shape × item size."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    total = 0
    for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(
            shardings, is_leaf=lambda s: hasattr(s, "spec"))):
        shape = list(leaf.shape)
        for d, entry in enumerate(sh.spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                assert shape[d] % sizes[a] == 0
                shape[d] //= sizes[a]
        total += int(np.prod(shape)) * np.dtype(leaf.dtype).itemsize
    return total


def _ref_held(arch, shape, mesh, smoke: bool) -> dict:
    cfg = ref_arch(arch, smoke=smoke)
    params = ref_lm.abstract_params(cfg)
    p_sh = ref_shd.param_shardings(cfg, mesh, params)
    out = {"param_bytes": _ref_local_bytes(params, p_sh, mesh)}
    mdt = np.dtype(jax.numpy.dtype(cfg.opt_dtype))
    moments = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, mdt),
                           params)
    out["opt_bytes"] = 2 * _ref_local_bytes(moments, p_sh, mesh) + 4
    st = jax.eval_shape(lambda: ref_lm.init_decode_state(
        cfg, shape.global_batch, shape.seq_len))
    leaves = [x for x in st[:4] if hasattr(x, "shape")]
    s_sh = ref_shd.decode_state_shardings(cfg, mesh, st)
    out["state_bytes"] = _ref_local_bytes(
        leaves, [s for x, s in zip(st[:4], s_sh[:4]) if hasattr(x, "shape")],
        mesh)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_held_bytes_equal_reference_shard_shapes(family, fake_group):
    arch = FAMILIES[family]
    shape = ShapeSpec("decode_smoke", 512, 8, "decode")
    mesh = dryrun._mesh("2x4")
    train = ShapeSpec("train_smoke", 512, 8, "train")
    got = dryrun._held_bytes(get_arch(arch, smoke=True), train, mesh)
    got["state_bytes"] = dryrun._held_bytes(get_arch(arch, smoke=True),
                                            shape, mesh)["state_bytes"]
    want = _ref_held(arch, shape, AbstractMesh((2, 4), ("data", "model")),
                     smoke=True)
    assert got == want


def test_kimi_full_size_held_bytes_equal_reference(fake_group):
    mesh = dryrun._mesh("single")
    shape = get_shape("decode_32k")
    cfg = get_arch("kimi-k2-1t-a32b")
    got = dryrun._held_bytes(cfg, ShapeSpec("t", 4096, 256, "train"), mesh)
    got["state_bytes"] = dryrun._held_bytes(cfg, shape, mesh)["state_bytes"]
    want = _ref_held("kimi-k2-1t-a32b", shape,
                     AbstractMesh((16, 16), ("data", "model")), smoke=False)
    assert got == want


REF_FLOPS = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from repro.analysis.hlo_walk import analyze_hlo
    from repro.compat import make_mesh
    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.launch.dryrun import _specs_for, build_lowerable
    from repro.models.hints import set_mesh
    mesh = make_mesh((2, 4), ("data", "model"))
    set_mesh(mesh)
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = get_arch(arch, smoke=True)
        shape = ShapeSpec("prefill_smoke", 512, 8, "prefill")
        with mesh:
            fn, args = build_lowerable(cfg, shape, _specs_for(cfg, shape),
                                       mesh)
            out[arch] = analyze_hlo(fn.lower(*args).compile().as_text()).flops
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_prefill_flops():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REF_FLOPS,
                          ",".join(FAMILIES.values())], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[0][len("RESULT "):])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_flops_equal_reference_hlo_walk(family, ref_prefill_flops,
                                                fake_group):
    arch = FAMILIES[family]
    rec = dryrun.run_cell(arch, PREFILL.name, "2x4", shape=PREFILL,
                          cfg=get_arch(arch, smoke=True))
    assert rec["status"] == "ok" and rec["chips"] == 8
    want = ref_prefill_flops[arch]
    got = rec["cost"]["flops_per_device"]
    assert want > 0 and abs(got - want) <= 1e-9 * want, (got, want)
    assert rec["collectives"]["ops"] > 0
    assert rec["memory"]["peak_bytes_per_device"] > \
        rec["memory"]["param_bytes"] > 0


LINES = {"all-gather": "%ag = {t} all-gather({s} %p), channel_id=1, "
                       "replica_groups={g}, dimensions={{0}}",
         "all-reduce": "%ar = {t} all-reduce({t} %p), channel_id=2, "
                       "replica_groups={g}, to_apply=%add",
         "reduce-scatter": "%rs = {t} reduce-scatter({s} %p), channel_id=3, "
                           "replica_groups={g}, dimensions={{0}}, "
                           "to_apply=%add",
         "all-to-all": "%aa = {t} all-to-all({t} %p), channel_id=4, "
                       "replica_groups={g}, dimensions={{0}}",
         "collective-permute": "%cp = {t} collective-permute({t} %p), "
                               "channel_id=5, source_target_pairs={{{{0,1}},"
                               "{{1,0}}}}"}


@pytest.mark.parametrize("kind", sorted(LINES))
def test_ring_model_equals_reference(kind):
    cases = [("bf16", (8, 1024), "[2,4]<=[8]", 4),
             ("f32", (16, 12), "{{0,1,2,3,4,5,6,7}}", 8),
             ("f32", (3, 5), "[8,1]<=[8]", 1),
             ("bf16", (64, 7168), "[16,16]<=[256]", 16)]
    for dt, shape, groups, n in cases:
        t = f"{dt}[{','.join(map(str, shape))}]{{1,0}}"
        line = LINES[kind].format(t=t, s=t, g=groups)
        want = ref_roofline.collective_wire_bytes("  " + line)
        R = int(np.prod(shape)) * (2 if dt == "bf16" else 4)
        got = roofline.collective_wire_bytes([(kind, R, n)])
        for key, value in want.items():
            assert got[key] == pytest.approx(value, rel=1e-12), (key, line)


def _records():
    recs = []
    for i, (arch, kind) in enumerate([("gemma-2b", "train"),
                                      ("kimi-k2-1t-a32b", "decode"),
                                      ("hymba-1.5b", "prefill")]):
        rec = {"arch": arch, "shape": f"{kind}_x", "mesh": "single",
               "status": "ok", "coded": False, "chips": 256, "kind": kind,
               "memory": {"peak_bytes_per_device": (i + 1) * 3.1e9},
               "cost": {"flops_per_device": (i + 2) * 1.7e13,
                        "bytes_accessed_per_device": (i + 1) * 4.4e11},
               "collectives": {"total_wire_bytes": (i + 1) * 2.2e9,
                               "ops": 10 * (i + 1)},
               "model_flops_per_token": 6 * (i + 1) * 2.5e9,
               "tokens": [1048576, 128, 1048576][i]}
        recs.append(rec)
    recs.append({"arch": "qwen1.5-32b", "shape": "long_500k",
                 "mesh": "single", "status": "skip:full-attention"})
    recs.append({"arch": "minicpm-2b", "shape": "train_4k", "mesh": "multi",
                 "status": "error: RuntimeError: x"})
    return recs


def test_roofline_terms_equal_reference_with_its_table():
    for rec in _records()[:3]:
        assert roofline.roofline_terms(rec, hw=ref_roofline.HW) == \
            ref_roofline.roofline_terms(rec)
        mine = roofline.roofline_terms(rec)
        assert mine["compute_s"] == rec["cost"]["flops_per_device"] / 989e12


def test_report_tables_equal_reference(tmp_path):
    recs = _records()
    for rec in recs[:3]:
        rec["roofline"] = roofline.roofline_terms(rec)
    for i, rec in enumerate(recs):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    loaded = report.load_cells(None, coded=None, results_dir=str(tmp_path))
    assert len(loaded) == len(recs)
    assert report.dryrun_table(loaded) == ref_report.dryrun_table(loaded)
    single = [r for r in loaded if r.get("mesh") == "single"]
    assert report.roofline_table(single) == ref_report.roofline_table(single)
    assert report.worst_cells(single) == ref_report.worst_cells(single)


def test_kimi_decode_cell_through_the_cli_and_report(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "kimi-k2-1t-a32b", "--shape", "decode_32k", "--mesh", "single",
         "--out-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rec = json.loads((tmp_path / "kimi-k2-1t-a32b__decode_32k__single.json"
                      ).read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    for key in ("memory", "cost", "collectives", "roofline",
                "model_flops_per_token", "tokens", "kind"):
        assert key in rec
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] >= mem["param_bytes"] + \
        mem["state_bytes"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.report",
         "--results-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "| kimi-k2-1t-a32b | decode_32k | single | ok |" in out.stdout
