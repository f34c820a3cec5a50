"""The port's mesh branches on a 2 × 4 gloo mesh of eight CPU processes,
as ``tests/test_runtime.py`` runs the reference on eight host devices.

One group of eight ``python -c`` children (``spawn``-free: plain
subprocesses, a ``FileStore`` under ``tmp_path``, a 60 s collective
time-out, each waited for with a bound and killed in a ``finally``) runs
every case once; the tests read rank 0's results.  Tolerances:

* ``distributed_coded_matmul`` on the ``model`` axis (the reference's
  job: MatDot K=3, N=8, A 16×48, B 48×12): below 1e-5 relative to
  ``A @ B`` at ``m = R`` and ``m = N`` (the reference's limit), every
  rank's answer the same;
* the MoE block's mesh branch on the reference test's exact config (E=4
  over model 4: experts split, EP) and with E=6 (experts do not divide
  the axis: the ffn dim is split, expert-TP), FSDP on: max abs error
  below 1e-4 of the reference's ``moe_ref`` on the reference's weights
  (the reference test's limit);
* attention: the query-chunk branch (512 queries, 128 per model rank)
  and the head-parallel branch (8 query heads over 4, with 4 KV heads
  split alike or 2 sliced per rank) against the unsharded plain
  attention, outputs and the q, k, v gradients within 1e-5 relative;
* the smoke configs (float32, seeded weights) on the mesh against one
  process: prefill logits within 2e-4 and two decode steps within 2e-3
  (relative Frobenius), and two train steps' losses and gradient norms
  within 1e-4 relative.  The MoE configs run drop-free (capacity factor
  E: a rank's capacity comes from its own tokens, as in the reference, so
  with drops the two runs would drop different assignments), and their
  train batch repeats its first half in its second, so that the
  load-balance loss — averaged over the batch shards on the mesh, as the
  reference's ``pmean`` does — equals the one-process one.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ArchConfig as RefArchConfig
from repro.models.moe import init_moe_params, moe_ref
from repro_torch.core import MatDotCode, chebyshev_roots
from repro_torch.core.partition import split_contraction
from repro_torch.runtime import coded

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
LM_ARCHS = ["repro-100m", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "hymba-1.5b",
            "falcon-mamba-7b", "musicgen-large", "llava-next-mistral-7b"]
MOE_CASES = {"ep": 4, "tp": 6}          # experts; the model axis is 4

CHILD = textwrap.dedent("""
    import copy, datetime, faulthandler, json, sys, traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.compat import P, distribute_tensor, placements
    from repro_torch.configs import ArchConfig, get_arch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.models.attention import attention
    from repro_torch.models.hints import full, set_mesh
    from repro_torch.models.moe import moe_block
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.coded import distributed_coded_matmul
    from repro_torch.runtime.steps import (make_decode_step,
                                           make_prefill_step, make_train_step)

    rank, io = int(sys.argv[1]), sys.argv[2]
    archs = sys.argv[3].split(",")
    faulthandler.enable()
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(io + "/store", 8), rank=rank,
        world_size=8, timeout=datetime.timedelta(seconds=60))
    mesh = make_local_mesh(2, 4, device_type="cpu")
    d = np.load(io + "/in.npz")
    out, errors = {}, {}

    def rel(a, b):
        a, b = full(a).double(), full(b).double()
        return float((a - b).norm() / b.norm())

    def case(name):
        def wrap(fn):
            try:
                fn()
            except Exception:
                errors[name] = traceback.format_exc()[-3000:]
            finally:
                set_mesh(None)
        return wrap

    @case("coded")
    def _():
        for key in ("m5", "m8"):
            est = distributed_coded_matmul(
                torch.from_numpy(d["E_A"]), torch.from_numpy(d["E_B"]),
                torch.from_numpy(d[key]), mesh, axis="model")
            out["coded_" + key] = est.numpy().tolist()

    @case("moe")
    def _():
        for tag in ("ep", "tp"):
            E = int(d["moe_E_" + tag])
            cfg = ArchConfig("m", "moe", 1, 32, 2, 2, 0, 97, n_experts=E,
                             experts_per_token=2, d_ff_expert=16,
                             n_shared_experts=1, capacity_factor=8.0)
            p = {}
            for key in d.files:
                pre = "moe_" + tag + "_p_"
                if not key.startswith(pre):
                    continue
                leaf = key[len(pre):]
                name = "layers.0.moe." + leaf.replace("__", ".")
                t = torch.from_numpy(d[key])
                t = distribute_tensor(t, mesh, placements(
                    shd.leaf_spec(name, t.shape, cfg, mesh), mesh),
                    src_data_rank=None)
                if leaf.startswith("shared__"):
                    p.setdefault("shared", {})[leaf[8:]] = t
                else:
                    p[leaf] = t
            x = distribute_tensor(torch.from_numpy(d["moe_x_" + tag]), mesh,
                                  placements(P("data"), mesh),
                                  src_data_rank=None)
            set_mesh(mesh)
            got, aux = moe_block(p, x, cfg)
            out["moe_" + tag] = full(got).numpy().tolist()
            out["moe_aux_finite_" + tag] = bool(torch.isfinite(full(aux)))

    @case("attention")
    def _():
        for tag, L, Hkv in (("qchunk", 512, 4), ("heads", 256, 4),
                            ("kvslice", 256, 2)):
            g = torch.Generator().manual_seed(3)
            q = torch.randn(2, 8, L, 16, generator=g)
            k = torch.randn(2, Hkv, L, 16, generator=g)
            v = torch.randn(2, Hkv, L, 16, generator=g)
            for window in (0, 64):
                ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
                want = attention_ref(ql, kl, vl, window=window or None)
                (want ** 2).sum().backward()
                plc = placements(P("data"), mesh)
                qd, kd, vd = (distribute_tensor(t, mesh, plc,
                                                src_data_rank=None
                                                ).requires_grad_()
                              for t in (q, k, v))
                set_mesh(mesh)
                got = attention(qd, kd, vd, window=window, use_kernels=False)
                (got ** 2).sum().backward()
                key = f"attn_{tag}_w{window}"
                out[key] = rel(got, want)
                out[key + "_grads"] = max(rel(a.grad, b.grad) for a, b in
                                          ((qd, ql), (kd, kl), (vd, vl)))
                set_mesh(None)

    for arch in archs:
        @case("lm_" + arch)
        def _():
            cfg = get_arch(arch, smoke=True).replace(dtype="float32")
            if cfg.has_moe:
                cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
            base = lm.init_params(cfg, device="cpu", dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(0))
            sh = shd.distribute_lm(copy.deepcopy(base), mesh)
            rng = np.random.default_rng(1)
            cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
            toks = rng.integers(0, cfg.vocab_size, size=(4, 512) + cb)
            L = toks.shape[1]
            pre = make_prefill_step(cfg, max_seq=L + 4, device="cpu")
            dec = make_decode_step(cfg, device="cpu")
            lg0, st0 = pre(base, {"tokens": toks})
            set_mesh(mesh)
            lg1, st1 = pre(sh, {"tokens": toks})
            res = {"prefill": rel(lg1, lg0), "decode": []}
            for _ in range(2):
                nxt = rng.integers(0, cfg.vocab_size, size=(4, 1) + cb)
                set_mesh(None)
                lg0, st0 = dec(base, nxt, st0)
                set_mesh(mesh)
                lg1, st1 = dec(sh, nxt, st1)
                res["decode"].append(rel(lg1, lg0))
            batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                            size=(4, 64) + cb)}
            if cfg.has_moe:
                batch["tokens"][2:] = batch["tokens"][:2]
            if cfg.family == "vlm":
                batch["vision_embeds"] = rng.standard_normal(
                    (4, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
            set_mesh(None)
            tb = copy.deepcopy(base)
            o0 = adamw_init(dict(tb.named_parameters()))
            ts = copy.deepcopy(base)
            o1 = adamw_init(dict(ts.named_parameters()))
            shd.distribute_lm(ts, mesh)
            o1 = shd.distribute_adamw(o1, mesh,
                                      shd.param_shardings(cfg, mesh, ts))
            tr = make_train_step(cfg, device="cpu")
            res["train"] = []
            for step in range(2):
                set_mesh(None)
                tb, o0, m0 = tr(tb, o0, batch, step)
                set_mesh(mesh)
                ts, o1, m1 = tr(ts, o1, batch, step)
                res["train"].append([
                    float(m0["loss"]), float(full(m1["loss"])),
                    float(m0["grad_norm"]), float(full(m1["grad_norm"]))])
            out["lm_" + arch] = res

    out["errors"] = errors
    with open(io + f"/out{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()                 # no rank tears the group down early
    dist.destroy_process_group()
""")


def _inputs(io: Path) -> dict:
    """The children's inputs, and the reference's answers to hold them to."""
    rng = np.random.default_rng(0)
    A, B = rng.standard_normal((16, 48)), rng.standard_normal((48, 12))
    code = MatDotCode(3, 8, chebyshev_roots(8))
    E_A, E_B = coded.encode_operands(code, *split_contraction(A, B, 3))
    arrays = {"E_A": E_A.astype(np.float32), "E_B": E_B.astype(np.float32)}
    for m in (code.recovery_threshold, 8):
        arrays[f"m{m}"] = coded.decode_weight_vector(
            code, np.arange(8), m).astype(np.float32)
    want = {"AB": A @ B}
    for tag, E in MOE_CASES.items():
        cfg = RefArchConfig("m", "moe", 1, 32, 2, 2, 0, 97, n_experts=E,
                            experts_per_token=2, d_ff_expert=16,
                            n_shared_experts=1, capacity_factor=8.0)
        p = init_moe_params(jax.random.key(0), cfg, jnp.float32)
        x = jax.random.normal(jax.random.key(1), (32, 32), jnp.float32)
        want["moe_" + tag] = np.asarray(moe_ref(p, x, cfg))
        arrays["moe_E_" + tag] = np.array(E)
        arrays["moe_x_" + tag] = np.asarray(x)
        for k, v in p.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    arrays[f"moe_{tag}_p_{k}__{kk}"] = np.asarray(vv)
            else:
                arrays[f"moe_{tag}_p_{k}"] = np.asarray(v)
    np.savez(io / "in.npz", **arrays)
    return want


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    io = tmp_path_factory.mktemp("mesh")
    want = _inputs(io)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = []
    try:
        for r in range(WORLD):
            log = open(io / f"rank{r}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD, str(r), str(io),
                 ",".join(LM_ARCHS)], env=env, stdout=log,
                stderr=subprocess.STDOUT))
            log.close()
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    logs = "".join((io / f"rank{r}.log").read_text()[-2000:]
                   for r in range(WORLD))
    assert rcs == [0] * WORLD, logs
    outs = [json.loads((io / f"out{r}.json").read_text())
            for r in range(WORLD)]
    return outs, want


def _case(mesh_run, key, error):
    outs, want = mesh_run
    errors = outs[0]["errors"]
    assert error not in errors, errors[error]
    return outs, want, outs[0][key]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("m", ["m5", "m8"])
def test_distributed_coded_matmul_on_model_axis(mesh_run, m):
    outs, want, got = _case(mesh_run, "coded_" + m, "coded")
    assert _rel(got, want["AB"]) < 1e-5
    for o in outs:
        np.testing.assert_array_equal(o["coded_" + m], got)


@pytest.mark.parametrize("tag", sorted(MOE_CASES))
def test_sharded_moe_matches_reference_oracle(mesh_run, tag):
    outs, want, got = _case(mesh_run, "moe_" + tag, "moe")
    assert np.abs(np.asarray(got) - want["moe_" + tag]).max() < 1e-4
    assert outs[0]["moe_aux_finite_" + tag]


@pytest.mark.parametrize("tag", ["qchunk", "heads", "kvslice"])
@pytest.mark.parametrize("window", [0, 64])
def test_mesh_attention_matches_unsharded(mesh_run, tag, window):
    outs, _, got = _case(mesh_run, f"attn_{tag}_w{window}", "attention")
    assert got < 1e-5
    assert outs[0][f"attn_{tag}_w{window}_grads"] < 1e-5


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_prefill_and_decode_on_mesh_match_one_process(mesh_run, arch):
    _, _, res = _case(mesh_run, "lm_" + arch, "lm_" + arch)
    assert res["prefill"] < 2e-4
    assert len(res["decode"]) == 2 and max(res["decode"]) < 2e-3


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_train_steps_on_mesh_match_one_process(mesh_run, arch):
    _, _, res = _case(mesh_run, "lm_" + arch, "lm_" + arch)
    assert len(res["train"]) == 2
    for loss0, loss1, gn0, gn1 in res["train"]:
        assert abs(loss1 - loss0) <= 1e-4 * abs(loss0)
        assert abs(gn1 - gn0) <= 1e-4 * abs(gn0)
