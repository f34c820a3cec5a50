"""The plain references against the port's plain path, at small sizes on
the CPU, in float32."""
import json

import numpy as np
import pytest
import torch

from h100bench import core, lm
from h100bench.conftest import ROOT, TINY_CONFIGS

HY = core.reference("hymba-1.5b")
SAC = core.reference("sac-lsac-k8n24")


def tiny_hymba(**kw):
    cfg = json.loads((ROOT / "h100bench/configs/hymba-1.5b.json")
                     .read_text())
    cfg.update(TINY_CONFIGS["hymba-1.5b"], dtype="float32", **kw)
    cfg["init"]["embed"] = ["normal", 0.125]
    return cfg


def loop_scan(x, dt, A, B, C, D):
    h = torch.zeros(x.shape[0], x.shape[2], A.shape[1], dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1) + D * x[:, t])
    return torch.stack(ys, 1)


@pytest.mark.parametrize("L,chunk", [(1, 4), (37, 8), (64, 64), (200, 16)])
def test_chunked_scan_is_the_loop(L, chunk):
    g = torch.Generator().manual_seed(L)
    Bt, Dm, S = 2, 6, 4
    x = torch.randn(Bt, L, Dm, generator=g, dtype=torch.float64)
    dt = torch.rand(Bt, L, Dm, generator=g, dtype=torch.float64) * 2
    A = -torch.rand(Dm, S, generator=g, dtype=torch.float64) * 8
    B = torch.randn(Bt, L, S, generator=g, dtype=torch.float64)
    C = torch.randn(Bt, L, S, generator=g, dtype=torch.float64)
    D = torch.randn(Dm, generator=g, dtype=torch.float64)
    got = HY.scan(x, dt, A, B, C, D, chunk)
    torch.testing.assert_close(got, loop_scan(x, dt, A, B, C, D),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("window", [0, 5, 16])
def test_blocked_attention_is_the_ports_plain_attention(window):
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(window)
    q = torch.randn(2, 40, 6, 8, generator=g)
    k = torch.randn(2, 40, 2, 8, generator=g)
    v = torch.randn(2, 40, 2, 8, generator=g)
    got = HY.attention(q, k, v, window, block=16)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=True,
                         window=window or None).transpose(1, 2)
    torch.testing.assert_close(got, want.reshape(2, 40, 48), rtol=1e-5,
                               atol=1e-5)


def test_hymba_training_is_the_ports_train_step():
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import make_schedule, make_train_step
    cfg = tiny_hymba()
    tr = json.loads((ROOT / "h100bench/traffic/train-8x4096.json")
                    .read_text())
    arch, model = lm.model(cfg, 3, "cpu")
    sch = tr["schedule"]
    step = make_train_step(arch, make_schedule(
        arch, peak_lr=sch["peak_lr"], warmup=sch["warmup"],
        total=sch["total"]), device="cpu")
    opt = adamw_init(dict(model.named_parameters()))
    batches = [lm.tokens(3, i, 2, 48, cfg["vocab_size"], "cpu")
               for i in range(3)]
    losses = []
    for i, b in enumerate(batches):
        model, opt, m = step(model, opt, {"tokens": b}, i)
        losses.append(float(m["loss"]))
        if i == 0:
            g1 = {k: float(v.norm()) / 0.1 for k, v in opt.m.items()}
    W = lm.make_weights(cfg, 3, "cpu")
    want = HY.train(W, batches, cfg, tr["optimizer"], sch, rows=1)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    for k, v in want["g1"].items():
        assert g1[k] == pytest.approx(v, rel=1e-3, abs=1e-6), k
    for k, p in model.named_parameters():
        assert float((p - W[k]).norm()) == pytest.approx(
            want["change"][k], rel=1e-3, abs=1e-7), k


def test_hymba_leaves_are_the_ports_parameters():
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    cfg = json.loads((ROOT / "h100bench/configs/hymba-1.5b.json")
                     .read_text())
    # the port's file leaves dt_rank to its default, ceil(d / 16) = 100
    assert lm.arch(cfg) == get_arch("hymba-1.5b").replace(
        source=lm.arch(cfg).source, dt_rank=100)
    with torch.device("meta"):
        m = LM(lm.arch(cfg), dtype=torch.bfloat16, device="meta")
    want = {k: (tuple(p.shape), str(p.dtype).split(".")[-1])
            for k, p in m.named_parameters()}
    assert {n: (tuple(s), d) for n, s, d in HY.leaves(cfg)} == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sac_decode_is_the_ports_decode(seed):
    from repro_torch.core.registry import make_code
    from repro_torch.serving.backends import SimulatedBackend
    cfg = json.loads((ROOT / "h100bench/configs/sac-lsac-k8n24.json")
                     .read_text())
    c = cfg["code"]
    code = make_code(c["family"], c["K"], c["N"], eps=c["eps"])
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(16, 64, generator=g, dtype=torch.float64)
    B = torch.randn(64, 12, generator=g, dtype=torch.float64)
    job = SAC.Job(cfg, A, B)
    P = SimulatedBackend(device="cpu").compute_products(code, [A], [B])[0]
    torch.testing.assert_close(job.P, P, rtol=1e-12, atol=1e-10)
    row = np.random.default_rng(seed).exponential(size=c["N"]) + 1.0
    order = np.argsort(row, kind="stable")
    for m in (1, 5, 14, 15, 20):
        t = np.sort(row)[m - 1]
        got_m, est, scale = job.estimate(row, t)
        w, _ = code.estimate_weights(order[:m], m)
        want = torch.einsum("m,mij->ij", torch.as_tensor(w),
                            P[order[:len(w)]])
        assert got_m == m and scale > 0
        torch.testing.assert_close(est, want, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(job.estimate(row, row.max())[1], A @ B,
                               rtol=1e-6, atol=1e-6)
