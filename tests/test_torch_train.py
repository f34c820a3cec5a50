"""The port's training stack against the reference's, on the CPU.

Weights and optimizer state cross over from the reference
(``lm_params_from_reference``, ``adamw_state_from_reference``); tokens
come from the shared step-keyed pipeline or a numpy seed.  Tolerances:

* ``cross_entropy_chunked`` and ``lm_loss`` — 1e-5 relative (float32
  scalars; the forward logits themselves agree to the reference's 2e-4);
  1e-4 for ``lm_loss`` through the coded FFN (N=16, K=8, one dead worker:
  the decode weights sum to 2.1e4 in magnitude, which amplifies each
  package's float32 rounding of the worker products);
* the optimizer — ``adamw_update``'s parameters and moments to 1e-6
  relative, the schedules equal in float32, ``clip_by_global_norm`` 1e-6;
* three train steps at peak lr 1e-2, each from the reference's state —
  loss and grad norm 1e-5 relative, lr equal, each element's change within
  1e-3 of the reference's, plus what a gradient rounding of 1e-5 of its
  leaf's largest element does through the update there (see the test);
* ``SyntheticTokens`` — equal arrays;
* checkpoints — bit-exact round trips, bfloat16 included;
* ``train()`` — the reference's own limits (``tests/test_train_driver.py``):
  the loss falls, resume reproduces the trajectory (bit for bit here),
  coded with one dead worker matches uncoded to 2e-3.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import MatDotCode as RefMatDot
from repro.core import chebyshev_roots as ref_cheb
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.models import init_params as ref_init_params
from repro.models import lm_loss as ref_lm_loss
from repro.models.layers import cross_entropy_chunked as ref_ce
from repro.optim import adamw as ref_adamw
from repro.runtime.coded import exact_weight_vector as ref_exact_weights
from repro.runtime.steps import make_schedule as ref_make_schedule
from repro.runtime.steps import make_train_step as ref_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig as PortArchConfig
from repro_torch.convert import (adamw_state_from_reference,
                                 lm_params_from_reference)
from repro_torch.data import SyntheticTokens
from repro_torch.launch.train import build_state, main, train
from repro_torch.models import (cross_entropy_chunked, embed_tokens,
                                forward_hidden, lm_loss)
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, wsd_schedule)
from repro_torch.runtime.steps import (decayed_names, make_schedule,
                                      make_train_step)

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["repro-100m", "falcon-mamba-7b", "hymba-1.5b"]
# the MoE (with the load-balance term), vlm and audio families
NEW_FAMILIES = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                "llava-next-mistral-7b", "musicgen-large"]
# one MoE and the audio family through the train step
STEP_FAMILIES = FAMILIES + ["qwen2-moe-a2.7b", "musicgen-large"]


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _port_cfg(cfg):
    return PortArchConfig(**dataclasses.asdict(cfg))


def _shared(cfg):
    """Reference parameters and the port's LM holding the same numbers."""
    params = ref_init_params(jax.random.key(0), cfg, jnp.float32)
    return params, lm_params_from_reference(jax.tree.map(np.asarray, params),
                                            _port_cfg(cfg))


# ------------------------------------------------------------------- loss

@pytest.mark.parametrize("T,chunk,masked", [(37, 16, False), (37, 16, True),
                                            (32, 16, False), (5, 64, True)])
def test_cross_entropy_chunked_matches_reference(T, chunk, masked):
    rng = np.random.default_rng(T + chunk)
    d, V = 8, 29
    hidden = rng.standard_normal((T, d)).astype(np.float32)
    table = rng.standard_normal((d, V)).astype(np.float32)
    tgt = rng.integers(0, V, T)
    mask = (rng.random(T) > 0.3).astype(np.float32) if masked else None
    want = ref_ce(lambda h: h @ jnp.asarray(table), jnp.asarray(hidden),
                  jnp.asarray(tgt), None if mask is None else
                  jnp.asarray(mask), chunk=chunk)
    tab = torch.from_numpy(table).requires_grad_(True)
    got = cross_entropy_chunked(lambda h: h @ tab, torch.from_numpy(hidden),
                                torch.from_numpy(tgt), None if mask is None
                                else torch.from_numpy(mask), chunk=chunk)
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-5
    # the gradient through the recomputed chunks, against the reference's
    got.backward()
    g_ref = jax.grad(lambda t: ref_ce(
        lambda h: h @ t, jnp.asarray(hidden), jnp.asarray(tgt),
        None if mask is None else jnp.asarray(mask), chunk=chunk))(
            jnp.asarray(table))
    assert _rel(tab.grad, g_ref) < 1e-5


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("coded_N", [None, 16])
def test_lm_loss_matches_reference(name, coded_N):
    cfg = ref_get_arch(name, smoke=True).replace(dtype="float32")
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    if coded_N:
        cfg = cfg.replace(coded=True)
        live = np.ones(coded_N, bool)
        live[0] = False
        batch["coded_weights"] = ref_exact_weights(
            RefMatDot(cfg.coded_K, coded_N, ref_cheb(coded_N)), live)
    params, model = _shared(cfg)
    want = ref_lm_loss(params, {k: jnp.asarray(v, jnp.float32 if
                                               k == "coded_weights" else None)
                                for k, v in batch.items()}, cfg)
    got = lm_loss(model, {k: torch.as_tensor(v, dtype=torch.float32 if
                                             k == "coded_weights"
                                             else torch.long)
                          for k, v in batch.items()}, _port_cfg(cfg))
    assert _rel(got, want) < (1e-4 if coded_N else 1e-5)


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_lm_loss_matches_reference_new_families(name):
    """1e-5 relative: the MoE configs with ``0.01·`` their load-balance
    loss, llava with its vision embeddings prepended (which change the
    loss: they are attended to), musicgen as the mean over its codebooks'
    losses."""
    cfg = ref_get_arch(name, smoke=True)
    data = RefTokens(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                     seed=4, n_codebooks=cfg.n_codebooks,
                     vision_tokens=cfg.vision_tokens, d_model=cfg.d_model)
    batch = data(0)
    params, model = _shared(cfg)
    pcfg = _port_cfg(cfg)

    ref_loss = jax.jit(ref_lm_loss, static_argnums=2)

    def both(batch):
        want = ref_loss(params, {k: jnp.asarray(v)
                                 for k, v in batch.items()}, cfg)
        got = lm_loss(model, {k: torch.as_tensor(v).long() if k == "tokens"
                              else torch.as_tensor(v)
                              for k, v in batch.items()}, pcfg)
        assert _rel(got, want) < 1e-5
        return float(got)

    loss = both(batch)
    if cfg.family == "vlm":
        assert batch["vision_embeds"].shape == (2, cfg.vision_tokens,
                                                cfg.d_model)
        scaled = dict(batch, vision_embeds=batch["vision_embeds"] * 3.0)
        assert abs(both(scaled) - loss) > 1e-6
    if cfg.has_moe:
        # the aux term is in: the loss without it is the CE alone
        h, aux = forward_hidden(model, embed_tokens(
            model, torch.as_tensor(batch["tokens"]).long(), pcfg), pcfg,
            torch.arange(16)[None].expand(2, 16))
        assert float(aux) >= 1.0 - 1e-6
        ce = cross_entropy_chunked(
            lambda x: x @ model.lm_head, h[:, :-1].reshape(-1, cfg.d_model),
            torch.as_tensor(batch["tokens"][:, 1:]).long().reshape(-1))
        assert abs(loss - float(ce) - 0.01 * float(aux)) < 1e-5


# -------------------------------------------------------------- optimizer

def _tree_pair(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (5, 3), "b": (3,), "e": (4, 2, 2)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
         for k, s in shapes.items()}
    return p, g


def test_adamw_update_matches_reference():
    p, g = _tree_pair()
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    state = ref_adamw.adamw_init(rp)
    mine = {k: torch.from_numpy(v) for k, v in p.items()}
    ostate = adamw_init(mine)
    for i in range(4):
        lr = 1e-2 * (i + 1)
        grads = {k: v * (i + 1) for k, v in g.items()}
        rp, state = ref_adamw.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, state, rp, lr=lr)
        mine, ostate = adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, ostate, mine,
            lr=torch.tensor(lr, dtype=torch.float32))
    assert int(ostate.step) == int(state.step) == 4
    for k in p:
        assert _rel(mine[k], rp[k]) < 1e-6, k
        assert _rel(ostate.m[k], state.m[k]) < 1e-6, k
        assert _rel(ostate.v[k], state.v[k]) < 1e-6, k
    # decay on matrices only: a zero gradient moves a vector not at all
    zero = {k: torch.zeros_like(v) for k, v in mine.items()}
    after, _ = adamw_update(zero, adamw_init(mine), mine, lr=0.5)
    assert torch.equal(after["b"], mine["b"])
    assert not torch.equal(after["w"], mine["w"])


def test_adamw_bf16_parameters_round_to_nearest_even_like_reference():
    p, g = _tree_pair(3)
    rp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    mine = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    rp2, rstate = ref_adamw.adamw_update(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
        ref_adamw.adamw_init(rp), rp, lr=3e-2)
    mine2, state = adamw_update(
        {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()},
        adamw_init(mine), mine, lr=torch.tensor(3e-2))
    for k in p:
        assert mine2[k].dtype == torch.bfloat16
        assert state.m[k].dtype == torch.float32
        np.testing.assert_array_equal(
            mine2[k].float().numpy(), np.asarray(rp2[k], np.float32))


def test_clip_by_global_norm_matches_reference():
    _, g = _tree_pair(1)
    for max_norm in (1.0, 1e3):
        rg, rn = ref_adamw.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        mg, mn = clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        assert _rel(mn, rn) < 1e-6
        for k in g:
            assert _rel(mg[k], rg[k]) < 1e-6


@pytest.mark.parametrize("which", ["cosine", "wsd"])
def test_schedules_match_reference_in_float32(which):
    mine = cosine_schedule if which == "cosine" else wsd_schedule
    theirs = getattr(ref_adamw, f"{which}_schedule")
    for step in [0, 1, 5, 10, 11, 40, 60, 89, 90, 95, 100, 150]:
        got = mine(step, peak_lr=1e-3, warmup=10, total=100)
        want = theirs(jnp.asarray(step), peak_lr=1e-3, warmup=10, total=100)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-7 * 1e-3, step
    # WSD is flat in the stable phase
    assert float(wsd_schedule(40, peak_lr=1e-3, warmup=10, total=100)) == \
        float(wsd_schedule(60, peak_lr=1e-3, warmup=10, total=100)) == \
        pytest.approx(1e-3)


def test_make_schedule_picks_wsd_for_minicpm_like_reference():
    for name in ("minicpm-2b", "repro-100m"):
        mine = make_schedule(get_arch(name, smoke=True))
        theirs = ref_make_schedule(ref_get_arch(name, smoke=True))
        assert mine.func.__name__ == theirs.func.__name__
        assert mine.keywords == theirs.keywords


# -------------------------------------------------------------- train step

@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_decayed_names_follow_the_reference_layout(name):
    """AdamW decays the leaves with ndim >= 2 in the reference's layout,
    which stacks the layers (``use_scan``): a layer's norm scales and SSM
    vectors decay there, the final norm does not."""
    cfg = ref_get_arch(name, smoke=True).replace(dtype="float32")
    abstract = jax.eval_shape(
        lambda: ref_init_params(jax.random.key(0), cfg, jnp.float32))
    marks = jax.tree.map(
        lambda a: np.full(a.shape, float(len(a.shape) >= 2), np.float32),
        abstract)
    named = dict(lm_params_from_reference(marks, _port_cfg(cfg))
                 .named_parameters())
    want = {k for k, p in named.items() if bool(p.flatten()[0])}
    assert decayed_names(named, _port_cfg(cfg)) == want
    assert any(k.endswith("mixer_norm") for k in want)
    assert "final_norm" not in want
    unstacked = _port_cfg(cfg.replace(use_scan=False))
    assert decayed_names(named, unstacked) == \
        {k for k, p in named.items() if p.ndim >= 2}


# a gradient element's float32 rounding, as a share of its leaf's largest
# element: the two packages' gradients from one state differ by at most
# 2.7e-6 of it on these configs (about 23 ulps); 1e-5 is about 84 ulps
GRAD_ROUNDING = 1e-5


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_train_steps_match_reference_from_shared_state(name):
    """Three steps at a real learning rate (cosine, warm-up 1, peak 1e-2),
    each from the reference's state after the step before: loss and grad
    norm to 1e-5 relative, lr equal, and every element's change ``p_after -
    p_before`` to 1e-3 of the reference's change.  On top of that, an
    element may differ by what a gradient rounding of ``GRAD_ROUNDING`` of
    its leaf's largest (clipped) gradient does through the reference's
    update at that element, ``lr (1 - b1) ρ max|g| / (c1 (sqrt(v̂) + eps))``:
    that matters only where the first moment is itself near rounding level
    (a sign the two packages may round either way); an element whose
    update is of order one, or a weight decay of ``lr·0.1·p``, lies orders
    above it."""
    b1, b2, eps = 0.9, 0.95, 1e-8              # the reference's defaults
    cfg = ref_get_arch(name, smoke=True).replace(dtype="float32")
    pcfg = _port_cfg(cfg)
    params = ref_init_params(jax.random.key(0), cfg, jnp.float32)
    opt = ref_adamw.adamw_init(params)
    kw = dict(peak_lr=1e-2, warmup=1, total=100)
    ref_step = jax.jit(ref_make_train_step(
        cfg, functools.partial(ref_adamw.cosine_schedule, **kw)))
    my_step = make_train_step(
        pcfg, functools.partial(cosine_schedule, **kw), device="cpu")
    ref_grad = jax.jit(jax.grad(lambda p, b: ref_lm_loss(p, b, cfg)))
    data = RefTokens(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                     seed=3, n_codebooks=cfg.n_codebooks)

    def port(tree):
        return lm_params_from_reference(jax.tree.map(np.asarray, tree), pcfg)

    for step in range(3):
        batch = {"tokens": jnp.asarray(data(step)["tokens"])}
        model = port(params)
        mine_opt = adamw_state_from_reference(jax.tree.map(np.asarray, opt),
                                              pcfg)
        before = port(params).state_dict()
        grads = port(ref_grad(params, batch)).state_dict()
        params, opt, rm = ref_step(params, opt, batch,
                                   jnp.asarray(step, jnp.int32))
        model, mine_opt, mm = my_step(model, mine_opt,
                                      {"tokens": data(step)["tokens"]}, step)
        assert _rel(mm["loss"], rm["loss"]) < 1e-5, step
        assert _rel(mm["grad_norm"], rm["grad_norm"]) < 1e-5, step
        assert float(mm["lr"]) == float(rm["lr"]), step
        assert int(mm["step"]) == int(rm["step"]) == step + 1
        lr, t = float(rm["lr"]), step + 1
        clip = min(1.0, 1.0 / float(rm["grad_norm"]))
        after = port(params).state_dict()
        v_hat = {k: v.double() / (1 - b2 ** t) for k, v in
                 adamw_state_from_reference(jax.tree.map(np.asarray, opt),
                                            pcfg).v.items()}
        for k, got in model.state_dict().items():
            mine_d = got.double() - before[k].double()
            want_d = after[k].double() - before[k].double()
            rounding = GRAD_ROUNDING * clip * float(grads[k].abs().max())
            allow = (lr * (1 - b1) * rounding
                     / ((1 - b1 ** t) * (v_hat[k].sqrt() + eps)))
            excess = (mine_d - want_d).abs() - (1e-3 * want_d.abs() + allow)
            assert float(excess.max()) <= 0, (step, k, float(excess.max()))
    assert not any(p.requires_grad for p in model.parameters())


# -------------------------------------------------------------------- data

@pytest.mark.parametrize("kw", [dict(vocab_size=100, seq_len=8,
                                     global_batch=4, seed=7),
                                dict(vocab_size=32_000, seq_len=512,
                                     global_batch=8, seed=0),
                                dict(vocab_size=50, seq_len=6,
                                     global_batch=2, seed=1, n_codebooks=4),
                                dict(vocab_size=50, seq_len=6,
                                     global_batch=2, seed=2,
                                     vision_tokens=3, d_model=5)])
def test_synthetic_tokens_equal_reference(kw):
    mine, theirs = SyntheticTokens(**kw), RefTokens(**kw)
    assert mine.batch_shape() == theirs.batch_shape()
    for step in (0, 3, 4, 1000):
        a, b = mine(step), theirs(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(mine(3)["tokens"], mine(4)["tokens"])


# ------------------------------------------------------------- checkpoints

def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor(3, dtype=torch.int32)}}
    for step in (1, 2, 3):
        mgr.save(step, {"a": tree["a"] + step,
                        "b": {"c": tree["b"]["c"] + step}})
    assert mgr.all_steps() == [2, 3]           # GC keeps last 2
    step, restored = mgr.restore_latest(tree)
    assert step == 3
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  tree["a"].numpy() + 3)
    assert restored["b"]["c"].dtype == torch.int32
    assert int(restored["b"]["c"]) == 6
    assert float(tree["a"][0, 0]) == 0.0       # ``like`` is left alone


def test_checkpoint_atomicity_orphan_cleanup(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    os.makedirs(tmp_path / "step_00000009.tmp")    # a crashed save
    mgr.save(1, {"x": torch.zeros(3)})
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    assert mgr.all_steps() == [1]
    assert mgr.restore_latest({"x": torch.zeros(3)})[0] == 1
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        {"x": torch.zeros(3)}) == (None, None)


def test_checkpoint_bf16_round_trip_is_bit_exact(tmp_path):
    cfg = get_arch("repro-100m", smoke=True).replace(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=64, dtype="bfloat16")
    params, opt = build_state(cfg, seed=5, device="cpu")
    tree = {"params": params.state_dict(), "opt": opt}
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(7, tree)
    manifest = (Path(path) / "manifest.json").read_text()
    assert '"bfloat16"' in manifest and "proc_0.npz" in os.listdir(path)
    fresh, fresh_opt = build_state(cfg, seed=6, device="cpu")
    step, got = mgr.restore_latest({"params": fresh.state_dict(),
                                    "opt": fresh_opt})
    assert step == 7
    for k, v in tree["params"].items():
        assert got["params"][k].dtype == v.dtype == torch.bfloat16
        assert torch.equal(got["params"][k].view(torch.int16),
                           v.view(torch.int16)), k
    assert type(got["opt"]) is type(opt)
    assert int(got["opt"].step) == 0 and got["opt"].step.dtype == torch.int32
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(7, {"params": {}, "opt": fresh_opt})


def test_checkpoint_keeps_the_float32_router_of_a_bf16_moe(tmp_path):
    """A bf16 MoE model's router is float32: it is stored as float32 (not
    as raw bf16 bits) and restored bit for bit, the experts as bf16."""
    cfg = get_arch("qwen2-moe-a2.7b", smoke=True).replace(dtype="bfloat16")
    params, opt = build_state(cfg, seed=5, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"params": params.state_dict(), "opt": opt})
    fresh, fresh_opt = build_state(cfg, seed=6, device="cpu")
    _, got = mgr.restore_latest({"params": fresh.state_dict(),
                                 "opt": fresh_opt})
    for k, v in params.state_dict().items():
        want = torch.float32 if k.endswith("router") else torch.bfloat16
        assert v.dtype == got["params"][k].dtype == want, k
        assert torch.equal(got["params"][k], v), k


# ------------------------------------------------------------- train()

def _tiny():
    return get_arch("repro-100m", smoke=True).replace(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
        vocab_size=256)


def test_loss_decreases():
    _, _, losses = train(_tiny(), steps=12, batch=4, seq=64, ckpt_dir=None,
                         resume=False, log_every=100, device="cpu")
    assert losses[-1] < losses[0]


def test_resume_reproduces_trajectory_bit_for_bit(tmp_path):
    cfg = _tiny()
    _, _, ref = train(cfg, steps=10, batch=2, seq=32, ckpt_dir=None,
                      resume=False, log_every=100, device="cpu")
    # run 6 steps with checkpoints, then resume to 10
    train(cfg, steps=6, batch=2, seq=32, ckpt_dir=str(tmp_path),
          resume=False, ckpt_every=3, log_every=100, device="cpu")
    _, _, resumed = train(cfg, steps=10, batch=2, seq=32,
                          ckpt_dir=str(tmp_path), resume=True, ckpt_every=3,
                          log_every=100, device="cpu")
    assert len(resumed) == 4
    np.testing.assert_allclose(ref[-len(resumed):], resumed, rtol=1e-6)
    assert ref[-len(resumed):] == resumed


def test_coded_training_matches_uncoded_with_dead_worker():
    cfg = _tiny()
    _, _, base = train(cfg, steps=6, batch=2, seq=32, ckpt_dir=None,
                       resume=False, log_every=100, device="cpu")
    _, _, coded = train(cfg.replace(coded_K=4), steps=6, batch=2, seq=32,
                        ckpt_dir=None, resume=False, coded=True,
                        dead_workers=1, coded_N=8, log_every=100,
                        device="cpu")
    np.testing.assert_allclose(base, coded, rtol=2e-3, atol=2e-3)


def test_simulated_failure_exits_42(tmp_path):
    with pytest.raises(SystemExit) as e:
        train(_tiny(), steps=5, batch=2, seq=16, ckpt_dir=str(tmp_path),
              resume=False, simulate_failure_at=2, ckpt_every=1,
              log_every=100, device="cpu")
    assert e.value.code == 42
    assert CheckpointManager(str(tmp_path)).all_steps() == [1, 2]


def test_cli_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu", "--smoke", "--steps", "3"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[train] step     2 loss" in out.stdout


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "llava-next-mistral-7b",
                                  "musicgen-large"])
def test_cli_trains_new_families_with_a_resume(name, tmp_path, capsys):
    """``--arch <family> --smoke`` on the CPU: 3 steps in one run, then 2
    with checkpoints and a resume to 3, which prints the same last loss."""
    args = ["--arch", name, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--seed", "1"]
    main(args + ["--steps", "3"])
    whole = capsys.readouterr().out
    main(args + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    main(args + ["--steps", "3", "--ckpt-dir", str(tmp_path), "--resume"])
    resumed = capsys.readouterr().out
    assert "[train] resumed from step 2" in resumed

    def loss(out, step):
        line = next(x for x in out.splitlines()
                    if x.startswith(f"[train] step {step:5d} loss"))
        return float(line.split()[4])
    assert np.isfinite(loss(whole, 0)) and np.isfinite(loss(whole, 2))
    assert loss(resumed, 2) == loss(whole, 2)


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--smoke", "--steps", "1"])
