"""The port's LM serving path against the reference, on the CPU.

The reference's weights (``init_params(jax.random.key(0), cfg,
jnp.float32)``) cross over with ``lm_params_from_reference``; tokens are
drawn with numpy from a seed and fed to both packages.  Tolerances are the
reference's own (``tests/test_models.py``): 2e-4 for full-sequence logits,
prefill logits and the decode state, 2e-3 for decode-step logits.  On the
CPU the kernels' wrappers run their plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import ArchConfig
from repro.models import compute_logits as ref_compute_logits
from repro.models.lm import abstract_params as ref_abstract_params
from repro.models import decode_step as ref_decode_step
from repro.models import embed_tokens as ref_embed_tokens
from repro.models import forward_hidden as ref_forward_hidden
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro_torch.configs import (ARCH_NAMES, PORTED_FAMILIES, check_family,
                                 get_arch)
from repro_torch.configs.base import ArchConfig as PortArchConfig
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import (LM, compute_logits, decode_step,
                                embed_tokens, forward_hidden, init_params,
                                prefill)
from repro_torch.runtime.steps import make_decode_step, make_prefill_step

DENSE = ArchConfig("dense-s", "dense", 3, 64, 4, 2, 128, 97, qkv_bias=True,
                   dtype="float32")
SSM = ArchConfig("ssm-s", "ssm", 2, 64, 0, 0, 128, 97, ssm_state=4,
                 d_inner=128, pos_embed="none", dtype="float32")
HYB = ArchConfig("hyb-s", "hybrid", 3, 64, 4, 2, 128, 97, ssm_state=4,
                 d_inner=128, sliding_window=8, global_attn_layers=(1,),
                 dtype="float32")
HYMBA = ref_get_arch("hymba-1.5b", smoke=True)
# the MoE, vlm and audio families' smoke configs
NEW = [ref_get_arch(n, smoke=True) for n in (
    "qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "llava-next-mistral-7b",
    "musicgen-large")]
# the dense and ssm families' smoke configs (minicpm-smoke's head dim is 18)
DENSE_SSM = [ref_get_arch(n, smoke=True) for n in (
    "gemma-2b", "qwen2.5-3b", "minicpm-2b", "falcon-mamba-7b",
    "qwen1.5-32b")]
CONFIGS = [DENSE, SSM, HYB, HYMBA] + NEW + DENSE_SSM


def _port_cfg(cfg):
    """The same configuration as the port's own ArchConfig."""
    return PortArchConfig(**dataclasses.asdict(cfg))


def _models(cfg):
    params = ref_init_params(jax.random.key(0), cfg, jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return params, lm_params_from_reference(tree, _port_cfg(cfg))


def _tokens(cfg, B=2, L=12, seed=0):
    """(B, L) tokens — (B, L, n_cb) for audio."""
    shape = (B, L, cfg.n_codebooks) if cfg.n_codebooks else (B, L)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _ref_full_logits(params, tokens, cfg):
    x = ref_embed_tokens(params, tokens, cfg)
    B, L = tokens.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(L)[None], (B, L))
    h, _ = ref_forward_hidden(params, x, cfg, pos)
    if cfg.n_codebooks:
        return np.stack([np.asarray(ref_compute_logits(params, h, cfg, c))
                         for c in range(cfg.n_codebooks)], axis=2)
    return np.asarray(ref_compute_logits(params, h, cfg))


def _full_logits(model, tokens, cfg):
    tokens = torch.as_tensor(tokens)
    B, L = tokens.shape[:2]
    pos = torch.arange(L)[None].expand(B, L)
    h, _ = forward_hidden(model, embed_tokens(model, tokens, cfg), cfg, pos)
    if cfg.n_codebooks:
        return torch.stack([compute_logits(model, h, cfg, c)
                            for c in range(cfg.n_codebooks)], 2).numpy()
    return compute_logits(model, h, cfg).numpy()


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_forward_logits_match_reference(cfg):
    params, model = _models(cfg)
    tokens = _tokens(cfg)
    _close(_full_logits(model, tokens, _port_cfg(cfg)),
           _ref_full_logits(params, jnp.asarray(tokens), cfg), 2e-4)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_prefill_and_decode_match_reference(cfg):
    """Prefill logits and decode state (KV caches, conv tail, f32 ssm_h) to
    2e-4, then each decode step's logits to 2e-3, against the reference
    run on the same weights and tokens."""
    params, model = _models(cfg)
    pcfg = _port_cfg(cfg)
    B, L, n = 2, 12, 8
    tokens = _tokens(cfg, B, L, seed=1)
    jt = jnp.asarray(tokens)
    want_logits, want = ref_prefill(params, jt[:, :n], cfg, max_seq=L)
    got_logits, got = prefill(model, torch.as_tensor(tokens[:, :n]), pcfg,
                              max_seq=L)
    _close(got_logits, want_logits, 2e-4)
    assert got.pos == int(want.pos) == n
    for name in ("kv_k", "kv_v", "conv", "ssm_h"):
        w, g = getattr(want, name), getattr(got, name)
        if isinstance(w, tuple):
            assert g == ()
            continue
        assert tuple(g.shape) == w.shape, name
        _close(g.float(), np.asarray(w, np.float32), 2e-4)
    assert not cfg.has_ssm or got.ssm_h.dtype == torch.float32
    for t in range(n, L):
        want_logits, want = ref_decode_step(params, jt[:, t:t + 1], want, cfg)
        got_logits, got = decode_step(model, torch.as_tensor(
            tokens[:, t:t + 1]), got, pcfg)
        _close(got_logits, want_logits, 2e-3)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_prefill_plus_decode_matches_own_forward(cfg):
    """The port's prefill(t<n) + decode(t>=n) equals its own full forward
    (the reference's test_prefill_plus_decode_matches_forward).  An MoE
    config runs drop-free here (capacity factor E / k): its capacity
    follows the number of tokens in a call, so with drops a prefill of n
    tokens and a forward of L route differently by design."""
    if cfg.has_moe:
        cfg = cfg.replace(capacity_factor=cfg.n_experts /
                          cfg.experts_per_token)
    _, model = _models(cfg)
    pcfg = _port_cfg(cfg)
    B, L, n = 2, 12, 8
    tokens = _tokens(cfg, B, L, seed=2)
    full = _full_logits(model, tokens, pcfg)
    logits, state = prefill(model, torch.as_tensor(tokens[:, :n]), pcfg,
                            max_seq=L)
    _close(logits[:, 0], full[:, n - 1], 2e-4)
    for t in range(n, L):
        logits, state = decode_step(model, torch.as_tensor(
            tokens[:, t:t + 1]), state, pcfg)
        _close(logits[:, 0], full[:, t], 2e-3)


def test_sliding_window_ring_buffer_decode():
    """Window-only arch: a ring-buffer cache of the window decodes as the
    full forward does (the reference's ring-buffer test)."""
    cfg = PortArchConfig("swa", "dense", 2, 64, 4, 2, 128, 97,
                         sliding_window=6, dtype="float32")
    gen = torch.Generator().manual_seed(1)
    model = init_params(cfg, device="cpu", generator=gen)
    B, L = 1, 16
    tokens = np.random.default_rng(3).integers(0, 97, (B, L))
    full = _full_logits(model, tokens, cfg)
    _, state = prefill(model, torch.as_tensor(tokens[:, :4]), cfg,
                       max_seq=cfg.sliding_window)
    assert state.kv_k.shape[3] == cfg.sliding_window     # window-sized cache
    for t in range(4, L):
        logits, state = decode_step(model, torch.as_tensor(
            tokens[:, t:t + 1]), state, cfg)
        _close(logits[:, 0], full[:, t], 2e-3)


def test_ring_buffer_prefill_longer_than_window():
    """A prompt longer than the ring cache keeps its last window, rolled so
    slot = position mod window, and decodes on as the full forward."""
    cfg = PortArchConfig("swa", "dense", 2, 64, 4, 2, 128, 97,
                         sliding_window=6, dtype="float32")
    model = init_params(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    tokens = np.random.default_rng(4).integers(0, 97, (2, 14))
    full = _full_logits(model, tokens, cfg)
    _, state = prefill(model, torch.as_tensor(tokens[:, :9]), cfg,
                       max_seq=6)
    for t in range(9, 14):
        logits, state = decode_step(model, torch.as_tensor(
            tokens[:, t:t + 1]), state, cfg)
        _close(logits[:, 0], full[:, t], 2e-3)


def test_steps_match_functions_and_take_numpy_tokens():
    _, model = _models(HYMBA)
    cfg = _port_cfg(HYMBA)
    tokens = _tokens(HYMBA, 2, 10, seed=5)
    logits, state = make_prefill_step(cfg, 12, device="cpu")(
        model, {"tokens": tokens[:, :9]})
    want, want_state = prefill(model, torch.as_tensor(tokens[:, :9]), cfg,
                               max_seq=12)
    torch.testing.assert_close(logits, want)
    step = make_decode_step(cfg, device="cpu")
    logits, state = step(model, tokens[:, 9:], state)
    want, _ = decode_step(model, torch.as_tensor(tokens[:, 9:]), want_state,
                          cfg)
    torch.testing.assert_close(logits, want)
    assert state.pos == 10


def _ref_keys(cfg) -> set:
    """The reference tree's leaves as the port's ``state_dict`` names."""
    params = ref_abstract_params(cfg, jnp.float32)
    keys = set()
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [p.key for p in path]
        if names[0] == "layers":
            keys.update(f"layers.{i}." + ".".join(names[1:])
                        for i in range(cfg.n_layers))
        else:
            keys.add(".".join(names))
    return keys


def test_state_dict_keys_follow_the_reference_tree():
    model = init_params(_port_cfg(HYB), device="cpu")
    assert set(model.state_dict()) == _ref_keys(HYB)


@pytest.mark.parametrize("cfg", [NEW[0], NEW[3]], ids=lambda c: c.name)
def test_state_dict_keys_follow_the_reference_tree_moe_audio(cfg):
    """An MoE layer's ``moe.{router, w_*, shared.w_*}`` and the audio
    family's per-codebook ``embed`` and ``lm_head``, with the reference's
    shapes and the router in float32 (as the reference's tree)."""
    model = init_params(_port_cfg(cfg), device="cpu")
    assert set(model.state_dict()) == _ref_keys(cfg)
    ref = ref_abstract_params(cfg, jnp.float32)
    assert tuple(model.embed.shape) == ref["embed"].shape
    if cfg.n_codebooks:
        assert tuple(model.lm_head.shape) == ref["lm_head"].shape == (
            cfg.n_codebooks, cfg.d_model, cfg.padded_vocab())
    else:
        assert "layers.1.moe.shared.w_down" in model.state_dict()
        assert ref["layers"]["moe"]["router"].dtype == jnp.float32
        assert model.layers[1].moe["router"].dtype == torch.float32


def test_converter_takes_per_layer_lists():
    """``use_scan=False`` trees hold a list of per-layer dicts."""
    cfg = HYB.replace(use_scan=False)
    params = ref_init_params(jax.random.key(0), cfg, jnp.float32)
    assert isinstance(params["layers"], list)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params),
                                     _port_cfg(cfg))
    np.testing.assert_array_equal(model.layers[2].ssm["x_proj"].numpy(),
                                  np.asarray(params["layers"][2]["ssm"]
                                             ["x_proj"]))


@pytest.mark.parametrize("name", ARCH_NAMES + ("repro-100m",))
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_are_the_references(name, smoke):
    """The port's configs are the reference's, and its LM holds the
    reference tree's shapes (both built abstractly: no memory)."""
    cfg = get_arch(name, smoke)
    ref_cfg = ref_get_arch(name, smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    model = LM(cfg, dtype=torch.bfloat16, device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ref = ref_abstract_params(ref_cfg)
    want = {"embed": ref["embed"].shape, "final_norm": ref["final_norm"].shape}
    if "lm_head" in ref:
        want["lm_head"] = ref["lm_head"].shape
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref["layers"])[0]:
        sub = ".".join(p.key for p in path)
        want.update({f"layers.{i}.{sub}": leaf.shape[1:]
                     for i in range(cfg.n_layers)})
    assert shapes == want


def test_hymba_full_width_shape():
    cfg = get_arch("hymba-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.resolved_d_inner, cfg.ssm_state,
            cfg.padded_vocab()) == (32, 1600, 25, 5, 64, 3200, 16, 32016)
    assert cfg.param_count() == 1_662_003_200
    # the analytic count leaves out final_norm, conv_b and dt_bias
    model = LM(cfg, dtype=torch.bfloat16, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 1_662_209_600


# The full-width serves on one 80 GB card: (batch, prompt + decode steps)
# and the bf16 weights and KV cache in GiB that the plan was made with.
# 75 GiB is the card's 79.6 GiB less 4.6 GiB for the CUDA context and the
# activations.
SERVED_CUTS = {"gemma-2b": (4, 8192 + 32, 4.67, 0.56),
               "qwen2.5-3b": (4, 8192 + 32, 6.33, 1.13),
               "minicpm-2b": (4, 8192 + 32, 5.08, 11.29),
               "falcon-mamba-7b": (4, 8192 + 32, 13.56, 0.0),
               "llava-next-mistral-7b": (4, 8192 + 32, 13.49, 4.02),
               "qwen1.5-32b": (1, 2048 + 16, 65.56, 2.52)}
CARD_PLAN_GIB = 75.0


@pytest.mark.parametrize("name", list(SERVED_CUTS))
def test_full_width_serve_fits_the_card(name, monkeypatch):
    """Weights plus the decode state of each full-width serve, built on the
    meta device (no memory): under CARD_PLAN_GIB, and the weights and KV
    cache the plan's figures to 1 %."""
    from repro_torch.models import lm as lm_mod
    monkeypatch.setattr(lm_mod, "resolve_device", torch.device)
    batch, max_seq, w_gib, kv_gib = SERVED_CUTS[name]
    cfg = get_arch(name)
    model = LM(cfg, dtype=torch.bfloat16, device="meta")
    state = lm_mod.init_decode_state(cfg, batch, max_seq, device="meta")

    def gib(ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor)) / 2 ** 30
    weights, kv = gib(model.parameters()), gib((state.kv_k, state.kv_v))
    total = weights + kv + gib((state.conv, state.ssm_h))
    assert total < CARD_PLAN_GIB
    assert weights == pytest.approx(w_gib, rel=1e-2)
    assert kv == pytest.approx(kv_gib, rel=1e-2)
    assert (kv == 0) == (not cfg.has_attention)


def test_init_params_distributions_and_seed():
    cfg = get_arch("hymba-1.5b", smoke=True)
    a = init_params(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    b = init_params(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    p = a.layers[0].ssm
    assert p["A_log"].dtype == p["D"].dtype == torch.float32
    torch.testing.assert_close(p["A_log"][5], torch.log(torch.arange(
        1.0, cfg.ssm_state + 1)))
    assert torch.all(p["dt_bias"] == -4.6) and torch.all(p["D"] == 1)
    assert torch.all(a.layers[1].mixer_norm == 1)
    wq = a.layers[0].attn["wq"]
    want_std = (2.0 / sum(wq.shape)) ** 0.5
    assert abs(float(wq.std()) / want_std - 1) < 0.1


def test_registry_resolves_every_reference_arch_and_no_other():
    """All eleven architectures resolve, full and smoke, and their
    families pass ``check_family``; an unknown name or family raises."""
    for name in ARCH_NAMES + ("repro-100m",):
        for smoke in (False, True):
            check_family(get_arch(name, smoke))
    assert {get_arch(n).family for n in ARCH_NAMES} == set(PORTED_FAMILIES)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    with pytest.raises(ValueError, match="unknown family"):
        init_params(get_arch("qwen2-moe-a2.7b", smoke=True).replace(
            family="vision"), device="cpu")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_a_card_raise(no_card):
    cfg = get_arch("hymba-1.5b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_decode_step(cfg)
    model = init_params(cfg, device="cpu")
    logits, state = make_prefill_step(cfg, 8, device="cpu")(
        model, {"tokens": np.zeros((1, 4), np.int64)})
    assert logits.shape == (1, 1, cfg.padded_vocab())
    assert make_decode_step(cfg, device="cpu")(
        model, np.zeros((1, 1), np.int64), state)[1].pos == 5


def test_step_refuses_parameters_on_another_device():
    cfg = get_arch("hymba-1.5b", smoke=True)
    model = LM(cfg, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="parameters on meta"):
        make_prefill_step(cfg, device="cpu")(model,
                                             {"tokens": np.zeros((1, 2))})


def test_decode_past_a_full_cache_raises():
    cfg = get_arch("hymba-1.5b", smoke=True)
    model = init_params(cfg, device="cpu")
    _, state = prefill(model, torch.zeros((1, 4), dtype=torch.long), cfg)
    with pytest.raises(ValueError, match="cache holds 4"):
        decode_step(model, torch.zeros((1, 1), dtype=torch.long), state, cfg)
