"""The port's MoE block against the reference's, on the CPU.

Expert weights (at the reference's ``init_moe_params`` scales) and tokens
are drawn with numpy from a seed and fed to both packages.  Tolerances:
the block's output to 2e-4 (the reference's model tolerance for float32
logits) and its load-balance loss to 1e-6, drop-free and with capacity
overflowing; against the port's own drop-free oracle ``moe_ref`` to 1e-5
(the reference's ``test_moe_block_matches_oracle_high_capacity``).  In
bf16 the router product is float32 in both packages, so the routing is
the same and the outputs agree to bf16 rounding (2e-2 relative
Frobenius).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import ArchConfig
from repro.models import forward_hidden
from repro.models import init_params as ref_init_params
from repro.models.moe import _top_k_gates as ref_top_k_gates
from repro.models.moe import moe_block
from repro.models.moe import router_aux_loss as ref_router_aux_loss
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig as PortArchConfig
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import LM, init_params
from repro_torch.models import forward_hidden as port_forward_hidden
from repro_torch.models.moe import (_router_logits, _top_k_gates, capacity,
                                    moe_ref, router_aux_loss)
from repro_torch.models.moe import moe_block as port_moe_block

# the reference jitted (one compile per shape, not one per operation)
ref_moe_block = jax.jit(moe_block, static_argnums=2)
ref_forward_hidden = jax.jit(forward_hidden, static_argnums=2)


def _cfg(capacity_factor, n_shared):
    return ArchConfig("m", "moe", 1, 32, 2, 2, 0, 97, n_experts=4,
                      experts_per_token=2, d_ff_expert=16,
                      n_shared_experts=n_shared,
                      capacity_factor=capacity_factor, dtype="float32")


def _port_cfg(cfg):
    return PortArchConfig(**dataclasses.asdict(cfg))


def _weights(cfg, seed):
    """An MoE layer's weights drawn with numpy at the reference's scales
    (``init_moe_params``), float32."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

    def normal(*shape, std=None):
        std = std or (2.0 / (shape[-2] + shape[-1])) ** 0.5
        return (std * rng.standard_normal(shape)).astype(np.float32)

    sg = (2.0 / (d + f)) ** 0.5
    p = {"router": normal(d, E), "w_gate": normal(E, d, f, std=sg),
         "w_up": normal(E, d, f, std=sg), "w_down": normal(E, f, d, std=sg)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": normal(d, fs), "w_up": normal(d, fs),
                       "w_down": normal(fs, d)}
    return p


def _cast(p, to, dtype):
    """The tree with every leaf ``to(leaf, dtype)``, the router float32."""
    return {k: _cast(v, to, dtype) if isinstance(v, dict) else
            to(v, "float32" if k == "router" else dtype)
            for k, v in p.items()}


def _ref(p, dtype="float32"):
    return _cast(p, lambda v, dt: jnp.asarray(v, getattr(jnp, dt)), dtype)


def _port(p, dtype="float32"):
    return _cast(p, lambda v, dt: torch.from_numpy(v).to(getattr(torch, dt)),
                 dtype)


def _dropped(p, x, cfg) -> int:
    """Assignments past their expert's capacity, by the reference's
    routing."""
    _, ids, _ = ref_top_k_gates(jnp.asarray(x @ p["router"]),
                                cfg.experts_per_token)
    counts = np.bincount(np.asarray(ids).ravel(), minlength=cfg.n_experts)
    C = capacity(_port_cfg(cfg), x.shape[0])
    return int(np.maximum(counts - C, 0).sum())


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("capacity_factor,T,drops", [(8.0, 40, False),
                                                     (0.1, 64, True),
                                                     (0.5, 37, True)])
def test_moe_block_matches_reference(capacity_factor, T, drops, n_shared):
    """Output to 2e-4 and aux loss to 1e-6, drop-free and with capacity
    overflowing (``tests/test_models.py``'s capacity factors 8.0 and 0.1,
    and a T that is not a multiple of anything): which tokens a full
    expert drops follows the stable sort in both packages."""
    cfg = _cfg(capacity_factor, n_shared)
    p = _weights(cfg, 0)
    x = np.random.default_rng(T).standard_normal((T, 32)).astype(np.float32)
    assert (_dropped(p, x, cfg) > 0) == drops
    want, want_aux = ref_moe_block(_ref(p), jnp.asarray(x), cfg)
    got, aux = port_moe_block(_port(p), torch.from_numpy(x), _port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    assert np.all(np.isfinite(got.numpy()))


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_block_matches_own_oracle_when_drop_free(n_shared):
    cfg = _port_cfg(_cfg(8.0, n_shared))
    p = _port(_weights(cfg, 1))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (40, 32)).astype(np.float32))
    out, aux = port_moe_block(p, x, cfg)
    torch.testing.assert_close(out, moe_ref(p, x, cfg), rtol=1e-5,
                               atol=1e-5)
    assert float(aux) >= 1.0 - 1e-6                       # E·Σf·P >= 1


def test_moe_block_bf16_routes_in_float32_like_reference():
    """bf16 activations and expert weights, float32 router: the same
    experts are picked as by the reference in bf16, and the outputs agree
    to bf16 rounding."""
    cfg = _cfg(8.0, 2)
    p = _weights(cfg, 2)
    x = np.random.default_rng(6).standard_normal((48, 32)).astype(np.float32)
    rp, xr = _ref(p, "bfloat16"), jnp.asarray(x, jnp.bfloat16)
    pp, xp = _port(p, "bfloat16"), torch.from_numpy(x).to(torch.bfloat16)
    _, want_ids, _ = ref_top_k_gates(xr @ rp["router"], 2)
    _, ids, _ = _top_k_gates(_router_logits(pp, xp), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    want, want_aux = ref_moe_block(rp, xr, cfg)
    got, aux = port_moe_block(pp, xp, _port_cfg(cfg))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < 2e-2
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("T", [1, 4, 37, 2048, 32768])
def test_capacity_rule(T):
    """C = round_up(max(8, int(cf·k·T/E)), 8): qwen2-moe-a2.7b's 2736 at
    4 x 8192 tokens, 176 at 2048, 8 in a decode step."""
    cfg = get_arch("qwen2-moe-a2.7b")
    want = {1: 8, 4: 8, 37: 8, 2048: 176, 32768: 2736}[T]
    assert capacity(cfg, T) == want
    c = int(cfg.capacity_factor * cfg.experts_per_token * T / cfg.n_experts)
    assert want == -(-max(8, c) // 8) * 8


def test_router_aux_loss_matches_reference():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((50, 6)).astype(np.float32) * 3
    ids = np.argsort(-logits, axis=1)[:, :2]
    want = ref_router_aux_loss(jnp.asarray(logits), jnp.asarray(ids), 6, 2)
    got = router_aux_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                          6, 2)
    assert abs(float(got) - float(want)) <= 1e-6


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"])
def test_forward_hidden_aux_is_the_reference_mean_over_layers(name):
    cfg = ref_get_arch(name, smoke=True)
    params = jax.jit(ref_init_params, static_argnums=(1, 2))(
        jax.random.key(0), cfg, jnp.float32)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params),
                                     _port_cfg(cfg))
    x = np.random.default_rng(8).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10)[None], (2, 10))
    want_h, want_aux = ref_forward_hidden(params, jnp.asarray(x), cfg,
                                          jnp.asarray(pos))
    h, aux = port_forward_hidden(model, torch.from_numpy(x), _port_cfg(cfg),
                            torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=2e-4,
                               atol=2e-4)
    assert float(want_aux) >= 1.0 - 1e-6
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_bf16_lm_keeps_the_router_in_float32():
    cfg = get_arch("qwen2-moe-a2.7b", smoke=True)
    model = init_params(cfg, device="cpu", dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        want = torch.float32 if name.endswith("router") else torch.bfloat16
        assert p.dtype == want, name
    moe = model.layers[0].moe
    assert set(moe) == {"router", "w_gate", "w_up", "w_down", "shared"}
    # the reference's distributions: init_dense router, sqrt(2/(d+f)) experts
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    for w, std in ((moe["router"], (2 / (d + E)) ** 0.5),
                   (moe["w_up"], (2 / (d + f)) ** 0.5),
                   (moe["shared"]["w_down"],
                    (2 / (d + f * cfg.n_shared_experts)) ** 0.5)):
        assert abs(float(w.float().std()) / std - 1) < 0.1
    full = LM(get_arch("qwen2-moe-a2.7b"), dtype=torch.bfloat16,
              device="meta")
    assert full.layers[5].moe["router"].dtype == torch.float32
