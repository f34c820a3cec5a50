"""What an LM driver needs: the program's configuration built from the
configuration file, its model holding the weights the benchmark made, and
the token batches drawn from the seed."""
from __future__ import annotations

import torch

from h100bench import core, weights

ARCH_KEYS = ("name", "family", "n_layers", "d_model", "n_heads",
             "n_kv_heads", "d_ff", "vocab_size", "head_dim", "ssm_state",
             "d_inner", "ssm_conv", "dt_rank", "sliding_window", "norm_eps",
             "rope_theta", "dtype")


def arch(cfg: dict):
    """The program's ``ArchConfig`` from the file's numbers; raises unless
    the sizes the program derives from them are the file's."""
    from repro_torch.configs.base import ArchConfig
    a = ArchConfig(**{k: cfg[k] for k in ARCH_KEYS},
                   global_attn_layers=tuple(cfg["global_attn_layers"]))
    derived = {"padded_vocab": a.padded_vocab(), "dt_rank":
               a.resolved_dt_rank, "d_inner": a.resolved_d_inner,
               "head_dim": a.resolved_head_dim}
    bad = {k: (v, cfg[k]) for k, v in derived.items() if v != cfg[k]}
    if bad:
        raise ValueError(f"the program derives other sizes: {bad}")
    return a


def make_weights(cfg: dict, seed: int, device) -> dict:
    ref = core.reference(cfg["name"])
    return weights.make(ref.leaves(cfg), cfg["init"], seed, device)


def model(cfg: dict, seed: int, device):
    """The program's LM with the benchmark's weights for ``seed``."""
    from repro_torch.models.lm import LM
    a = arch(cfg)
    m = LM(a, dtype=getattr(torch, cfg["dtype"]), device=device)
    W = make_weights(cfg, seed, device)
    named = dict(m.named_parameters())
    if set(named) != set(W) or any(named[k].shape != W[k].shape
                                   or named[k].dtype != W[k].dtype
                                   for k in W):
        raise ValueError("the program's parameters are not the "
                         "configuration's leaves")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(W[k])
    return a, m


def tokens(seed: int, index: int, rows: int, length: int, vocab: int,
           device) -> torch.Tensor:
    """Batch ``index`` of the run: uniform token ids, drawn on the device
    by a generator seeded from the seed and the index."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(index)) % (1 << 63))
    return torch.randint(0, vocab, (rows, length), generator=gen,
                         device=device, dtype=torch.long)
