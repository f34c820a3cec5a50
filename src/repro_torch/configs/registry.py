"""Architecture registry of the port: ``get_arch(name, smoke)`` and the
paper's §V job (``PAPER_JOB``).

Counterpart of the reference's ``configs/registry.py``: the same eleven
architectures, whose configuration modules are copies of the reference's,
in all six families (dense, moe, ssm, hybrid, vlm, audio).
:func:`check_family` raises only for a family string the reference does
not know.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import (falcon_mamba_7b, gemma_2b, hymba_1_5b, kimi_k2_1t_a32b,
               llava_next_mistral_7b, minicpm_2b, musicgen_large,
               qwen15_32b, qwen25_3b, qwen2_moe_a27b, repro_100m)
from .base import SHAPES, ArchConfig, ShapeSpec

__all__ = ["ARCH_NAMES", "PORTED_FAMILIES", "PAPER_JOB", "PaperJobConfig",
           "get_arch", "get_shape", "check_family", "cells"]

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

_MODULES = {
    "repro-100m": repro_100m,
    "falcon-mamba-7b": falcon_mamba_7b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "gemma-2b": gemma_2b,
    "qwen1.5-32b": qwen15_32b,
    "qwen2.5-3b": qwen25_3b,
    "minicpm-2b": minicpm_2b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "hymba-1.5b": hymba_1_5b,
    "musicgen-large": musicgen_large,
}

# the 10 ASSIGNED architectures (the dry-run grid); extras like repro-100m
# resolve via get_arch but are not part of the assignment cells
ARCH_NAMES = tuple(a for a in _MODULES if a != "repro-100m")


def check_family(cfg: ArchConfig) -> None:
    """Raise unless ``cfg.family`` is one of the reference's families."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         "known: " + ", ".join(PORTED_FAMILIES))


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCH_NAMES)}")
    return _MODULES[name].SMOKE if smoke else _MODULES[name].CONFIG


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def cells(include_skips: bool = False):
    """All assigned (arch × shape) cells (the reference's dry-run grid).

    ``long_500k`` runs only for sub-quadratic archs (SSM / hybrid); pure
    full-attention archs are skipped.  Decode shapes run for every arch.
    """
    out = []
    for a in ARCH_NAMES:
        cfg = get_arch(a)
        for s, spec in SHAPES.items():
            skip = (s == "long_500k" and not cfg.sub_quadratic)
            if skip and not include_skips:
                continue
            out.append((a, s, "skip:full-attention" if skip else "run"))
    return out


# --------------------------------------------------------- paper's workload

@dataclass(frozen=True)
class PaperJobConfig:
    """The paper's §V experiment: 100×8000 @ 8000×100 over N=24 workers."""
    Nx: int = 100
    Nz: int = 8000
    Ny: int = 100
    K: int = 8
    N: int = 24
    trials: int = 100
    eps_complex: float = 0.1        # Fig 3a X_complex magnitude


PAPER_JOB = PaperJobConfig()
