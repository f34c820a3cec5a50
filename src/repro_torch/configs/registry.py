"""Architecture registry of the port: ``get_arch(name, smoke)``.

Counterpart of the reference's ``configs/registry.py``.  The port runs the
dense, ssm and hybrid families; the configuration modules of those
architectures are copies of the reference's.  An architecture of another
family (MoE, vlm, audio) raises :class:`NotImplementedError` naming the
ROADMAP item that ports it, rather than half-running.
"""
from __future__ import annotations

from . import (falcon_mamba_7b, gemma_2b, hymba_1_5b, minicpm_2b,
               qwen15_32b, qwen25_3b, repro_100m)
from .base import SHAPES, ArchConfig, ShapeSpec

__all__ = ["ARCH_NAMES", "PORTED_FAMILIES", "get_arch", "get_shape",
           "check_family"]

PORTED_FAMILIES = ("dense", "ssm", "hybrid")

_MODULES = {
    "repro-100m": repro_100m,
    "falcon-mamba-7b": falcon_mamba_7b,
    "gemma-2b": gemma_2b,
    "qwen1.5-32b": qwen15_32b,
    "qwen2.5-3b": qwen25_3b,
    "minicpm-2b": minicpm_2b,
    "hymba-1.5b": hymba_1_5b,
}

# the reference's other architectures, by family, until a slice ports them
_NOT_PORTED = {
    "kimi-k2-1t-a32b": "moe",
    "qwen2-moe-a2.7b": "moe",
    "llava-next-mistral-7b": "vlm",
    "musicgen-large": "audio",
}

ARCH_NAMES = tuple(a for a in _MODULES if a != "repro-100m")


def check_family(cfg: ArchConfig) -> None:
    """Raise unless the port runs ``cfg``'s family (dense, ssm, hybrid)."""
    if cfg.family not in PORTED_FAMILIES or cfg.has_moe:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(ROADMAP Queue A, A12: MoE blocks and the vlm / audio "
            "embeddings); the port runs " + ", ".join(PORTED_FAMILIES))


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is of the {_NOT_PORTED[name]!r} family, which "
            "is not ported yet (ROADMAP Queue A, A12)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCH_NAMES)}")
    return _MODULES[name].SMOKE if smoke else _MODULES[name].CONFIG


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]
