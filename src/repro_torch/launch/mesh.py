"""Production meshes, over the process group that is initialised.

Counterpart of the reference's ``launch/mesh.py``, with its shapes and axis
names, so the dry run's cells compare one to one with the reference's:
single pod ``(16, 16)`` over ``("data", "model")``, 256 ranks; multi-pod
``(2, 16, 16)`` over ``("pod", "data", "model")``, 512 ranks, with a
leading ``pod`` axis (pure data parallelism).  On H100s a rank is one card;
the dry run plans these meshes on a fake process group of 256 or 512
ranks.  Defined as functions, so importing this module touches no process
group.
"""
from __future__ import annotations

from ..compat import make_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda"):
    """A ``(data, model)`` mesh over however many ranks the initialised
    group has (``data · model`` of them) — tests and the card's checks."""
    return make_mesh((data, model), ("data", "model"), device_type)
