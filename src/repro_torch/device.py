"""Device resolution for the port's entry points.

Every entry point runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``).  There is no capability probe and no fallback: asking
for CUDA where no card is present raises.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` / ``"cuda"`` → the CUDA card (raises without one); ``"cpu"``
    → the CPU.  A ``torch.device`` passes through the same checks."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         "'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev
