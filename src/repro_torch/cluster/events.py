"""Completion events of the serving event stream.

The modeled backends unroll one latency draw into a time-ordered stream of
:class:`ShardEvent` elements — a completed shard carrying its product stack
(a tensor on the backend's device), or a lost shard that will never arrive.
The scheduler's single event loop consumes that stream.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["ShardEvent"]


@dataclass(frozen=True)
class ShardEvent:
    """One element of a completion stream.

    ``kind`` is ``"done"`` (``products`` holds the shard's ``(B, Nx, Ny)``
    stack over the batch) or ``"lost"`` (``reason`` says why).  ``t`` is
    seconds since the batch was dispatched.
    """

    kind: str                     # "done" | "lost"
    shard: int                    # encode-shard index (the code's worker id)
    t: float                      # seconds since dispatch
    worker: int                   # worker id that held the shard
    products: torch.Tensor | None = None   # (B, Nx, Ny) for "done"
    reason: str | None = None              # for "lost"
