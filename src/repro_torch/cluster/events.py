"""Completion events and record/replay traces of the serving event stream.

The modeled backends unroll one latency draw into a time-ordered stream of
:class:`ShardEvent` elements; the cluster runtime replaces the draw with
measured events — each worker's product arrives on the master's result
stream and is timestamped on arrival — but keeps the stream contract
identical: events are strictly ordered in time, deadline ticks fire after
any completion sharing their timestamp, and the estimate a client reads at
``t`` includes every shard that completed by ``t``.

:class:`ShardEvent` is one element of that stream (a completed shard
carrying its product stack as a tensor on the backend's device, a lost
shard, or a speculative re-dispatch).  :class:`TraceRecording` captures the
measured per-shard completion times of every dispatched batch so a cluster
run can be *replayed* through the simulated backend: same products, same
completion times, bit-identical decode outputs.  Its JSON format is the
reference's, so a trace saved by one package loads in the other.

This module is imported by the worker processes' package, so torch is only
named in annotations here: a numpy-compute worker never imports it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:                                  # pragma: no cover
    import torch

__all__ = ["ShardEvent", "BatchRecord", "TraceRecording"]


@dataclass(frozen=True)
class ShardEvent:
    """One element of a completion stream.

    ``kind`` is ``"done"`` (``products`` holds the shard's ``(B, Nx, Ny)``
    stack over the batch), ``"lost"`` (``reason``: ``"crash"`` — the
    worker process died, ``"timeout"`` — the shard was abandoned past the
    hang deadline, ``"dispatch"`` — the task could not be delivered,
    ``"missing"`` — a modeled non-finite time), or ``"redispatch"`` — the
    shard was sent to an *additional* worker mid-batch (``reason``:
    ``"hedge"`` — the speculation policy fired, ``"crash"`` — a crashed
    primary's shard was re-queued, ``"replicate"`` — up-front pinned
    replication).  ``t`` is seconds since the batch was dispatched, strictly
    increasing within a live batch so replayed event order is exactly
    arrival order.  ``speculative`` marks ``done`` events won by a
    speculative copy rather than the original dispatchee.
    """

    kind: str                     # "done" | "lost" | "redispatch"
    shard: int                    # encode-shard index (the code's worker id)
    t: float                      # seconds since dispatch
    worker: int                   # worker id that held the shard
    products: torch.Tensor | None = None   # (B, Nx, Ny) for "done"
    reason: str | None = None              # for "lost" / "redispatch"
    speculative: bool = False              # "done": a speculative copy won
    timings: tuple | None = None           # "done": worker-side monotonic
    #   deltas (wait, operand_resolve, compute) — span metadata, never
    #   recorded into BatchRecord, so replay stays bit-identical


@dataclass
class BatchRecord:
    """Measured completion process of one dispatched batch.

    ``redispatches`` is speculative-execution metadata (``[shard, reason]``
    pairs in trigger order) — bookkeeping only.  Replay needs just the
    final per-shard ``times``/``lost`` outcome (whoever won, the shard
    completed exactly once at the recorded instant), which is what keeps a
    speculative trace replaying bit-identically.
    """

    n_shards: int
    times: dict[int, float] = field(default_factory=dict)   # shard -> t
    lost: dict[int, str] = field(default_factory=dict)      # shard -> reason
    redispatches: list = field(default_factory=list)        # [shard, reason]

    def latency_row(self) -> np.ndarray:
        """Per-shard completion times; lost shards never complete (``inf``).

        This is exactly the row a ``draw_latencies`` replay hands the
        event loop: the synthetic dispatch sorts the finite times into the
        measured arrival order (times are strictly increasing at the
        recorder) and pushes the ``inf`` entries past every deadline.
        """
        row = np.full(self.n_shards, np.inf)
        for shard, t in self.times.items():
            row[int(shard)] = float(t)
        return row

    def to_dict(self) -> dict:
        out = {"n_shards": int(self.n_shards),
               "times": {str(k): float(v) for k, v in self.times.items()},
               "lost": {str(k): str(v) for k, v in self.lost.items()}}
        if self.redispatches:
            out["redispatches"] = [[int(s), str(r)]
                                   for s, r in self.redispatches]
        return out

    @staticmethod
    def from_dict(d: dict) -> "BatchRecord":
        return BatchRecord(
            n_shards=int(d["n_shards"]),
            times={int(k): float(v) for k, v in d.get("times", {}).items()},
            lost={int(k): str(v) for k, v in d.get("lost", {}).items()},
            redispatches=[[int(s), str(r)]
                          for s, r in d.get("redispatches", [])])


@dataclass
class TraceRecording:
    """Ordered batch records of one cluster serving run (JSON round-trip).

    ``ReplayBackend`` consumes the records in dispatch order; the schema is
    versioned so a stale file fails loudly instead of replaying garbage.
    """

    batches: list[BatchRecord] = field(default_factory=list)

    VERSION = 1

    def append(self, record: BatchRecord) -> None:
        self.batches.append(record)

    def __len__(self) -> int:
        return len(self.batches)

    def to_dict(self) -> dict:
        return {"version": self.VERSION, "kind": "cluster-trace",
                "batches": [b.to_dict() for b in self.batches]}

    @staticmethod
    def from_dict(d: dict) -> "TraceRecording":
        if not isinstance(d, dict):
            raise ValueError("not a cluster trace recording")
        if d.get("kind") != "cluster-trace":
            raise ValueError("not a cluster trace recording")
        if d.get("version") != TraceRecording.VERSION:
            raise ValueError(f"trace version {d.get('version')!r} != "
                             f"{TraceRecording.VERSION}")
        return TraceRecording(batches=[BatchRecord.from_dict(b)
                                       for b in d.get("batches", [])])

    def save(self, path: str) -> str:
        from ..ioutil import write_json_atomic
        return write_json_atomic(path, self.to_dict(), indent=2)

    @staticmethod
    def load(path: str) -> "TraceRecording":
        import json
        with open(path) as f:
            return TraceRecording.from_dict(json.load(f))
