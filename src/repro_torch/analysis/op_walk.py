"""A walk over the ATen ops one traced piece of the model dispatches, per
device: matmul FLOPs, bytes, collectives and peak memory.

Counterpart of the reference's ``analysis/hlo_walk.py``, which parses the
optimized HLO text of a compiled program.  The port has no compiled
program to parse; it runs the program itself on fake tensors (no storage
is allocated) over a fake process group of the mesh's size, and this
mode records what each rank's ops would do:

* **FLOPs** of the matrix products on the rank's local shards (PyTorch's
  FLOP formulas, ``torch.utils.flop_counter``, and the flash kernel's
  ``4·B·H·Lq·Lkv·d``); elementwise work counts nothing, as in the
  reference (its walk counts dot FLOPs only);
* **bytes**: operands + result of every op that moves data (views,
  factories, casts and copies excluded, as the reference excludes
  bitcasts, broadcasts, converts and copies) — a proxy for HBM traffic;
* **collectives**: each functional collective the DTensor redistributions
  and the ``local_map`` bodies issue, with its kind, per-device result
  bytes and group size, priced by the ring model of
  :mod:`repro_torch.analysis.roofline`.

DTensor infers each new op's output shape by running it on fake tensors
of the GLOBAL shapes (``ShardingPropagator``); those runs are not the
program, and :class:`OpWalk` leaves them out: it marks them
(:func:`propagation_runs`) and counts how many there were, so that a
caller can also check that none ran (then a memory tracker beside it saw
no global-shape tensor either).

The reference's walk is trip-count aware (it multiplies each while-loop
body by its count).  The port gets the same effect without running
Python loops over every layer and every token: the dry run traces one
layer of each kind, one cross-entropy chunk and one decode step, and
multiplies each :class:`OpCosts` by its count (:meth:`OpCosts.scaled`).
Ops on DTensors are skipped here: DTensor turns each into ops on local
tensors and collectives, which are what this mode counts.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..compat import DTensor
from .roofline import KINDS, wire_bytes

__all__ = ["OpCosts", "OpWalk", "propagation_runs"]

_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")

# ops that move no bytes of their own: views, factories, casts, copies
_SKIP_BYTES = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "slice", "select", "unsqueeze", "squeeze", "as_strided", "alias",
    "detach", "split", "split_with_sizes", "chunk", "unbind", "narrow",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "full",
    "full_like", "arange", "scalar_tensor", "_to_copy", "copy_", "clone",
    "lift_fresh", "wait_tensor", "_local_scalar_dense", "view_as_real",
    "view_as_complex", "unfold", "diagonal", "expand_as", "lift_fresh_copy",
}


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


@dataclass
class OpCosts:
    """Per-device costs of a traced piece."""
    flops: float = 0.0
    bytes: float = 0.0
    wire: dict = field(default_factory=lambda: {k: 0.0 for k in KINDS})
    n_collectives: int = 0
    by_kind: dict = field(default_factory=dict)  # kind → count

    @property
    def total_wire(self) -> float:
        return sum(self.wire.values())

    def scaled(self, k: float) -> "OpCosts":
        """The costs of ``k`` repeats of this piece."""
        return OpCosts(self.flops * k, self.bytes * k,
                       {a: b * k for a, b in self.wire.items()},
                       int(round(self.n_collectives * k)),
                       {a: int(round(b * k)) for a, b in
                        self.by_kind.items()})

    def __add__(self, other: "OpCosts") -> "OpCosts":
        kinds = dict(self.by_kind)
        for a, b in other.by_kind.items():
            kinds[a] = kinds.get(a, 0) + b
        return OpCosts(self.flops + other.flops, self.bytes + other.bytes,
                       {a: self.wire[a] + other.wire[a] for a in KINDS},
                       self.n_collectives + other.n_collectives, kinds)


class _PropagationMark:
    """Counts DTensor's shape-inference runs and marks the ops they
    dispatch, by wrapping ``ShardingPropagator._propagate_tensor_meta_non_
    cached`` (installed once, on first use)."""

    def __init__(self):
        self.depth, self.runs = 0, 0


def propagation_runs() -> _PropagationMark:
    """The installed mark."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    mark = getattr(ShardingPropagator, "_repro_torch_mark", None)
    if mark is None:
        mark = _PropagationMark()
        inner = ShardingPropagator._propagate_tensor_meta_non_cached

        def marked(self, *args, **kwargs):
            mark.depth += 1
            mark.runs += 1
            try:
                return inner(self, *args, **kwargs)
            finally:
                mark.depth -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = marked
        ShardingPropagator._repro_torch_mark = mark
    return mark


def _group_size(packet_name: str, args) -> int:
    if packet_name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return int(_resolve_process_group(args[-1]).size())


class OpWalk(TorchDispatchMode):
    """Accumulates :class:`OpCosts` over the local ops dispatched while it
    is active (``with OpWalk() as w: ...; w.costs``)."""

    def __init__(self):
        super().__init__()
        self.costs = OpCosts()
        self._mark = propagation_runs()
        self._runs0 = self._mark.runs

    @property
    def propagations(self) -> int:
        """DTensor shape-inference runs since this walk was made."""
        return self._mark.runs - self._runs0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # let DTensor desugar into local ops and collectives first
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._mark.depth:
            return out            # DTensor's shape inference, not the run
        packet = func._overloadpacket
        name = packet.__name__
        c = self.costs
        if packet.__module__ and any(ns in str(packet)
                                     for ns in _COLLECTIVE_NS) \
                and name in _COLLECTIVE_KINDS:
            kind = _COLLECTIVE_KINDS[name]
            n = _group_size(name, args)
            R = _nbytes(out)
            if n > 1:
                c.wire[kind] += wire_bytes(kind, R, n)
                c.n_collectives += 1
                c.by_kind[kind] = c.by_kind.get(kind, 0) + 1
            return out
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if name not in _SKIP_BYTES:
            c.bytes += _nbytes(out) + sum(_nbytes(a) for a in args)
        return out
