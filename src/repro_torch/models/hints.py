"""Sharding hints: the mesh the model runs on, and the placements its
activations are pinned to.

Counterpart of the reference's ``models/hints.py``.  The module state is
the reference's: the registered mesh (:func:`set_mesh`), its batch axes
(``pod``, ``data``) with their total size, and the model axis with its
size.  :func:`hint`, :func:`batch_hint` and :func:`axes_hint` keep the
reference's divisibility rules: a DTensor is redistributed to the
placements the spec names; a plain tensor with no mesh registered is
returned as it is (the reference's no-op outside a mesh).  With a mesh
registered a plain tensor raises, and a redistribute that fails raises:
there is no ``except Exception: return x``.

The rest is plumbing the reference gets from GSPMD for free:
:func:`fsdp_gather` is the FSDP (ZeRO-3) all-gather of a weight's
data-axis shard, done where a layer uses the weight (its autograd
transpose is a reduce-scatter); :func:`replicate_like` and
:func:`local_like` put a tensor every rank computes alike (positions,
masks, rotary tables) beside a DTensor activation.
"""
from __future__ import annotations

from ..compat import (DTensor, P, Partial, Replicate, Shard, axis_names,
                      axis_sizes, distribute_tensor, placements)

_BATCH_AXES: tuple = ("data",)
_BATCH_SIZE: int = 1          # product of the batch axes' sizes
_MODEL_AXIS: str = "model"
_MODEL_SIZE: int = 1
_MESH = None                  # the registered DeviceMesh

__all__ = ["set_batch_axes", "get_batch_axes", "get_model_info", "hint",
           "batch_hint", "axes_hint", "set_mesh", "get_mesh", "is_dt",
           "fsdp_gather", "replicate_like", "local_like", "reduced",
           "model_rank", "full"]


def set_batch_axes(axes, size: int = 1, model_axis: str = "model",
                   model_size: int = 1) -> None:
    """Configure the mesh axes carrying the batch + their total size."""
    global _BATCH_AXES, _BATCH_SIZE, _MODEL_AXIS, _MODEL_SIZE
    _BATCH_AXES = tuple(axes)
    _BATCH_SIZE = int(size)
    _MODEL_AXIS = model_axis
    _MODEL_SIZE = int(model_size)


def set_mesh(mesh) -> None:
    """Register the mesh the model runs on (``None``: one device).  Enables
    the mesh branches of the MoE, attention and coded paths."""
    global _MESH
    _MESH = mesh
    if mesh is None:
        set_batch_axes(("data",), 1, "model", 1)
        return
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    baxes = tuple(a for a in ("pod", "data") if a in names)
    bsize = 1
    for a in baxes:
        bsize *= int(sizes[a])
    msize = int(sizes["model"]) if "model" in names else 1
    set_batch_axes(baxes, bsize, "model", msize)


def get_mesh():
    return _MESH


def get_batch_axes() -> tuple:
    return _BATCH_AXES


def get_model_info() -> tuple:
    return _MODEL_AXIS, _MODEL_SIZE


def is_dt(x) -> bool:
    return isinstance(x, DTensor)


def hint(x, spec: P):
    """Redistribute a DTensor to the placements of ``spec`` (its partial
    sums reduced); a plain tensor passes only with no mesh registered."""
    if isinstance(x, DTensor):
        want = placements(spec, x.device_mesh)
        if tuple(x.placements) != want:
            x = x.redistribute(x.device_mesh, want)
        return x
    if _MESH is None:
        return x
    raise TypeError(f"a plain {tuple(x.shape)} tensor under a registered "
                    "mesh: the model's activations must be DTensors there")


def _batch_entry():
    return _BATCH_AXES if len(_BATCH_AXES) > 1 else _BATCH_AXES[0]


def batch_hint(x, dim: int = 0):
    """Pin ``dim`` of x to the batch axes, the rest unsharded.

    Skipped when the dim doesn't divide the axes' total size (e.g. batch-1
    long-context decode — there the model axes carry the work instead).
    """
    if not _BATCH_AXES or x.shape[dim] % max(_BATCH_SIZE, 1) != 0:
        return x
    spec = [None] * x.ndim
    spec[dim] = _batch_entry()
    return hint(x, P(*spec))


def axes_hint(x, batch_dim: int | None = 0, model_dim: int | None = None):
    """Pin batch_dim to the data axes AND model_dim to the model axis.

    Either pin is dropped independently if its dim size doesn't divide the
    axis — replicating big activations over the model axis otherwise
    multiplies their work by its size.
    """
    spec = [None] * x.ndim
    if batch_dim is not None and _BATCH_SIZE > 1 \
            and x.shape[batch_dim] % _BATCH_SIZE == 0:
        spec[batch_dim] = _batch_entry()
    if model_dim is not None and _MODEL_SIZE > 1 \
            and x.shape[model_dim] % _MODEL_SIZE == 0:
        spec[model_dim] = _MODEL_AXIS
    if all(s is None for s in spec):
        return x
    return hint(x, P(*spec))


def fsdp_gather(w):
    """A weight with its batch-axis (FSDP) shards gathered; its model-axis
    shard kept.  A plain tensor passes as it is."""
    if not isinstance(w, DTensor):
        return w
    names = axis_names(w.device_mesh)
    want = tuple(Replicate() if a in ("pod", "data") else pl
                 for a, pl in zip(names, w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def replicate_like(t, x):
    """``t`` (the same on every rank) as a replicated DTensor on ``x``'s
    mesh when ``x`` is a DTensor, else ``t``."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim,
                              run_check=False)


def local_like(t, x, dims: dict):
    """``t`` (the same full tensor on every rank) sharded as ``x`` is along
    the dims they share: ``dims`` maps a dim of ``x`` to the dim of ``t``
    it matches; other mesh axes replicate ``t``."""
    if not isinstance(x, DTensor):
        return t
    plc = []
    for pl in x.placements:
        if isinstance(pl, Shard) and pl.dim % x.ndim in dims:
            plc.append(Shard(dims[pl.dim % x.ndim]))
        else:
            plc.append(Replicate())
    return distribute_tensor(t, x.device_mesh, plc, src_data_rank=None)


def reduced(x):
    """A DTensor with its partial sums over mesh axes reduced (all-reduced
    to replicated); anything else as it is.  The row-parallel products
    (attention's ``wo``, the MLP's and Mamba's down-projections) end here."""
    if not isinstance(x, DTensor) or not any(
            isinstance(pl, Partial) for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(pl, Partial) else pl
        for pl in x.placements])


def model_rank(mesh) -> int:
    """This rank's coordinate on the model axis (0 without one)."""
    if "model" not in axis_names(mesh):
        return 0
    return int(mesh.get_local_rank("model"))


def full(x):
    """The whole tensor on every rank (a DTensor gathered, a plain tensor
    as it is)."""
    return x.full_tensor() if isinstance(x, DTensor) else x
