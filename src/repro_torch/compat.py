"""The port's one place for the DTensor API: import paths and the few
differences from the reference's jax calls.

Counterpart of the reference's ``compat.py``, which keeps ``jax.shard_map``,
``jax.make_mesh`` and ``jax.lax.pvary`` working across jax releases.  Here:

* a partition spec is :class:`P`, a tuple with one entry per tensor dim
  (an axis name, a tuple of axis names, or ``None``), as jax's
  ``PartitionSpec``; :func:`placements` turns it into DTensor placements
  over a mesh's axes (``Shard(dim)`` on each mesh axis the spec names,
  ``Replicate()`` on the others);
* :func:`shard_map` is ``torch.distributed.tensor.experimental.local_map``
  with specs for placements: the body sees each rank's local tensors, and
  an output spec may name an axis as partial (``Partial("sum")`` etc.,
  passed as placements), which the caller then reduces;
* :func:`make_mesh` is ``init_device_mesh`` with the axis names, over the
  process group that is initialised;
* :func:`pvary` is the identity: DTensor has no varying-manual types;
* :func:`all_gather_autograd` is the functional all-gather whose autograd
  transpose is a reduce-scatter (``all_gather_single_autograd`` where the
  installed torch has it, else its older name
  ``all_gather_tensor_autograd``).
"""
from __future__ import annotations

import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)
from torch.distributed.tensor.experimental import local_map

__all__ = ["P", "DTensor", "DeviceMesh", "Partial", "Replicate", "Shard",
           "distribute_tensor", "axis_names", "axis_sizes", "placements",
           "shard_map", "make_mesh", "pvary",
           "all_gather_autograd"]


class P(tuple):
    """A partition spec: ``P("model", None)`` shards dim 0 over ``model``;
    ``P(("pod", "data"))`` shards dim 0 over both axes, ``pod`` outer."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return "P" + super().__repr__()


def axis_names(mesh) -> tuple:
    """The mesh's axis names: a torch ``DeviceMesh`` (``mesh_dim_names``)
    or anything with jax's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a torch ``DeviceMesh``, or of anything with
    jax's ``axis_names`` and a ``shape`` mapping (``AbstractMesh`` or a
    stand-in)."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return {a: int(mesh.size(i))
                for i, a in enumerate(mesh.mesh_dim_names)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh_or_names) -> tuple:
    """DTensor placements, one per mesh axis, for the spec ``spec``.  A
    spec shorter than the tensor leaves the trailing dims replicated."""
    names = mesh_or_names if isinstance(mesh_or_names, tuple) \
        else axis_names(mesh_or_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in _axes_of(entry):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def _single(s) -> bool:
    """Is ``s`` one spec (a :class:`P` or a tuple of placements) rather
    than a sequence of them?"""
    return s is None or isinstance(s, P) or (
        len(s) > 0 and isinstance(s[0], Placement))


def _as_placements(s, names):
    """One spec as a list of placements (``local_map`` reads a tuple as
    one entry per output)."""
    if s is None:
        return None
    if isinstance(s, P):
        return list(placements(s, names))
    return list(s)                   # placements given as they are


def _grad_placements(ins, outs) -> tuple:
    """The placements of the inputs' gradients: an input replicated over a
    mesh axis along which the body varies (some input sharded over it, or
    some output partial over it) gets a partial gradient there, which the
    caller's autograd then sums — ``shard_map``'s transpose of a
    replicated input."""
    varying = set()
    for plc in ins:
        for i, pl in enumerate(plc or ()):
            if isinstance(pl, Shard):
                varying.add(i)
    for plc in (outs if outs and not isinstance(outs[0], Placement)
                else (outs,)):
        for i, pl in enumerate(plc or ()):
            if isinstance(pl, Partial):
                varying.add(i)
    return tuple(None if plc is None else
                 [Partial() if i in varying and isinstance(pl, Replicate)
                  else pl for i, pl in enumerate(plc)] for plc in ins)


def shard_map(f, *, mesh, in_specs, out_specs):
    """``local_map`` of ``f`` over ``mesh``: each input is redistributed to
    its spec (a :class:`P`, or a tuple of placements; ``None`` for a
    non-tensor input), ``f`` runs on the local tensors, and each output is
    wrapped with its spec (placements may be partial); several outputs take
    a sequence of specs.  Under autograd an input replicated over an axis
    along which the body varies gets its gradient summed over that axis,
    as ``shard_map``'s transpose does."""
    names = axis_names(mesh)
    outs = _as_placements(out_specs, names) if _single(out_specs) \
        else tuple(_as_placements(s, names) for s in out_specs)
    ins = tuple(_as_placements(s, names) for s in in_specs)
    return local_map(f, out_placements=outs, in_placements=ins,
                     in_grad_placements=_grad_placements(ins, outs),
                     device_mesh=mesh, redistribute_inputs=True)


def make_mesh(shape, axis_names, device_type: str = "cuda") -> DeviceMesh:
    """``init_device_mesh`` over the initialised process group, whose world
    size must be the product of ``shape``."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def pvary(x, axis_name):
    """The identity (DTensor tracks no varying-manual types)."""
    return x


def all_gather_autograd(t, dim: int, group):
    """All-gather ``t`` along ``dim`` over ``group`` (a ``(mesh, mesh dim)``
    pair); under autograd its transpose is a reduce-scatter."""
    fn = getattr(funcol, "all_gather_single_autograd", None) \
        or funcol.all_gather_tensor_autograd
    return fn(t, dim, group)
