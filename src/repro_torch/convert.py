"""Carry state across from the reference package.

This system has no model weights: its state is the code (generator,
evaluation points, decode basis) and the request operands.
:func:`code_from_reference` rebuilds a reference code as the port's code by
reading its public attributes as numpy values — duck typing on the class
name, so nothing of the reference is imported — with bit-equal
``generator()`` and ``estimate_weights``.  :func:`to_device` moves numpy
operands onto a device.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import (ChebyshevBasis, EpsApproxMatDotCode, GroupSACCode,
                   LagrangeCode, LayerSACCode, MappedChebyshevBasis,
                   MatDotCode, MonomialBasis, OrthoMatDotCode)

__all__ = ["code_from_reference", "basis_from_reference", "to_device"]


def basis_from_reference(basis):
    """The port's decode basis with the reference basis's parameters."""
    kind = type(basis).__name__
    if kind == "MonomialBasis":
        return MonomialBasis(scale=basis.scale)
    if kind == "ChebyshevBasis":
        return ChebyshevBasis()
    if kind == "MappedChebyshevBasis":
        return MappedChebyshevBasis(basis.lo, basis.hi)
    raise ValueError(f"unknown decode basis {kind!r}")


def code_from_reference(code):
    """The port's counterpart of a reference code (duck-typed).

    Reads ``K``, ``N``, ``eval_points`` and the family's own parameters
    (``group_sizes`` and ``permutation``; ``base``, ``eps``, ``n_sizes``,
    ``anchors`` and ``cluster``), and carries the decode basis over, so
    ``generator()`` and ``estimate_weights`` are bit-equal to the
    reference's.
    """
    kind = type(code).__name__
    K, N = int(code.K), int(code.N)
    pts = np.array(code.eval_points)
    if kind in ("MatDotCode", "EpsApproxMatDotCode"):
        cls = MatDotCode if kind == "MatDotCode" else EpsApproxMatDotCode
        new = cls(K, N, pts)
    elif kind == "OrthoMatDotCode":
        new = OrthoMatDotCode(K, N, pts)
    elif kind == "LagrangeCode":
        new = LagrangeCode(K, N, pts, anchors=np.array(code.anchors))
    elif kind == "GroupSACCode":
        new = GroupSACCode(K, N, pts, np.array(code.group_sizes),
                           permutation=np.array(code.permutation))
    elif kind == "LayerSACCode":
        new = LayerSACCode(K, N, base=code.base, n_sizes=np.array(
            code.n_sizes), eps=float(code.eps),
            anchors=np.array(code.anchors))
        # the reference's points and clusters as they are (a restricted
        # code keeps the original shards, not re-spread offsets)
        new.eval_points = pts
        new.cluster = np.array(code.cluster)
    else:
        raise ValueError(f"unknown code family {kind!r}")
    new.decode_basis = basis_from_reference(code.decode_basis)
    return new


def to_device(arrays, device, dtype: torch.dtype | None = None):
    """Numpy arrays (one, or a list / tuple / dict of them) as tensors on
    ``device``, cast to ``dtype`` when given."""
    if isinstance(arrays, dict):
        return {k: to_device(v, device, dtype) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(to_device(v, device, dtype) for v in arrays)
    return torch.as_tensor(np.asarray(arrays), device=device, dtype=dtype)
