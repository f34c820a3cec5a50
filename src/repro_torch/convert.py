"""Carry state across from the reference package.

This system has no model weights: its state is the code (generator,
evaluation points, decode basis) and the request operands.
:func:`code_from_reference` rebuilds a reference code as the port's code by
reading its public attributes as numpy values — duck typing on the class
name, so nothing of the reference is imported — with bit-equal
``generator()`` and ``estimate_weights``.  :func:`to_device` moves numpy
operands onto a device.  :func:`lm_params_from_reference` carries a
reference language model's parameter tree (numpy arrays) into the port's
:class:`repro_torch.models.LM`, and :func:`adamw_state_from_reference` its
optimizer state into the port's :class:`repro_torch.optim.AdamWState`.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import (ChebyshevBasis, EpsApproxMatDotCode, GroupSACCode,
                   LagrangeCode, LayerSACCode, MappedChebyshevBasis,
                   MatDotCode, MonomialBasis, OrthoMatDotCode)

__all__ = ["code_from_reference", "basis_from_reference", "to_device",
           "lm_params_from_reference", "adamw_state_from_reference"]


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


def _tensor(arr) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as ``np.asarray`` gives
    them from jax) as a CPU tensor of the same dtype."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _flatten(tree, prefix: str, out: dict) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", out)
        else:
            out[prefix + key] = val


def _index(tree, i: int):
    """Layer ``i`` of a tree stacked on a leading layer axis."""
    return {k: _index(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def lm_params_from_reference(tree, cfg, mesh=None):
    """The port's :class:`~repro_torch.models.LM` (on the CPU) holding the
    numbers of a reference parameter tree; with ``mesh`` its parameters are
    DTensors placed by :mod:`repro_torch.runtime.sharding` (each rank keeps
    its own shard of the same tree).

    ``tree`` is the reference's ``init_params`` tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``): ``embed``, ``layers`` (stacked
    on a leading layer axis when ``cfg.use_scan``, else a list of per-layer
    dicts; a MoE layer's ``moe`` subtree nests ``shared``), ``final_norm``
    and, untied, ``lm_head`` (per codebook for audio, as ``embed``).  Each
    leaf keeps its dtype (``A_log``, ``D`` and the MoE ``router`` are
    float32 in every model).
    """
    from .models import LM
    state = _lm_state(tree, cfg)
    model = LM(cfg, dtype=state["embed"].dtype, device="cpu")
    model.load_state_dict(state, strict=True)
    if mesh is not None:
        from .runtime.sharding import distribute_lm
        distribute_lm(model, mesh, cfg)
    return model


def _lm_state(tree, cfg) -> dict:
    """A reference LM-shaped tree as the port's ``state_dict``: CPU
    tensors under the :class:`~repro_torch.models.LM`'s names, in its
    order."""
    from .models import LM
    layers = tree["layers"]
    flat: dict = {}
    for i in range(cfg.n_layers):
        layer = layers[i] if isinstance(layers, (list, tuple)) else \
            _index(layers, i)
        _flatten(layer, f"layers.{i}.", flat)
    for key in ("embed", "final_norm", "lm_head"):
        if key in tree:
            flat[key] = tree[key]
    names = list(LM(cfg, dtype=torch.float32, device="meta").state_dict())
    if sorted(names) != sorted(flat):
        raise ValueError(f"{cfg.name}: the tree's leaves "
                         f"{sorted(set(flat) ^ set(names))} do not match "
                         "the port's parameters")
    return {k: _tensor(flat[k]) for k in names}


def adamw_state_from_reference(state, cfg, mesh=None):
    """The port's :class:`~repro_torch.optim.AdamWState` (on the CPU)
    holding a reference ``AdamWState`` with numpy leaves (``jax.tree.map(
    np.asarray, state)``): the step as an int32 scalar, the moments under
    the parameter names of :func:`lm_params_from_reference`, each leaf
    keeping its dtype; with ``mesh`` placed as the parameters are."""
    from .optim import AdamWState
    out = AdamWState(step=torch.tensor(int(np.asarray(state.step)),
                                       dtype=torch.int32),
                     m=_lm_state(state.m, cfg), v=_lm_state(state.v, cfg))
    if mesh is None:
        return out
    from .runtime.sharding import distribute_adamw, param_shardings
    return distribute_adamw(out, mesh, param_shardings(cfg, mesh, out.m))

