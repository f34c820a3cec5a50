"""SAC coded matmul as a distributed runtime primitive.

Counterpart of the reference's ``runtime/coded.py``, at two integration
levels:

1. :func:`distributed_coded_matmul` — the paper's master/worker job mapped
   onto a mesh axis (as the reference's, ``(mesh, axis)``) or onto the
   ranks of a ``torch.distributed`` process group: each rank holds its
   share of the N workers' encoded operands ``E_A[n], E_B[n]``, computes
   their products (the ``coded_matmul`` kernel on a CUDA tensor, its plain
   version on the CPU), and the decode is one **weighted all-reduce** over
   the axis's group — the extraction weights (host-side float64 solve,
   :mod:`repro_torch.core.solve`) arrive as a per-worker scalar with zeros
   for stragglers and failures.  Any resolution layer of any SAC code is a
   different weight vector, so one program serves every (m, layer) state.

2. :func:`coded_contraction` — straggler-tolerant tensor parallelism inside
   a model: a dense down-projection whose contraction dim is split into K
   blocks and expanded to N coded partial products; the decode is a
   weighted sum over the N products.  The layer output survives any N -
   (2K-1) lost contributions exactly.  On a mesh (DTensor operands) the
   worker axis n goes on the model axis, as the reference's hints put it,
   so each worker is a model shard and the decode contraction over n is
   the weighted reduce; on one device the same einsums run there.

The host-side functions (:func:`decode_weight_vector`,
:func:`encode_operands`, :func:`exact_weight_vector`) are the reference's
numpy code.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..compat import (DTensor, P, Partial, Replicate, axis_names,
                      axis_sizes, distribute_tensor, placements, shard_map)
from ..core.codes.base import CDCCode
from ..kernels.coded_matmul.ops import worker_products

__all__ = ["decode_weight_vector", "distributed_coded_matmul",
           "coded_contraction", "coded_contraction_reference",
           "coded_generators", "encode_operands", "exact_weight_vector"]


# ------------------------------------------------------------ host control

def decode_weight_vector(code: CDCCode, order: np.ndarray, m: int,
                         beta_mode: str = "one",
                         oracle: dict | None = None) -> np.ndarray:
    """Length-N decode weights: w[worker] for completed, 0 for stragglers.

    ``Σ_n w_n P_n`` is the (β-scaled) SAC estimate at resolution state m —
    the control-plane object the master broadcasts each deadline tick.

    The job path (:func:`distributed_coded_matmul`) reduces in the *real*
    worker-product dtype, so complex weights (X_complex evaluation points)
    must not enter it — their imaginary part would be silently dropped by the
    dtype cast.  We raise instead; complex codes go through the re/im pair
    expansion (``worker_products_complex``, the paper's 4× real-multiply
    cost) or the host-side :meth:`CDCCode.decode`.
    """
    completed = np.asarray(order)[:m]
    res = code.estimate_weights(completed, m)
    if res is None:
        raise ValueError(f"m={m} below first threshold "
                         f"{code.first_threshold} of {code.name}")
    w, info = res
    b = code.beta(info, m, beta_mode, oracle)
    full = np.zeros(code.N, dtype=np.result_type(w.dtype, np.float64))
    full[completed[:len(w)]] = b * w
    if np.iscomplexobj(full):
        if np.any(full.imag != 0.0):
            raise ValueError(
                f"{code.name}: complex decode weights cannot enter the real "
                "job path (the runtime reduction would drop the imaginary "
                "part).  Use a real-evaluation-point code, or split the job "
                "into re/im worker products (worker_products_complex) and "
                "decode host-side via code.decode.")
        full = full.real
    return full


def encode_operands(code: CDCCode, A_blocks, B_blocks):
    """Host-side f64 encode → per-worker operand stacks (N, ..., ...)."""
    return code.encode(np.asarray(A_blocks), np.asarray(B_blocks))


# ------------------------------------------------ process-group job path

def distributed_coded_matmul(E_A: torch.Tensor, E_B: torch.Tensor,
                             weights: torch.Tensor, mesh=None,
                             axis: str = "model", *, group=None
                             ) -> torch.Tensor:
    """Run N coded workers on a mesh axis, or over the ranks of a process
    group; decode by a weighted all-reduce.

    ``E_A (N, Nx, bz)``, ``E_B (N, bz, Ny)``, ``weights (N,)`` — the global
    stacks (plain tensors alike on every rank, or DTensors on ``mesh``), a
    real dtype, on this rank's device (complex evaluation points are
    handled by the caller as re/im pairs).  N must be a multiple of the
    axis's (or group's) size; its rank r computes workers ``r·N/size …
    (r+1)·N/size - 1`` (several workers per rank fold into the kernel's
    worker dim).  With ``mesh`` (a ``DeviceMesh``) the job runs on its
    ``axis``, as the reference's; without one, over ``group`` (``None``:
    the default world group, which must be initialised).  Every rank
    returns the decoded ``(Nx, Ny)`` as a plain tensor.
    """
    if mesh is not None:
        return _mesh_job(E_A, E_B, weights, mesh, axis)
    N = E_A.shape[0]
    size = dist.get_world_size(group)
    if N % size != 0:
        raise ValueError(f"N={N} workers must tile the process "
                         f"group({size}) axis")
    n = N // size
    lo = dist.get_rank(group) * n
    p = worker_products(E_A[lo:lo + n], E_B[lo:lo + n])
    contrib = torch.einsum("w,wij->ij", weights[lo:lo + n].to(p.dtype), p)
    dist.all_reduce(contrib, group=group)    # decode == weighted reduction
    return contrib


def _mesh_job(E_A, E_B, weights, mesh, axis: str) -> torch.Tensor:
    """The job on ``mesh``'s ``axis``: workers split over the axis (and
    alike over the other axes), one weighted all-reduce over the axis."""
    N = E_A.shape[0]
    ax = axis_sizes(mesh)[axis]
    if N % ax != 0:
        raise ValueError(f"N={N} workers must tile the {axis}({ax}) axis")
    spec = placements(P(axis), mesh)
    E_A, E_B, weights = (
        t if isinstance(t, DTensor) else
        distribute_tensor(t, mesh, spec, src_data_rank=None)
        for t in (E_A, E_B, weights))

    def worker(e_a, e_b, w):
        p = worker_products(e_a, e_b)       # this rank's workers, in one go
        return torch.einsum("w,wij->ij", w.to(p.dtype), p)

    partial = tuple(Partial() if a == axis else Replicate()
                    for a in axis_names(mesh))
    fn = shard_map(worker, mesh=mesh, in_specs=(P(axis), P(axis), P(axis)),
                   out_specs=partial)
    out = fn(E_A, E_B, weights)             # decode == weighted reduction
    return out.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


# ------------------------------------------------- model-integrated coding

def coded_generators(code: CDCCode, device=None):
    """``(G_A, G_B)`` as float32 tensors on ``device`` (the CPU when not
    given); complex evaluation points raise."""
    G_A, G_B = code.generator()
    if np.iscomplexobj(G_A):
        raise ValueError("coded_contraction uses real evaluation points; "
                         "complex codes go through the re/im job path")
    return (torch.as_tensor(G_A, device=device).to(torch.float32),
            torch.as_tensor(G_B, device=device).to(torch.float32))


def coded_contraction(h: torch.Tensor, w_down: torch.Tensor,
                      G_A: torch.Tensor, G_B: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Straggler-tolerant ``h @ w_down`` (contraction dim coded).

    h (T, F); w_down (F, d); G_A/G_B (N, K); weights (N,) decode vector.
    The generators are cast to the operands' dtypes and the weights to the
    products', as in the reference.  With DTensor operands the worker axis
    n lands on the model axis and the rows on the batch axes.
    """
    from ..models.hints import get_batch_axes, hint, replicate_like

    T, F = h.shape
    N, K = G_A.shape
    G_A, G_B, weights = (replicate_like(t, h) for t in (G_A, G_B, weights))
    baxes = get_batch_axes()
    bspec = (baxes if len(baxes) > 1 else baxes[0]) if baxes else None
    hb = h.reshape(T, K, F // K)
    wb = w_down.reshape(K, F // K, -1)
    # encode both sides (the paper's encoder: linear combinations of blocks);
    # the worker axis n lives on the model axis so each "worker" is a model
    # shard and the decode contraction is the weighted reduce
    h_enc = hint(torch.einsum("nk,tkf->ntf", G_A.to(h.dtype), hb),
                 P("model", bspec, None))
    w_enc = hint(torch.einsum("nk,kfd->nfd", G_B.to(w_down.dtype), wb),
                 P("model", None, None))
    # N independent worker products, then decode-as-weighted-reduction
    prods = hint(torch.einsum("ntf,nfd->ntd", h_enc, w_enc),
                 P("model", bspec, None))
    return torch.einsum("n,ntd->td", weights.to(prods.dtype), prods)


def coded_contraction_reference(h, w_down):
    """The uncoded baseline this layer replaces."""
    return h @ w_down


def exact_weight_vector(code: CDCCode, live_mask: np.ndarray,
                        beta_mode: str = "one") -> np.ndarray:
    """Weights for the current set of live workers (mask True = alive).

    Picks the first R live workers (or all, for SAC approximate layers when
    fewer than R are alive) in index order — the runtime's deadline tick.
    """
    order = np.concatenate([np.nonzero(live_mask)[0],
                            np.nonzero(~np.asarray(live_mask))[0]])
    m = int(np.sum(live_mask))
    return decode_weight_vector(code, order, m, beta_mode)
