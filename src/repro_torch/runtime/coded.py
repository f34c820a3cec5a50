"""SAC coded matmul as a distributed runtime primitive.

Counterpart of the reference's ``runtime/coded.py``, at two integration
levels:

1. :func:`distributed_coded_matmul` — the paper's master/worker job mapped
   onto the ranks of a ``torch.distributed`` process group (the reference's
   mesh axis): each rank holds ``N / world_size`` workers' encoded operands
   ``E_A[n], E_B[n]``, computes their products (the ``coded_matmul`` kernel
   on a CUDA tensor, its plain version on the CPU), and the decode is one
   **weighted all-reduce** — the extraction weights (host-side float64
   solve, :mod:`repro_torch.core.solve`) arrive as a per-worker scalar with
   zeros for stragglers and failures.  Any resolution layer of any SAC code
   is a different weight vector, so one program serves every (m, layer)
   state.

2. :func:`coded_contraction` — straggler-tolerant tensor parallelism inside
   a model: a dense down-projection whose contraction dim is split into K
   blocks and expanded to N coded partial products; the decode is a
   weighted sum over the N products.  The layer output survives any N -
   (2K-1) lost contributions exactly.  The reference pins its worker axis
   to the mesh's model axis with sharding hints (``models/hints.py``); on
   one process those hints do nothing, and the port, which has no mesh yet
   (ROADMAP A11), computes the same einsums on one device.

The host-side functions (:func:`decode_weight_vector`,
:func:`encode_operands`, :func:`exact_weight_vector`) are the reference's
numpy code.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

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
                             weights: torch.Tensor, group=None
                             ) -> torch.Tensor:
    """Run N coded workers over the ranks of ``group``; decode by a weighted
    all-reduce.

    ``E_A (N, Nx, bz)``, ``E_B (N, bz, Ny)``, ``weights (N,)`` — the global
    stacks, a real dtype, on this rank's device (complex evaluation points
    are handled by the caller as re/im pairs).  N must be a multiple of the
    group's size; rank r computes workers ``r·N/size … (r+1)·N/size - 1``
    (several workers per rank fold into the kernel's worker dim).
    ``group=None`` is the default (world) group, which must be initialised.
    Every rank returns the decoded ``(Nx, Ny)``.
    """
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
    products', as in the reference.
    """
    T, F = h.shape
    N, K = G_A.shape
    hb = h.reshape(T, K, F // K)
    wb = w_down.reshape(K, F // K, -1)
    # encode both sides (the paper's encoder: linear combinations of blocks)
    h_enc = torch.einsum("nk,tkf->ntf", G_A.to(h.dtype), hb)
    w_enc = torch.einsum("nk,kfd->nfd", G_B.to(w_down.dtype), wb)
    # N independent worker products, then decode-as-weighted-reduction
    prods = torch.einsum("ntf,nfd->ntd", h_enc, w_enc)
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
