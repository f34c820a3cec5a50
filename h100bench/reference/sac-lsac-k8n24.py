"""Plain reference of the L-SAC job (paper §IV, over OrthoMatDot): the
encode, the workers' products and the decode at any set of finished
workers, in float64 with plain torch on the operands' device.

Frozen here, independent of the program: the evaluation points (K
clusters of N/K points within ±ε of the roots of T_K), the orthonormal
Chebyshev generator, the anytime estimate ``Σ_k α_k · mean of cluster k's
finished products`` (β = 1), and the exact decode at R = 2K−1 finished
workers through the Chebyshev fit's extraction weights.  Lower-precision
products for the controls: ``tf32`` (each encoded operand rounded to TF32,
as a single TF32 pass takes it) and ``fp8`` (each worker's operands scaled
to e4m3's range and rounded to it).
"""
from __future__ import annotations

import numpy as np
import torch


def chebyshev_roots(n: int) -> np.ndarray:
    k = np.arange(1, n + 1, dtype=np.float64)
    return np.sort(np.cos((2 * k - 1) * np.pi / (2 * n)))


def chebyshev_T(x: np.ndarray, p: int) -> np.ndarray:
    """``T[i, j] = T_j(x_i)`` for j < p, by the three-term recursion."""
    x = np.asarray(x, dtype=np.float64)
    T = np.empty(x.shape + (p,))
    T[..., 0] = 1.0
    if p > 1:
        T[..., 1] = x
    for j in range(1, p - 1):
        T[..., j + 1] = 2 * x * T[..., j] - T[..., j - 1]
    return T


def points(K: int, N: int, eps: float):
    """Evaluation points and each worker's cluster: anchor k's N/K points
    at offsets ε(2i − n + 1)/n."""
    n = N // K
    off = eps * (2 * np.arange(n) - n + 1) / n
    anchors = chebyshev_roots(K)
    return (anchors[:, None] + off[None]).ravel(), np.repeat(np.arange(K), n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Each worker's ``(rows, cols)`` operand scaled to e4m3's largest
    value and rounded to e4m3; returned in float32 at its own scale."""
    x = x.float()
    amax = x.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Job:
    """One request ``C = A·B`` under the configuration's code."""

    def __init__(self, cfg: dict, A: torch.Tensor, B: torch.Tensor):
        c = cfg["code"]
        if c["family"] != "layer_sac_ortho" or cfg["beta_mode"] != "one":
            raise ValueError("this reference is L-SAC over OrthoMatDot "
                             "with beta 1")
        K, N = c["K"], c["N"]
        self.K, self.N, self.R = K, N, 2 * K - 1
        self.x, self.cluster = points(K, N, c["eps"])
        G = chebyshev_T(self.x, K)
        G[:, 0] /= np.sqrt(2.0)                 # orthonormal: O_0 = T_0/√2
        self.alphas = np.full(K, 2.0 / K)
        self.anchors = chebyshev_roots(K)
        dev = A.device
        g = torch.as_tensor(G, dtype=torch.float64, device=dev)
        bz = A.shape[1] // K
        Ab = A.double().reshape(A.shape[0], K, bz).permute(1, 0, 2)
        Bb = B.double().reshape(K, bz, B.shape[1])
        self.EA = torch.einsum("nk,kij->nij", g, Ab)
        self.EB = torch.einsum("nk,kij->nij", g, Bb)
        self.P = torch.bmm(self.EA, self.EB)
        self.norms = torch.linalg.vector_norm(self.P, dim=(1, 2))

    def products(self, precision: str) -> torch.Tensor:
        """The workers' products from the encoded operands rounded to
        ``precision`` (``tf32`` or ``fp8``), summed in float32 with TF32
        off; float64 out."""
        cast = {"tf32": tf32, "fp8": fp8}[precision]
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.bmm(cast(self.EA), cast(self.EB)).double()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def estimate(self, row: np.ndarray, t: float, products=None):
        """``(m, estimate, scale)`` from the workers finished by time ``t``
        of the latency row (a completion at ``t`` counts), or ``None``
        before the first; ``scale`` is ``Σ_i |w_i| ‖P_i‖`` of the decode's
        weights over the float64 products, the size of what rounding the
        products can move the estimate by."""
        P = self.P if products is None else products
        order = np.argsort(row, kind="stable")
        m = int(np.sum(row <= t))
        if m < 1:
            return None
        done = order[:m]
        w = np.zeros(self.N)
        if m >= self.R:
            xs = self.x[done[:self.R]]
            V = chebyshev_T(xs, self.R)
            a = self.alphas @ chebyshev_T(self.anchors, self.R)
            w[done[:self.R]] = np.linalg.solve(V.T, a)
        else:
            ks = self.cluster[done]
            counts = np.bincount(ks, minlength=self.K)
            w[done] = self.alphas[ks] / counts[ks]
        wt = torch.as_tensor(w, dtype=torch.float64, device=P.device)
        scale = float(wt.abs() @ self.norms)
        return m, torch.einsum("m,mij->ij", wt, P), scale
