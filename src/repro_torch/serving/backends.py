"""Execution backends: where the coded worker products actually run.

Every backend exposes the reference's serving contract — the event stream.
The master hands a batch of requests to :meth:`ExecutionBackend
.dispatch_batch` and walks the returned handle's ``next_event`` stream:
each ``done`` event carries one shard's ``(B, Nx, Ny)`` product stack (a
tensor on the backend's device) and a completion timestamp.  Modeled
backends satisfy the contract through :class:`SyntheticDispatch` —
products are computed up front and one latency draw is unrolled into a
time-ordered event sequence:

* :class:`SimulatedBackend` — float64 products (the oracle) +
  shifted-exponential latencies: on a CPU device the reference's numpy
  encode and einsum, bit for bit; on the card the same contractions in
  torch float64 / complex128, so that a full-width oracle run takes
  seconds instead of hours.
* :class:`TorchDeviceBackend` — encode and worker products on the device
  through the hand-written kernels (:mod:`repro_torch.kernels`); complex
  evaluation points take the four-GEMM path.  Latencies are drawn as the
  reference ``DeviceBackend`` draws them.
* :class:`repro_torch.cluster.backend.ClusterBackend`
  (``make_backend("cluster")``) — real worker processes; the event stream
  is *measured*, and supports mid-batch speculative re-dispatch.
* ``make_backend("replay")`` — re-serves a recorded cluster trace through
  the simulated product path, bit-identically.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cluster.events import ShardEvent
from ..core.codes.base import CDCCode
from ..core.partition import split_contraction
from ..core.straggler import (sample_times, shifted_exp_times,
                              validate_latency_kw)
from ..device import resolve_device
from ..kernels import poly_encode, worker_products, worker_products_complex
from ..names import unknown_name
from ..runtime.coded import distributed_coded_matmul, encode_operands

__all__ = ["ExecutionBackend", "SyntheticDispatch", "SimulatedBackend",
           "TorchDeviceBackend", "make_backend", "BACKEND_NAMES"]


class SyntheticDispatch:
    """Event-stream adapter over modeled products + one latency draw.

    The latency row is unrolled into time-ordered events (stable shard
    order on ties), non-finite times become ``lost`` events delivered after
    every completion, and ``elapsed()`` is the synthetic clock of the last
    delivered event.  ``next_event`` never blocks.
    """

    def __init__(self, products: torch.Tensor, times: np.ndarray):
        times = np.asarray(times, dtype=np.float64)
        events = []
        for i in np.argsort(times, kind="stable"):
            shard = int(i)
            t = float(times[shard])
            if np.isfinite(t):
                events.append(ShardEvent(kind="done", shard=shard, t=t,
                                         worker=shard,
                                         products=products[:, shard]))
            else:
                events.append(ShardEvent(kind="lost", shard=shard, t=t,
                                         worker=shard, reason="missing"))
        self._events = events
        self._cursor = 0
        self._elapsed = 0.0

    def elapsed(self) -> float:
        return self._elapsed

    @property
    def outstanding(self) -> int:
        return len(self._events) - self._cursor

    def set_abandon(self, t: float | None) -> None:
        """No-op: a modeled stream already encodes losses as non-finite."""

    def next_event(self, timeout: float | None = None) -> ShardEvent | None:
        if self._cursor >= len(self._events):
            return None
        ev = self._events[self._cursor]
        self._cursor += 1
        self._elapsed = ev.t
        return ev

    def finalize(self) -> None:
        self._cursor = len(self._events)


class ExecutionBackend:
    """Base backend: the event-stream ``dispatch_batch`` contract.

    Modeled backends implement ``compute_products`` (the batched worker
    outputs, a tensor on :attr:`device`) and ``draw_latencies`` (one
    completion-time row per batch, drawn with the scheduler's numpy rng)
    and inherit ``dispatch_batch``.  :attr:`device` is where the products
    land, and so where the scheduler keeps operands and decode state.  Live
    backends (the cluster) override ``dispatch_batch`` wholesale and ignore
    ``rng``: their completion events are measured, not drawn; they set
    ``live = True`` so open-loop serving paces arrivals on the wall clock.
    """

    name = "abstract"
    live = False                   # wall-clocked event stream?

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def dispatch_batch(self, code: CDCCode, As, Bs,
                       n_shards: int | None = None,
                       rng: np.random.Generator | None = None):
        """Dispatch one batch; returns an event-stream handle.

        ``n_shards`` dispatches (and computes) only the first ``n_shards``
        encode shards; ``rng`` drives the latency draw.
        """
        products = self.compute_products(code, As, Bs, n_shards)
        if rng is None:
            rng = np.random.default_rng()
        times = self.draw_latencies(rng, products.shape[1])
        return SyntheticDispatch(products, times)

    def compute_products(self, code: CDCCode, As, Bs,
                         n_shards: int | None = None) -> torch.Tensor:
        """Products for a batch of requests — ``(B, n, Nx, Ny)``."""
        raise NotImplementedError

    def draw_latencies(self, rng: np.random.Generator,
                       N: int) -> np.ndarray:
        """Per-worker completion times for one dispatched batch."""
        raise NotImplementedError

    @staticmethod
    def _generators(code: CDCCode, n_shards: int | None):
        G_A, G_B = code.generator()
        if n_shards is not None:
            if not 1 <= n_shards <= code.N:
                raise ValueError(f"need 1 <= n_shards <= N={code.N}; got "
                                 f"{n_shards}")
            G_A, G_B = G_A[:n_shards], G_B[:n_shards]
        return G_A, G_B

    @classmethod
    def _encode_batch(cls, code: CDCCode, As, Bs,
                      n_shards: int | None = None):
        """Encoded float32 worker operands of the whole batch, on the
        operands' device, through :func:`~repro_torch.kernels.poly_encode`.

        The requests are cast to float32 into one ``(B, Nx, Nz)`` and one
        ``(B, Nz, Ny)`` stack (the only copies), split into strided block
        views, and encoded in one launch per operand.  With ``n_shards`` the
        generator rows are sliced *before* the encode.  Returns ``((EA_re,
        EA_im), (EB_re, EB_im))`` with ``E_A: (B, n, Nx, bz)`` and ``E_B: (B,
        n, bz, Ny)``; the imaginary parts are ``None`` for real points, and
        otherwise come from the same launch over ``[G.real; G.imag]``.
        """
        G_A, G_B = cls._generators(code, n_shards)
        X_A = _stack_f32(As)
        X_B = _stack_f32(Bs)
        A_blocks, B_blocks = split_contraction(X_A, X_B, code.K)
        cplx = np.iscomplexobj(G_A) or np.iscomplexobj(G_B)
        out = []
        for G, X in ((G_A, A_blocks), (G_B, B_blocks)):
            if cplx:
                G2 = np.concatenate([np.real(G), np.imag(G)])
                E = poly_encode(_gen_tensor(G2, X.device), X, parts=2)
                out.append((E[0], E[1]))
            else:
                out.append((poly_encode(_gen_tensor(G, X.device), X), None))
        return tuple(out)


def _stack_f32(mats) -> torch.Tensor:
    """One float32 ``(B, r, c)`` tensor from same-shape matrices."""
    first = mats[0]
    X = torch.empty((len(mats),) + tuple(first.shape), dtype=torch.float32,
                    device=first.device)
    for i, M in enumerate(mats):
        X[i].copy_(M)
    return X


def _gen_tensor(G: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(G), dtype=torch.float32,
                           device=device)


class SimulatedBackend(ExecutionBackend):
    """Float64 products; simulated worker latencies (§V).

    The float64 oracle of the port.  On a CPU :attr:`device` the encode and
    the worker products are the reference's numpy einsums (bit-identical);
    on a CUDA device they are the same contractions in torch float64 /
    complex128 on the card (:meth:`_products_torch`; float64 rounding, a
    different summation order).  ``model`` names the latency model
    (:data:`~repro_torch.core.straggler.LATENCY_MODELS`, shifted
    exponential by default); the remaining keywords configure it.
    """

    name = "sim"

    def __init__(self, *, device=None, model: str = "shifted_exp",
                 **latency_kw):
        super().__init__(device)
        validate_latency_kw(model, latency_kw)
        self.model = model
        self.latency_kw = latency_kw

    @staticmethod
    def _encode_host(code: CDCCode, As, Bs, n_shards: int | None = None):
        """``(E_A: (B,n,Nx,bz), E_B: (B,n,bz,Ny))`` as host numpy float64
        (complex128 for complex points) — the reference's encode."""
        blocks = [split_contraction(_host(A), _host(B), code.K)
                  for A, B in zip(As, Bs)]
        A_blocks = np.stack([ab for ab, _ in blocks])    # (B, K, Nx, bz)
        B_blocks = np.stack([bb for _, bb in blocks])    # (B, K, bz, Ny)
        G_A, G_B = ExecutionBackend._generators(code, n_shards)
        E_A = np.einsum("nk,rkij->rnij", G_A, A_blocks)
        E_B = np.einsum("nk,rkij->rnij", G_B, B_blocks)
        return E_A, E_B

    def compute_products(self, code: CDCCode, As, Bs,
                         n_shards: int | None = None) -> torch.Tensor:
        if self.device.type != "cpu":
            return self._products_torch(code, As, Bs, n_shards, self.device)
        E_A, E_B = self._encode_host(code, As, Bs, n_shards)
        P = np.einsum("rnij,rnjl->rnil", E_A, E_B)
        return torch.from_numpy(P).to(self.device)

    @staticmethod
    def _products_torch(code: CDCCode, As, Bs, n_shards: int | None,
                        device) -> torch.Tensor:
        """The encode and products of :meth:`_encode_host` in torch float64
        (complex128 for complex points) on ``device``, one request at a
        time so that the encoded operands of one request are live at
        once."""
        G_A, G_B = ExecutionBackend._generators(code, n_shards)
        cplx = np.iscomplexobj(G_A) or np.iscomplexobj(G_B)
        dtype = torch.complex128 if cplx else torch.float64
        gA = torch.as_tensor(G_A, dtype=dtype, device=device)
        gB = torch.as_tensor(G_B, dtype=dtype, device=device)
        out = None
        for r, (A, B) in enumerate(zip(As, Bs)):
            A = torch.as_tensor(A, device=device).to(dtype)
            B = torch.as_tensor(B, device=device).to(dtype)
            A_blocks, B_blocks = split_contraction(A, B, code.K)
            E_A = torch.einsum("nk,kij->nij", gA, A_blocks)
            E_B = torch.einsum("nk,kij->nij", gB, B_blocks)
            P = torch.bmm(E_A, E_B)
            if out is None:
                out = torch.empty((len(As),) + tuple(P.shape), dtype=dtype,
                                  device=device)
            out[r] = P
            del A, B, A_blocks, B_blocks, E_A, E_B, P
        return out

    def draw_latencies(self, rng: np.random.Generator,
                       N: int) -> np.ndarray:
        return sample_times(rng, N, model=self.model, **self.latency_kw)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TorchDeviceBackend(ExecutionBackend):
    """Encode and worker products on the device, through the kernels.

    The batch and worker axes fold into the kernel's single worker axis
    (``(B·N, Nx, bz) @ (B·N, bz, Ny)``) so one launch covers the whole
    batch; complex evaluation points go through
    :func:`~repro_torch.kernels.worker_products_complex` (four launches) and
    come back as one complex tensor.  The kernels take float32 operands, as
    the reference's device backend does.  Latencies reuse the simulated
    model, drawn exactly as the reference ``DeviceBackend`` draws them.
    :meth:`decode_on_mesh` runs one job through the process-group path.
    """

    name = "device"

    def __init__(self, *, device=None, shift: float = 1.0, rate: float = 1.0,
                 straggler_frac: float = 0.0,
                 straggler_slowdown: float = 5.0):
        super().__init__(device)
        self.latency_kw = {"shift": shift, "rate": rate,
                           "straggler_frac": straggler_frac,
                           "straggler_slowdown": straggler_slowdown}

    def compute_products(self, code: CDCCode, As, Bs,
                         n_shards: int | None = None) -> torch.Tensor:
        As = [torch.as_tensor(A, device=self.device) for A in As]
        Bs = [torch.as_tensor(B, device=self.device) for B in Bs]
        (ea, ea_im), (eb, eb_im) = self._encode_batch(code, As, Bs, n_shards)
        B, N = ea.shape[:2]

        def fold(t):
            return t.reshape((B * N,) + tuple(t.shape[2:]))

        if ea_im is None:
            P = worker_products(fold(ea), fold(eb))
        else:
            re, im = worker_products_complex(fold(ea), fold(ea_im), fold(eb),
                                             fold(eb_im))
            P = torch.complex(re, im)
        return P.reshape((B, N) + tuple(P.shape[1:]))

    def draw_latencies(self, rng: np.random.Generator,
                       N: int) -> np.ndarray:
        return shifted_exp_times(rng, N, **self.latency_kw)

    def decode_on_mesh(self, code: CDCCode, A, B, weights,
                       group=None) -> torch.Tensor:
        """End-to-end device decode: a weighted all-reduce over the ranks
        of ``group`` (``None``: the world), through
        :func:`~repro_torch.runtime.coded.distributed_coded_matmul` on this
        backend's device.

        ``A``, ``B`` are encoded on the host in float64, as the reference
        does, then cast to float32 (the kernels' operand type here, as in
        :meth:`compute_products`).  ``weights`` is the incremental
        decoder's current :meth:`~repro_torch.serving.incremental.
        IncrementalDecoder.weight_vector` (real — complex weights are
        rejected)."""
        if np.iscomplexobj(np.asarray(weights)):
            raise ValueError("complex decode weights cannot enter the real "
                             "mesh job path; use a real-point code")
        A_blocks, B_blocks = split_contraction(_host(A), _host(B), code.K)
        E_A, E_B = encode_operands(code, A_blocks, B_blocks)

        def put(x):
            return torch.as_tensor(x).to(torch.float32).to(self.device)

        return distributed_coded_matmul(put(E_A), put(E_B),
                                        put(np.asarray(weights)), group=group)


def _make_cluster(**kw):
    from ..cluster.backend import ClusterBackend      # lazy: multiprocessing
    return ClusterBackend(**kw)


def _make_replay(**kw):
    from ..cluster.backend import ReplayBackend
    return ReplayBackend(**kw)


_BACKENDS = {"sim": SimulatedBackend, "device": TorchDeviceBackend,
             "cluster": _make_cluster, "replay": _make_replay}

BACKEND_NAMES = tuple(sorted(_BACKENDS))


def make_backend(name: str, **kw) -> ExecutionBackend:
    """``sim`` | ``device`` | ``cluster`` | ``replay`` — an unknown name is
    rejected with the valid list."""
    build = _BACKENDS.get(name)
    if build is None:
        raise unknown_name("backend", name, BACKEND_NAMES)
    return build(**kw)
