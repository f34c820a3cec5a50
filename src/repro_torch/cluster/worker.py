"""Worker processes: pluggable shard compute + injectable chaos.

A worker is one OS process in a :class:`~repro_torch.cluster.pool.WorkerPool`.
It blocks on its transport endpoint, and for every ``("task", ...)``
message resolves the batch's operand reference, computes its encode
shard's product stack for the whole request batch through its
:class:`ShardComputer`, and sends the result up the transport's shared
result stream.  The perturbation layer runs *before* the compute, so
injected chaos shapes the completion-time process the master observes —
reproducible straggler/crash/hang scenarios on a real fleet:

* ``sleep:LO:HI``   — per-task uniform jitter in ``[LO, HI]`` seconds (every
  worker; the baseline latency spread).
* ``slow:C:DELAY``  — ``C`` designated slow workers add ``DELAY`` seconds per
  task (persistent stragglers — bad hosts).
* ``crash:C``       — ``C`` designated workers exit hard on their first task
  (the in-flight shard is lost; the pool replaces the process).
* ``hang:C``        — ``C`` designated workers sleep forever on their first
  task (liveness says healthy, the shard never arrives — only a master-side
  deadline catches it).

Designation is deterministic: the first ``crash`` worker ids crash, the next
``hang`` ids hang, the next ``slow`` ids are slow.  Replacement workers get
fresh ids past the doomed ranges, so a replaced crasher serves correctly.

**The compute seam** — :class:`ShardComputer` has two implementations:

* :class:`NumpyShardComputer` — the host einsum (a width-1 slice of the
  simulated backend's full-batch contraction, so record/replay through
  ``SimulatedBackend`` stays bit-identical).
* :class:`TorchShardComputer` — the same shard product through the port's
  ``coded_matmul`` kernel (:func:`repro_torch.kernels.coded_matmul
  .worker_products`) on the worker's own card: worker ``wid`` pins itself
  to ``cuda:{wid % device_count}`` unless its spec names ``cpu`` (then the
  kernel's plain version runs).  Complex evaluation points take the
  four-launch ``worker_products_complex``; the card never sees a complex
  dtype.  The compute dtype is the spec's (``SAC_CLUSTER_DEVICE_DTYPE``:
  float32 or bfloat16).  The result comes back to the host as float32
  (bf16 products widened on the card, exactly: numpy has no bfloat16), so
  the worker's ``compute`` time covers the launches to their end.

A worker that cannot build its computer, reach its card, load the kernel or
launch it does not fall back: it reports the failure to the master
(``("failed", wid, message)`` at startup, ``("error", ...)`` on a task),
which raises it.  On ``("shutdown",)`` a worker replies ``("bye", wid,
counters)`` with its own kernel launch counts.

This module is the spawn target, so its import-time dependencies stay
numpy + stdlib: torch is imported only by a device-compute worker, which
limits itself to one intra-op thread and runs one launch *before* the
ready handshake — ``pool.lease`` blocks on readiness, so the dispatch
clock never pays for CUDA startup.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace

import numpy as np

from ..names import compute_dtype_name, unknown_name
from .config import global_config

__all__ = ["ChaosSpec", "WorkerPlan", "ShardComputer", "NumpyShardComputer",
           "TorchShardComputer", "ComputeSpec", "COMPUTE_NAMES",
           "make_computer", "worker_main"]

_HANG_SECONDS = 1e6

COMPUTE_NAMES = ("numpy", "device")


@dataclass(frozen=True)
class ChaosSpec:
    """Parsed ``--chaos`` configuration (see module docstring for kinds)."""

    sleep: tuple[float, float] | None = None
    crash: int = 0
    hang: int = 0
    slow: int = 0
    slow_delay: float = 0.0

    @staticmethod
    def parse(text: str | None) -> "ChaosSpec":
        """``"crash:1,sleep:0.01:0.05,slow:3:0.4"`` → :class:`ChaosSpec`.

        Unknown kinds and malformed parameters raise with the valid
        vocabulary — a typo'd chaos flag must fail at the CLI, not silently
        run a clean fleet.
        """
        if not text:
            return ChaosSpec()
        kw: dict = {}
        for part in str(text).split(","):
            part = part.strip()
            if not part:
                continue
            kind, *params = part.split(":")
            try:
                if kind == "sleep":
                    if len(params) == 1:
                        kw["sleep"] = (0.0, float(params[0]))
                    else:
                        lo, hi = map(float, params)
                        kw["sleep"] = (lo, hi)
                elif kind == "crash":
                    (kw["crash"],) = map(int, params)
                elif kind == "hang":
                    (kw["hang"],) = map(int, params)
                elif kind == "slow":
                    count, delay = params
                    kw["slow"] = int(count)
                    kw["slow_delay"] = float(delay)
                else:
                    raise unknown_name(
                        "chaos kind", kind,
                        ("sleep:LO:HI", "slow:COUNT:DELAY", "crash:COUNT",
                         "hang:COUNT"))
            except (TypeError, ValueError) as e:
                if "unknown chaos kind" in str(e):
                    raise
                raise ValueError(f"malformed chaos entry {part!r}: {e}") \
                    from None
        spec = ChaosSpec(**kw)
        if spec.crash < 0 or spec.hang < 0 or spec.slow < 0:
            raise ValueError(f"chaos counts must be >= 0; got {spec}")
        if spec.sleep is not None and not 0 <= spec.sleep[0] <= spec.sleep[1]:
            raise ValueError(f"need 0 <= sleep LO <= HI; got {spec.sleep}")
        return spec

    def plan_for(self, worker_id: int) -> "WorkerPlan":
        """The deterministic perturbation plan of one worker id."""
        wid = int(worker_id)
        crash = wid < self.crash
        hang = self.crash <= wid < self.crash + self.hang
        slow = self.crash + self.hang <= wid < \
            self.crash + self.hang + self.slow
        return WorkerPlan(sleep=self.sleep, crash=crash, hang=hang,
                          slow_delay=self.slow_delay if slow else 0.0)


@dataclass(frozen=True)
class WorkerPlan:
    """One worker's resolved perturbations (picklable, numpy-free)."""

    sleep: tuple[float, float] | None = None
    crash: bool = False
    hang: bool = False
    slow_delay: float = 0.0


# ------------------------------------------------------------ compute seam
@dataclass(frozen=True)
class ComputeSpec:
    """Picklable recipe for a worker's :class:`ShardComputer`.

    ``kind`` is ``"device"`` (the default: the ``coded_matmul`` kernel) or
    ``"numpy"`` (the reference's float64 einsum, for the bit-for-bit check
    against it).  ``device`` is ``"cuda"`` (the default: the card) or
    ``"cpu"`` (the kernel's plain version, for tests).  The pool stamps
    ``device_index`` per worker (``wid % host_device_count``); the worker
    itself reduces it modulo the cards it sees.  ``dtype`` is what device
    compute runs in, ``"float32"`` or ``"bfloat16"``.
    """

    kind: str = "device"
    device: str = "cuda"
    device_index: int = 0
    host_device_count: int = 8
    dtype: str = "float32"

    @staticmethod
    def parse(spec: "ComputeSpec | str | None",
              device: str = "cuda") -> "ComputeSpec":
        """Normalize ``None`` / ``"numpy"`` / ``"device"`` / a ready spec;
        ``device`` is where a new spec's device compute runs."""
        if isinstance(spec, ComputeSpec):
            return spec
        cfg = global_config
        kind = cfg.compute if spec is None else str(spec)
        if kind not in COMPUTE_NAMES:
            raise unknown_name("compute kind", kind, COMPUTE_NAMES)
        if device not in ("cuda", "cpu"):
            raise ValueError(f"unsupported compute device {device!r}; use "
                             "'cuda' or 'cpu'")
        return ComputeSpec(kind=kind, device=device,
                           host_device_count=cfg.host_device_count,
                           dtype=compute_dtype_name(cfg.device_dtype))

    def for_worker(self, wid: int) -> "ComputeSpec":
        """This spec pinned to worker ``wid``'s device."""
        if self.kind != "device":
            return self
        count = self.host_device_count
        return replace(self, device_index=int(wid) % count if count > 0
                       else int(wid))


class ShardComputer:
    """The compute seam: one shard's product stack for a request batch.

    ``shard_products(E_A, E_B, shard)`` takes the full encoded operand
    stacks ``(B, n, Nx, bz)`` / ``(B, n, bz, Ny)`` (host arrays) and returns
    the ``(B, Nx, Ny)`` product stack of encode shard ``shard`` —
    contiguous, safe to ship (never a view into shared memory).
    """

    name = "abstract"

    def shard_products(self, E_A: np.ndarray, E_B: np.ndarray,
                       shard: int) -> np.ndarray:
        raise NotImplementedError

    def warmup(self) -> None:
        """Pay one-time startup cost (device: CUDA init, kernel load)."""

    def counters(self) -> dict:
        """Kernel launches since :meth:`warmup` (what ``bye`` reports)."""
        return {}


class NumpyShardComputer(ShardComputer):
    """Host numpy: the *same contraction on the same memory layout* as the
    simulated backend's full-batch ``"rnij,rnjl->rnil"`` (a width-1 slice of
    the worker axis), so a recorded cluster run replayed through
    ``SimulatedBackend`` reproduces bit-identical products."""

    name = "numpy"

    def shard_products(self, E_A, E_B, shard):
        n = int(shard)
        P = np.einsum("rnij,rnjl->rnil",
                      E_A[:, n:n + 1], E_B[:, n:n + 1])[:, 0]
        return np.ascontiguousarray(P)


class TorchShardComputer(ShardComputer):
    """Shard products through the ``coded_matmul`` kernel on one device.

    The shard slice folds the batch axis into the kernel's worker axis
    (``(B, Nx, bz) @ (B, bz, Ny)``), the ``TorchDeviceBackend`` layout.
    Each operand slice is copied into a fresh float32 device tensor and,
    with ``dtype="bfloat16"``, rounded to bf16 there, so the kernel sees
    the same aligned layout in a worker and in a replay.  Complex operands
    take the four-launch ``worker_products_complex``; the result comes back
    as a contiguous host array (float32, or complex64 for complex points;
    bf16 products are widened to float32 on the device first, which is
    exact).  ``device="cuda"`` raises without a card: there is no CPU
    fallback.
    """

    name = "device"

    def __init__(self, device: str = "cuda", device_index: int = 0,
                 dtype: str = "float32"):
        import torch

        from ..kernels.coded_matmul import ops
        self._torch = torch
        self._ops = ops
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("a device-compute worker found no CUDA "
                                   "device; it does not fall back to the "
                                   "CPU (give the pool compute device 'cpu' "
                                   "to run the plain version)")
            dev = torch.device("cuda",
                               int(device_index) % torch.cuda.device_count())
        elif dev.type != "cpu":
            raise ValueError(f"unsupported compute device {device!r}")
        self.device = dev
        self.dtype = getattr(torch, compute_dtype_name(dtype))
        self._base = self._bf16_base = self._simt_base = 0

    def _put(self, x: np.ndarray):
        host = np.ascontiguousarray(x, dtype=np.float32)
        return self._torch.from_numpy(host).to(self.device).to(self.dtype)

    def _get(self, t) -> np.ndarray:
        return t.to(self._torch.float32).cpu().numpy()

    def shard_products(self, E_A, E_B, shard):
        n = int(shard)
        ea, eb = E_A[:, n], E_B[:, n]              # (B, Nx, bz), (B, bz, Ny)
        if np.iscomplexobj(ea) or np.iscomplexobj(eb):
            re, im = self._ops.worker_products_complex(
                self._put(ea.real), self._put(ea.imag),
                self._put(eb.real), self._put(eb.imag))
            P = np.empty(tuple(re.shape), np.complex64)
            P.real = self._get(re)
            P.imag = self._get(im)
            return P
        P = self._ops.worker_products(self._put(ea), self._put(eb))
        return np.ascontiguousarray(self._get(P))

    def warmup(self) -> None:
        one = np.ones((1, 1, 1, 1), np.float32)
        self.shard_products(one, one, 0)
        self._base = self._ops.coded_matmul.launches
        self._bf16_base = self._ops.coded_matmul.bf16_launches
        self._simt_base = self._ops.coded_matmul.bf16_simt_launches

    def counters(self) -> dict:
        """``coded_matmul`` launches, and in bf16 also ``coded_matmul_bf16``
        (the bf16 instances', the same launches) and
        ``coded_matmul_bf16_simt`` (those of them that took the CUDA-core
        instance, for operands TMA cannot address)."""
        mm = self._ops.coded_matmul
        out = {"coded_matmul": mm.launches - self._base}
        if self.dtype == self._torch.bfloat16:
            out["coded_matmul_bf16"] = mm.bf16_launches - self._bf16_base
            out["coded_matmul_bf16_simt"] = (mm.bf16_simt_launches
                                             - self._simt_base)
        return out


def make_computer(spec: ComputeSpec | str | None) -> ShardComputer:
    """Build the :class:`ShardComputer` a :class:`ComputeSpec` describes."""
    spec = ComputeSpec.parse(spec)
    if spec.kind == "numpy":
        return NumpyShardComputer()
    return TorchShardComputer(device=spec.device,
                              device_index=spec.device_index,
                              dtype=spec.dtype)


# ------------------------------------------------------------- entry point
def worker_main(worker_id: int, endpoint_arg, plan: WorkerPlan,
                seed: int, compute: ComputeSpec | None = None) -> None:
    """Worker process entry point: serve tasks until ``("shutdown",)``.

    ``endpoint_arg`` is the transport's picklable spawn argument
    (:func:`~repro_torch.cluster.transport.make_worker_endpoint` rebuilds
    the endpoint in-child).  Messages on the endpoint:

    * ``("task", batch_id, shard, operand_ref)`` — resolve the operands,
      compute the shard product stack, reply
      ``("done", worker_id, batch_id, shard, P, timings)`` (chaos
      permitting).  ``timings`` is the monotonic delta triple
      ``(wait, operand_resolve, compute)`` measured in-worker; ``compute``
      ends once the product is on the host.  A compute exception is
      reported as ``("error", worker_id, batch_id, shard, message)`` and
      ends the worker.
    * ``("ping", token)`` — reply ``("pong", worker_id, token, t)``
      (heartbeat liveness).
    * ``("shutdown",)`` — reply ``("bye", worker_id, counters)`` and exit.

    The jitter rng is seeded on ``(seed, worker_id)`` so a chaos run is
    reproducible per worker identity.  The ``finally`` closes the endpoint
    — tracked shm attachments are released on *every* Python-level exit
    path (EOF, compute exception, shutdown), not just a clean loop exit.
    """
    from .transport import TransportClosed, make_worker_endpoint
    rng = np.random.default_rng([int(seed), int(worker_id), 0xC1A0])
    try:
        endpoint = make_worker_endpoint(endpoint_arg)
    except TransportClosed:
        return                                   # master already gone
    try:
        try:
            spec = ComputeSpec.parse(compute)
            if spec.kind == "device":
                import torch
                torch.set_num_threads(1)         # 24 workers share a host
            computer = make_computer(spec)
            computer.warmup()                    # CUDA init before the
        except Exception as e:                   # ready handshake: lease()
            try:                                 # blocks on it, so dispatch
                endpoint.send(("failed", int(worker_id),   # never pays for
                               f"{type(e).__name__}: {e}"))  # startup
            except TransportClosed:
                pass
            raise
        try:
            endpoint.send(("ready", int(worker_id)))
        except TransportClosed:
            return
        first_task = True
        while True:
            try:
                msg = endpoint.recv()
            except TransportClosed:
                return                           # master went away
            kind = msg[0]
            if kind == "shutdown":
                try:
                    endpoint.send(("bye", int(worker_id),
                                   computer.counters()))
                except TransportClosed:
                    pass
                return
            if kind == "ping":
                try:
                    endpoint.send(("pong", int(worker_id), msg[1],
                                   time.monotonic()))
                except TransportClosed:
                    return
                continue
            if kind != "task":
                continue                         # unknown message: stay up
            t_recv = time.monotonic()
            if first_task:
                first_task = False
                if plan.crash:
                    os._exit(13)                 # hard death: no cleanup
                if plan.hang:
                    time.sleep(_HANG_SECONDS)
            if plan.sleep is not None:
                # jitter chaos models scheduling noise: it lands in the
                # wait phase, before the worker picks the task up
                jitter = float(rng.uniform(plan.sleep[0], plan.sleep[1]))
                if jitter > 0:
                    time.sleep(jitter)
            _, batch_id, shard, ref = msg
            t_op = time.monotonic()              # wait = chaos + queueing
            try:
                E_A, E_B = endpoint.get_operands(ref)
                t_cmp = time.monotonic()
                if plan.slow_delay > 0:
                    # slow-worker chaos models a degraded device: it lands
                    # in the compute phase, so attribution names the sick
                    # worker's compute — total task latency is unchanged
                    time.sleep(plan.slow_delay)
                try:
                    P = computer.shard_products(E_A, E_B, int(shard))
                except Exception as e:
                    try:
                        endpoint.send(("error", int(worker_id),
                                       int(batch_id), int(shard),
                                       f"{type(e).__name__}: {e}"))
                    except TransportClosed:
                        pass
                    raise
            finally:
                endpoint.release_operands()
            t_done = time.monotonic()
            # monotonic deltas only — the master anchors the span on its
            # own clock, so socket workers need no clock sync
            timings = (t_op - t_recv, t_cmp - t_op, t_done - t_cmp)
            try:
                endpoint.send(("done", int(worker_id), int(batch_id),
                               int(shard), P, timings))
            except TransportClosed:
                return
    finally:
        endpoint.close()
