"""Cluster execution backend: measured completions from real worker pools.

:class:`ClusterBackend` dispatches each encoded shard to one process of a
:class:`~repro_torch.cluster.pool.WorkerPool` (operands via shared memory),
and the completion *times* the serving loop walks are measured on the
master as each product arrives, not drawn from a model.

:meth:`ClusterBackend.dispatch_batch` returns a :class:`ClusterDispatch`
whose :meth:`~ClusterDispatch.next_event` stream feeds the unified serving
loop: decoders update as shards arrive, answers emit mid-batch.  The
dispatch is wired against the runtime's two seams: operands are published
through the pool's :class:`~repro_torch.cluster.transport.Transport`
(shared memory locally, broadcast frames over TCP) and task messages carry
an opaque operand reference the worker's endpoint resolves; which
:class:`~repro_torch.cluster.worker.ShardComputer` produces the products is
the pool's ``compute`` recipe.  Every combination of
``{numpy, device} × {local, socket}`` serves the same features.

**Which encode each compute kind uses, and why.**

* ``compute="numpy"`` — the master encodes as the reference does: one
  float64 (complex128 for complex points) host ``einsum`` over the stacked
  request blocks (:meth:`~repro_torch.serving.backends.SimulatedBackend
  ._encode_host`).  The workers' width-1 einsum slices are then bit-identical
  to the simulated backend's full-batch contraction, so a numpy trace
  replays bit for bit through the port's ``sim`` path — and through the
  reference's, to float64 rounding.
* ``compute="device"`` — the master encodes on its own device through
  :meth:`~repro_torch.serving.backends.ExecutionBackend._encode_batch`
  (the ``poly_encode`` kernel on the card) and publishes the float32
  stacks (complex64 for complex points): the workers compute in float32,
  or round them to bf16 on their card (``SAC_CLUSTER_DEVICE_DTYPE=
  bfloat16``), and float32 is half the bytes of float64 in shared memory
  and on the socket.  :class:`ReplayBackend` with ``compute="device"``
  runs the same encode and the same :class:`~repro_torch.cluster.worker
  .TorchShardComputer` path in the same dtype, so a device trace replays
  bit for bit inside the port under the same ``SAC_CLUSTER_DEVICE_DTYPE``.

Worker products arrive as host arrays and become tensors on the backend's
:attr:`device`, where the scheduler keeps operands and decode state.

**Speculative execution** (``speculate=True``): the dispatch can re-send a
still-pending shard to a backup worker leased *outside* the active fleet
(:meth:`ClusterDispatch.speculate` — the scheduler's hedging policy decides
when), first completion wins and losing copies are cancelled; a crashed
primary's shard is re-queued to its replacement instead of abandoned; and
``replicate=r`` pins ``r-1`` up-front copies of every shard (the
replication baseline the paper compares against).

:class:`ReplayBackend` replays a
:class:`~repro_torch.cluster.events.TraceRecording` through the simulated
product path — the record/replay fixture that pins the cluster decode
outputs bit-identical to the simulated ones.  Replay needs only the final
per-shard outcome, so speculative traces replay through the same fixture
unchanged.

The master times its encode and publish per batch into the
``backend.encode_seconds`` and ``backend.publish_seconds`` histograms
(the device encode's time runs until the stacks are on the host).
"""
from __future__ import annotations

import queue as queue_mod
import time

import numpy as np
import torch

from ..obs import NULL_REGISTRY
from ..serving.backends import ExecutionBackend, SimulatedBackend
from .events import BatchRecord, ShardEvent, TraceRecording
from .pool import WorkerPool
from .worker import COMPUTE_NAMES, ComputeSpec, make_computer

__all__ = ["ClusterBackend", "ClusterDispatch", "ReplayBackend"]

_POLL = 0.02          # result-queue wait chunk: bounds reap/abandon latency


def worker_operands(backend: ExecutionBackend, compute: str, code, As, Bs,
                    n_shards: int | None = None):
    """The host ``(E_A, E_B)`` stacks a batch publishes to its workers.

    ``compute="numpy"``: the reference's float64 host encode.
    ``compute="device"``: the ``poly_encode`` kernel on ``backend.device``,
    brought to the host as float32 (complex64 for complex points).  See the
    module docstring for why.
    """
    if compute == "numpy":
        return SimulatedBackend._encode_host(code, As, Bs, n_shards)
    dev = backend.device
    As = [torch.as_tensor(A, device=dev) for A in As]
    Bs = [torch.as_tensor(B, device=dev) for B in Bs]
    return tuple(_host_stack(re, im) for re, im in
                 backend._encode_batch(code, As, Bs, n_shards))


def _host_stack(re: torch.Tensor, im: torch.Tensor | None) -> np.ndarray:
    """One encoded stack on the host (complex64 when ``im`` is given)."""
    if im is None:
        return re.cpu().numpy()
    out = np.empty(tuple(re.shape), np.complex64)
    out.real = re.cpu().numpy()
    out.imag = im.cpu().numpy()
    return out


class ClusterDispatch:
    """One in-flight batch: pending shards, live events, measured times.

    Event timestamps are seconds since dispatch, taken at the instant the
    master drains the result (so processing order *is* timestamp order) and
    nudged strictly increasing — a replayed ``argsort`` reconstructs the
    exact arrival sequence, which is what makes record/replay bit-identical.
    """

    def __init__(self, backend: "ClusterBackend", E_A: np.ndarray,
                 E_B: np.ndarray):
        self.backend = backend
        self.device = backend.device
        self.pool = backend.pool
        self.n_shards = int(E_A.shape[1])
        self.batch_id = backend._next_batch_id()
        self.max_requeue = backend.max_requeue
        self._m = backend._m                      # backend.* counters
        self._h_phase = backend._h_phase          # per-phase latency hists
        if backend.speculate_enabled:
            # a worker wedged on a previous batch (hung primary whose shard
            # a backup won) must not be handed a fresh shard
            for wid in self.pool.stale_workers(self.batch_id):
                self.pool.retire(wid, "stale")
        self.workers = self.pool.lease(self.n_shards)
        t_pub = time.perf_counter()
        self._operands = self.pool.transport.publish(E_A, E_B)
        backend._h_publish.observe(time.perf_counter() - t_pub)
        self._out_shape = (E_A.shape[0], E_A.shape[2], E_B.shape[3])
        self._out_dtype = np.result_type(E_A.dtype, E_B.dtype)
        self.pending: dict[int, int] = {}         # shard -> primary worker id
        self.copies: dict[int, set[int]] = {}     # shard -> every live copy
        self.attempts: dict[int, int] = {}        # shard -> dispatch count
        self.times: dict[int, float] = {}
        self.lost: dict[int, str] = {}
        self.products: dict[int, np.ndarray] = {}
        self.redispatches: list[tuple[int, str]] = []
        self.n_speculated = 0
        self._backup_wids: list[int] = []
        self._queued: list[ShardEvent] = []       # lost/redispatch backlog
        self._last_t = 0.0
        self.abandon_at: float | None = None
        self._finalized = False
        if backend.speculate_enabled or backend.replicate > 1:
            # pay process startup before the dispatch clock starts, so a
            # mid-batch lease_backup finds a warm ready spare
            self.pool.prewarm(max(self.pool.target_spares,
                                  (backend.replicate - 1) * self.n_shards))
        backend._live_dispatches.add(self)
        self._m["batches_dispatched"].inc()
        self._m["shards_dispatched"].inc(self.n_shards)
        self._t0 = time.monotonic()
        undelivered = []
        for shard in range(self.n_shards):
            wid = self.workers[shard]
            self.pending[shard] = wid
            self.copies[shard] = {wid}
            self.attempts[shard] = 1
            if not self.pool.send(
                    wid, ("task", self.batch_id, shard,
                          self._operands.ref), operands=self._operands):
                undelivered.append(shard)
        if backend.replicate > 1:
            for shard in range(self.n_shards):
                for _ in range(backend.replicate - 1):
                    self.speculate(shard, reason="replicate")
        for shard in undelivered:
            self._undelivered(shard)

    # ------------------------------------------------------------------ time
    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def _stamp(self) -> float:
        """Strictly-increasing arrival timestamp (see class docstring)."""
        t = self.elapsed()
        if t <= self._last_t:
            t = float(np.nextafter(self._last_t, np.inf))
        self._last_t = t
        return t

    # ------------------------------------------------------------ event pump
    @property
    def outstanding(self) -> int:
        # queued lost/redispatch events still owe the consumer a delivery
        return len(self.pending) + len(self._queued)

    def set_abandon(self, t: float | None) -> None:
        """Abandon still-pending shards once ``elapsed() >= t`` (hang bound)."""
        self.abandon_at = None if t is None else float(t)

    # ----------------------------------------------------------- speculation
    def copies_of(self, shard: int) -> int:
        """How many live copies of ``shard`` are currently in flight."""
        return len(self.copies.get(shard, ()))

    def speculate(self, shard: int, reason: str = "hedge") -> bool:
        """Re-dispatch a still-pending shard to a freshly leased backup.

        The backup runs *outside* the active fleet (shard → slot identity
        never rotates) and races the primary: first completion wins, the
        loser is cancelled.  Emits a ``redispatch`` event on the stream.
        Returns ``False`` when the shard already resolved or no backup
        could be leased — the caller simply doesn't hedge.
        """
        if shard not in self.pending:
            return False
        wid = self.pool.lease_backup()
        if wid is None:
            return False
        if not self.pool.send(wid, ("task", self.batch_id, shard,
                                    self._operands.ref),
                              operands=self._operands):
            self.pool.release_backup(wid)
            return False
        self._backup_wids.append(wid)
        self.copies.setdefault(shard, set()).add(wid)
        self.attempts[shard] = self.attempts.get(shard, 1) + 1
        self.n_speculated += 1
        self._m["speculations"].inc()
        self.redispatches.append((shard, reason))
        self._queued.append(ShardEvent(kind="redispatch", shard=shard,
                                       t=self._stamp(), worker=wid,
                                       reason=reason))
        return True

    def _mark_lost(self, shard: int, reason: str) -> None:
        wid = self.pending.pop(shard)
        self.pool.mark_done(wid, self.batch_id, shard)
        for other in self.copies.pop(shard, set()) - {wid}:
            self.pool.cancel(other, self.batch_id, shard)
        t = self._stamp()
        self.lost[shard] = reason
        self._queued.append(ShardEvent(kind="lost", shard=shard, t=t,
                                       worker=wid, reason=reason))

    def _undelivered(self, shard: int) -> None:
        """The primary's channel was dead at dispatch (a worker that died
        after the lease's reap, e.g. a crasher reading a task whose shard
        its replica had already won).  A replica sent meanwhile becomes the
        primary, as when a primary crashes mid-batch; without one the shard
        is lost."""
        self.copies[shard].discard(self.pending[shard])
        if self.copies[shard]:
            self.pending[shard] = min(self.copies[shard])
        else:
            self._mark_lost(shard, "dispatch")

    def _requeue(self, shard: int) -> bool:
        """Crashed primary: re-send the shard to its slot's replacement."""
        new_wid = self.pool.active[shard]
        if not self.pool.send(new_wid, ("task", self.batch_id, shard,
                                        self._operands.ref),
                              operands=self._operands):
            return False
        self.pending[shard] = new_wid
        self.copies.setdefault(shard, set()).add(new_wid)
        self.attempts[shard] = self.attempts.get(shard, 1) + 1
        self.pool.requeued(1)
        self._m["requeues"].inc()
        self.redispatches.append((shard, "crash"))
        self._queued.append(ShardEvent(kind="redispatch", shard=shard,
                                       t=self._stamp(), worker=new_wid,
                                       reason="crash"))
        return True

    def _sweep(self) -> None:
        """Reap crashed workers; abandon everything past the hang bound.

        In speculate mode a crashed primary's shard is *re-queued* — to a
        surviving copy if one is racing, else to the replacement worker in
        the same lease slot (bounded by ``max_requeue`` attempts) — instead
        of being written off for the batch.
        """
        for wid, lost_shards in self.pool.reap(replace=True):
            for batch_id, shard in lost_shards:
                if batch_id != self.batch_id or shard not in self.pending:
                    continue
                if self.pending[shard] != wid:
                    # a backup copy died; the primary is still racing
                    self.copies.get(shard, set()).discard(wid)
                    continue
                self.copies.get(shard, set()).discard(wid)
                survivors = self.copies.get(shard, set())
                if survivors:
                    # promote a live copy to primary; reap overcounted
                    self.pending[shard] = min(survivors)
                    self.pool.requeued(1)
                    continue
                if (self.backend.speculate_enabled
                        and self.attempts.get(shard, 1) < self.max_requeue
                        and self._requeue(shard)):
                    continue
                self._mark_lost(shard, "crash")
        if self.abandon_at is not None and self.elapsed() >= self.abandon_at:
            for shard in sorted(self.pending):
                wid = self.pending[shard]
                # retire before clearing the in-flight bookkeeping: the
                # pool's shards_lost counter reads the worker's busy set
                self.pool.retire(wid, "timeout")
                self._mark_lost(shard, "timeout")

    def next_event(self, timeout: float | None = None) -> ShardEvent | None:
        """The next live event, or ``None`` on timeout.

        Kinds: ``done`` (first completion of a shard — late duplicates from
        cancelled copies are swallowed and counted by the pool), ``lost``,
        and ``redispatch`` (a speculative/re-queued copy was launched).
        Blocks at most ``timeout`` seconds (``None``: until the next event
        or the abandon bound).  Crashed workers surface as ``lost`` events
        from the periodic reap sweep, so a dead process can never wedge the
        stream.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._queued:
                return self._queued.pop(0)
            if not self.pending:
                return None
            self._sweep()
            if self._queued:
                return self._queued.pop(0)
            left = _POLL if deadline is None \
                else min(_POLL, deadline - time.monotonic())
            if left <= 0:
                return None
            try:
                msg = self.pool.results.get(timeout=left)
            except queue_mod.Empty:
                continue
            if msg[0] == "pong" or self.pool.absorb(msg):
                continue
            if msg[0] == "error":
                _, wid, batch_id, shard, err = msg
                raise RuntimeError(f"cluster worker {wid} failed on batch "
                                   f"{batch_id} shard {shard}: {err}")
            # workers piggyback a monotonic timing triple as field 6; a
            # 5-field message (older transports, hand-crafted test frames)
            # simply has no timings
            _, wid, batch_id, shard, P = msg[:5]
            timings = msg[5] if len(msg) > 5 else None
            duplicate = self.pool.mark_done(wid, batch_id, shard)
            if duplicate or batch_id != self.batch_id \
                    or shard not in self.pending:
                continue              # stale/abandoned/first-wins loser
            primary = self.pending.pop(shard)
            for other in self.copies.pop(shard, {primary}) - {wid}:
                self.pool.cancel(other, batch_id, shard)
            t = self._stamp()
            self.times[shard] = t
            self.products[shard] = P
            products = torch.from_numpy(P).to(self.device)
            if timings is not None:
                self._h_phase["wait"].observe(timings[0])
                self._h_phase["operands"].observe(timings[1])
                self._h_phase["compute"].observe(timings[2])
            return ShardEvent(kind="done", shard=shard, t=t, worker=wid,
                              products=products, speculative=wid != primary,
                              timings=timings)

    def drain(self, timeout: float) -> None:
        """Pump events until nothing is pending (bounded by ``timeout``)."""
        if self.abandon_at is None:
            self.set_abandon(self.elapsed() + timeout)
        while self.pending or self._queued:
            if self.next_event(timeout=_POLL) is None and not self.pending:
                break

    # -------------------------------------------------------------- teardown
    def record(self) -> BatchRecord:
        return BatchRecord(n_shards=self.n_shards, times=dict(self.times),
                           lost=dict(self.lost),
                           redispatches=[[s, r]
                                         for s, r in self.redispatches])

    def latency_row(self) -> np.ndarray:
        """Measured per-shard times (``inf`` where the shard never arrived)."""
        return self.record().latency_row()

    def product_stack(self) -> torch.Tensor:
        """``(B, n_shards, Nx, Ny)`` stack on the backend's device; lost
        shards are zero-filled.

        Zeros are safe placeholders: a lost shard's time is ``inf``, so no
        decode state the event loop reaches ever reads its product.
        """
        B, Nx, Ny = self._out_shape
        out = np.zeros((B, self.n_shards, Nx, Ny), dtype=self._out_dtype)
        for shard, P in self.products.items():
            out[:, shard] = P
        return torch.from_numpy(out).to(self.device)

    def finalize(self) -> BatchRecord:
        """Release the batch's published operands; record its completion trace."""
        if self._finalized:
            return self.record()
        self._finalized = True
        self.backend._live_dispatches.discard(self)
        for wid in self._backup_wids:
            self.pool.release_backup(wid)
        self._operands.release()
        rec = self.record()
        if self.backend.recording is not None:
            self.backend.recording.append(rec)
        return rec


class ClusterBackend(ExecutionBackend):
    """Products from a real worker pool; latencies *measured*, not modeled.

    ``workers`` is the starting fleet, ``spares`` the warm-spare budget,
    ``chaos`` the injected perturbation spec (see
    :class:`~repro_torch.cluster.worker.ChaosSpec`).  ``grace`` bounds how
    long a live dispatch waits for stragglers past its last deadline before
    abandoning them (the hang bound); ``sync_timeout`` bounds blocking
    :meth:`ClusterDispatch.drain` callers.  ``record=True`` keeps a
    :class:`~repro_torch.cluster.events.TraceRecording` of every batch for
    replay.

    ``speculate=True`` arms the speculative surface: crashed primaries'
    shards re-queue to their replacements (up to ``max_requeue`` attempts),
    wedged workers are retired between batches, and the scheduler may call
    :meth:`ClusterDispatch.speculate` mid-batch.  ``replicate=r`` instead
    pins ``r-1`` up-front copies of every shard — the classic replication
    baseline, no policy in the loop.

    ``compute`` (``"device"``, the default, or ``"numpy"``) and
    ``transport`` (``"local"`` | ``"socket"``; ``hosts`` overrides the
    socket listener addresses) select the pool's two seams — any of the
    four combinations serves the full feature set.  ``device`` is where
    the master encodes (device compute), keeps the products and decodes —
    the CUDA card unless ``"cpu"`` — and where device-compute workers run.
    """

    name = "cluster"
    live = True                    # events are wall-clocked measurements

    def __init__(self, *, workers: int = 4, spares: int = 0,
                 chaos=None, seed: int = 0, record: bool = False,
                 grace: float = 2.0, sync_timeout: float = 60.0,
                 speculate: bool = False, replicate: int = 1,
                 max_requeue: int = 3, compute=None, transport=None,
                 hosts=None, pool: WorkerPool | None = None, metrics=None,
                 device=None):
        super().__init__(device)
        if grace <= 0 or sync_timeout <= 0:
            raise ValueError("grace and sync_timeout must be > 0")
        if replicate < 1:
            raise ValueError(f"replicate must be >= 1; got {replicate}")
        if pool is None:
            compute = ComputeSpec.parse(compute, device=self.device.type)
        self.pool = pool if pool is not None else WorkerPool(
            workers, spares=spares, chaos=chaos, seed=seed,
            compute=compute, transport=transport, hosts=hosts,
            metrics=metrics)
        self.compute = self.pool.compute.kind
        self._owns_pool = pool is None
        # an adopted pool keeps its own registry unless we were handed one
        self.metrics = metrics if metrics is not None else self.pool.metrics
        if self.metrics is None:
            self.metrics = NULL_REGISTRY
        self._m = {k: self.metrics.counter("backend." + k)
                   for k in ("batches_dispatched", "shards_dispatched",
                             "speculations", "requeues")}
        # per-phase shard latency distributions from the worker-reported
        # timing triples — the aggregate view attribution drills into
        self._h_phase = {
            "wait": self.metrics.histogram("backend.shard_wait_seconds"),
            "operands": self.metrics.histogram(
                "backend.shard_operand_seconds"),
            "compute": self.metrics.histogram(
                "backend.shard_compute_seconds"),
        }
        self._h_encode = self.metrics.histogram("backend.encode_seconds")
        self._h_publish = self.metrics.histogram("backend.publish_seconds")
        self.grace = float(grace)
        self.sync_timeout = float(sync_timeout)
        self.speculate_enabled = bool(speculate)
        self.replicate = int(replicate)
        self.max_requeue = int(max_requeue)
        self.recording: TraceRecording | None = \
            TraceRecording() if record else None
        self._batch_counter = 0
        self._live_dispatches: set[ClusterDispatch] = set()

    def _next_batch_id(self) -> int:
        self._batch_counter += 1
        return self._batch_counter

    # ------------------------------------------------------------- live path
    def dispatch_batch(self, code, As, Bs, n_shards: int | None = None,
                       rng=None) -> ClusterDispatch:
        """Encode the batch and fan its shards out to the pool — live handle.

        The pool is right-sized to the shard count: a code (or fleet cap)
        larger than the current fleet *acquires* workers — the scale-out
        path — and a smaller one releases them into warm spares.  ``rng``
        is accepted for the unified backend signature and unused: cluster
        latencies are measured, never drawn.
        """
        t_enc = time.perf_counter()
        E_A, E_B = worker_operands(self, self.compute, code, As, Bs,
                                   n_shards)
        self._h_encode.observe(time.perf_counter() - t_enc)
        return ClusterDispatch(self, E_A, E_B)

    # -------------------------------------------------------------- teardown
    def close(self) -> None:
        # finalize anything a crashed/raising caller left in flight: the
        # published operands (shm segments!) must not outlive the backend
        for d in list(self._live_dispatches):
            d.finalize()
        if self._owns_pool:
            self.pool.shutdown()

    def __enter__(self) -> "ClusterBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ReplayBackend(SimulatedBackend):
    """Replay a recorded cluster trace through the simulated product path.

    Products come from the *same* encode + contraction as the cluster
    workers, and ``draw_latencies`` replays the measured per-shard times
    batch by batch.  Serving a replay therefore reproduces a cluster run
    exactly, which is both the equivalence fixture and a debugging tool
    (re-serve a production trace under a different decoder/cache
    configuration).

    ``compute`` mirrors the recorded run's compute seam: ``"numpy"`` runs
    the float64 host encode and the full-batch einsum on any
    :attr:`device` — bit-identical to
    :class:`~repro_torch.cluster.worker.NumpyShardComputer`'s width-1
    slices — while ``"device"`` (the default, as for
    :class:`ClusterBackend`) runs the cluster's device encode and
    recomputes every per-shard product through the *same*
    :class:`~repro_torch.cluster.worker.TorchShardComputer` path the
    workers ran (on ``device``'s type, pinned per shard as the pool pins
    its first lease, in the dtype ``SAC_CLUSTER_DEVICE_DTYPE`` names), so
    device-mode traces replay bit-identically too under the recorded run's
    dtype.
    """

    name = "replay"

    def __init__(self, recording: TraceRecording, compute: str = "device",
                 **sim_kw):
        super().__init__(**sim_kw)
        if compute not in COMPUTE_NAMES:
            raise ValueError(f"unknown compute kind {compute!r}; valid: "
                             f"{', '.join(COMPUTE_NAMES)}")
        self.recording = recording
        self.compute = compute
        self._computers: dict[int, object] = {}
        self._cursor = 0

    def _computer_for(self, shard: int):
        """One device computer per device index, mirroring the pool's
        pinning (worker ``wid`` == shard slot on the first lease)."""
        spec = ComputeSpec.parse("device", device=self.device.type) \
            .for_worker(shard)
        if spec.device_index not in self._computers:
            self._computers[spec.device_index] = make_computer(spec)
        return self._computers[spec.device_index]

    def compute_products(self, code, As, Bs,
                         n_shards: int | None = None) -> torch.Tensor:
        E_A, E_B = worker_operands(self, self.compute, code, As, Bs,
                                   n_shards)
        if self.compute == "numpy":
            P = np.einsum("rnij,rnjl->rnil", E_A, E_B)
        else:
            P = np.stack([self._computer_for(shard).shard_products(
                E_A, E_B, shard) for shard in range(E_A.shape[1])], axis=1)
        return torch.from_numpy(P).to(self.device)

    def draw_latencies(self, rng: np.random.Generator,
                       N: int) -> np.ndarray:
        if self._cursor >= len(self.recording.batches):
            raise ValueError(f"trace exhausted after "
                             f"{len(self.recording.batches)} batches")
        rec = self.recording.batches[self._cursor]
        self._cursor += 1
        if rec.n_shards != N:
            raise ValueError(f"recorded batch {self._cursor} has "
                             f"{rec.n_shards} shards, fleet wants {N} — "
                             "replay must use the recording's code/fleet")
        return rec.latency_row()
