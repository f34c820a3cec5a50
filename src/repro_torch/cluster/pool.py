"""Worker pool: acquisition, warm spares, liveness, dead-worker replacement.

The elastic controller can always *shrink* the dispatched fleet below the
starting ``--N``; growing past it needs somewhere for the extra workers to
come from.  :class:`WorkerPool` is that somewhere — a supervisor over real
OS processes (:func:`~repro_torch.cluster.worker.worker_main`):

* :meth:`acquire` / :meth:`release` — lease workers into the active fleet
  and return them; released workers stay warm as spares up to the
  configured budget (a later ``acquire`` reuses them without paying process
  startup), beyond it they are shut down.
* :meth:`lease` — the dispatch-path wrapper: rightsize the active fleet to
  exactly ``n`` workers (acquiring or releasing as needed) and return the
  shard → worker assignment.
* :meth:`reap` — liveness sweep: dead processes (crashed workers) are
  detected, their in-flight shards reported lost, and replacements spawned
  so the fleet heals to its leased size.
* :meth:`heartbeat` — active ping over the task channels (a stuck-but-alive
  worker answers ``is_alive()`` yet never a ping); safe between batches.
* :meth:`lease_backup` / :meth:`release_backup` / :meth:`cancel` /
  :meth:`prewarm` — the speculative-execution surface: backups are leased
  *outside* the active fleet (shard → slot identity never rotates), a
  cancelled copy's late result is reaped as a duplicate
  (``duplicates_reaped``) instead of corrupting the next batch, and
  ``shards_cancelled`` counts first-wins losers separately from
  ``shards_lost`` (shards that genuinely never arrived).

The pool is wired against the runtime's two seams: the **transport**
(:mod:`~repro_torch.cluster.transport` — ``"local"`` pipes/shm or
``"socket"`` TCP; every message, operand block and result crosses it) and
the **compute** recipe (:class:`~repro_torch.cluster.worker.ComputeSpec` —
numpy or device shard products; the pool stamps each worker's device index
at spawn).  Workers are daemon processes: a wedged master can die without
leaving orphans, and a test cannot be held hostage by a hung worker.

Process discipline: workers are started with ``spawn`` only (a forked child
of a process that holds CUDA, or a test runner's channel, is unsafe), and
the pool only ever joins and ``kill()``s the :class:`multiprocessing.Process`
objects it spawned — never a process group, never another pid.  A device
pool on a CUDA card builds the ``coded_matmul`` kernel once in the parent
before it spawns anyone, so the workers load it instead of each starting
``nvcc``.  A worker that reports a startup failure (no card, no kernel)
makes the pool raise.  :meth:`shutdown` collects each worker's ``bye`` and
keeps its kernel launch counts in :attr:`worker_counters`.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import time
from dataclasses import dataclass, field

from ..obs import NULL_REGISTRY
from .transport import OperandHandle, Transport, make_transport
from .worker import ChaosSpec, ComputeSpec, worker_main

__all__ = ["WorkerPool", "WorkerHandle"]

_JOIN_TIMEOUT = 2.0
_SHUTDOWN_DRAIN = 5.0     # bound on shutdown's wait for workers to exit


def _build_kernel_once() -> None:
    """Build the workers' kernel in the parent (one ``nvcc``, not one per
    worker) when this host has a card; without one the workers report it."""
    import torch
    if torch.cuda.is_available():
        from ..kernels._build import build_all
        build_all(("coded_matmul",))


@dataclass
class WorkerHandle:
    """Supervisor-side state of one worker process."""

    wid: int
    proc: object
    conn: object                          # master-side transport channel
    busy: set = field(default_factory=set)   # in-flight (batch_id, shard)
    ready: bool = False                   # startup handshake received

    def alive(self) -> bool:
        # a closed/truncated channel is as dead as a crashed process: its
        # in-flight shards can never arrive, so reap must see it
        return self.proc.is_alive() and not self.conn.dead

    def poll_ready(self, timeout: float = 0.0) -> bool:
        """Consume the worker's startup handshake if it has arrived."""
        if self.ready:
            return True
        if self.conn.poll_ready(timeout):
            self.ready = True
        return self.ready


class WorkerPool:
    """A supervised fleet of worker processes with warm spares.

    ``workers`` processes are spawned up front (the starting fleet);
    ``spares`` is the warm-spare budget kept alive after releases.  ``chaos``
    is a :class:`~repro_torch.cluster.worker.ChaosSpec` or its string form —
    perturbation plans are assigned by worker id at spawn, so runs are
    reproducible.  Workers always start with ``spawn``: a forked child
    would inherit the master's CUDA state and pipes.

    ``transport`` selects the wire (``"local"`` | ``"socket"`` | a ready
    :class:`~repro_torch.cluster.transport.Transport`; ``hosts`` overrides the
    socket listener addresses) and ``compute`` the workers' shard computer
    (``"device"`` | ``"numpy"`` | a
    :class:`~repro_torch.cluster.worker.ComputeSpec`); both default from
    :data:`~repro_torch.cluster.config.global_config`.
    """

    def __init__(self, workers: int = 0, *, spares: int = 0,
                 chaos: ChaosSpec | str | None = None, seed: int = 0,
                 ready_timeout: float = 60.0,
                 transport: Transport | str | None = None,
                 compute: ComputeSpec | str | None = None,
                 hosts=None, metrics=None):
        if workers < 0 or spares < 0:
            raise ValueError(f"need workers >= 0 and spares >= 0; got "
                             f"{workers}, {spares}")
        self.ready_timeout = float(ready_timeout)
        self.chaos = chaos if isinstance(chaos, ChaosSpec) \
            else ChaosSpec.parse(chaos)
        self.seed = int(seed)
        self.target_spares = int(spares)
        self._ctx = mp.get_context("spawn")
        self.metrics = metrics if metrics is not None else NULL_REGISTRY
        self.transport = make_transport(transport, ctx=self._ctx,
                                        hosts=hosts, metrics=self.metrics)
        self.compute = ComputeSpec.parse(compute)
        if self.compute.kind == "device" and self.compute.device == "cuda":
            _build_kernel_once()
        self._active: dict[int, WorkerHandle] = {}
        self._spares: list[WorkerHandle] = []
        self._backups: dict[int, WorkerHandle] = {}   # speculative leases
        self._cancelled: set[tuple[int, int, int]] = set()  # (wid, batch,
        #                                                      shard)
        self._next_id = 0
        self._closed = False
        self.worker_counters: dict[int, dict] = {}   # wid -> bye counters
        self.stats = {"spawned": 0, "replaced": 0, "retired": 0,
                      "crashed": 0, "acquired": 0, "released": 0,
                      "shards_lost": 0, "shards_cancelled": 0,
                      "duplicates_reaped": 0, "backups_leased": 0,
                      "shards_requeued": 0}
        # registry mirror of the stats dict: every mutation goes through
        # _bump so ``pool.<key>`` counters and ``stats`` cannot diverge
        self._mcounters = {k: self.metrics.counter("pool." + k)
                           for k in self.stats}
        # fleet-composition gauges for the time-series sampler; every
        # fleet mutation also bumps a counter, so refreshing them from
        # _bump keeps the levels exact without per-site wiring
        self._g_active = self.metrics.gauge("pool.active_workers")
        self._g_spare = self.metrics.gauge("pool.spare_workers")
        self._g_backup = self.metrics.gauge("pool.backup_workers")
        if workers:
            self.acquire(workers)

    def _bump(self, key: str, n: int = 1) -> None:
        self.stats[key] += n
        self._mcounters[key].inc(n)
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        self._g_active.set(len(self._active))
        self._g_spare.set(len(self._spares))
        self._g_backup.set(len(self._backups))

    # ---------------------------------------------------------------- sizing
    @property
    def results(self):
        """The transport's unified result stream (done/pong messages)."""
        return self.transport.results

    @property
    def active(self) -> list[int]:
        """Leased worker ids in lease order (shard n runs on ``active[n]``)."""
        return list(self._active)

    @property
    def size(self) -> int:
        return len(self._active)

    @property
    def spares(self) -> int:
        return len(self._spares)

    @property
    def backups(self) -> list[int]:
        """Worker ids of live speculative leases (outside the active fleet)."""
        return list(self._backups)

    def _handle(self, wid: int) -> WorkerHandle | None:
        """Resolve a worker id across the active fleet and backup leases."""
        h = self._active.get(int(wid))
        return h if h is not None else self._backups.get(int(wid))

    def _spawn(self) -> WorkerHandle:
        wid = self._next_id
        self._next_id += 1
        channel, endpoint_arg = self.transport.connect(wid)
        proc = self._ctx.Process(
            target=worker_main,
            args=(wid, endpoint_arg, self.chaos.plan_for(wid), self.seed,
                  self.compute.for_worker(wid)),
            daemon=True, name=f"sac-worker-{wid}")
        proc.start()
        if endpoint_arg[0] == "local":
            endpoint_arg[1].close()       # child's pipe end, now inherited
        self._bump("spawned")
        return WorkerHandle(wid=wid, proc=proc, conn=channel)

    def acquire(self, n: int) -> list[int]:
        """Lease ``n`` more workers into the active fleet; returns their ids.

        Warm spares are reused first (no process startup), the rest are
        spawned.  This is the scale-*out* path: nothing bounds the fleet to
        the starting size.
        """
        if n < 0:
            raise ValueError(f"acquire needs n >= 0; got {n}")
        self._check_open()
        out = []
        for _ in range(n):
            while self._spares:
                h = self._spares.pop()
                if h.alive():
                    break
                self._scrap(h)
            else:
                h = self._spawn()
            self._active[h.wid] = h
            out.append(h.wid)
        self._bump("acquired", len(out))
        return out

    def release(self, wids) -> None:
        """Return leased workers; keep up to ``spares`` warm, retire the rest."""
        for wid in list(wids):
            h = self._active.pop(int(wid), None)
            if h is None:
                continue
            self._bump("released")
            if h.alive() and len(self._spares) < self.target_spares:
                self._spares.append(h)
            else:
                self._shutdown_handle(h)
        self._refresh_gauges()

    def lease(self, n: int) -> list[int]:
        """Rightsize the active fleet to exactly ``n`` and return it in order.

        The dispatch-path entry point: a grown fleet acquires (spares first),
        a shrunk one releases from the tail (warm spares keep the release
        cheap to undo).  Dead actives are replaced first, and the lease only
        returns once every worker has completed its startup handshake — so
        the dispatch clock (wall-clock deadlines!) never pays for process
        spawn time.
        """
        if n < 1:
            raise ValueError(f"lease needs n >= 1; got {n}")
        self.reap(replace=True)
        if len(self._active) < n:
            self.acquire(n - len(self._active))
        elif len(self._active) > n:
            self.release(self.active[n:])
        self.wait_ready(timeout=self.ready_timeout)
        return self.active

    def wait_ready(self, timeout: float = 30.0) -> bool:
        """Block until every active worker reported its startup handshake.

        Workers that die during startup are replaced (one healing pass) and
        the replacements awaited too; returns ``False`` if anything is
        still silent at the timeout — callers treat the silent workers like
        any other straggler (their shards simply never arrive).
        """
        deadline = time.monotonic() + timeout
        for attempt in range(2):
            all_ready = True
            for h in list(self._active.values()):
                while not h.poll_ready(0.0):
                    self._check_started(h)
                    left = deadline - time.monotonic()
                    if left <= 0 or not h.alive():
                        all_ready = False
                        break
                    h.poll_ready(min(left, 0.05))
            if all_ready:
                return True
            if attempt == 0 and not self.reap(replace=True):
                break                      # silent but alive: nothing to heal
        return all(h.ready for h in self._active.values())

    # -------------------------------------------------------------- liveness
    def reap(self, replace: bool = True) -> list[tuple[int, set]]:
        """Sweep for dead workers; returns ``[(wid, lost_shards), ...]``.

        A dead *active* worker is replaced in place (same lease slot, fresh
        process with a fresh id) when ``replace`` — the pool heals to its
        leased size, and the caller learns which in-flight ``(batch, shard)``
        pairs died with the process.  Dead spares are silently scrapped.
        Dead *backup* workers are scrapped without replacement (and without
        counting ``shards_lost`` — their copies are duplicates whose primary
        may still deliver); the dispatch decides whether the shard needs a
        fresh copy.
        """
        self._check_open()
        dead = []
        for wid, h in list(self._active.items()):
            if h.alive():
                continue
            self._check_started(h)
            dead.append((wid, set(h.busy)))
            self._bump("crashed")
            self._bump("shards_lost", len(h.busy))
            self._scrap(h)
            self._forget_cancelled(wid)
            if replace:
                nh = self._spawn()
                self._replace_slot(wid, nh)
                self._bump("replaced")
            else:
                del self._active[wid]
        for wid, h in list(self._backups.items()):
            if h.alive():
                continue
            dead.append((wid, set(h.busy)))
            self._bump("crashed")
            self._scrap(h)
            self._forget_cancelled(wid)
            del self._backups[wid]
        self._spares = [h for h in self._spares
                        if h.alive() or self._scrap(h)]
        return dead

    def _replace_slot(self, old_wid: int, nh: WorkerHandle) -> None:
        """Put ``nh`` into ``old_wid``'s *position* of the lease order.

        Shard n runs on ``active[n]``, and the empirical straggler profile
        bootstraps per-shard column marginals — so a replacement must keep
        the dead worker's slot, not shift every later worker one shard over.
        """
        self._active = {(nh.wid if wid == old_wid else wid):
                        (nh if wid == old_wid else h)
                        for wid, h in self._active.items()}

    def retire(self, wid: int, reason: str = "retired") -> None:
        """Kill and replace one active worker (hung past its deadline).

        A backup lease is killed without replacement — backups have no slot
        in the lease order to heal, and their in-flight copies are
        duplicates, not losses.
        """
        wid = int(wid)
        bh = self._backups.pop(wid, None)
        if bh is not None:
            self._bump("retired")
            bh.proc.kill()
            self._scrap(bh, join=True)
            self._forget_cancelled(wid)
            return
        h = self._active.get(wid)
        if h is None:
            return
        self._bump("retired")
        self._bump("shards_lost", len(h.busy))
        h.proc.kill()
        self._scrap(h, join=True)
        self._forget_cancelled(wid)
        self._replace_slot(wid, self._spawn())
        self._bump("replaced")

    def _forget_cancelled(self, wid: int) -> None:
        """Drop cancellation bookkeeping for a worker that no longer exists."""
        self._cancelled = {c for c in self._cancelled if c[0] != wid}

    def stale_workers(self, batch_id: int) -> list[int]:
        """Active workers still holding work from batches before ``batch_id``.

        A hung primary whose shard was won by a speculative copy keeps no
        ``busy`` entry (first-wins cancel cleared it) but does keep a
        ``_cancelled`` marker; a plain hung worker keeps its ``busy`` entry.
        Either way the process is wedged and must be retired before it can
        poison the next dispatch.
        """
        out = []
        for wid, h in self._active.items():
            if any(b < batch_id for b, _ in h.busy):
                out.append(wid)
            elif any(c[0] == wid and c[1] < batch_id
                     for c in self._cancelled):
                out.append(wid)
        return out

    def heartbeat(self, timeout: float = 2.0) -> dict[int, float]:
        """Ping every idle active worker; returns ``{wid: rtt_seconds}``.

        Only safe between batches: pongs arrive on the shared result queue,
        so a concurrent dispatch would have its completions drained here.
        Busy/hung workers simply do not answer — absence from the returned
        dict *is* the signal.
        """
        self._check_open()
        token = time.monotonic_ns()
        idle = [h for h in self._active.values() if not h.busy and h.alive()]
        t0 = time.monotonic()
        for h in idle:
            h.conn.send(("ping", token))
        out: dict[int, float] = {}
        deadline = t0 + timeout
        while len(out) < len(idle):
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                msg = self.results.get(timeout=left)
            except queue_mod.Empty:
                break
            if msg[0] == "pong" and msg[2] == token:
                out[msg[1]] = time.monotonic() - t0
            else:
                self.absorb(msg)
        return out

    def absorb(self, msg) -> bool:
        """Keep a worker's ``bye`` counters; ``True`` if ``msg`` was one.

        Every consumer of :attr:`results` hands non-result messages here,
        so a retired worker's farewell is never mistaken for a completion.
        """
        if msg[0] != "bye":
            return False
        self.worker_counters[int(msg[1])] = dict(msg[2])
        return True

    def kernel_launches(self) -> dict[str, int]:
        """Kernel launches the workers reported, summed by kernel name."""
        out: dict[str, int] = {}
        for counters in self.worker_counters.values():
            for name, n in counters.items():
                out[name] = out.get(name, 0) + int(n)
        return out

    # ------------------------------------------------------------- transport
    def send(self, wid: int, msg,
             operands: OperandHandle | None = None) -> bool:
        """Deliver one task message; ``False`` when the channel is dead.

        ``operands`` is the batch's published operand handle — the channel
        decides what crossing the wire means (nothing for shared memory,
        a one-time broadcast frame per worker for the socket transport).
        """
        h = self._handle(wid)
        if h is None:
            return False
        if not h.conn.send(msg, operands):
            return False
        if msg[0] == "task":
            h.busy.add((msg[1], msg[2]))
        return True

    def mark_done(self, wid: int, batch_id: int, shard: int) -> bool:
        """Record a completion; ``True`` when it was a reaped duplicate.

        A result from a copy cancelled by first-wins is still delivered on
        the shared queue eventually — it must be swallowed (and counted)
        instead of being mistaken for a fresh completion.
        """
        key = (int(wid), int(batch_id), int(shard))
        dup = key in self._cancelled
        if dup:
            self._cancelled.discard(key)
            self._bump("duplicates_reaped")
        h = self._handle(wid)
        if h is not None:
            h.busy.discard((batch_id, shard))
        return dup

    # ----------------------------------------------------------- speculation
    def cancel(self, wid: int, batch_id: int, shard: int) -> bool:
        """First-wins: mark a losing copy cancelled; its late result is reaped.

        Returns ``True`` when the worker still held the shard.  The worker
        itself is not interrupted (tasks are not preemptible); the
        ``_cancelled`` marker makes its eventual result land as a
        ``duplicates_reaped`` instead of a completion.
        """
        h = self._handle(wid)
        if h is None or (batch_id, shard) not in h.busy:
            return False
        h.busy.discard((batch_id, shard))
        self._cancelled.add((int(wid), int(batch_id), int(shard)))
        self._bump("shards_cancelled")
        return True

    def lease_backup(self) -> int | None:
        """Lease one worker *outside* the active fleet for a speculative copy.

        Warm spares are reused first; otherwise a fresh process is spawned
        and its startup handshake awaited (bounded by ``ready_timeout``) so
        the copy starts computing immediately.  The backup never enters the
        lease order — shard → slot identity in ``active`` stays stable.
        """
        self._check_open()
        while self._spares:
            h = self._spares.pop()
            if h.alive():
                break
            self._scrap(h)
        else:
            h = self._spawn()
        deadline = time.monotonic() + self.ready_timeout
        while not h.poll_ready(0.0):
            self._check_started(h)
            left = deadline - time.monotonic()
            if left <= 0 or not h.alive():
                break
            h.poll_ready(min(left, 0.05))
        if not h.alive():
            self._scrap(h)
            return None
        self._backups[h.wid] = h
        self._bump("backups_leased")
        return h.wid

    def release_backup(self, wid: int) -> None:
        """Return a speculative lease; keep it warm if the budget allows."""
        h = self._backups.pop(int(wid), None)
        if h is None:
            return
        self._bump("released")
        if h.alive() and len(self._spares) < self.target_spares:
            self._spares.append(h)
        else:
            self._shutdown_handle(h)

    def prewarm(self, n: int) -> None:
        """Spawn up to ``n`` warm spares and await their startup handshakes.

        Called before a speculative dispatch so a mid-batch ``lease_backup``
        never pays process startup inside the deadline window.
        """
        self._check_open()
        fresh = []
        while len(self._spares) + len(fresh) < int(n):
            fresh.append(self._spawn())
        deadline = time.monotonic() + self.ready_timeout
        for h in fresh:
            while not h.poll_ready(0.0):
                self._check_started(h)
                left = deadline - time.monotonic()
                if left <= 0 or not h.alive():
                    break
                h.poll_ready(min(left, 0.05))
        self._spares.extend(h for h in fresh if h.alive() or self._scrap(h))

    def requeued(self, n: int = 1) -> None:
        """Reclassify ``n`` crash losses as re-queues (the shard lives on).

        ``reap`` charges ``shards_lost`` for every in-flight shard of a dead
        worker; when the dispatch re-sends the shard to the replacement
        instead of abandoning it, the loss didn't happen.
        """
        self._bump("shards_lost", -int(n))
        self._bump("shards_requeued", int(n))

    # -------------------------------------------------------------- shutdown
    def _check_started(self, h: WorkerHandle) -> None:
        """Raise a worker's reported startup failure (no silent fallback)."""
        if not h.ready:
            h.poll_ready(0.0)
        if h.conn.error is not None:
            raise RuntimeError(f"cluster worker {h.wid} failed to start: "
                               f"{h.conn.error}")

    def _scrap(self, h: WorkerHandle, join: bool = False) -> bool:
        h.conn.close()
        if join:
            h.proc.join(_JOIN_TIMEOUT)
        return False          # so reap's filter-expression can call it

    @staticmethod
    def _stop(h: WorkerHandle) -> None:
        """Bounded join of this pool's own child, then ``kill()`` of it."""
        h.proc.join(_JOIN_TIMEOUT)
        if h.proc.is_alive():
            h.proc.kill()
            h.proc.join(_JOIN_TIMEOUT)

    def _shutdown_handle(self, h: WorkerHandle) -> None:
        h.conn.send(("shutdown",))
        self._stop(h)
        self._scrap(h)

    def _drain_until_exit(self, handles) -> None:
        """Read the result stream, keeping ``bye`` counters, until every
        worker has exited and each clean exit's ``bye`` is in (bounded).

        A worker whose last results nobody reads (a cancelled duplicate)
        cannot exit: its queue's feeder thread waits on the full pipe.
        Draining lets it finish instead of waiting out a join bound.
        """
        deadline = time.monotonic() + _SHUTDOWN_DRAIN
        while True:
            alive = any(h.proc.is_alive() for h in handles)
            clean = {h.wid for h in handles if h.proc.exitcode == 0}
            if not alive and clean <= set(self.worker_counters):
                return
            left = deadline - time.monotonic()
            if left <= 0:
                return
            try:
                msg = self.results.get(timeout=min(left, 0.05))
            except queue_mod.Empty:
                continue
            except (OSError, EOFError):
                return
            self.absorb(msg)

    def shutdown(self) -> None:
        """Stop every worker (active + spares); idempotent.

        Every worker is asked to stop at once; the result stream is drained
        (collecting their ``bye`` counters) while they exit; any still
        alive past the bound is killed.
        """
        if self._closed:
            return
        self._closed = True
        handles = [*self._active.values(), *self._backups.values(),
                   *self._spares]
        for h in handles:
            h.conn.send(("shutdown",))
        self._drain_until_exit(handles)
        for h in handles:
            self._stop(h)
            self._scrap(h)
        self._active.clear()
        self._backups.clear()
        self._spares.clear()
        self.transport.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("pool is shut down")

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def __repr__(self):
        return (f"WorkerPool(active={self.size}, spares={self.spares}, "
                f"spawned={self.stats['spawned']}, "
                f"replaced={self.stats['replaced']})")
