"""Master scheduler: request queue, batching, event-driven refinement loop.

Requests enter a queue, the master pops them in batches (one encode + one
worker dispatch per batch, sharing one latency draw), and answers
*stream*: one event loop walks the backend's ``dispatch_batch`` event
stream — worker completions merged with deadline ticks — pushing each
completed product into the request's incremental decoder and emitting a
refined estimate at every tick (and, in ``stream`` mode, at every
completion event).

Operands go to the backend's device at :meth:`MasterScheduler.submit`; the
reference product ``C = A @ B`` (float64, for the error report), the
decoders and the squared relative error ``‖est − C‖² / ‖C‖²`` are all
computed there, so on the card nothing but scalars reaches the host.  Host
control — queue, admission, latency clock, policy — stays in float64 numpy.

Timebase: on modeled backends, completion times and deadlines live on the
simulated latency clock; on the cluster backend
(:class:`~repro_torch.cluster.backend.ClusterBackend`) the same loop
consumes a *live* measured stream and deadlines become wall-clock seconds
from dispatch.  The event ordering honours the ``merged_event_stream``
contract (time order; ties resolve completion-before-tick), which is what
makes a recorded cluster run replay bit-identically through the simulated
path.

Speculative re-dispatch (``speculation=``): on a backend whose dispatch
handle supports mid-batch :meth:`speculate` (the cluster), the loop watches
the live stream and — when the hedging policy
(:class:`repro_torch.design.policy.SpeculationPolicy`) says a pending shard
is unlikely to finish before the deadline relative to the marginal value of
its resolution layer — re-dispatches the shard to a warm spare.  First
completion wins; duplicates are cancelled and counted separately from
losses; crashed workers' shards are re-queued by the dispatch instead of
abandoned.

Open-loop serving (:meth:`MasterScheduler.run_open`): timestamped arrivals
(:mod:`repro_torch.serving.loadgen` workloads) interleave with completions
on the merged event stream — requests are admitted at their arrival
instants *during* in-flight batches, shed when the bounded queue overflows
(``queue_limit``), batched earliest-deadline-first (``queue_policy="edf"``)
within shape-compatible classes, and released early once every member hit
its accuracy SLO (``target``).  Tie rule extending the stream contract: at
equal timestamps, completions (and the dispatches they trigger) precede
arrivals.  With an unbounded FIFO queue and no per-request SLOs the open
loop reduces bit-identically to :meth:`MasterScheduler.run`.  Arrivals live
on the virtual clock of the modeled backends and on the wall clock of a
live one (``realtime``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.codes.base import CDCCode
from ..obs import NULL_BURN, NULL_FLIGHT, NULL_REGISTRY, NULL_SAMPLER, \
    NULL_TRACER
from .backends import ExecutionBackend, SimulatedBackend
from ..names import unknown_name
from .cache import DecodeWeightCache
from .incremental import make_decoder

__all__ = ["ServeConfig", "MatmulRequest", "Answer", "RequestResult",
           "MasterScheduler", "serve_request", "merged_event_stream",
           "QUEUE_POLICIES"]

QUEUE_POLICIES = ("fifo", "edf")


def merged_event_stream(t_sorted, deadlines) -> list[tuple[float, int, int]]:
    """``(t, kind, i)`` stream: completion events (kind 0, ``i`` = completion
    index into the sorted times) merged with deadline ticks (kind 1), ticks
    firing *after* any completion carrying the same timestamp — the estimate
    a client reads at t includes every worker that finished by t.

    """
    events = [(float(t_sorted[i]), 0, i) for i in range(len(t_sorted))]
    events += [(float(dl), 1, -1) for dl in deadlines]
    events.sort(key=lambda e: (e[0], e[1]))
    return events


@dataclass
class ServeConfig:
    """Knobs of the serving loop (defaults = the historical serve CLI)."""

    deadlines: tuple = (1.1, 1.3, 1.6, 2.0, 3.0)
    stream: bool = False          # also answer at every completion event
    batch_size: int = 4           # requests encoded/dispatched together
    beta_mode: str = "one"
    decoder: str = "incremental"  # "incremental" | "recompute" (baseline)
    track_errors: bool = True     # compute C=A@B and report relative errors
    seed: int = 0
    # admission control + queue policy (the open-loop serving knobs; the
    # defaults are exactly the historical closed-loop behavior)
    queue_limit: int | None = None   # bounded queue: submit() sheds beyond
    queue_policy: str = "fifo"       # "fifo" | "edf" (see QUEUE_POLICIES)
    shed_expired: bool = False       # drop requests already past deadline
    #                                  at dequeue instead of dispatching them


@dataclass
class MatmulRequest:
    req_id: int
    A: torch.Tensor
    B: torch.Tensor
    # open-loop metadata (all optional; closed-loop submits leave defaults)
    tenant: str | None = None     # multi-tenant label for SLO accounting
    arrival: float = 0.0          # arrival instant on the global serve clock
    deadline: float | None = None  # absolute latency-SLO instant
    target: float | None = None   # accuracy SLO: stop refining at this
    #                               relative error (requires track_errors)


@dataclass
class Answer:
    """One emitted refinement of one request."""

    t: float                      # simulated service time of the answer
    m: int                        # completions incorporated
    rel_err: float | None         # ‖est - C‖²/‖C‖² (None: no estimate yet
    #                               or error tracking disabled)
    exact: bool                   # m reached the recovery threshold
    kind: str                     # "deadline" | "event"


@dataclass
class RequestResult:
    req_id: int
    answers: list = field(default_factory=list)
    ttfa: float | None = None     # time of the first available estimate
    t_exact: float | None = None  # time the estimate became exact
    decode_stats: dict = field(default_factory=dict)
    # open-loop bookkeeping on the *global* serve clock (``answers`` times
    # stay relative to the batch dispatch, as in closed-loop serving)
    tenant: str | None = None
    arrival: float = 0.0
    batch: int | None = None         # dispatch id serving this request (the
    #                                  tracer's batch key; None when dropped)
    t_dispatch: float | None = None  # instant the batch left the queue
    t_target: float | None = None    # instant the accuracy SLO was met
    t_done: float | None = None      # instant the batch released (or the
    #                                  request was dropped at dequeue)
    slo_ok: bool | None = None       # target met within the deadline
    dropped: str | None = None       # "expired": dequeued past deadline

    @property
    def tta(self) -> float | None:
        """Time-to-target-accuracy from arrival (``None``: never reached)."""
        if self.t_target is None:
            return None
        return self.t_target - self.arrival


_DEFAULT_CACHE = object()        # sentinel: "give me the default LRU";
#                                  an explicit cache=None disables caching


class MasterScheduler:
    """Queue → batch → dispatch → event-driven incremental decode.

    The scheduler keeps operands, reference products and decode state on
    ``backend.device``.

    ``policy`` (optional) is the adaptive-serving hook
    (:class:`repro_torch.design.AdaptivePolicy`, duck-typed): the scheduler feeds
    it every dispatched batch's observed worker latencies and consults it
    between batches; when a refit moves the frontier pick, the scheduler
    switches codes via :meth:`set_code` before the next dispatch.  A policy
    with ``per_class=True`` gets the batch's
    :class:`~repro.design.policy.RequestClass` alongside each observation
    and may switch codes per class (:attr:`class_codes`): heterogeneous job
    shapes serve under separately tuned codes on one scheduler.

    :meth:`set_fleet` is the elastic-fleet path: dispatch only the first
    ``N'`` encode shards of the current code — bit-identical to serving
    :func:`repro_torch.core.registry.restrict_code`'s N'-worker code
    directly.
    """

    def __init__(self, code: CDCCode, backend: ExecutionBackend | None = None,
                 config: ServeConfig | None = None,
                 cache: DecodeWeightCache | None = _DEFAULT_CACHE,
                 policy=None, speculation=None, metrics=None, tracer=None,
                 flight=None, sampler=None, burn=None):
        self.code = code
        self.backend = backend if backend is not None else SimulatedBackend()
        self.config = config if config is not None else ServeConfig()
        self.cache = DecodeWeightCache() if cache is _DEFAULT_CACHE else cache
        self.policy = policy
        self.speculation = speculation         # SpeculationPolicy (or None)
        self.device = self.backend.device
        self.metrics = metrics if metrics is not None else NULL_REGISTRY
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.flight = flight if flight is not None else NULL_FLIGHT
        self.sampler = sampler if sampler is not None else NULL_SAMPLER
        self.burn = burn if burn is not None else NULL_BURN
        if self.flight.enabled and self.sampler.enabled:
            self.flight.bind_sampler(self.sampler)
        # gate perf_counter pairs (a real cost even when discarded) on one
        # bool instead of the registry's no-op instruments
        self._m_on = self.metrics.enabled
        self._g_queue = self.metrics.gauge("serve.queue_depth")
        self._g_inflight = self.metrics.gauge("serve.inflight_shards")
        self._g_err = self.metrics.gauge("serve.last_rel_err")
        self._h_tick = self.metrics.histogram("serve.decode_tick_seconds")
        self._h_ttfa = self.metrics.histogram("serve.tta_first_seconds")
        self._h_tta = self.metrics.histogram("serve.tta_exact_seconds")
        self._h_depth = self.metrics.histogram("serve.queue_depth_sampled")
        self._h_decode = self.metrics.histogram("serve.decode_push_seconds")
        self._c_shed = self.metrics.counter("serve.shed")
        # global serve clock for closed-loop telemetry: accumulated batch
        # spans, so sampler ticks share one timeline with open-loop runs
        self._clock = 0.0
        if self.config.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got "
                             f"{self.config.batch_size}")
        if self.config.queue_policy not in QUEUE_POLICIES:
            raise unknown_name("queue policy", self.config.queue_policy,
                               QUEUE_POLICIES)
        if self.config.queue_limit is not None \
                and self.config.queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1 (or None), got "
                             f"{self.config.queue_limit}")
        self.rng = np.random.default_rng(self.config.seed)
        self._queue: deque[MatmulRequest] = deque()
        self._next_id = 0
        self._served = 0
        self.fleet: int | None = None          # dispatched shards (None=all)
        self.class_codes: dict = {}            # RequestClass -> code override
        self.switches: list[tuple[int, str, str]] = []
        self.losses: list[tuple[int, int, str]] = []   # (batch#, shard, why)
        self.speculations: list[tuple[int, int, str]] = []   # re-dispatches
        self._batches_served = 0
        # open-loop admission bookkeeping: shed decisions and the queue-depth
        # time series ((t, depth) samples at every admission/dispatch on the
        # global serve clock — the registry's histogram mirrors the depths)
        self.shed: list[tuple[str, float]] = []        # (tenant, arrival)
        self.depth_series: list[tuple[float, int]] = []
        # hedge-trigger observation window: recent per-batch completion rows
        # feed a small straggler fit so the speculation policy has a
        # P(finish-by-deadline) estimate after the first served batch
        self._hedge_rows: deque = deque(maxlen=64)
        self._hedge_fit: tuple[int, object] | None = None

    # --------------------------------------------------------------- intake
    def submit(self, A, B, *,
               tenant: str | None = None, deadline: float | None = None,
               arrival: float = 0.0,
               target: float | None = None) -> int | None:
        """Queue one job on the scheduler's device, validating its shape
        before accepting it.

        Mixed shapes are fine across the queue — batches group same-shape
        runs — but a malformed job must fail here, not deep inside a later
        batch encode.

        The keyword surface is the open-loop intake: ``tenant`` labels the
        request for per-tenant SLO accounting, ``arrival`` stamps it on the
        global serve clock, ``deadline`` is the *absolute* latency-SLO
        instant (arrival + the tenant's SLO window), and ``target`` is the
        accuracy SLO (relative error at which refinement may stop).  The
        old positional ``submit(A, B)`` surface is unchanged.

        Admission control: with ``config.queue_limit`` set, a submit
        against a full queue is *shed* — recorded in :attr:`shed`, counted
        in the obs registry (``serve.shed`` plus a per-tenant counter), and
        ``None`` is returned instead of a request id.
        """
        if not isinstance(A, torch.Tensor):
            A = np.asarray(A)
        if not isinstance(B, torch.Tensor):
            B = np.asarray(B)
        sa, sb = tuple(A.shape), tuple(B.shape)
        if len(sa) != 2 or len(sb) != 2 or sa[1] != sb[0]:
            raise ValueError(f"need 2-D operands with matching inner dim; "
                             f"got A {sa}, B {sb}")
        if sa[1] % self.code.K != 0:
            raise ValueError(f"inner dim {sa[1]} must be divisible by "
                             f"K={self.code.K} (the contraction splits into "
                             "K blocks)")
        limit = self.config.queue_limit
        if limit is not None and len(self._queue) >= limit:
            label = tenant if tenant is not None else "default"
            self.shed.append((label, float(arrival)))
            self._c_shed.inc()
            self.metrics.counter(f"serve.shed.{label}").inc()
            self.flight.record("shed", tenant=label, arrival=float(arrival),
                               depth=len(self._queue))
            return None
        # operands reach the device only once admitted: a shed request
        # costs no copy
        A = torch.as_tensor(A, device=self.device)
        B = torch.as_tensor(B, device=self.device)
        req_id = self._next_id
        self._next_id += 1
        self._queue.append(MatmulRequest(
            req_id, A, B, tenant=tenant, arrival=float(arrival),
            deadline=None if deadline is None else float(deadline),
            target=None if target is None else float(target)))
        self._g_queue.set(len(self._queue))
        self._h_depth.observe(float(len(self._queue)))
        self.depth_series.append((float(arrival), len(self._queue)))
        return req_id

    @property
    def pending(self) -> int:
        return len(self._queue)

    # ---------------------------------------------------------- code switch
    def set_code(self, code: CDCCode, cls=None) -> None:
        """Switch the serving code (adaptive policy, operator override).

        Only called between batches — in-flight decodes always finish on the
        code that dispatched them.  The decode-weight cache needs no flush:
        entries are keyed on ``code.cache_key()``.  Queued requests must
        stay servable, so the new K is validated against the queue first.

        ``cls`` scopes the switch to one request class (per-class adaptive
        policies); ``None`` switches the default code for every class
        without an override.
        """
        queued = self._queue if cls is None else \
            [r for r in self._queue if self._class_of(r) == cls]
        bad = [r.req_id for r in queued if r.A.shape[1] % code.K != 0]
        if bad:
            raise ValueError(
                f"cannot switch to {code!r}: queued requests {bad} have "
                f"inner dims not divisible by K={code.K}")
        old = self._code_for(cls)
        if code is not old:
            self.switches.append((self._served, repr(old), repr(code)))
        if cls is None:
            if code is not self.code:
                self.fleet = None          # fleet was sized for the old code
            self.code = code
        else:
            self.class_codes[cls] = code

    def _class_of(self, req: MatmulRequest):
        from ..design.policy import RequestClass
        return RequestClass.of(_host_like(req.A), _host_like(req.B))

    def _code_for(self, cls) -> CDCCode:
        return self.class_codes.get(cls, self.code) if cls is not None \
            else self.code

    # ---------------------------------------------------------- fleet sizing
    def set_fleet(self, N: int | None) -> None:
        """Dispatch only the first ``N`` encode shards of the current code.

        The cost axis of the elastic controller: a deliberately shrunk
        fleet occupies ``N`` workers instead of ``code.N``, at the price of
        the completions that will never arrive (the decode path already
        tolerates absent workers).  ``None`` restores the full fleet.
        Serving with ``set_fleet(N')`` is bit-identical to serving
        :func:`repro_torch.core.registry.restrict_code`'s N'-worker code.
        """
        if N is None:
            self.fleet = None
            return
        N = int(N)
        if not 1 <= N <= self.code.N:
            raise ValueError(f"fleet must be in [1, N={self.code.N}]; "
                             f"got {N}")
        if N < self.code.first_threshold:
            raise ValueError(
                f"fleet {N} is below the code's first threshold "
                f"{self.code.first_threshold}: no request could ever be "
                "answered (raise the fleet or switch codes first)")
        self.fleet = N

    # -------------------------------------------------------- queue policy
    @staticmethod
    def _edf_key(r: MatmulRequest):
        """EDF order: earliest absolute deadline first; deadline-less
        requests sort last; ties break by arrival then submission order."""
        return (r.deadline if r.deadline is not None else np.inf,
                r.arrival, r.req_id)

    def _next_batch(self) -> list[MatmulRequest]:
        """Pop the next batch per ``config.queue_policy``.

        ``fifo`` — the historical rule: the head of the queue plus the
        same-shape *prefix run* behind it (stops at the first shape
        mismatch), so closed-loop serving is bit-identical to every run
        before queue policies existed.

        ``edf`` — deadline-aware: the queued request with the earliest
        absolute deadline anchors the batch, then the rest of the queue is
        scanned in EDF order for class-compatible (same-shape) requests to
        fill it.  Batches still stack into one encode + one dispatch, so
        compatibility stays a hard constraint, not a preference.
        """
        if self.config.queue_policy == "edf":
            first = min(self._queue, key=self._edf_key)
            shape = (first.A.shape, first.B.shape)
            batch = [first]
            for r in sorted(self._queue, key=self._edf_key):
                if len(batch) >= self.config.batch_size:
                    break
                if r is not first and (r.A.shape, r.B.shape) == shape:
                    batch.append(r)
            taken = {id(r) for r in batch}
            self._queue = deque(r for r in self._queue
                                if id(r) not in taken)
            return batch
        head = self._queue[0]
        shape = (head.A.shape, head.B.shape)
        batch = [self._queue.popleft()]
        while (self._queue and len(batch) < self.config.batch_size
               and (self._queue[0].A.shape,
                    self._queue[0].B.shape) == shape):
            batch.append(self._queue.popleft())
        return batch

    # ----------------------------------------------------------- event loop
    def run(self) -> list[RequestResult]:
        """Serve everything queued; returns results in submission order.

        A batch stacks its requests into one encode + one worker dispatch,
        so only same-shape runs of the queue batch together.
        """
        results: list[RequestResult] = []
        per_class = getattr(self.policy, "per_class", False)
        while self._queue:
            batch = self._next_batch()
            self._g_queue.set(len(self._queue))
            cls = self._class_of(batch[0]) \
                if (self.policy is not None and per_class) else None
            results.extend(self._serve_batch(batch, cls))
            self._served += len(batch)
            if self.policy is not None:
                new_code = self.policy.maybe_retune(cls) if per_class \
                    else self.policy.maybe_retune()
                if new_code is not None:
                    self.set_code(new_code, cls=cls)
        return sorted(results, key=lambda r: r.req_id)

    def run_open(self, workload, *, realtime: bool | None = None
                 ) -> list[RequestResult]:
        """Open-loop serving: timestamped arrivals against a busy fleet.

        ``workload`` is an iterable of arrival records — anything with
        ``.arrival``, ``.A``, ``.B`` and an optional ``.tenant`` (a
        :class:`~repro_torch.serving.loadgen.TenantSpec`-shaped object
        carrying ``name`` / ``deadline`` / ``target_error``, a bare string
        label, or ``None``) — typically
        :func:`repro_torch.serving.loadgen.build_workload` output.  Unlike
        :meth:`run`, the load does *not* wait for the fleet: requests
        arrive at their own instants, are admitted (or shed) against the
        bounded queue mid-flight, interleaved with completions on the
        merged event stream, and the next batch is formed only when the
        fleet frees up — the open-loop regime where
        queueing collapse is visible.

        Clock: on modeled backends arrivals and completions share one
        *virtual* clock (the dispatch's synthetic event times offset by the
        batch's dispatch instant), so runs are deterministic and cost no
        wall time; on a live backend (``backend.live``) the global clock is
        wall seconds from the first arrival.  ``realtime=None`` picks
        automatically.

        Tie rule, extending the ``merged_event_stream`` contract: at equal
        timestamps completions are ingested first, then the dispatches
        they trigger, then arrivals — the queue state an arrival is
        admitted against reflects everything that happened by its instant.

        Per-request SLOs: a request carrying a ``target`` releases its
        batch early once *every* member hit its target (or became exact),
        with ``serve.slo_hit/miss.<tenant>`` counters and
        :attr:`RequestResult.t_target` stamped on the global clock.  With
        ``config.shed_expired``, requests already past their deadline at
        dequeue are dropped undispatched.  A workload with no tenants, an
        unbounded FIFO queue, and all arrivals at 0 reduces bit-identically
        to :meth:`run`.

        Returns served (and dropped-at-dequeue) results in admission
        order; shed arrivals appear only in :attr:`shed`.
        """
        reqs = sorted(workload, key=lambda r: float(r.arrival))
        if any(getattr(self._tenant_of(r), "target_error", None) is not None
               for r in reqs) and not self.config.track_errors:
            raise ValueError("open-loop accuracy SLOs (tenant target_error) "
                             "require config.track_errors=True")
        if realtime is None:
            realtime = bool(getattr(self.backend, "live", False))
        feed = _ArrivalFeed(self, reqs)
        results: list[RequestResult] = []
        per_class = getattr(self.policy, "per_class", False)
        t_now = 0.0
        t0_wall = time.monotonic() if realtime else None
        while feed.more or self._queue:
            if not self._queue:
                # idle fleet: jump (or sleep) to the next arrival
                if realtime:
                    delay = feed.next_time - (time.monotonic() - t0_wall)
                    if delay > 0:
                        time.sleep(delay)
                    t_now = time.monotonic() - t0_wall
                else:
                    t_now = max(t_now, feed.next_time)
                self.sampler.tick(t_now)
                feed.admit_until(t_now)
                continue
            # dispatch instant: strictly-earlier arrivals are already in
            # (admitted during the previous batch's event walk); pull the
            # batch first, then admit arrivals tied with this instant —
            # completions and their dispatches precede arrivals at equal t
            if self.config.shed_expired:
                results.extend(self._drop_expired(t_now))
            if not self._queue:
                continue
            batch = self._next_batch()
            self._g_queue.set(len(self._queue))
            self.depth_series.append((t_now, len(self._queue)))
            feed.admit_until(t_now)
            cls = self._class_of(batch[0]) \
                if (self.policy is not None and per_class) else None
            ctx = _OpenContext(feed, t_now, realtime)
            results.extend(self._serve_batch(batch, cls, open_ctx=ctx))
            self._served += len(batch)
            t_now = ctx.t_release
            if self.policy is not None:
                new_code = self.policy.maybe_retune(cls) if per_class \
                    else self.policy.maybe_retune()
                if new_code is not None:
                    self.set_code(new_code, cls=cls)
        return sorted(results, key=lambda r: r.req_id)

    @staticmethod
    def _tenant_of(r):
        """The tenant object (or label, or None) riding an arrival record."""
        return getattr(r, "tenant", None)

    def _admit_open(self, r) -> int | None:
        """Admit one arrival record through the keyword submit surface."""
        ten = self._tenant_of(r)
        name = getattr(ten, "name", ten)   # TenantSpec | str | None
        window = getattr(ten, "deadline", None)
        target = getattr(ten, "target_error", None)
        arrival = float(r.arrival)
        return self.submit(
            r.A, r.B, tenant=name, arrival=arrival,
            deadline=None if window is None else arrival + float(window),
            target=target)

    def _drop_expired(self, t_now: float) -> list[RequestResult]:
        """Deadline-aware dequeue shedding (``config.shed_expired``).

        A queued request whose absolute deadline already passed cannot meet
        its SLO; dispatching it would only delay requests that still can.
        Dropped requests get an answerless result (``dropped="expired"``)
        and count as SLO misses.
        """
        dropped = []
        keep = deque()
        for r in self._queue:
            if r.deadline is not None and r.deadline < t_now:
                res = RequestResult(r.req_id, tenant=r.tenant,
                                    arrival=r.arrival, t_done=t_now,
                                    slo_ok=False, dropped="expired")
                self._slo_count(r.tenant, False, t_now)
                self.metrics.counter("serve.dropped_expired").inc()
                dropped.append(res)
            else:
                keep.append(r)
        if dropped:
            self._queue = keep
            self._g_queue.set(len(self._queue))
        return dropped

    def _slo_count(self, tenant: str | None, hit: bool,
                   t: float = 0.0) -> None:
        label = tenant if tenant is not None else "default"
        kind = "slo_hit" if hit else "slo_miss"
        self.metrics.counter(f"serve.{kind}.{label}").inc()
        self.burn.observe(label, hit, t)

    def _fleet_for(self, code: CDCCode) -> int:
        """Shards actually dispatched for a batch served under ``code``.

        The elastic fleet caps the *default* code wherever it serves
        (including class batches that have not switched yet); a per-class
        override is already sized by its own spec's N.
        """
        if code is self.code and self.fleet is not None:
            return min(self.fleet, code.N)
        return code.N

    def _observe(self, times, n_requests: int, cls) -> None:
        """Feed one batch's per-worker completion times to the policy."""
        if self.policy is None:
            return
        if getattr(self.policy, "per_class", False):
            self.policy.observe(times, n_requests=n_requests, cls=cls)
        else:
            self.policy.observe(times, n_requests=n_requests)

    def _cache_for(self, batch: list[MatmulRequest]):
        """The decoders' cache handle — class-scoped when budgets are on."""
        if self.cache is None or not getattr(self.cache, "wants_classes",
                                             False):
            return self.cache
        return self.cache.for_class(self._class_of(batch[0]))

    def _prepare_batch(self, batch: list[MatmulRequest], code: CDCCode,
                       cfg: ServeConfig):
        """Per-request reference data, decoders, and result shells."""
        # oracle-grade β needs each request's true block products; the
        # closed-form modes don't, so skip the K block matmuls for them
        needs_oracle = cfg.beta_mode == "oracle"
        refs = []
        for r in batch:
            C = norm = req_oracle = None
            if cfg.track_errors:
                C = r.A @ r.B
                norm = float(torch.linalg.norm(C) ** 2)
            if needs_oracle:
                # the β oracle is host float64 control data (block products)
                from ..core.partition import split_contraction
                Ab, Bb = split_contraction(r.A.cpu().numpy(),
                                           r.B.cpu().numpy(), code.K)
                req_oracle = code.oracle_context(Ab, Bb)
            refs.append((C, norm, req_oracle))
        cache = self._cache_for(batch)
        decoders = [make_decoder(cfg.decoder, code, beta_mode=cfg.beta_mode,
                                 oracle=refs[i][2], cache=cache)
                    for i in range(len(batch))]
        results = [RequestResult(r.req_id) for r in batch]
        return refs, decoders, results

    @staticmethod
    def _reach_times(t_sorted: np.ndarray, code: CDCCode, Nf: int):
        """``(ttfa, t_exact)`` threshold-crossing times (``None``: never)."""
        first_t = float(t_sorted[code.first_threshold - 1]) \
            if code.first_threshold <= min(Nf, len(t_sorted)) else None
        exact_t = float(t_sorted[code.recovery_threshold - 1]) \
            if code.recovery_threshold <= min(Nf, len(t_sorted)) else None
        return first_t, exact_t

    def _open_track(self, batch, decoders, refs, results, m: int, R: int,
                    t_glob: float) -> None:
        """Stamp ``t_target`` for requests whose accuracy SLO was just met."""
        for r, dec, (C, norm, _), res in zip(batch, decoders, refs, results):
            if r.target is None or res.t_target is not None:
                continue
            if m >= R:                     # exact: every target is met
                res.t_target = t_glob
                continue
            est = dec.estimate()
            if est is None or C is None or norm <= 0.0:
                continue
            err = float(torch.linalg.norm(est - C) ** 2 / norm)
            if err <= r.target:
                res.t_target = t_glob

    @staticmethod
    def _open_settled(batch, results, m: int, R: int) -> bool:
        """Early-release rule: every member hit its target (or is exact)."""
        if m >= R:
            return True
        return all(r.target is not None and res.t_target is not None
                   for r, res in zip(batch, results))

    def _serve_batch(self, batch: list[MatmulRequest],
                     cls=None, open_ctx=None) -> list[RequestResult]:
        """The event loop over one dispatch's completion stream.

        The backend's ``dispatch_batch`` handle yields ``done`` / ``lost``
        (and, under speculation, ``redispatch``) events; deadline ticks are
        merged in honoring the ``merged_event_stream`` contract — events are
        timestamped in strictly increasing arrival order, a tick fires after
        any completion carrying an earlier-or-equal timestamp, and once
        every shard is resolved the remaining ticks flush with the final
        ``m``.  On modeled backends the handle is a
        :class:`~repro_torch.serving.backends.SyntheticDispatch` whose
        synthetic clock never blocks; on the cluster it is live and
        wall-clocked.

        ``open_ctx`` (open-loop serving only) threads the arrival feed and
        the batch's dispatch instant through the walk: arrivals strictly
        earlier than an event are admitted before it is ingested, tied
        arrivals after (completion-before-arrival), and — when any member
        carries an accuracy SLO — the batch releases early once every
        member hit its target, cancelling the remaining shard work.
        """
        code, cfg = self._code_for(cls), self.config
        Nf = self._fleet_for(code)
        # reference products / decoders are built *before* the dispatch
        # starts the wall clock: the C = A@B error baselines are master-side
        # bookkeeping and must not inflate the measured completion times
        refs, decoders, results = self._prepare_batch(batch, code, cfg)
        t_start = open_ctx.t_start if open_ctx is not None else 0.0
        # telemetry timebase: open-loop events already live on the global
        # clock via t_start; closed-loop batches stack onto the accumulated
        # serve clock so sampler ticks share one monotone timeline
        t_base = t_start if open_ctx is not None else self._clock
        slo_active = open_ctx is not None \
            and any(r.target is not None for r in batch)
        if open_ctx is not None:
            for r, res in zip(batch, results):
                res.tenant = r.tenant
                res.arrival = r.arrival
                res.t_dispatch = t_start
        dispatch = self.backend.dispatch_batch(
            code, [r.A for r in batch], [r.B for r in batch],
            n_shards=Nf if Nf != code.N else None, rng=self.rng)
        batch_no = self._batches_served
        self._batches_served += 1
        # cluster dispatches carry a 1-based id; synthetic ones don't
        bid = int(getattr(dispatch, "batch_id", batch_no + 1))
        for res in results:
            res.batch = bid
        self.tracer.batch_begin(bid, Nf)
        self.flight.record("dispatch", batch=bid, shards=Nf,
                           requests=len(batch))
        self._g_inflight.set(Nf)
        self.sampler.tick(t_base)
        deadlines = sorted(float(d) for d in cfg.deadlines)
        grace = float(getattr(self.backend, "grace", 2.0))
        bound = deadlines[-1] if deadlines else 0.0
        if open_ctx is not None:
            # open loop: the hang bound must cover the batch's own latency
            # SLOs, which live on the global clock, not the tick schedule
            rels = [r.deadline - t_start for r in batch
                    if r.deadline is not None]
            bound = max([bound] + rels)
        dispatch.set_abandon(bound + grace)
        # hedging is live only when both sides opt in: a policy on the
        # scheduler AND a dispatch that can actually re-dispatch mid-batch
        poll = float(self.speculation.poll) \
            if (self.speculation is not None
                and hasattr(dispatch, "speculate")) else None
        R = code.recovery_threshold
        shard_times: dict[int, float] = {}
        disp_t: dict[int, float] = {}      # shard -> latest redispatch time
        timed_out = False                  # this batch abandoned shards
        m, di = 0, 0
        try:
            while di < len(deadlines) or dispatch.outstanding:
                if not dispatch.outstanding:
                    # every shard resolved: the remaining ticks carry the
                    # final m whatever the clock says — flush them
                    for dl in deadlines[di:]:
                        self._emit(batch, decoders, refs, results, dl, m, R,
                                   "deadline", bid)
                    di = len(deadlines)
                    break
                timeout = None
                if di < len(deadlines):
                    timeout = deadlines[di] - dispatch.elapsed()
                    if timeout <= 0:
                        self._emit(batch, decoders, refs, results,
                                   deadlines[di], m, R, "deadline", bid)
                        di += 1
                        continue
                if poll is not None:
                    # cap the wait so hedge triggers are not delayed until
                    # the next deadline tick
                    timeout = poll if timeout is None else min(timeout, poll)
                if open_ctx is not None and open_ctx.realtime \
                        and open_ctx.feed.more:
                    # live open loop: wake at the next arrival so admission
                    # (and shed) decisions land near their true instants
                    wait = max(open_ctx.feed.next_time - t_start
                               - dispatch.elapsed(), 0.0) + 1e-3
                    timeout = wait if timeout is None \
                        else min(timeout, wait)
                ev = dispatch.next_event(timeout=timeout)
                if ev is None:
                    # deadline reached or spurious wake — a natural point to
                    # reconsider hedging the still-pending shards
                    self.sampler.tick(t_base + dispatch.elapsed())
                    if open_ctx is not None:
                        open_ctx.feed.admit_until(
                            t_start + dispatch.elapsed())
                    if poll is not None:
                        self._maybe_speculate(dispatch, code, m, shard_times,
                                              deadlines)
                    continue
                if open_ctx is not None:
                    # arrivals strictly earlier than this event are admitted
                    # before it is ingested (ties wait: completion first)
                    open_ctx.feed.admit_until(t_start + ev.t, strict=True)
                # stream-contract tie rule: a tick fires after any
                # completion sharing its timestamp, so strictly-earlier
                # ticks flush before this event is ingested
                while di < len(deadlines) and deadlines[di] < ev.t:
                    self._emit(batch, decoders, refs, results, deadlines[di],
                               m, R, "deadline", bid)
                    di += 1
                if ev.kind == "done":
                    if ev.shard in shard_times:
                        continue           # defensive: dispatches dedup
                    m += 1
                    spec = getattr(ev, "speculative", False)
                    self.tracer.done(
                        bid, ev.shard, ev.worker, ev.t,
                        start=disp_t.get(ev.shard, 0.0) if spec else 0.0,
                        timings=getattr(ev, "timings", None),
                        speculative=spec)
                    if self._m_on:
                        d0 = time.perf_counter()
                        for i, dec in enumerate(decoders):
                            dec.push(ev.shard, ev.products[i])
                        d_dur = time.perf_counter() - d0
                        self._h_decode.observe(d_dur)
                        self.tracer.decode_apply(bid, ev.shard, ev.t,
                                                 dur=d_dur)
                    else:
                        for i, dec in enumerate(decoders):
                            dec.push(ev.shard, ev.products[i])
                        self.tracer.decode_apply(bid, ev.shard, ev.t)
                    shard_times[ev.shard] = ev.t
                    self.flight.record("done", batch=bid, shard=ev.shard,
                                       worker=ev.worker, t=ev.t, m=m)
                    if m == code.first_threshold:
                        self.tracer.milestone(bid, "first-threshold", ev.t,
                                              m=m)
                    if m == R:
                        self.tracer.milestone(bid, "exact", ev.t, m=m)
                    if cfg.stream:
                        self._emit(batch, decoders, refs, results, ev.t, m,
                                   R, "event", bid)
                elif ev.kind == "redispatch":      # speculation bookkeeping
                    self.speculations.append((batch_no, ev.shard, ev.reason))
                    disp_t[ev.shard] = ev.t
                    self.tracer.redispatch(bid, ev.shard, ev.worker, ev.t,
                                           ev.reason)
                    self.flight.record("redispatch", batch=bid,
                                       shard=ev.shard, worker=ev.worker,
                                       t=ev.t, reason=ev.reason)
                else:                      # lost shard (crash/timeout)
                    self.losses.append((batch_no, ev.shard, ev.reason))
                    timed_out = timed_out or ev.reason == "timeout"
                    self.tracer.lost(bid, ev.shard, ev.worker, ev.t,
                                     ev.reason)
                    self.flight.record("lost", batch=bid, shard=ev.shard,
                                       worker=ev.worker, t=ev.t,
                                       reason=ev.reason)
                self._g_inflight.set(dispatch.outstanding)
                self.sampler.tick(t_base + ev.t)
                if open_ctx is not None:
                    t_glob = t_start + ev.t
                    if slo_active and ev.kind == "done":
                        self._open_track(batch, decoders, refs, results,
                                         m, R, t_glob)
                    settled = slo_active and self._open_settled(
                        batch, results, m, R)
                    if not settled and dispatch.outstanding:
                        # tied arrivals admit after the completion they
                        # share a timestamp with (completion-before-arrival)
                        open_ctx.feed.admit_until(t_glob)
                    if settled:
                        # every member hit its accuracy SLO: release the
                        # fleet now, cancelling the outstanding shard work.
                        # Ties at this instant stay with the feed — the
                        # run_open loop admits them after the dispatch this
                        # release triggers (which may free a queue slot)
                        break
                if poll is not None:
                    self._maybe_speculate(dispatch, code, m, shard_times,
                                          deadlines)
        finally:
            if open_ctx is not None:
                open_ctx.t_release = t_start + dispatch.elapsed()
            else:
                self._clock = t_base + dispatch.elapsed()
            self._g_inflight.set(0)
            dispatch.finalize()
        t_sorted = np.sort(np.fromiter(shard_times.values(), np.float64,
                                       count=len(shard_times)))
        first_t, exact_t = self._reach_times(t_sorted, code, Nf)
        for res in results:
            res.ttfa = first_t
            res.t_exact = exact_t
        if open_ctx is not None:
            for r, res in zip(batch, results):
                res.t_done = open_ctx.t_release
                if r.target is not None:
                    hit = res.t_target is not None and (
                        r.deadline is None or res.t_target <= r.deadline)
                    res.slo_ok = hit
                    self._slo_count(r.tenant, hit, open_ctx.t_release)
        if self._m_on:
            for _ in results:              # TTA series is per *request*
                if first_t is not None:
                    self._h_ttfa.observe(first_t)
                if exact_t is not None:
                    self._h_tta.observe(exact_t)
        if self.flight.enabled:
            if Nf > 0 and not shard_times:
                self.flight.dump("all-shards-lost", self.metrics)
            elif timed_out:
                self.flight.dump("hang-abandon", self.metrics)
        # observed completions feed the straggler profile: a full row keeps
        # per-shard identity (the empirical fitter's column marginals); a
        # lossy batch degrades to the pooled sample instead of fabricating
        # times for shards that never arrived
        if len(shard_times) == Nf:
            row = np.empty(Nf)
            for shard, t in shard_times.items():
                row[shard] = t
        else:
            row = np.asarray(sorted(shard_times.values()), dtype=np.float64)
        if row.size:
            self._observe(row, len(batch), cls)
            if self.speculation is not None:
                self._hedge_rows.append(row)
        for res, dec in zip(results, decoders):
            res.decode_stats = dict(dec.stats)
        return results

    # ------------------------------------------------------------ speculation
    def _hedge_profile(self):
        """Straggler fit over the recent observation window (or ``None``).

        Refit lazily once per new batch row; lossy batches contribute their
        pooled finite times (row shapes differ, so the per-shard stack
        degrades to a flat sample — same rule as the adaptive policy's
        fleet-switch path).
        """
        n = len(self._hedge_rows)
        if n == 0:
            return None
        if self._hedge_fit is not None and self._hedge_fit[0] == n:
            return self._hedge_fit[1]
        from ..design.profile import StragglerProfile
        rows = [np.asarray(r, dtype=np.float64).ravel()
                for r in self._hedge_rows]
        profile = None
        try:
            if all(r.shape == rows[0].shape for r in rows):
                profile = StragglerProfile.fit(np.stack(rows))
            else:
                profile = StragglerProfile.fit(np.concatenate(rows))
        except ValueError:
            profile = None                 # too few observations to fit
        self._hedge_fit = (n, profile)
        return profile

    def _maybe_speculate(self, dispatch, code: CDCCode, m: int,
                         shard_times: dict, deadlines: list) -> None:
        """Hedge still-pending shards whose completion odds fell too low."""
        pol = self.speculation
        pending = getattr(dispatch, "pending", None)
        if not pending or not deadlines:
            return
        cap = pol.max_per_batch
        elapsed = dispatch.elapsed()
        profile = self._hedge_profile()
        done_times = sorted(shard_times.values())
        for shard in sorted(pending):
            if cap is not None and dispatch.n_speculated >= cap:
                return
            if dispatch.copies_of(shard) > 1:
                continue                   # one hedge per shard at a time
            if pol.should_speculate(code=code, m_done=m, elapsed=elapsed,
                                    deadline=deadlines[-1],
                                    done_times=done_times,
                                    n_pending=len(pending),
                                    profile=profile, shard=shard):
                if not dispatch.speculate(shard, reason="hedge"):
                    return                 # no backup available: stop trying

    def _emit(self, batch, decoders, refs, results, t, m, R, kind,
              bid: int = 0) -> None:
        t0 = time.perf_counter() if self._m_on else 0.0
        errs = []
        for dec, (C, norm, _), res in zip(decoders, refs, results):
            est = dec.estimate()
            err = None
            if est is not None and C is not None and norm > 0.0:
                err = float(torch.linalg.norm(est - C) ** 2 / norm)
                errs.append(err)
            res.answers.append(Answer(t=t, m=m, rel_err=err,
                                      exact=m >= R, kind=kind))
        if self._m_on:
            self._h_tick.observe(time.perf_counter() - t0)
            if errs:           # the sampler's anytime-accuracy trajectory
                self._g_err.set(sum(errs) / len(errs))
        if kind == "deadline":
            self.tracer.milestone(bid, "deadline-tick", t, m=m)


class _ArrivalFeed:
    """Cursor over time-sorted arrivals, admitting them as the clock moves.

    ``admit_until(t)`` pushes every arrival with instant ≤ t (strictly < t
    with ``strict=True`` — the pre-ingest half of the completion-before-
    arrival tie rule) through the scheduler's keyword submit surface, where
    admission control sheds against the bounded queue.
    """

    __slots__ = ("sched", "reqs", "i")

    def __init__(self, sched: MasterScheduler, reqs: list):
        self.sched = sched
        self.reqs = reqs
        self.i = 0

    @property
    def more(self) -> bool:
        return self.i < len(self.reqs)

    @property
    def next_time(self) -> float:
        return float(self.reqs[self.i].arrival)

    def admit_until(self, t: float, strict: bool = False) -> None:
        while self.i < len(self.reqs):
            ta = float(self.reqs[self.i].arrival)
            if ta > t or (strict and ta >= t):
                break
            self.sched._admit_open(self.reqs[self.i])
            self.i += 1


class _OpenContext:
    """Per-batch open-loop context: the arrival feed plus clock offsets.

    ``t_start`` anchors the dispatch's relative event times on the global
    serve clock; ``t_release`` is stamped when the fleet frees up (early
    release, stream exhaustion, or abandonment).
    """

    __slots__ = ("feed", "t_start", "realtime", "t_release")

    def __init__(self, feed: _ArrivalFeed, t_start: float, realtime: bool):
        self.feed = feed
        self.t_start = t_start
        self.realtime = realtime
        self.t_release = t_start


def _host_like(t: torch.Tensor) -> np.ndarray:
    """A zero-cost numpy stand-in with ``t``'s shape and dtype (request
    classes read only those)."""
    dt = torch.empty((), dtype=t.dtype).numpy().dtype
    return np.broadcast_to(np.empty((), dt), tuple(t.shape))


def serve_request(code: CDCCode, A, B, rng, *, deadlines,
                  straggler_frac: float = 0.0, beta_mode: str = "one",
                  decoder: str = "incremental",
                  cache: DecodeWeightCache | None = None, device=None):
    """One request through the serving runtime (legacy-shaped entry point).

    Returns ``[(deadline, m_done, rel_err or None), ...]``; ``rng`` drives
    the latency draw.
    """
    cfg = ServeConfig(deadlines=tuple(deadlines), stream=False, batch_size=1,
                      beta_mode=beta_mode, decoder=decoder)
    sched = MasterScheduler(code,
                            SimulatedBackend(straggler_frac=straggler_frac,
                                             device=device),
                            cfg, cache)
    sched.rng = rng                      # caller-controlled randomness
    sched.submit(A, B)
    res = sched.run()[0]
    return [(a.t, a.m, a.rel_err) for a in res.answers
            if a.kind == "deadline"]
