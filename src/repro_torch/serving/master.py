"""Master scheduler: request queue, batching, event-driven refinement loop.

Requests enter a queue, the master pops them in same-shape batches (one
encode + one worker dispatch per batch, sharing one latency draw), and
answers *stream*: one event loop walks the backend's ``dispatch_batch``
event stream — worker completions merged with deadline ticks — pushing each
completed product into the request's incremental decoder and emitting a
refined estimate at every tick (and, in ``stream`` mode, at every
completion event).

Operands go to the backend's device at :meth:`MasterScheduler.submit`; the
reference product ``C = A @ B`` (float64, for the error report), the
decoders and the squared relative error ``‖est − C‖² / ‖C‖²`` are all
computed there, so on the card nothing but scalars reaches the host.

Timebase: completion times and deadlines live on the simulated latency
clock.  The event ordering honours the ``merged_event_stream`` contract
(time order; ties resolve completion-before-tick).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.codes.base import CDCCode
from .backends import ExecutionBackend, SimulatedBackend
from .cache import DecodeWeightCache
from .incremental import make_decoder

__all__ = ["ServeConfig", "MatmulRequest", "Answer", "RequestResult",
           "MasterScheduler", "serve_request", "merged_event_stream"]


def merged_event_stream(t_sorted, deadlines) -> list[tuple[float, int, int]]:
    """``(t, kind, i)`` stream: completion events (kind 0, ``i`` = completion
    index into the sorted times) merged with deadline ticks (kind 1), ticks
    firing *after* any completion carrying the same timestamp."""
    events = [(float(t_sorted[i]), 0, i) for i in range(len(t_sorted))]
    events += [(float(dl), 1, -1) for dl in deadlines]
    events.sort(key=lambda e: (e[0], e[1]))
    return events


@dataclass
class ServeConfig:
    """Knobs of the closed-loop serving loop."""

    deadlines: tuple = (1.1, 1.3, 1.6, 2.0, 3.0)
    stream: bool = False          # also answer at every completion event
    batch_size: int = 4           # requests encoded/dispatched together
    beta_mode: str = "one"
    decoder: str = "incremental"  # "incremental" | "recompute" (baseline)
    track_errors: bool = True     # compute C=A@B and report relative errors
    seed: int = 0


@dataclass
class MatmulRequest:
    req_id: int
    A: torch.Tensor
    B: torch.Tensor


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
    batch: int | None = None      # dispatch id serving this request


_DEFAULT_CACHE = object()        # sentinel: "give me the default LRU";
#                                  an explicit cache=None disables caching


class MasterScheduler:
    """Queue → batch → dispatch → event-driven incremental decode.

    The scheduler keeps operands, reference products and decode state on
    ``backend.device``.
    """

    def __init__(self, code: CDCCode, backend: ExecutionBackend | None = None,
                 config: ServeConfig | None = None,
                 cache: DecodeWeightCache | None = _DEFAULT_CACHE):
        self.code = code
        self.backend = backend if backend is not None else SimulatedBackend()
        self.config = config if config is not None else ServeConfig()
        self.cache = DecodeWeightCache() if cache is _DEFAULT_CACHE else cache
        self.device = self.backend.device
        if self.config.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got "
                             f"{self.config.batch_size}")
        self.rng = np.random.default_rng(self.config.seed)
        self._queue: deque[MatmulRequest] = deque()
        self._next_id = 0
        self.losses: list[tuple[int, int, str]] = []   # (batch#, shard, why)
        self._batches_served = 0

    # --------------------------------------------------------------- intake
    def submit(self, A, B) -> int:
        """Queue one job on the scheduler's device, validating its shape."""
        A = torch.as_tensor(A, device=self.device)
        B = torch.as_tensor(B, device=self.device)
        if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[0]:
            raise ValueError(f"need 2-D operands with matching inner dim; "
                             f"got A {tuple(A.shape)}, B {tuple(B.shape)}")
        if A.shape[1] % self.code.K != 0:
            raise ValueError(f"inner dim {A.shape[1]} must be divisible by "
                             f"K={self.code.K} (the contraction splits into "
                             "K blocks)")
        req_id = self._next_id
        self._next_id += 1
        self._queue.append(MatmulRequest(req_id, A, B))
        return req_id

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _next_batch(self) -> list[MatmulRequest]:
        """The head of the queue plus the same-shape prefix run behind it."""
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
        """Serve everything queued; returns results in submission order."""
        results: list[RequestResult] = []
        while self._queue:
            results.extend(self._serve_batch(self._next_batch()))
        return sorted(results, key=lambda r: r.req_id)

    def _prepare_batch(self, batch: list[MatmulRequest], code: CDCCode,
                       cfg: ServeConfig):
        """Per-request reference data, decoders, and result shells."""
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
        decoders = [make_decoder(cfg.decoder, code, beta_mode=cfg.beta_mode,
                                 oracle=refs[i][2], cache=self.cache)
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

    def _serve_batch(self, batch: list[MatmulRequest]) -> list[RequestResult]:
        """The event loop over one dispatch's completion stream.

        Deadline ticks are merged into the backend's event stream honouring
        the ``merged_event_stream`` contract: a tick fires after any
        completion carrying an earlier-or-equal timestamp, and once every
        shard is resolved the remaining ticks flush with the final ``m``.
        """
        code, cfg = self.code, self.config
        Nf = code.N
        refs, decoders, results = self._prepare_batch(batch, code, cfg)
        dispatch = self.backend.dispatch_batch(
            code, [r.A for r in batch], [r.B for r in batch], rng=self.rng)
        batch_no = self._batches_served
        self._batches_served += 1
        for res in results:
            res.batch = batch_no + 1
        deadlines = sorted(float(d) for d in cfg.deadlines)
        R = code.recovery_threshold
        shard_times: dict[int, float] = {}
        m, di = 0, 0
        try:
            while di < len(deadlines) or dispatch.outstanding:
                if not dispatch.outstanding:
                    for dl in deadlines[di:]:
                        self._emit(decoders, refs, results, dl, m, R,
                                   "deadline")
                    di = len(deadlines)
                    break
                if di < len(deadlines) \
                        and deadlines[di] - dispatch.elapsed() <= 0:
                    self._emit(decoders, refs, results, deadlines[di], m, R,
                               "deadline")
                    di += 1
                    continue
                ev = dispatch.next_event()
                if ev is None:
                    continue
                # stream-contract tie rule: strictly-earlier ticks flush
                # before this event is ingested
                while di < len(deadlines) and deadlines[di] < ev.t:
                    self._emit(decoders, refs, results, deadlines[di], m, R,
                               "deadline")
                    di += 1
                if ev.kind == "done":
                    if ev.shard in shard_times:
                        continue
                    m += 1
                    for i, dec in enumerate(decoders):
                        dec.push(ev.shard, ev.products[i])
                    shard_times[ev.shard] = ev.t
                    if cfg.stream:
                        self._emit(decoders, refs, results, ev.t, m, R,
                                   "event")
                else:                      # lost shard
                    self.losses.append((batch_no, ev.shard, ev.reason))
        finally:
            dispatch.finalize()
        t_sorted = np.sort(np.fromiter(shard_times.values(), np.float64,
                                       count=len(shard_times)))
        first_t, exact_t = self._reach_times(t_sorted, code, Nf)
        for res, dec in zip(results, decoders):
            res.ttfa = first_t
            res.t_exact = exact_t
            res.decode_stats = dict(dec.stats)
        return results

    def _emit(self, decoders, refs, results, t, m, R, kind) -> None:
        for dec, (C, norm, _), res in zip(decoders, refs, results):
            est = dec.estimate()
            err = None
            if est is not None and C is not None and norm > 0.0:
                err = float(torch.linalg.norm(est - C) ** 2 / norm)
            res.answers.append(Answer(t=t, m=m, rel_err=err,
                                      exact=m >= R, kind=kind))


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
