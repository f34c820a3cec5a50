"""Per-shard spans assembled master-side; Chrome/Perfetto trace export.

The tracer is an append-only event sink the serving loop stamps as it
walks a dispatch's event stream.  Everything is batch-local time (seconds
since that batch's dispatch — exactly the ``ShardEvent.t`` clock) plus one
wall offset per batch taken when the batch begins, so events from
successive batches land on one global timeline without the recorder ever
touching the hot path twice per event.

**No clock sync.**  Socket workers may live on other machines; their
clocks are never compared with the master's.  A worker reports *monotonic
deltas* — ``(wait, operand_resolve, compute)`` seconds — piggybacked on
its result frame, and the master anchors them **backwards from the
arrival timestamp** it measured itself: the compute sub-span ends at
arrival, the operand-ship sub-span ends where compute starts.  Ship-back
latency is therefore folded into the parent span's head, never into the
compute time — durations stay non-negative by construction (and are
clamped against the dispatch instant for safety).

Export is the Chrome trace-event JSON format (load in Perfetto / ``
chrome://tracing``): one lane (``tid``) per pool worker under the
"workers" process, complete spans (``ph: "X"``) per completed shard with
nested operand-ship/compute sub-spans, instant events for losses and
re-dispatches on the owning worker's lane, and decode-apply /
accuracy-milestone instants on the master lane.  Spans are *additive
metadata*: nothing here feeds the decode path, so recorded traces replay
bit-identically with tracing enabled.
"""
from __future__ import annotations

import time

__all__ = ["Tracer", "NULL_TRACER"]

_US = 1e6
_PID_MASTER = 0
_PID_WORKERS = 1


class Tracer:
    """Event sink + Chrome trace-event exporter (see module docstring)."""

    enabled = True

    def __init__(self):
        self._t0 = time.monotonic()
        self._batch_t0: dict[int, float] = {}     # batch id -> wall offset, s
        self._events: list[tuple] = []            # raw stamps, append-only

    # ------------------------------------------------------------- stamping
    def batch_begin(self, batch_id: int, n_shards: int = 0) -> None:
        """Anchor ``batch_id``'s local clock on the global timeline.

        Idempotent — the first caller (right after dispatch, when the
        batch's ``t = 0``) wins, so the scheduler and a backend can both
        stamp it without fighting.
        """
        if batch_id not in self._batch_t0:
            self._batch_t0[batch_id] = time.monotonic() - self._t0
            self._events.append(("batch", batch_id, n_shards))

    def done(self, batch_id: int, shard: int, worker: int, t: float, *,
             start: float = 0.0, timings=None,
             speculative: bool = False) -> None:
        """A shard completed at batch-local ``t``; its winning copy was
        dispatched at ``start`` (0 for the original fan-out).  ``timings``
        is the worker's ``(wait, operand_resolve, compute)`` delta tuple
        (``None`` on transports/tests that predate it)."""
        self._events.append(("done", batch_id, shard, worker, float(t),
                            float(start), timings, bool(speculative)))

    def lost(self, batch_id: int, shard: int, worker: int, t: float,
             reason: str) -> None:
        self._events.append(("lost", batch_id, shard, worker, float(t),
                            str(reason)))

    def redispatch(self, batch_id: int, shard: int, worker: int, t: float,
                   reason: str) -> None:
        self._events.append(("redispatch", batch_id, shard, worker,
                            float(t), str(reason)))

    def decode_apply(self, batch_id: int, shard: int, t: float,
                     dur: float | None = None) -> None:
        """The master pushed the shard's product into the decoders.
        ``dur`` is the measured wall seconds of the rank-1 update batch
        (``None`` when the scheduler runs with metrics timing off)."""
        self._events.append(("decode", batch_id, shard, float(t),
                             None if dur is None else float(dur)))

    def milestone(self, batch_id: int, name: str, t: float, **args) -> None:
        """Accuracy milestone (first-threshold, exact, deadline tick)."""
        self._events.append(("milestone", batch_id, str(name), float(t),
                            args))

    # --------------------------------------------------------------- export
    @property
    def n_events(self) -> int:
        return len(self._events)

    def raw_events(self, kind: str | None = None) -> list[tuple]:
        """The raw stamp tuples (tests assert on these, not the JSON)."""
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e[0] == kind]

    def _base_us(self, batch_id: int) -> float:
        return self._batch_t0.get(batch_id, 0.0) * _US

    def to_dict(self) -> dict:
        """Chrome trace-event JSON: ``{"traceEvents": [...]}``."""
        events: list[dict] = []
        worker_lanes: set[int] = set()
        for ev in self._events:
            kind = ev[0]
            if kind == "batch":
                continue
            if kind == "done":
                _, bid, shard, wid, t, start, timings, spec = ev
                base = self._base_us(bid)
                start = min(max(0.0, start), t)
                worker_lanes.add(wid)
                args = {"batch": bid, "shard": shard, "worker": wid,
                        "speculative": spec, "t_s": t}
                if timings is not None:
                    wait, operands, compute = (float(x) for x in timings)
                    args.update(wait_s=wait, operand_resolve_s=operands,
                                compute_s=compute)
                    # anchor the worker's deltas backwards from arrival
                    c0 = max(start, t - compute)
                    o0 = max(start, t - compute - operands)
                    events.append(_span("operand-ship", bid, wid,
                                        base + o0 * _US,
                                        max(0.0, c0 - o0) * _US))
                    events.append(_span("compute", bid, wid,
                                        base + c0 * _US,
                                        max(0.0, t - c0) * _US))
                events.append(_span(f"shard {shard}", bid, wid,
                                    base + start * _US,
                                    max(0.0, t - start) * _US, args=args))
            elif kind in ("lost", "redispatch"):
                _, bid, shard, wid, t, reason = ev
                worker_lanes.add(wid)
                events.append(_instant(
                    f"{kind}:{reason}", self._base_us(bid) + t * _US,
                    _PID_WORKERS, wid, scope="t",
                    args={"batch": bid, "shard": shard}))
            elif kind == "decode":
                _, bid, shard, t, dur = (ev if len(ev) == 5
                                         else (*ev, None))
                dargs = {"batch": bid, "shard": shard}
                if dur is not None:
                    dargs["dur_s"] = dur
                events.append(_instant(
                    "decode-apply", self._base_us(bid) + t * _US,
                    _PID_MASTER, 0, scope="t", args=dargs))
            elif kind == "milestone":
                _, bid, name, t, args = ev
                events.append(_instant(
                    name, self._base_us(bid) + t * _US,
                    _PID_MASTER, 0, scope="p",
                    args={"batch": bid, **args}))
        meta = [_meta("process_name", _PID_MASTER, 0, "sac-master"),
                _meta("thread_name", _PID_MASTER, 0, "decode loop")]
        meta.append(_meta("process_name", _PID_WORKERS, 0, "sac-workers"))
        for wid in sorted(worker_lanes):
            meta.append(_meta("thread_name", _PID_WORKERS, wid,
                              f"worker {wid}"))
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        from ..ioutil import write_json_atomic
        return write_json_atomic(path, self.to_dict(), indent=2)


def _span(name, bid, tid, ts_us, dur_us, args=None) -> dict:
    out = {"name": name, "cat": "shard", "ph": "X", "pid": _PID_WORKERS,
           "tid": int(tid), "ts": round(ts_us, 3),
           "dur": round(max(0.0, dur_us), 3)}
    if args is not None:
        out["args"] = args
    else:
        out["args"] = {"batch": bid}
    return out


def _instant(name, ts_us, pid, tid, scope="t", args=None) -> dict:
    return {"name": name, "cat": "serve", "ph": "i", "s": scope,
            "pid": pid, "tid": int(tid), "ts": round(max(0.0, ts_us), 3),
            "args": args or {}}


def _meta(name, pid, tid, value) -> dict:
    return {"name": name, "ph": "M", "pid": pid, "tid": int(tid),
            "args": {"name": value}}


class _NullTracer:
    """Shared no-op tracer: the always-wired handle when ``--trace-out``
    is absent (one no-op call per event on the hot path)."""

    enabled = False
    n_events = 0

    def batch_begin(self, batch_id, n_shards=0) -> None:
        pass

    def done(self, batch_id, shard, worker, t, *, start=0.0, timings=None,
             speculative=False) -> None:
        pass

    def lost(self, batch_id, shard, worker, t, reason) -> None:
        pass

    def redispatch(self, batch_id, shard, worker, t, reason) -> None:
        pass

    def decode_apply(self, batch_id, shard, t, dur=None) -> None:
        pass

    def milestone(self, batch_id, name, t, **args) -> None:
        pass


NULL_TRACER = _NullTracer()
