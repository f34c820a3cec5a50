"""Bounded ring-buffer flight recorder for aborted serves.

Chaos failures in CI used to be log archaeology: the run dies, the print
lines scroll away, and the only evidence is an exit code.  The flight
recorder keeps the last ``capacity`` runtime events in a preallocated ring
(``collections.deque(maxlen=...)`` — appends are O(1), never allocate a
new buffer, and drop the oldest entry for free) and, when a serve aborts —
uncaught exception, a batch that lost every shard, or a hang-abandon —
dumps the ring plus a metrics snapshot to a JSON file via the repo's
atomic writer.  Recording is append-only on the event loop; serialization
only happens at dump time, off the serving path.
"""
from __future__ import annotations

from collections import deque

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Last-N event ring + dump-on-abort (see module docstring).

    ``path`` is where dumps land.  Multiple aborts in one run dump to
    numbered siblings (``flight.json``, ``flight.2.json``, ...) so a
    hang-abandon followed by an exception does not overwrite evidence.
    """

    enabled = True

    def __init__(self, path: str, capacity: int = 256,
                 series_tail: int = 64):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.path = str(path)
        self.capacity = int(capacity)
        self.series_tail = int(series_tail)
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._sampler = None         # bound TimeSeriesSampler, if any
        self.dumps: list[str] = []   # paths written, in dump order

    def __len__(self) -> int:
        return len(self._ring)

    def bind_sampler(self, sampler) -> None:
        """Attach a time-series sampler; dumps then embed its last
        ``series_tail`` samples, so an abort shows the minutes *before*
        death, not just the final counter state."""
        self._sampler = sampler if getattr(sampler, "enabled", False) \
            else None

    def record(self, kind: str, **fields) -> None:
        """Append one event to the ring (evicting the oldest when full)."""
        self._seq += 1
        self._ring.append((self._seq, str(kind), fields))

    def _dump_path(self) -> str:
        if not self.dumps:
            return self.path
        root, dot, ext = self.path.rpartition(".")
        if not dot:
            return f"{self.path}.{len(self.dumps) + 1}"
        return f"{root}.{len(self.dumps) + 1}.{ext}"

    def dump(self, reason: str, metrics=None) -> str:
        """Write the ring (+ optional registry snapshot) and return the path."""
        from ..ioutil import write_json_atomic
        payload = {
            "kind": "flight-recorder",
            "reason": str(reason),
            "seq": self._seq,
            "events": [{"seq": s, "kind": k, **f} for s, k, f in self._ring],
        }
        if metrics is not None:
            snap = metrics.snapshot() if hasattr(metrics, "snapshot") else metrics
            payload["metrics"] = snap
        if self._sampler is not None:
            payload["series"] = self._sampler.last(self.series_tail)
        path = self._dump_path()
        write_json_atomic(path, payload, indent=2)
        self.dumps.append(path)
        return path


class _NullFlightRecorder:
    """Shared no-op recorder wired in when ``--flight-recorder`` is absent."""

    enabled = False
    path = None
    dumps: list = []

    def __len__(self) -> int:
        return 0

    def bind_sampler(self, sampler) -> None:
        pass

    def record(self, kind, **fields) -> None:
        pass

    def dump(self, reason, metrics=None) -> None:
        return None


NULL_FLIGHT = _NullFlightRecorder()
