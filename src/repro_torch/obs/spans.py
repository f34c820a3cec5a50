"""Spans at the port's layer boundaries, on the profiler's clock.

``with span("sac.decode", device=dev):`` marks one layer boundary of the
serving path or the training step.  It records only while a
``torch.profiler`` runs:

* a host range on the profiler's own clock, the one the kernels'
  timeline is drawn on, so that each idle gap of the device can be put
  down to the span the host was in;
* given a ``device``, also a record in a bounded ring (:data:`RING`
  records): the span's name and, on a CUDA device, two timing events
  recorded on the current stream at entry and exit.  Their interval is
  the span's *stream interval*: from the device reaching the first work
  the span enqueued to its finishing the last, with whatever idle lies
  between.  It is not the kernels' busy time.

Otherwise :func:`span` returns one shared no-op: the serving loop, the
training step and every test pay one C call a span, and nothing
allocates.

Only a span whose stream interval something reads takes a ``device``:
on an H100 host an event costs ~12 µs to create and as much to record,
and on a host-bound path (the coded decode) that shows as device idle.
A ``sync.*`` span, around a transfer that blocks the host, is a host
range alone; the ``sync.*`` ranges are the count of those transfers.

The host range is ``RecordFunctionFast`` (scope ``FUNCTION``), not
``record_function``: the profiler draws a user scope on the device's
timeline too, as an annotation over the kernels it encloses, and a span
puts nothing there.
"""
from __future__ import annotations

from collections import deque

import torch

__all__ = ["span", "span_records", "clear_spans", "NULL_SPAN", "RING"]

RING = 65_536
_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class _NoSpan:
    """The shared no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NoSpan()


class _Timed:
    """A span with a ring record: its host range and, on a CUDA device,
    the events that bracket its stream interval."""

    __slots__ = ("name", "device", "start", "end", "_range")

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device
        self.start = self.end = None

    def __enter__(self):
        self._range = _Range(self.name)
        self._range.__enter__()
        if self.device.type == "cuda":
            self.start = _event(self.device)
        return self

    def __exit__(self, *exc):
        if self.start is not None:
            self.end = _event(self.device)
        self._range.__exit__(*exc)
        return False


def _event(device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class SpanRecorder:
    """The ring of the timed spans' records."""

    def __init__(self, size: int = RING):
        self.ring: deque = deque(maxlen=size)

    def span(self, name: str, device=None):
        if not _profiling():
            return NULL_SPAN
        if device is None:
            return _Range(name)
        rec = _Timed(name, torch.device(device))
        self.ring.append(rec)
        return rec

    def records(self) -> list[dict]:
        """Each timed span as ``{name, stream_ms}`` in entry order, its ms
        between its two events (after waiting for the later); ``None`` on
        a CPU device and for a span still open."""
        rows = []
        for r in list(self.ring):
            ms = None
            if r.end is not None:
                r.end.synchronize()
                ms = r.start.elapsed_time(r.end)
            rows.append({"name": r.name, "stream_ms": ms})
        return rows

    def clear(self) -> None:
        self.ring.clear()


SPANS = SpanRecorder()


def span(name: str, device=None):
    """A context manager over one layer boundary (see the module's text).
    ``device``: where the span's work runs, given where its stream
    interval is read; only a CUDA device gets timing events."""
    return SPANS.span(name, device)


def span_records() -> list[dict]:
    """The ring's records with their stream ms
    (:meth:`SpanRecorder.records`)."""
    return SPANS.records()


def clear_spans() -> None:
    """Empties the ring."""
    SPANS.clear()
