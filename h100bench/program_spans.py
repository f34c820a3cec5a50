"""The program's own spans (``repro_torch.obs.span``), as the per-layer
readers use them: host ranges and kernel launches from the profiled
window's trace, the window's idle gaps put down to the innermost program
span open on the host when each gap opened, and stream intervals from the
program's ring of span records.

A stream interval runs from the device reaching a span's first work to
its finishing the last, idle between included: it is not the kernels'
busy time.  A span is recorded only while a profiler runs, so the trace
and the ring hold the profiled window's spans; against a program without
spans every reader returns ``None``.
"""
from __future__ import annotations

PREFIXES = ("sac.", "sync.", "train.")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
# the training step's spans after its backward
OPTIMIZER = ("train.clip", "train.optimizer", "train.apply")


def records():
    """The program's records of timed spans, or ``None`` where it records
    none."""
    try:
        from repro_torch.obs import span_records
    except ImportError:
        return None
    return span_records() or None


def _is(name: str, names) -> bool:
    """``name`` is one of ``names`` or a child name of one (``a.b.c`` of
    ``a.b``)."""
    return any(name == n or name.startswith(n + ".") for n in names)


def _program(tr):
    """The trace's host ranges of the program's spans, by start."""
    return sorted((s for s in tr.spans if s[0].startswith(PREFIXES)),
                  key=lambda x: x[1])


def _units(spans, unit: str) -> int:
    return sum(1 for s in spans if s[0] == unit)


def stream_ms_per_unit(tr, unit: str, names) -> float | None:
    """Stream ms a unit (a ``unit`` span in the trace) of the timed spans
    named by ``names``; ``None`` without units, without such a record or
    with one unresolved."""
    n, recs = _units(_program(tr), unit), records()
    if not n or recs is None:
        return None
    ms = [r["stream_ms"] for r in recs if _is(r["name"], names)]
    if not ms or None in ms:
        return None
    return sum(ms) / n


def count_per_unit(tr, unit: str, names) -> float | None:
    """The program spans named by ``names`` in the trace, a unit."""
    spans = _program(tr)
    if not _units(spans, unit):
        return None
    return sum(1 for s in spans if _is(s[0], names)) / _units(spans, unit)


def launches_per_unit(tr, unit: str, names) -> float | None:
    """Kernel launches (runtime calls) starting inside a program span
    named by ``names``, a unit."""
    spans = _program(tr)
    if not _units(spans, unit):
        return None
    inside = [(s, e) for n, s, e in spans if _is(n, names)]
    n = sum(1 for name, t, _ in tr.spans if name.startswith(LAUNCHES)
            and any(s <= t < e for s, e in inside))
    return n / _units(spans, unit)


def gaps(tr) -> list:
    """The window's idle gaps as ``(start_us, seconds)``: where no kernel
    runs between the first kernel's start and the last one's end."""
    out, end = [], None
    for _, s, e in sorted(tr.kernels, key=lambda x: x[1]):
        if end is not None and s > end:
            out.append((end, (s - end) / 1e6))
        end = e if end is None else max(end, e)
    return out


def idle_ms_per_unit(tr, unit: str, names) -> float | None:
    """Idle ms a unit in the gaps that open while the innermost program
    span open on the host is named by ``names``."""
    spans = _program(tr)
    if not _units(spans, unit) or tr.busy_s <= 0:
        return None
    total, active, i = 0.0, [], 0
    for t, sec in gaps(tr):                  # gaps in time order
        while i < len(spans) and spans[i][1] <= t:
            active.append(spans[i])
            i += 1
        active = [sp for sp in active if sp[2] > t]
        if active and _is(min(active, key=lambda x: x[2] - x[1])[0], names):
            total += sec
    return 1e3 * total / _units(spans, unit)
