"""Reduction of a ``torch.profiler`` trace to what the per-layer readers
read: the device's kernel intervals by name, its busy time as the union of
those intervals (overlapping streams cannot read busy over the window),
the harness's own spans, and the breakdown the result line carries.
"""
from __future__ import annotations

from dataclasses import dataclass, field

SPAN_PREFIX = "h100bench."


@dataclass
class Trace:
    """One profiled sub-window: ``kernels`` as ``(name, start_us, end_us)``
    on the device, ``spans`` as ``(name, start_us, end_us)`` of the
    harness's ``record_function`` blocks and the host ops under them,
    ``window_s`` its host wall time and ``units`` how many of the cell's
    units of work (batches, steps) it holds."""
    kernels: list
    spans: list
    window_s: float
    units: int
    busy_s: float = field(init=False)

    def __post_init__(self):
        self.busy_s = union_s(self.kernels)

    def device_s(self, *needles: str) -> float:
        """Device seconds of the kernels whose name holds any needle."""
        return sum(e - s for n, s, e in self.kernels
                   if any(k in n for k in needles)) / 1e6

    def by_kind(self) -> dict:
        out: dict = {}
        for n, s, e in self.kernels:
            k = kind(n)
            out[k] = out.get(k, 0.0) + (e - s) / 1e6
        return out


def idle_pct(tr: Trace):
    """The share of the window in which no operation ran on the device, or
    ``None`` where the trace holds no device operation."""
    if tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def kind(kernel: str) -> str:
    """A kernel's kind by its name: flash, the scan, the worker products,
    the encode, GEMMs of the libraries, or the elementwise and reduction
    passes with the copies (``elementwise_other``)."""
    n = kernel.lower()
    if "flash" in n:
        return "flash"
    if "ssm_scan" in n:
        return "scan"
    if "coded_matmul" in n:
        return "coded_matmul"
    if "poly_encode" in n:
        return "poly_encode"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "cutlass", "xmma",
                            "cublas")):
        return "other_gemm"
    return "elementwise_other"


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(name, start_us, end_us)``."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def from_profile(prof, window_s: float, units: int) -> Trace:
    """The device kernels (and copies) and the host events of a finished
    ``torch.profiler.profile``.  The harness's spans also show on the
    device's timeline, as annotations over the work they enclose: they are
    not operations and stay out of the kernels."""
    kernels, spans = [], []
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if t <= s:
            continue
        if not str(e.device_type).endswith("CUDA"):
            spans.append((e.name, s, t))
        elif not e.name.startswith(SPAN_PREFIX):
            kernels.append((e.name, s, t))
    return Trace(kernels, spans, window_s, units)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by what the host was doing: the innermost harness span and host
    op open at each gap's start."""
    ops: dict = {}
    for n, s, e in tr.kernels:
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
    gaps = []                                # (start_us, seconds)
    end = None
    for _, s, e in sorted(tr.kernels, key=lambda x: x[1]):
        if end is not None and s > end:
            gaps.append((end, (s - end) / 1e6))
        end = e if end is None else max(end, e)
    by_label: dict = {}
    spans = sorted(tr.spans, key=lambda x: x[1])
    active, i = [], 0
    for t, sec in gaps:                      # one sweep: gaps in time order
        while i < len(spans) and spans[i][1] <= t:
            active.append(spans[i])
            i += 1
        active = [sp for sp in active if sp[2] > t]
        label = _host_label(active)
        by_label[label] = by_label.get(label, 0.0) + sec
    rank = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    grank = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in rank],
            "idle_gaps": [[n, v] for n, v in grank]}


def _host_label(active) -> str:
    span = op = None
    for n, s, e in active:
        if n.startswith(SPAN_PREFIX):
            if span is None or e - s < span[1]:
                span = (n[len(SPAN_PREFIX):], e - s)
        elif op is None or e - s < op[1]:
            op = (n, e - s)
    parts = [p[0] for p in (span, op) if p is not None]
    return " / ".join(parts) if parts else "host"
