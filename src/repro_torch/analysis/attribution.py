"""Tail-latency root-cause attribution from serve traces.

The load harness says *that* a tenant missed its SLO; this module
says *why*.  It decomposes each served request's time-to-target into the
phases the runtime actually spent it in —

* **queue_wait** — arrival → batch dispatch (admission backlog),
* **operand_ship** — worker-reported operand-resolve time of the critical
  shard (transport),
* **compute** — the critical shard's compute time (including any
  slow-worker chaos, which the worker injects into this phase),
* **wait** — the critical shard's pre-operand wait (scheduling jitter),
* **decode** — measured rank-1 update cost on the master,
* **other** — the residual (stragglers the decode didn't need, event-loop
  slack; on modeled backends, where no worker timings exist, the whole
  post-dispatch span lands here *unless* queueing dominates upstream)

— then aggregates: which worker / host / tenant contributed how much to
the p99 time-to-target and to SLO misses.  The *critical shard* of a
request is the last completion at or before the instant its accuracy
target was met (the completion that delivered the target); its span is
read from the Tracer's worker-reported timings, so no clock sync is
assumed anywhere.

Inputs are deliberately file-shaped: a Chrome trace-event document (the
Tracer's ``to_dict()`` or a ``--trace-out`` JSON file) plus per-request
records (``RequestResult`` objects or the ``--json`` serve report's
request dicts).
"""
from __future__ import annotations

import json

__all__ = ["attribute", "attribution_report", "load_trace_doc",
           "PHASES"]

PHASES = ("queue_wait", "wait", "operand_ship", "compute", "decode",
          "other")


def load_trace_doc(path_or_doc) -> dict:
    """Accept a trace dict, a Tracer, or a path to trace JSON."""
    if hasattr(path_or_doc, "to_dict"):
        return path_or_doc.to_dict()
    if isinstance(path_or_doc, dict):
        return path_or_doc
    with open(path_or_doc) as f:
        return json.load(f)


def _req_field(r, name, default=None):
    if isinstance(r, dict):
        return r.get(name, default)
    return getattr(r, name, default)


def _index_trace(doc: dict):
    """Per-batch shard completions and decode costs from a trace doc.

    Returns ``(dones, decode_cost)`` where ``dones[batch]`` is a list of
    ``{"t", "worker", "shard", "wait", "operands", "compute"}`` (timing
    keys ``None`` on modeled backends) sorted by batch-local completion
    time, and ``decode_cost[batch]`` sums the measured decode-apply
    durations.
    """
    dones: dict[int, list[dict]] = {}
    decode_cost: dict[int, float] = {}
    for ev in doc.get("traceEvents", []):
        args = ev.get("args") or {}
        if ev.get("ph") == "X" and str(ev.get("name", "")).startswith(
                "shard ") and "t_s" in args:
            dones.setdefault(int(args["batch"]), []).append({
                "t": float(args["t_s"]),
                "worker": int(args.get("worker", -1)),
                "shard": int(args.get("shard", -1)),
                "speculative": bool(args.get("speculative", False)),
                "wait": args.get("wait_s"),
                "operands": args.get("operand_resolve_s"),
                "compute": args.get("compute_s"),
            })
        elif ev.get("ph") == "i" and ev.get("name") == "decode-apply" \
                and "dur_s" in args:
            b = int(args["batch"])
            decode_cost[b] = decode_cost.get(b, 0.0) + float(args["dur_s"])
    for lst in dones.values():
        lst.sort(key=lambda d: d["t"])
    return dones, decode_cost


def attribute(trace, requests, *, hosts=None) -> list[dict]:
    """Per-request phase decomposition; one row per attributable request.

    ``trace`` is anything :func:`load_trace_doc` accepts; ``requests`` are
    ``RequestResult``-shaped objects or serve-report request dicts carrying
    ``req_id / tenant / arrival / batch / t_dispatch / t_target / t_done /
    t_exact / slo_ok``.  ``hosts`` (optional) maps workers to hosts the
    way the socket transport assigns them: ``host = hosts[wid %
    len(hosts)]`` — pass the ``--hosts`` list to localise blame to a
    machine; without it every worker reports host ``"local"``.

    Dropped/shed requests (no batch) get a pure ``queue_wait`` row: their
    entire lifetime was spent waiting.
    """
    doc = load_trace_doc(trace)
    dones, decode_cost = _index_trace(doc)
    rows = []
    for r in requests:
        req_id = _req_field(r, "req_id")
        tenant = _req_field(r, "tenant") or "default"
        arrival = float(_req_field(r, "arrival", 0.0) or 0.0)
        batch = _req_field(r, "batch")
        t_disp = _req_field(r, "t_dispatch")
        t_target = _req_field(r, "t_target")
        t_done = _req_field(r, "t_done")
        t_exact = _req_field(r, "t_exact")
        slo_ok = _req_field(r, "slo_ok")
        dropped = _req_field(r, "dropped")
        phases = dict.fromkeys(PHASES, 0.0)
        worker = host = None
        if batch is None:
            # never dispatched: the whole story is the queue
            end = t_done if t_done is not None else t_target
            if end is not None:
                phases["queue_wait"] = max(0.0, float(end) - arrival)
            total = phases["queue_wait"]
        else:
            # closed-loop results have no dispatch stamp: the batch left
            # the queue immediately, so the global clock is batch-local
            t_disp = float(t_disp) if t_disp is not None else arrival
            phases["queue_wait"] = max(0.0, t_disp - arrival)
            # batch-local instant the request stopped caring: target met,
            # else exact recovery, else batch release
            if t_target is not None:
                rel_end = float(t_target) - t_disp
            elif t_exact is not None:
                rel_end = float(t_exact)
            elif t_done is not None:
                rel_end = float(t_done) - t_disp
            else:
                rel_end = 0.0
            rel_end = max(0.0, rel_end)
            crit = None
            for d in dones.get(int(batch), []):
                if d["t"] <= rel_end + 1e-9:
                    crit = d          # last completion before the target
                else:
                    break
            if crit is not None:
                worker = crit["worker"]
                if crit["compute"] is not None:
                    phases["compute"] = float(crit["compute"])
                    phases["operand_ship"] = float(crit["operands"] or 0.0)
                    phases["wait"] = float(crit["wait"] or 0.0)
            phases["decode"] = decode_cost.get(int(batch), 0.0)
            accounted = sum(phases[p] for p in
                            ("wait", "operand_ship", "compute", "decode"))
            phases["other"] = max(0.0, rel_end - accounted)
            total = phases["queue_wait"] + rel_end
        if hosts:
            host = hosts[worker % len(hosts)] if worker is not None else None
        elif worker is not None:
            host = "local"
        dominant = max(PHASES, key=lambda p: phases[p]) if total > 0 \
            else None
        rows.append({"req_id": req_id, "tenant": tenant, "batch": batch,
                     "worker": worker, "host": host, "total": total,
                     "slo_ok": slo_ok, "dropped": dropped,
                     "phases": phases, "dominant": dominant})
    return rows


def _quantile(sorted_vals: list[float], q: float) -> float | None:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def _rank(rows: list[dict], key: str, tail_cut: float) -> list[dict]:
    """Aggregate per-request rows by ``key`` (worker/host/tenant)."""
    groups: dict = {}
    for row in rows:
        k = row.get(key)
        if k is None:
            continue
        g = groups.setdefault(k, {
            key: k, "requests": 0, "slo_misses": 0, "tail_requests": 0,
            "total_seconds": 0.0,
            "phase_seconds": dict.fromkeys(PHASES, 0.0)})
        g["requests"] += 1
        g["total_seconds"] += row["total"]
        if row["slo_ok"] is False:
            g["slo_misses"] += 1
        if row["total"] >= tail_cut:
            g["tail_requests"] += 1
        for p in PHASES:
            g["phase_seconds"][p] += row["phases"][p]
    out = sorted(groups.values(),
                 key=lambda g: (-g["tail_requests"], -g["total_seconds"]))
    for g in out:
        ps = g["phase_seconds"]
        g["dominant_phase"] = max(PHASES, key=lambda p: ps[p]) \
            if g["total_seconds"] > 0 else None
    return out


def attribution_report(trace, requests, *, hosts=None,
                       tail_q: float = 0.99) -> dict:
    """The full report: per-request rows + worker/host/tenant rankings.

    ``tail_q`` defines the tail: requests whose total is at or above that
    quantile of the total distribution count as *tail requests*, and the
    rankings order by tail membership first — the worker at the top of
    ``workers`` is the proximate cause of the p99.
    """
    rows = attribute(trace, requests, hosts=hosts)
    totals = sorted(r["total"] for r in rows)
    tail_cut = _quantile(totals, tail_q) or 0.0
    phase_totals = dict.fromkeys(PHASES, 0.0)
    for r in rows:
        for p in PHASES:
            phase_totals[p] += r["phases"][p]
    grand = sum(phase_totals.values())
    dominant = max(PHASES, key=lambda p: phase_totals[p]) if grand > 0 \
        else None
    workers = _rank(rows, "worker", tail_cut)
    report = {
        "kind": "attribution-report",
        "n_requests": len(rows),
        "n_slo_misses": sum(1 for r in rows if r["slo_ok"] is False),
        "tail_q": tail_q,
        "tail_cut_seconds": tail_cut,
        "p99_total": _quantile(totals, 0.99),
        "p50_total": _quantile(totals, 0.50),
        "phase_seconds": phase_totals,
        "phase_shares": {p: (phase_totals[p] / grand if grand > 0 else 0.0)
                         for p in PHASES},
        "dominant_phase": dominant,
        "workers": workers,
        "hosts": _rank(rows, "host", tail_cut),
        "tenants": _rank(rows, "tenant", tail_cut),
        "requests": rows,
    }
    if workers:
        top = workers[0]
        report["top_worker"] = {"worker": top["worker"],
                                "dominant_phase": top["dominant_phase"],
                                "tail_requests": top["tail_requests"]}
    return report
