"""sac_top: live serve dashboard + offline tail-latency attribution.

``live`` renders one (or a refreshing loop of) terminal frame(s) from a
metrics scrape — either a running exporter (``--url http://host:port``)
or a saved ``/json`` scrape (``--file scrape.json``, what the CI smoke
uses).  Each frame shows counter rates and gauge sparklines from the
time-series ring, per-tenant SLO hit/miss/goodput, and the burn-rate
alert state.  ``--once`` prints a single frame and exits (headless CI).

``attribution`` runs :mod:`repro_torch.analysis.attribution` over a serve
report (``repro_torch.launch.serve --json``) plus its ``--trace-out`` file
and prints the phase decomposition and worker/host/tenant rankings — "the
p99 is worker 3's compute phase", not "the p99 is 2.4s".

Stdlib only; no curses, no extra deps — frames are plain text with ANSI
clear-screen between refreshes.

The port's copy of the reference's ``tools/sac_top.py``: ``live`` as it
is, ``attribution`` on the port's own attribution module.  Run as
``python -m repro_torch.tools.sac_top``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(vals, width: int = 32) -> str:
    vals = [float(v) for v in vals][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[int((v - lo) / (hi - lo) * (len(_SPARK) - 1))]
                   for v in vals)


def _fmt(v) -> str:
    if v is None:
        return "-"
    f = float(v)
    if f == int(f) and abs(f) < 1e9:
        return str(int(f))
    if abs(f) >= 100:
        return f"{f:.0f}"
    if abs(f) >= 1:
        return f"{f:.2f}"
    return f"{f:.4f}"


def fetch_scrape(url: str | None, path: str | None) -> dict:
    if path:
        with open(path) as f:
            return json.load(f)
    target = url.rstrip("/")
    if not target.endswith("/json"):
        target += "/json"
    with urllib.request.urlopen(target, timeout=5.0) as resp:
        return json.load(resp)


# --------------------------------------------------------------- live frames
def render_frame(scrape: dict, *, width: int = 32) -> str:
    snap = scrape.get("snapshot", {})
    series = scrape.get("series", {})
    burn = scrape.get("burn", {})
    ts = series.get("t", [])
    lines = ["sac_top — serve telemetry"
             + (f"  [{len(ts)} samples, t={_fmt(ts[-1])}s]" if ts else
                "  [no samples]"),
             ""]

    gauges = series.get("gauges", {})
    if gauges:
        lines.append("gauges" + " " * 30 + "now     trend")
        for name, col in sorted(gauges.items()):
            if not col:
                continue
            lines.append(f"  {name:<32} {_fmt(col[-1]):>7} "
                         f"{sparkline(col, width)}")
        lines.append("")

    rates = series.get("rates", {})
    if rates:
        lines.append("counter rates (/s)" + " " * 18 + "now     trend")
        for name, col in sorted(rates.items()):
            if not col or max(col) <= 0:
                continue
            lines.append(f"  {name:<32} {_fmt(col[-1]):>7} "
                         f"{sparkline(col, width)}")
        lines.append("")

    counters = snap.get("counters", {})
    tenants = sorted({n.rsplit(".", 1)[1] for n in counters
                      if n.startswith(("serve.slo_hit.", "serve.slo_miss."))})
    if tenants:
        firing = set(burn.get("firing", []))
        lines.append(f"{'tenant':<16} {'hit':>6} {'miss':>6} "
                     f"{'goodput/s':>10}  burn")
        for t in tenants:
            hit = counters.get(f"serve.slo_hit.{t}", 0)
            miss = counters.get(f"serve.slo_miss.{t}", 0)
            rate = rates.get(f"serve.slo_hit.{t}", [])
            gp = rate[-1] if rate else None
            state = "FIRING" if t in firing else "ok"
            lines.append(f"{t:<16} {_fmt(hit):>6} {_fmt(miss):>6} "
                         f"{_fmt(gp):>10}  {state}")
        lines.append("")

    alerts = burn.get("alerts", [])
    if alerts:
        lines.append(f"burn alerts ({len(alerts)}):")
        for a in alerts[-5:]:
            lines.append(f"  t={_fmt(a['t'])}s {a['kind']:<5} "
                         f"{a['tenant']:<14} burn {_fmt(a['burn_long'])}x "
                         f"(short {_fmt(a['burn_short'])}x)")
        lines.append("")

    hists = snap.get("histograms", {})
    key_hists = [n for n in ("serve.tta_exact_seconds",
                             "backend.shard_compute_seconds",
                             "backend.shard_wait_seconds") if n in hists]
    if key_hists:
        lines.append(f"{'latency (s)':<32} {'p50':>8} {'p99':>8} "
                     f"{'count':>7}")
        for n in key_hists:
            h = hists[n]
            lines.append(f"  {n:<30} {_fmt(h.get('p50')):>8} "
                         f"{_fmt(h.get('p99')):>8} {_fmt(h['count']):>7}")
    return "\n".join(lines)


def cmd_live(args) -> int:
    if not args.url and not args.file:
        print("live: need --url or --file", file=sys.stderr)
        return 2
    while True:
        try:
            scrape = fetch_scrape(args.url, args.file)
        except Exception as exc:
            print(f"scrape failed: {exc}", file=sys.stderr)
            return 1
        frame = render_frame(scrape, width=args.width)
        if not args.once:
            sys.stdout.write("\x1b[2J\x1b[H")     # clear + home
        print(frame)
        if args.once:
            return 0
        time.sleep(args.interval)


# --------------------------------------------------------------- attribution
def cmd_attribution(args) -> int:
    from ..analysis.attribution import attribution_report
    with open(args.report) as f:
        report = json.load(f)
    requests = report.get("requests", report if isinstance(report, list)
                          else [])
    hosts = args.hosts.split(",") if args.hosts else None
    out = attribution_report(args.trace, requests, hosts=hosts,
                             tail_q=args.tail_q)
    if args.json:
        json.dump(out, sys.stdout, indent=2)
        print()
        return 0
    print(f"attribution over {out['n_requests']} requests "
          f"({out['n_slo_misses']} SLO misses), "
          f"p50 {_fmt(out['p50_total'])}s / p99 {_fmt(out['p99_total'])}s")
    print(f"dominant phase: {out['dominant_phase']}")
    shares = out["phase_shares"]
    for p, s in sorted(shares.items(), key=lambda kv: -kv[1]):
        if s > 0:
            bar = "#" * int(round(s * 40))
            print(f"  {p:<14} {s * 100:5.1f}%  {bar}")
    for key in ("workers", "hosts", "tenants"):
        rows = out[key]
        if not rows:
            continue
        label = key[:-1]
        print(f"\ntop {key} by tail contribution:")
        print(f"  {label:<14} {'reqs':>5} {'tail':>5} {'miss':>5} "
              f"{'seconds':>9}  dominant")
        for g in rows[:args.top]:
            print(f"  {str(g[label]):<14} {g['requests']:>5} "
                  f"{g['tail_requests']:>5} {g['slo_misses']:>5} "
                  f"{g['total_seconds']:>9.3f}  {g['dominant_phase']}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sac_top", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    live = sub.add_parser("live", help="render serve telemetry frames")
    live.add_argument("--url", help="exporter base URL "
                      "(e.g. http://127.0.0.1:9109)")
    live.add_argument("--file", help="saved /json scrape instead of a URL")
    live.add_argument("--once", action="store_true",
                      help="one frame, no clear-screen (CI headless mode)")
    live.add_argument("--interval", type=float, default=1.0,
                      help="refresh period in seconds (default 1)")
    live.add_argument("--width", type=int, default=32,
                      help="sparkline width (default 32)")
    live.set_defaults(fn=cmd_live)

    att = sub.add_parser("attribution",
                         help="offline tail root-cause report")
    att.add_argument("report", help="serve report JSON "
                     "(repro_torch.launch.serve --json output)")
    att.add_argument("trace", help="trace JSON (--trace-out file)")
    att.add_argument("--hosts", help="comma-separated host list "
                     "(worker -> host via wid %% len(hosts))")
    att.add_argument("--tail-q", type=float, default=0.99,
                     help="tail quantile (default 0.99)")
    att.add_argument("--top", type=int, default=5,
                     help="rows per ranking table (default 5)")
    att.add_argument("--json", action="store_true",
                     help="emit the full report as JSON")
    att.set_defaults(fn=cmd_attribution)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
