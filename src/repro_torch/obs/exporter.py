"""Background-thread HTTP exposition endpoint for live scrapes.

Serves two views of a running serve's registry on a local port:

- ``GET /metrics`` — Prometheus text exposition format (version 0.0.4):
  counters and gauges as single samples, histograms as cumulative ``le``
  buckets plus ``_sum``/``_count``.  Names are sanitised to the
  ``sac_<metric>`` namespace (dots and other illegal characters become
  underscores), so `serve.slo_hit.interactive` scrapes as
  ``sac_serve_slo_hit_interactive``.
- ``GET /json`` — a machine-friendly scrape bundling the full registry
  snapshot, the sampler's recent series (counter rates included), and
  the burn tracker's alert state; `tools/sac_top.py live` renders it.

The server is a stdlib :class:`ThreadingHTTPServer` on a daemon thread —
no new dependencies, no interference with worker subprocesses, and
*off by default* (the scheduler never imports this module; `launch/serve`
starts it only under ``--metrics-port``).  Scrapes read live instrument
objects without locks; counters/gauges are single attributes (atomic
reads under the GIL) and histogram bucket lists are append-free, so the
worst case is a scrape that is one observation stale — fine for a
monitoring endpoint.  Port 0 binds an ephemeral port (see ``.port``),
which is what tests and the CI smoke use.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import NULL_REGISTRY
from .slo import NULL_BURN
from .timeseries import NULL_SAMPLER

__all__ = ["MetricsExporter", "prometheus_text"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "sac_" + _NAME_RE.sub("_", name)


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(snapshot: dict) -> str:
    """Render a registry snapshot dict as Prometheus text exposition."""
    lines: list[str] = []
    for name, value in snapshot.get("counters", {}).items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {_fmt(value)}")
    for name, value in snapshot.get("gauges", {}).items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {_fmt(value)}")
    for name, h in snapshot.get("histograms", {}).items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        cum = 0
        for le, n in zip(h["buckets"], h["counts"]):
            cum += n
            lines.append(f'{pname}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{pname}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{pname}_sum {_fmt(h['total'])}")
        lines.append(f"{pname}_count {h['count']}")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """HTTP scrape endpoint over (registry, sampler, burn tracker).

    ``port=0`` binds an ephemeral port, published as ``.port`` after
    :meth:`start`.  The handler thread pool is daemonised so an exporter
    left running never blocks interpreter exit.
    """

    def __init__(self, registry, *, sampler=NULL_SAMPLER, burn=NULL_BURN,
                 host: str = "127.0.0.1", port: int = 0,
                 series_tail: int = 120):
        self.registry = registry
        self.sampler = sampler
        self.burn = burn
        self.host = host
        self.port = int(port)
        self.series_tail = int(series_tail)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.scrapes = 0

    # ------------------------------------------------------------- payloads
    def metrics_text(self) -> str:
        return prometheus_text(self.registry.snapshot())

    def json_payload(self) -> dict:
        series = self.sampler.series()
        tail = self.series_tail
        if tail and len(series["t"]) > tail:
            series["t"] = series["t"][-tail:]
            for col in ("counters", "gauges", "rates"):
                series[col] = {k: v[-tail:] for k, v in series[col].items()}
        return {
            "kind": "metrics-scrape",
            "snapshot": self.registry.snapshot(),
            "series": series,
            "burn": self.burn.to_dict(),
        }

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        body = exporter.metrics_text().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path in ("/json", "/"):
                        body = json.dumps(exporter.json_payload()).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as exc:  # scrape must never kill the serve
                    self.send_error(500, str(exc))
                    return
                exporter.scrapes += 1
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name="sac-metrics-exporter", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
