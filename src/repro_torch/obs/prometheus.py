"""Prometheus text-format exposition (format 0.0.4) for a MetricRegistry
(the port's copy of ``repro/obs/prometheus.py``).

``render`` turns a registry collect into the plain-text scrape body;
``MetricsServer`` serves it on ``/metrics`` from a stdlib http.server
daemon thread (no dependencies — the container has no prometheus_client);
``snapshot`` is the one-shot variant for tests and ``--dump-metrics``.
"""
from __future__ import annotations

import http.server
import math
import threading
from typing import Optional

from .registry import Metric, MetricRegistry


def _escape_help(value: str) -> str:
    # HELP text escapes only backslash and newline (text format 0.0.4)
    return value.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    # label values additionally escape the double quote
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _format_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _render_family(m: Metric) -> str:
    lines = []
    if m.help:
        lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
    lines.append(f"# TYPE {m.name} {m.kind}")
    for labels in sorted(m.samples):
        v = m.samples[labels]
        if labels:
            body = ",".join(f'{k}="{_escape_label(str(val))}"'
                            for k, val in labels)
            lines.append(f"{m.name}{{{body}}} {_format_value(v)}")
        else:
            lines.append(f"{m.name} {_format_value(v)}")
    return "\n".join(lines)


def render(registry: MetricRegistry) -> str:
    """Collect the registry and render Prometheus text format 0.0.4."""
    return "\n".join(_render_family(m) for m in registry.collect()
                     if m.samples) + "\n"


def snapshot(registry: MetricRegistry) -> str:
    """One-shot scrape body (alias of ``render`` — named for intent)."""
    return render(registry)


class MetricsServer:
    """``/metrics`` endpoint on a daemon thread.

    >>> srv = MetricsServer(registry, port=9105)
    >>> srv.start()          # returns the bound port (0 picks a free one)
    >>> ...
    >>> srv.stop()
    """

    def __init__(self, registry: MetricRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry
        self.host = host
        self.port = port
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        registry = self.registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib API name)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = render(registry).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # silence per-request stderr spam
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
