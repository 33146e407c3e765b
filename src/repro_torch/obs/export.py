"""Live metrics exporter: a background ``http.server`` thread serving
``GET /metrics`` (Prometheus text exposition of a
:class:`repro_torch.obs.metrics.Registry`) and ``GET /healthz``, as
``repro.obs.export`` (stdlib only), enabled by ``--metrics-port`` on
the port's launchers.

The server never touches engine internals directly: an optional
``refresh`` callback (``Engine._refresh_gauges`` in practice) runs on
the serving thread before each render, pulling point-in-time gauges
(queue depths, running slots, free pages) into the registry so a scrape
mid-run sees the same values ``Engine.stats()`` would report. The
refresh reads host-side counts only and makes no CUDA call, so a scrape
neither syncs the card in the middle of a step nor invalidates a graph
capture; start the server after ``Engine.warmup()`` all the same.
Nothing binds a socket or starts a thread before
:class:`MetricsServer` is constructed / ``start()``-ed.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .metrics import Registry

__all__ = ["MetricsServer"]


class MetricsServer:
    """Daemon-thread HTTP server exposing one registry.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    available as ``.port`` after ``start()``.
    """

    def __init__(self, registry: Registry, *, port: int = 0,
                 host: str = "127.0.0.1",
                 refresh: Optional[Callable[[], None]] = None):
        self.registry = registry
        self.refresh = refresh
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics",
            daemon=True)
        self._stopped = False
        self.host = host
        self.port = int(self._httpd.server_address[1])

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?", 1)[0] == "/metrics":
                    if server.refresh is not None:
                        try:
                            server.refresh()
                        except Exception:
                            pass    # stale gauges beat a dead scrape
                    body = server.registry.render().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?", 1)[0] == "/healthz":
                    body, ctype = b"ok\n", "text/plain; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                # a scraper may hang up mid-response (timeout, ^C):
                # that is its business, not a handler-thread traceback
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def log_message(self, fmt, *args):
                pass    # scrapes must not spam the serving console

        return Handler

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent: every shutdown path (CLI finally-blocks, tests,
        signal handlers) may call it without coordinating."""
        if self._stopped:
            return
        self._stopped = True
        # shutdown() blocks on an event only serve_forever() sets — on
        # a server that was never start()ed it would wait forever
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
        self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
