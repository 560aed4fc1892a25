"""Live observability exposition: the port of
``paddle_tpu/profiler/exposition.py``.

:class:`ObservabilityServer` is a standard-library ``http.server`` in a
daemon thread, serving:

- ``/metrics``: Prometheus text exposition v0.0.4 of the configured
  registry (a fleet's :class:`~.metrics.FederatedRegistry`:
  ``replica``-labelled children and summed totals);
- ``/statusz``: one JSON document of named section providers (replica
  health and breakers, SLO attainment and alerts, the slowest recent
  request traces, flight-recorder incidents, goodput), each guarded: a
  section that raises becomes an ``{"error": ...}`` stanza;
- ``/healthz``: liveness (200 ``ok``).

The handler only reads: it takes no engine lock and touches no device,
so a scrape never blocks the serving loop. Every response is
materialized before it is sent; a handler exception answers 500 with a
JSON body. ``port=0`` binds an ephemeral port. Scrapes are counted
(``obs/scrapes``, ``obs/scrape_errors`` on the process-wide registry).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import metrics as _metrics
# the response skeleton is shared with the API front door
# (inference/api_server.py) through httpbase
from .httpbase import evaluate_sections, materialize_response

__all__ = ["ObservabilityServer", "evaluate_sections"]

_metrics.declare("obs/scrapes", "counter",
                 "HTTP scrapes served by the ObservabilityServer "
                 "(/metrics + /statusz + /healthz)")
_metrics.declare("obs/scrape_errors", "counter",
                 "ObservabilityServer requests that returned a 500 "
                 "(a section provider or the registry render raised)")


class _Handler(BaseHTTPRequestHandler):
    """One scrape. The server instance hangs off ``self.server.owner``
    (the ObservabilityServer)."""

    protocol_version = "HTTP/1.1"

    # silence the default stderr access log (scrapes arrive every few
    # seconds forever; the serving process's stderr is for the runtime)
    def log_message(self, fmt, *args):  # noqa: A002
        pass

    def _send(self, code, body, ctype):
        code, headers, data = materialize_response(code, body, ctype)
        self.send_response(code)
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 — http.server API
        owner = self.server.owner
        path = self.path.split("?", 1)[0]
        _metrics.get_registry().counter("obs/scrapes").inc()
        try:
            if path == "/healthz":
                self._send(200, "ok\n", "text/plain; charset=utf-8")
            elif path == "/metrics":
                self._send(200, owner.render_metrics(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/statusz":
                self._send(200, owner.render_statusz(),
                           "application/json")
            else:
                self._send(404, json.dumps(
                    {"error": f"unknown path {path!r}",
                     "paths": ["/metrics", "/statusz", "/healthz"]}),
                    "application/json")
        except Exception as exc:  # noqa: BLE001 — a scrape must never
            # kill the handler thread or drop mid-document
            _metrics.get_registry().counter("obs/scrape_errors").inc()
            try:
                self._send(500, json.dumps(
                    {"error": f"{type(exc).__name__}: {exc}"}),
                    "application/json")
            except OSError:
                pass


class ObservabilityServer:
    """Background-thread HTTP exposition of a metrics registry plus
    named /statusz sections (module docstring).

    ``registry`` defaults to the process-wide registry; a fleet passes
    its :class:`~.metrics.FederatedRegistry`. ``sections`` maps section
    name -> zero-arg callable returning a JSON-serializable value,
    evaluated per scrape (live state, not a cached copy);
    :meth:`add_section` registers more after construction.
    """

    def __init__(self, registry=None, sections=None, host="127.0.0.1",
                 port=0, pre_scrape=None):
        self.registry = registry
        #: zero-arg callable run before every /metrics render (best-
        #: effort): the fleet wires the SLO tracker's refresh() here
        #: so a Prometheus-only scraper reads current burn/attainment
        #: gauges, not values frozen since the last recorded request
        self.pre_scrape = pre_scrape
        self._sections = dict(sections or {})
        self._lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self
        self._thread = None

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.05},
                name="obs-exposition", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- sections ----------------------------------------------------------

    def add_section(self, name, provider):
        """Register/replace a /statusz section provider (zero-arg
        callable -> JSON-serializable)."""
        with self._lock:
            self._sections[str(name)] = provider
        return self

    # -- renders (also the test surface: no HTTP needed) --------------------

    def render_metrics(self) -> str:
        if self.pre_scrape is not None:
            try:
                self.pre_scrape()
            except Exception:  # noqa: BLE001 — a refresh hook must
                pass           # never fail the scrape itself
        reg = self.registry or _metrics.get_registry()
        return reg.export_prometheus()

    def render_statusz(self) -> str:
        """The /statusz JSON document (see :func:`evaluate_sections`
        for the guarded evaluation contract)."""
        with self._lock:
            sections = dict(self._sections)
        doc = evaluate_sections(sections)
        # default=str: a section that leaks a non-JSON value (numpy
        # scalar, Exception) must not make the whole document
        # unserializable mid-incident — exactly when /statusz matters
        return json.dumps(doc, default=str, sort_keys=True)
