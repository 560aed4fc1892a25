"""OpenAI-compatible async streaming HTTP front door: the port of
``paddle_tpu/inference/api_server.py``.

:class:`ApiServer` is a standard-library ``asyncio`` streams server
over a serving backend (a ``ServingFleet``, a
``ContinuousBatchingEngine``, an ``EngineSupervisor`` or an
``AdmissionController``), exposing:

- ``POST /v1/completions`` and ``POST /v1/chat/completions``: the
  OpenAI request and response schema; ``"stream": true`` answers with
  SSE ``data:`` chunks (one delta per harvested token batch) and a
  final ``data: [DONE]``, otherwise one JSON document;
- ``GET /v1/models``: the one served model id;
- ``GET /healthz``: liveness (503 once the pump thread has died);
- ``GET /statusz``: the front door's sections (connections, streams,
  per-route latency) merged with the backend fleet's, through the
  guarded :func:`~..profiler.httpbase.evaluate_sections`.

Threads: the engine is cooperative and not thread-safe, so one thread
("api-pump") makes every backend call and so every CUDA launch: it
drains an inbox of submit and cancel jobs, calls ``backend.step()`` in
a loop, and after each turn pushes each live stream's new tokens to its
``asyncio.Queue`` with one ``loop.call_soon_threadsafe``: tokens stream
as they are harvested. The pump runs on the backend's device and on the
stream that was current on it when :meth:`ApiServer.start` was called
(the engine's pinned buffers and events were made for it). The asyncio
loop ("api-http") owns the sockets only.

The mapping onto ``ServedRequest``:

- body fields beat the ``X-Tenant`` / ``X-Priority`` /
  ``X-TTFT-Deadline-Ms`` / ``X-Deadline-Ms`` headers; an absent tenant
  is ``"default"``, priority is clamped into ``serving.PRIORITY_RANGE``,
  and a malformed deadline is a structured 400
  (:func:`parse_request_options`);
- :class:`~.reliability.Overloaded` becomes HTTP 429 with a
  ``Retry-After`` header from ``retry_after_s``;
- typed request errors (``DeadlineExceeded``, ``RequestCancelled``,
  ``RequestQuarantined``, ``ReplicaFailed``) become OpenAI-style error
  JSON (with the partial text kept) or a final SSE error event, both
  carrying the request's finish_reason;
- a client that disconnects mid-stream has its request cancelled, so
  its pages go back to the pool;
- the trace id (the fleet's) comes back as an ``X-Trace-Id`` header,
  and the request's hops gain ``http_recv``, ``first_byte`` and
  ``last_byte``.

Front-door traffic is counted as the ``http/*`` family on the fleet's
federated registry (or a private one for a bare engine).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import math
import queue as _queuelib
import threading
import time

import numpy as np
import torch

from ..profiler import metrics as _metrics
from ..profiler.httpbase import (evaluate_sections, http1_head,
                                 http1_response)
from .reliability import Overloaded, record_hop
from .serving import PRIORITY_RANGE

__all__ = ["ApiServer", "ApiError", "parse_request_options",
           "default_tokenize", "default_detokenize"]

_metrics.declare("http/requests", "counter",
                 "HTTP requests received by the API front door "
                 "(route-labeled children per endpoint)")
_metrics.declare("http/streams", "counter",
                 "SSE completion streams opened (stream=true requests "
                 "that passed admission)")
_metrics.declare("http/disconnects", "counter",
                 "client disconnects observed mid-request; each one "
                 "invokes cancel() so the request's pages are "
                 "reclaimed")
_metrics.declare("http/bytes_sent", "counter",
                 "response bytes written by the API front door, SSE "
                 "frames included")
_metrics.declare("http/errors", "counter",
                 "error responses returned by the front door (4xx/5xx "
                 "documents + terminal SSE error events)")
_metrics.declare("http/connections", "gauge",
                 "currently open client connections on the API front "
                 "door")
_metrics.declare("http/route_latency_ms", "histogram",
                 "per-request wall ms from parsed request to last "
                 "byte written (route-labeled children; SSE streams "
                 "count their full stream duration)")


# ---- the HTTP mapping door ------------------------------------------------

class ApiError(Exception):
    """A structured client-visible HTTP error: ``status`` plus an
    OpenAI-style ``{"error": {...}}`` body."""

    def __init__(self, status, message, etype="invalid_request_error",
                 **extra):
        super().__init__(message)
        self.status = int(status)
        self.etype = str(etype)
        self.extra = dict(extra)

    def body(self) -> dict:
        err = {"message": str(self), "type": self.etype,
               "code": self.status}
        err.update(self.extra)
        return {"error": err}


def default_tokenize(text):
    """The dependency-free default tokenizer: the prompt string is
    whitespace-separated integer token ids (``"12 7 4983"``) — the
    shape the load harness and tests speak. Anything else is a 400
    (bring a real tokenizer via ``ApiServer(tokenize=...)``)."""
    toks = []
    for part in str(text).split():
        if not part.isdigit():
            raise ApiError(
                400, "the default tokenizer accepts whitespace-"
                     f"separated integer token ids; got {part!r} "
                     "(pass token-id lists, or construct ApiServer "
                     "with a real tokenize/detokenize pair)")
        toks.append(int(part))
    return toks


def default_detokenize(token_ids):
    """Inverse of :func:`default_tokenize`: space-joined ids. Streamed
    greedy content through this pair is byte-comparable with a direct
    engine run's token list."""
    return " ".join(str(int(t)) for t in token_ids)


def _pick(body, headers, body_key, header_key):
    """Body field beats header; returns (value, source) or (None, None)."""
    if body_key in body:
        return body[body_key], f"body.{body_key}"
    if header_key in headers:
        return headers[header_key], f"header {header_key}"
    return None, None


def parse_request_options(body, headers, priority_range=PRIORITY_RANGE):
    """Map request body fields + ``X-*`` headers onto the
    ``ServedRequest`` submit surface. Returns ``{tenant, priority,
    ttft_deadline_s, deadline_s}``; raises :class:`ApiError` (400,
    structured body) on malformed values.

    The contract:

    - unknown/absent/non-string tenant -> ``"default"``;
    - priority must parse as an integer and is CLAMPED into
      ``priority_range`` (an untrusted client cannot out-rank the
      whole pool by sending 2**31);
    - deadlines arrive in MILLISECONDS (``ttft_deadline_ms`` /
      ``deadline_ms`` body fields, ``X-TTFT-Deadline-Ms`` /
      ``X-Deadline-Ms`` headers) and must be positive finite numbers.
    """
    headers = {str(k).lower(): v for k, v in dict(headers or {}).items()}
    body = dict(body or {})

    tenant, _src = _pick(body, headers, "tenant", "x-tenant")
    if not isinstance(tenant, str) or not tenant.strip():
        tenant = "default"
    else:
        tenant = tenant.strip()

    raw, src = _pick(body, headers, "priority", "x-priority")
    priority = 0
    if raw is not None:
        if isinstance(raw, bool) or not isinstance(raw, (int, str)):
            raise ApiError(400, f"priority must be an integer "
                                f"({src} = {raw!r})")
        try:
            priority = int(str(raw).strip())
        except ValueError:
            raise ApiError(400, f"priority must be an integer "
                                f"({src} = {raw!r})") from None
        lo, hi = priority_range
        priority = max(int(lo), min(int(hi), priority))

    def deadline_s(body_key, header_key):
        raw, src = _pick(body, headers, body_key, header_key)
        if raw is None:
            return None
        try:
            v = float(raw) if not isinstance(raw, bool) else math.nan
        except (TypeError, ValueError):
            v = math.nan
        if not math.isfinite(v) or v <= 0:
            raise ApiError(
                400, f"{body_key} must be a positive finite number of "
                     f"milliseconds ({src} = {raw!r})")
        return v / 1e3

    return {"tenant": tenant, "priority": priority,
            "ttft_deadline_s": deadline_s("ttft_deadline_ms",
                                          "x-ttft-deadline-ms"),
            "deadline_s": deadline_s("deadline_ms", "x-deadline-ms")}


#: typed per-request failure -> (HTTP status, OpenAI-style error type).
#: finish_reason comes from the request itself ("cancelled",
#: "deadline", "quarantined", "failed"); "eos" renders as OpenAI's
#: "stop". 499 is the nginx client-closed-request convention.
_ERROR_STATUS = {
    "RequestCancelled": (499, "cancelled"),
    "DeadlineExceeded": (504, "deadline_exceeded"),
    "RequestQuarantined": (500, "quarantined"),
    "ReplicaFailed": (502, "replica_failed"),
}


def _finish_reason(req) -> str | None:
    fr = getattr(req, "finish_reason", None)
    return "stop" if fr == "eos" else fr


# ---- backend adapters ----------------------------------------------------

class _FleetBackend:
    """A ServingFleet: fleet-global ids, federated registry, statusz
    sections, fleet-minted trace ids."""

    kind = "fleet"

    def __init__(self, fleet):
        self.fleet = fleet
        self.registry = fleet.metrics

    @property
    def device(self):
        rep = next((r for r in self.fleet.replicas.values() if r.live()),
                   None)
        return None if rep is None else getattr(rep.engine, "device",
                                                None)

    def submit(self, prompt_ids, max_new_tokens, **kw):
        return self.fleet.submit(prompt_ids, max_new_tokens, **kw)

    def step(self):
        return self.fleet.step()

    def has_work(self):
        return self.fleet.has_work()

    def cancel(self, rid):
        return self.fleet.cancel(rid)

    def live(self, rid):
        return self.fleet.request(rid)

    def track(self, rid, req):
        """Per-turn token view: attempts can be REPLACED mid-flight
        (failover carry, hedging), so the fleet re-resolves by id
        every turn — a dict lookup, not a scan."""
        return None

    def statusz_sections(self):
        return self.fleet.statusz_sections()


class _EngineBackend:
    """A bare ContinuousBatchingEngine or an EngineSupervisor (both
    expose add_request/step/cancel/request/has_work), optionally
    fronted by an AdmissionController for the 429 shed path."""

    kind = "engine"

    def __init__(self, engine, admission=None):
        self.engine = engine
        self.admission = admission
        self.registry = None       # server-private registry

    @property
    def device(self):
        return getattr(getattr(self.engine, "engine", self.engine),
                       "device", None)

    def submit(self, prompt_ids, max_new_tokens, **kw):
        if self.admission is not None:
            return self.admission.submit(prompt_ids, max_new_tokens,
                                         **kw)
        return self.engine.add_request(prompt_ids, max_new_tokens, **kw)

    def step(self):
        return self.engine.step()

    def has_work(self):
        return self.engine.has_work()

    def cancel(self, rid):
        return self.engine.cancel(rid)

    def live(self, rid):
        return self.engine.request(rid)

    def track(self, rid, req):
        """The engine mutates ONE ServedRequest object end to end
        (salvage/requeue adopt the same object), so the pump can read
        ``req.tokens`` directly instead of paying engine.request()'s
        completed-list scan per stream per turn."""
        return req

    def statusz_sections(self):
        return {}


def _make_backend(backend, admission=None):
    if hasattr(backend, "replicas") and hasattr(backend, "submit"):
        return _FleetBackend(backend)
    if hasattr(backend, "add_request"):
        return _EngineBackend(backend, admission)
    if hasattr(backend, "engine") and hasattr(backend, "submit"):
        # an AdmissionController passed directly
        return _EngineBackend(backend.engine, backend)
    raise TypeError(f"unsupported backend {type(backend).__name__}: "
                    "expected ContinuousBatchingEngine, "
                    "EngineSupervisor, AdmissionController or "
                    "ServingFleet")


class _Stream:
    """Pump-side view of one in-flight HTTP request: the id, the
    token high-water mark already published, the asyncio queue the
    handler coroutine drains, and (engine backends) the tracked
    ServedRequest object read directly per turn."""

    __slots__ = ("rid", "sent", "queue", "loop", "req")

    def __init__(self, rid, q, loop, req=None):
        self.rid = rid
        self.sent = 0
        self.queue = q
        self.loop = loop
        self.req = req

    def push(self, item):
        try:
            self.loop.call_soon_threadsafe(self.queue.put_nowait, item)
        except RuntimeError:
            pass    # loop already closed (server stopping)


def _deliver_batch(batch):
    """Loop-thread callback: fan one pump turn's items out to their
    stream queues (see ApiServer._publish)."""
    for q, item in batch:
        q.put_nowait(item)


# ---- the server ----------------------------------------------------------

class ApiServer:
    """The front door (module docstring). ``backend`` is a
    ``ContinuousBatchingEngine``, ``EngineSupervisor``,
    ``AdmissionController`` or ``ServingFleet``; ``port=0`` binds an
    ephemeral port (``server.port`` / ``server.url`` after
    :meth:`start`). ``tokenize``/``detokenize`` default to the
    integer-token-id codec (:func:`default_tokenize`)."""

    def __init__(self, backend, host="127.0.0.1", port=0,
                 model_id="paddle-tpu", tokenize=None, detokenize=None,
                 admission=None, registry=None,
                 priority_range=PRIORITY_RANGE, stream_chunk_tokens=1):
        self._backend = _make_backend(backend, admission)
        self.host = host
        self._port_req = int(port)
        self.port = None
        self.model_id = str(model_id)
        self.tokenize = tokenize or default_tokenize
        self.detokenize = detokenize or default_detokenize
        self.priority_range = tuple(priority_range)
        #: SSE throughput/latency dial: a stream's FIRST tokens and
        #: its final flush always publish immediately (TTFT and
        #: completion are never delayed), but mid-stream tokens wait
        #: until this many are pending before riding a chunk. >1
        #: trades inter-token latency for fewer json+write cycles —
        #: what saturated single-core serving wants.
        self.stream_chunk_tokens = max(1, int(stream_chunk_tokens))
        self.metrics = (registry or self._backend.registry
                        or _metrics.MetricsRegistry())

        self._loop = None
        self._server = None
        self._loop_thread = None
        self._pump_thread = None
        self._started = threading.Event()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._inbox = _queuelib.SimpleQueue()
        self._lock = threading.Lock()
        self._streams: dict = {}        # rid -> _Stream
        self._connections = 0
        self._routes_seen: set = set()
        self._pump_error = None
        self._pump_stream = None

    # -- lifecycle ---------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self):
        if self._loop_thread is not None:
            return self
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="api-http", daemon=True)
        self._loop_thread.start()
        if not self._started.wait(timeout=10.0):
            raise RuntimeError("ApiServer failed to bind within 10s")
        if self.port is None:
            raise RuntimeError("ApiServer failed to bind "
                               f"{self.host}:{self._port_req}")
        dev = self._backend.device
        if dev is not None and dev.type == "cuda":
            # the pump launches on the stream the caller's thread runs
            # the engine on, not on its own thread's default
            self._pump_stream = torch.cuda.current_stream(dev)
        self._pump_thread = threading.Thread(
            target=self._pump, name="api-pump", daemon=True)
        self._pump_thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=10.0)
            self._pump_thread = None
        if self._loop is not None and self._shutdown is not None:
            try:
                self._loop.call_soon_threadsafe(self._shutdown.set)
            except RuntimeError:
                pass
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10.0)
            self._loop_thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    _shutdown = None

    def _run_loop(self):
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._serve_main())
        except Exception:   # noqa: BLE001 — bind failure: start() sees
            pass            # port None and raises with context
        finally:
            self._started.set()
            try:
                self._loop.close()
            except RuntimeError:
                pass

    async def _serve_main(self):
        self._shutdown = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self._port_req)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        await self._shutdown.wait()
        self._server.close()
        await self._server.wait_closed()
        # cancel lingering per-connection tasks so the loop can close
        for task in asyncio.all_tasks():
            if task is not asyncio.current_task():
                task.cancel()

    # -- the pump thread (owns every backend mutation) ---------------------

    def _pump(self):
        if self._pump_stream is None:
            return self._pump_loop()
        with torch.cuda.device(self._pump_stream.device), \
                torch.cuda.stream(self._pump_stream):
            return self._pump_loop()

    def _pump_loop(self):
        while not self._stop.is_set():
            progressed = self._drain_inbox()
            if self._backend.has_work():
                progressed = True
                try:
                    done = self._backend.step()
                except BaseException as exc:  # noqa: BLE001 — the
                    # backend died below its own containment (restart
                    # budget spent, audit assertion, ...): every live
                    # stream gets a terminal typed error instead of a
                    # silent hang, and /healthz goes 503
                    self._pump_error = exc
                    self._fail_streams(exc)
                    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                        raise
                    continue
                self._publish(done)
            if not progressed:
                self._wake.wait(0.005)
                self._wake.clear()
        # drain any last-moment jobs so their futures never hang
        self._drain_inbox()

    def _drain_inbox(self) -> bool:
        ran = False
        while True:
            try:
                fn, fut = self._inbox.get_nowait()
            except _queuelib.Empty:
                return ran
            ran = True
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as exc:  # noqa: BLE001 — delivered
                fut.set_exception(exc)    # to the awaiting handler

    def _publish(self, done):
        """After one backend turn: push freshly harvested tokens to
        each live stream, and completion markers for delivered
        requests (tokens first — the delivered object is the
        authoritative final view). All of one turn's pushes ride a
        SINGLE call_soon_threadsafe: each wakeup makes the loop
        thread runnable mid-step and the GIL ping-pong starves the
        backend, so one loop wakeup per turn, not one per stream."""
        donemap = {r.request_id: r for r in (done or [])}
        with self._lock:
            streams = list(self._streams.items())
        batch = []
        for rid, st in streams:
            fin = donemap.get(rid)
            req = fin if fin is not None else \
                (st.req if st.req is not None
                 else self._backend.live(rid))
            if req is not None:
                toks = req.tokens
                pending = len(toks) - st.sent
                if pending > 0 and (fin is not None or st.sent == 0
                                    or pending
                                    >= self.stream_chunk_tokens):
                    fresh = [int(t) for t in toks[st.sent:]]
                    st.sent = len(toks)
                    batch.append((st.queue, ("tokens", fresh)))
            if fin is not None:
                with self._lock:
                    self._streams.pop(rid, None)
                batch.append((st.queue, ("done", fin)))
        if batch:
            try:
                self._loop.call_soon_threadsafe(_deliver_batch, batch)
            except RuntimeError:
                pass    # loop already closed (server stopping)

    def _fail_streams(self, exc):
        with self._lock:
            streams = list(self._streams.values())
            self._streams.clear()
        for st in streams:
            st.push(("fail", exc))

    async def _in_pump(self, fn):
        """Run ``fn`` on the pump thread (between backend turns) and
        await its result."""
        fut = concurrent.futures.Future()
        self._inbox.put((fn, fut))
        self._wake.set()
        return await asyncio.wrap_future(fut)

    # -- connection handling ----------------------------------------------

    async def _handle_conn(self, reader, writer):
        self._connections += 1
        self.metrics.gauge("http/connections").set(self._connections)
        try:
            parsed = await self._read_request(reader)
            if parsed is not None:
                await self._dispatch(parsed, reader, writer)
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:
            raise
        except ApiError as exc:
            # a request-line/framing error surfaced before _dispatch
            self.metrics.counter("http/errors").inc()
            await self._try_write(writer, http1_response(
                exc.status, json.dumps(exc.body()),
                "application/json"))
        except Exception as exc:  # noqa: BLE001 — a handler bug must
            # answer 500, never drop the connection mid-parse
            self.metrics.counter("http/errors").inc()
            await self._try_write(writer, http1_response(
                500, json.dumps({"error": {
                    "message": f"{type(exc).__name__}: {exc}",
                    "type": "internal_error", "code": 500}}),
                "application/json"))
        finally:
            self._connections -= 1
            self.metrics.gauge("http/connections").set(
                self._connections)
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1", "replace").split()
        if len(parts) < 2:
            raise ApiError(400, f"malformed request line {line!r}")
        method, target = parts[0].upper(), parts[1]
        headers = {}
        while True:
            hl = await reader.readline()
            if hl in (b"\r\n", b"\n", b""):
                break
            name, _, value = hl.decode("latin-1", "replace").partition(":")
            headers[name.strip().lower()] = value.strip()
        body = b""
        try:
            n = int(headers.get("content-length", "0") or "0")
        except ValueError:
            n = 0
        if n > 0:
            body = await reader.readexactly(n)
        return method, target.split("?", 1)[0], headers, body

    async def _dispatch(self, parsed, reader, writer):
        method, path, headers, body = parsed
        route = path if path in ("/v1/completions",
                                 "/v1/chat/completions", "/v1/models",
                                 "/healthz", "/statusz") else "other"
        self._routes_seen.add(route)
        ctr = self.metrics.counter("http/requests")
        ctr.inc()                        # all-routes total (statusz)
        ctr.labels(route=route).inc()    # per-route series (/metrics)
        t0 = time.perf_counter()
        try:
            if path in ("/v1/completions", "/v1/chat/completions"):
                if method != "POST":
                    raise ApiError(405, f"{path} requires POST",
                                   etype="method_not_allowed")
                await self._completion(
                    path, headers, body, reader, writer,
                    chat=path.endswith("/chat/completions"))
            elif path == "/v1/models" and method == "GET":
                await self._try_write(writer, http1_response(
                    200, json.dumps({
                        "object": "list",
                        "data": [{"id": self.model_id,
                                  "object": "model",
                                  "owned_by": "paddle_tpu"}]}),
                    "application/json"))
            elif path == "/healthz" and method == "GET":
                if self._pump_error is not None:
                    self.metrics.counter("http/errors").inc()
                    await self._try_write(writer, http1_response(
                        503, json.dumps({"error": {
                            "message": f"pump dead: "
                                       f"{self._pump_error}",
                            "type": "unavailable", "code": 503}}),
                        "application/json"))
                else:
                    await self._try_write(writer, http1_response(
                        200, "ok\n", "text/plain; charset=utf-8"))
            elif path == "/statusz" and method == "GET":
                doc = evaluate_sections(self._statusz_sections())
                await self._try_write(writer, http1_response(
                    200, json.dumps(doc, default=str, sort_keys=True),
                    "application/json"))
            else:
                raise ApiError(404, f"unknown path {path!r}",
                               etype="not_found",
                               paths=["/v1/completions",
                                      "/v1/chat/completions",
                                      "/v1/models", "/healthz",
                                      "/statusz"])
        except ApiError as exc:
            self.metrics.counter("http/errors").inc()
            extra = []
            if exc.status == 429 and "retry_after_s" in exc.extra:
                extra = [("Retry-After", str(int(math.ceil(
                    exc.extra["retry_after_s"]))))]
            await self._try_write(writer, http1_response(
                exc.status, json.dumps(exc.body()),
                "application/json", extra))
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.metrics.histogram("http/route_latency_ms") \
                .labels(route=route).observe(ms)

    async def _try_write(self, writer, data: bytes):
        writer.write(data)
        # only pay the drain() round-trip when the transport actually
        # built up backpressure — per-chunk drains dominate the SSE
        # hot path otherwise
        if writer.transport.get_write_buffer_size() > 65536:
            await writer.drain()
        self.metrics.counter("http/bytes_sent").inc(len(data))

    # -- /statusz sections -------------------------------------------------

    def _statusz_sections(self):
        sections = dict(self._backend.statusz_sections())

        def http_section():
            snap = {}
            for name in ("http/requests", "http/streams",
                         "http/disconnects", "http/bytes_sent",
                         "http/errors"):
                m = self.metrics.get(name)
                snap[name.split("/", 1)[1]] = \
                    0 if m is None else m.value
            snap["connections"] = self._connections
            with self._lock:
                snap["live_streams"] = len(self._streams)
            snap["pump_alive"] = self._pump_error is None
            return snap

        def routes_section():
            out = {}
            hist = self.metrics.get("http/route_latency_ms")
            if hist is None:
                return out
            for route in sorted(self._routes_seen):
                child = hist.labels(route=route)
                out[route] = {
                    "count": child.count,
                    "p50_ms": round(child.percentile(50), 3),
                    "p99_ms": round(child.percentile(99), 3)}
            return out

        sections["http"] = http_section
        sections["routes"] = routes_section
        return sections

    # -- completions -------------------------------------------------------

    def _prompt_ids(self, body, chat):
        if chat:
            msgs = body.get("messages")
            if not isinstance(msgs, list) or not msgs:
                raise ApiError(400, "chat completions require a "
                                    "non-empty messages list")
            ids = []
            for m in msgs:
                if not isinstance(m, dict) or "content" not in m:
                    raise ApiError(400, "each message must be an "
                                        "object with a content field")
                ids.extend(self.tokenize(str(m["content"])))
            if not ids:
                raise ApiError(400, "messages tokenized to an empty "
                                    "prompt")
            return ids
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            ids = self.tokenize(prompt)
        elif isinstance(prompt, list) and prompt and \
                all(isinstance(t, int) and not isinstance(t, bool)
                    for t in prompt):
            ids = [int(t) for t in prompt]
        else:
            raise ApiError(400, "prompt must be a non-empty string or "
                                "a list of integer token ids")
        if not ids:
            raise ApiError(400, "prompt tokenized to an empty "
                                "sequence")
        return ids

    async def _completion(self, path, headers, body_bytes, reader,
                          writer, chat):
        try:
            body = json.loads(body_bytes.decode("utf-8")) \
                if body_bytes else {}
        except (ValueError, UnicodeDecodeError):
            raise ApiError(400, "request body is not valid JSON") \
                from None
        if not isinstance(body, dict):
            raise ApiError(400, "request body must be a JSON object")
        opts = parse_request_options(body, headers,
                                     self.priority_range)
        prompt_ids = self._prompt_ids(body, chat)
        max_tokens = body.get("max_tokens", 16)
        if not isinstance(max_tokens, int) or isinstance(max_tokens,
                                                         bool) \
                or max_tokens < 1:
            raise ApiError(400, "max_tokens must be a positive "
                                "integer")
        eos = body.get("eos_token_id")
        if eos is not None and (not isinstance(eos, int)
                                or isinstance(eos, bool)):
            raise ApiError(400, "eos_token_id must be an integer")
        stream = bool(body.get("stream", False))

        prompt_arr = np.asarray(prompt_ids, dtype=np.int32)
        q = asyncio.Queue()

        def _do_submit():
            rid = self._backend.submit(
                prompt_arr, max_tokens, eos_token_id=eos, **opts)
            req = self._backend.live(rid)
            if req is not None:
                record_hop(req, "http_recv", route=path)
            st = _Stream(rid, q, self._loop,
                         req=self._backend.track(rid, req))
            with self._lock:
                self._streams[rid] = st
            return rid, req

        try:
            rid, req0 = await self._in_pump(_do_submit)
        except Overloaded as exc:
            raise ApiError(
                429, str(exc), etype="overloaded",
                retry_after_s=round(exc.retry_after_s, 4)) from None
        except ValueError as exc:
            # _check_fits: prompt/max_new beyond the pool geometry
            raise ApiError(400, str(exc)) from None

        trace_id = getattr(req0, "trace_id", None)
        trace_id = rid if trace_id is None else trace_id
        if stream:
            await self._stream_response(path, chat, rid, req0, q,
                                        trace_id, prompt_ids, reader,
                                        writer)
        else:
            await self._unary_response(chat, rid, req0, q, trace_id,
                                       prompt_ids, reader, writer)

    def _cancel_for_disconnect(self, rid):
        self.metrics.counter("http/disconnects").inc()
        with self._lock:
            self._streams.pop(rid, None)
        # cancel on the pump thread; fire-and-forget (the client is
        # gone — nobody is waiting on the result)
        self._inbox.put((lambda: self._backend.cancel(rid),
                         concurrent.futures.Future()))
        self._wake.set()

    async def _await_outcome(self, rid, q, reader, on_tokens=None):
        """Drain the stream queue until a terminal item, watching the
        client socket for disconnect (EOF/reset -> cancel() so pages
        are reclaimed). Returns ("done", req) | ("fail", exc) |
        ("disconnect", None)."""
        watcher = asyncio.create_task(reader.read(65536))
        try:
            while True:
                getter = asyncio.create_task(q.get())
                await asyncio.wait({getter, watcher},
                                   return_when=asyncio.FIRST_COMPLETED)
                if not getter.done():
                    # client hung up (or sent junk mid-stream) before
                    # the backend finished
                    getter.cancel()
                    self._cancel_for_disconnect(rid)
                    return "disconnect", None
                kind, payload = getter.result()
                if kind == "tokens":
                    toks = list(payload)
                    # coalesce every batch already sitting in the
                    # queue into ONE SSE chunk: when the pump outruns
                    # the writer (single-core CPU, slow client) this
                    # collapses many small json+write cycles into one
                    # without delaying any token that could have been
                    # sent sooner
                    tail = None
                    while tail is None:
                        try:
                            k2, p2 = q.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                        if k2 == "tokens":
                            toks.extend(p2)
                        else:
                            tail = (k2, p2)
                    if on_tokens is not None:
                        ok = await on_tokens(toks)
                        if not ok:
                            self._cancel_for_disconnect(rid)
                            return "disconnect", None
                    if tail is not None:
                        return tail
                    continue
                return kind, payload
        finally:
            watcher.cancel()

    # -- non-streaming -----------------------------------------------------

    async def _unary_response(self, chat, rid, req0, q, trace_id,
                              prompt_ids, reader, writer):
        kind, payload = await self._await_outcome(rid, q, reader)
        if kind == "disconnect":
            return
        if kind == "fail":
            self.metrics.counter("http/errors").inc()
            await self._try_write(writer, http1_response(
                500, json.dumps({"error": {
                    "message": f"backend failed: {payload}",
                    "type": "internal_error", "code": 500,
                    "trace_id": trace_id}}),
                "application/json",
                [("X-Trace-Id", str(trace_id))]))
            return
        req = payload
        text = self.detokenize(req.tokens)
        created = int(time.time())
        extra = [("X-Trace-Id", str(trace_id))]
        if req.error is not None:
            status, etype = _ERROR_STATUS.get(
                type(req.error).__name__, (500, "serving_error"))
            self.metrics.counter("http/errors").inc()
            doc = {"error": {"message": str(req.error), "type": etype,
                             "code": status,
                             "finish_reason": _finish_reason(req),
                             "trace_id": trace_id,
                             # a failed stream still delivers its
                             # partial prefix, never silence
                             "partial_text": text}}
            await self._try_write(writer, http1_response(
                status, json.dumps(doc), "application/json", extra))
            record_hop(req, "last_byte")
            return
        if chat:
            choice = {"index": 0,
                      "message": {"role": "assistant",
                                  "content": text},
                      "finish_reason": _finish_reason(req)}
            obj, oid = "chat.completion", f"chatcmpl-{trace_id}"
        else:
            choice = {"index": 0, "text": text,
                      "finish_reason": _finish_reason(req)}
            obj, oid = "text_completion", f"cmpl-{trace_id}"
        doc = {"id": oid, "object": obj, "created": created,
               "model": self.model_id, "choices": [choice],
               "usage": {"prompt_tokens": len(prompt_ids),
                         "completion_tokens": len(req.tokens),
                         "total_tokens": len(prompt_ids)
                         + len(req.tokens)}}
        record_hop(req, "first_byte")
        await self._try_write(writer, http1_response(
            200, json.dumps(doc), "application/json", extra))
        record_hop(req, "last_byte")

    # -- SSE streaming -----------------------------------------------------

    def _sse_chunk(self, chat, oid, created, *, delta_text=None,
                   finish_reason=None, role=False, error=None):
        if chat:
            delta = {}
            if role:
                delta["role"] = "assistant"
            if delta_text is not None:
                delta["content"] = delta_text
            choice = {"index": 0, "delta": delta,
                      "finish_reason": finish_reason}
            obj = "chat.completion.chunk"
        else:
            choice = {"index": 0, "text": delta_text or "",
                      "finish_reason": finish_reason}
            obj = "text_completion"
        doc = {"id": oid, "object": obj, "created": created,
               "model": self.model_id, "choices": [choice]}
        if error is not None:
            doc["error"] = error
        return b"data: " + json.dumps(doc).encode("utf-8") + b"\n\n"

    async def _stream_response(self, path, chat, rid, req0, q,
                               trace_id, prompt_ids, reader, writer):
        self.metrics.counter("http/streams").inc()
        created = int(time.time())
        oid = (f"chatcmpl-{trace_id}" if chat else f"cmpl-{trace_id}")
        head = http1_head(200, [
            ("Content-Type", "text/event-stream; charset=utf-8"),
            ("Cache-Control", "no-cache"),
            ("Connection", "close"),
            ("X-Trace-Id", str(trace_id))])
        try:
            await self._try_write(writer, head)
        except (ConnectionResetError, BrokenPipeError, OSError):
            self._cancel_for_disconnect(rid)
            return

        state = {"first": True, "tokens": [], "text": ""}

        async def on_tokens(fresh):
            state["tokens"].extend(fresh)
            full = self.detokenize(state["tokens"])
            delta, state["text"] = full[len(state["text"]):], full
            chunk = self._sse_chunk(chat, oid, created,
                                    delta_text=delta,
                                    role=state["first"])
            try:
                await self._try_write(writer, chunk)
            except (ConnectionResetError, BrokenPipeError, OSError):
                return False
            if state["first"]:
                state["first"] = False
                live = req0 if req0 is not None \
                    else self._backend.live(rid)
                if live is not None:
                    record_hop(live, "first_byte")
            return True

        kind, payload = await self._await_outcome(rid, q, reader,
                                                  on_tokens)
        if kind == "disconnect":
            return
        if kind == "fail":
            self.metrics.counter("http/errors").inc()
            err = {"message": f"backend failed: {payload}",
                   "type": "internal_error", "code": 500,
                   "trace_id": trace_id}
            await self._try_write(writer, self._sse_chunk(
                chat, oid, created, finish_reason="failed",
                error=err))
            await self._try_write(writer, b"data: [DONE]\n\n")
            return
        req = payload
        # the delivered object is authoritative: any tokens the pump
        # attached to the terminal item's request beyond what we
        # streamed were already pushed as a tokens item before "done"
        error = None
        if req.error is not None:
            status, etype = _ERROR_STATUS.get(
                type(req.error).__name__, (500, "serving_error"))
            self.metrics.counter("http/errors").inc()
            error = {"message": str(req.error), "type": etype,
                     "code": status, "trace_id": trace_id}
        final = self._sse_chunk(chat, oid, created,
                                finish_reason=_finish_reason(req),
                                error=error)
        try:
            await self._try_write(writer, final)
            await self._try_write(writer, b"data: [DONE]\n\n")
        except (ConnectionResetError, BrokenPipeError, OSError):
            self.metrics.counter("http/disconnects").inc()
            return
        record_hop(req, "last_byte")
