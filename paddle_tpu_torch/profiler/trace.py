"""Structured trace layer: nestable spans, counters, chrome-trace export.
The port of ``paddle_tpu/profiler/trace.py``.

Host-side spans with wall time, optional device-sync points and
FLOPs/bytes annotations, counter samples and instant markers, exported to
the chrome trace-event schema (Perfetto, chrome://tracing) and to raw
JSON.

- A DISABLED tracer costs one attribute read per span, so the
  instrumentation stays in production paths (:func:`get_tracer` is
  disabled until something enables it).
- Spans are exception-safe: the event is recorded, with an ``error``
  arg, even when the body raises.
- :func:`block_on` waits on the CUDA work of the tensors it is given,
  and a span calls it only when it is asked to (``sync=``): tracing adds
  no host synchronisation of its own.
- Exports are atomic (tmp + fsync + ``os.replace``): a crash or a full
  disk mid-export never leaves a torn file.
- :class:`RequestTraceLog` keeps the summaries of completed requests
  (bounded) for ``/statusz``'s slowest traces.

Standard library only at import time; ``torch`` is imported inside
:func:`block_on`.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field

__all__ = ["TraceEvent", "Tracer", "get_tracer", "trace_span",
           "block_on", "log_perf_event", "perf_logger",
           "RequestTraceLog", "get_trace_log", "epoch_summary"]

perf_logger = logging.getLogger("paddle_tpu_torch.perf")

_US = 1e6


@dataclass
class TraceEvent:
    """One trace record in chrome trace-event vocabulary: ``ph="X"`` is
    a complete span (ts + dur), ``"C"`` a counter sample (gauges),
    ``"i"`` an instant marker (e.g. a device-sync point)."""

    name: str
    ph: str = "X"
    cat: str = "user"
    ts: float = 0.0          # microseconds since tracer epoch
    dur: float = 0.0         # microseconds (X events)
    tid: int = 0
    depth: int = 0
    args: dict = field(default_factory=dict)

    def to_chrome(self, pid: int) -> dict:
        ev = {"name": self.name, "ph": self.ph, "cat": self.cat,
              "ts": self.ts, "pid": pid, "tid": self.tid}
        if self.ph == "X":
            ev["dur"] = self.dur
        if self.ph == "i":
            ev["s"] = "t"            # thread-scoped instant
        if self.args:
            ev["args"] = self.args
        return ev


def block_on(value):
    """Device-sync point: block until the CUDA work behind ``value`` (a
    tensor, a list/tuple/dict of them, or a callable returning one) is
    done. Waits on the current stream of each CUDA device the tensors
    live on; CPU tensors (and anything else) need no wait. Returns the
    seconds spent blocked."""
    t0 = time.perf_counter()
    if callable(value):
        value = value()
    import torch
    devices = set()

    def _collect(v):
        if isinstance(v, (list, tuple)):
            for x in v:
                _collect(x)
        elif isinstance(v, dict):
            for x in v.values():
                _collect(x)
        elif isinstance(v, torch.Tensor) and v.is_cuda:
            devices.add(v.device)

    _collect(value)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return time.perf_counter() - t0


class _Span:
    """Context manager recording one X event. Exception-safe: records
    even when the body raises (annotating ``args['error']``)."""

    __slots__ = ("_tracer", "name", "cat", "args", "sync", "_t0", "_depth")

    def __init__(self, tracer, name, cat, sync, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.sync = sync
        self.args = args

    def set_args(self, **kw):
        """Attach/override metadata mid-span (e.g. flops discovered
        after shapes are known)."""
        self.args.update(kw)
        return self

    def __enter__(self):
        tl = self._tracer._tl
        self._depth = getattr(tl, "depth", 0)
        tl.depth = self._depth + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self.sync is not None and exc_type is None:
                sync_s = block_on(self.sync)
                self.args.setdefault("sync_s", round(sync_s, 6))
            t1 = time.perf_counter()
            if exc_type is not None:
                self.args["error"] = f"{exc_type.__name__}: {exc}"
            self._tracer._record(TraceEvent(
                name=self.name, ph="X", cat=self.cat,
                ts=(self._t0 - self._tracer._epoch) * _US,
                dur=(t1 - self._t0) * _US,
                tid=threading.get_ident() & 0xFFFF, depth=self._depth,
                args=self.args))
        finally:
            self._tracer._tl.depth = self._depth
        return False                         # never swallow exceptions


class _NullSpan:
    """Shared no-op span for the disabled tracer (one object, no
    allocation per call)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_args(self, **kw):
        return self


_NULL_SPAN = _NullSpan()


class Tracer:
    """Process-wide structured trace recorder (see module docstring)."""

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.events: list[TraceEvent] = []
        self.options = None                 # ProfilerOptions when enabled
        self._lock = threading.Lock()
        self._tl = threading.local()
        self._epoch = time.perf_counter()

    # -- recording --------------------------------------------------------

    def _record(self, ev: TraceEvent):
        with self._lock:
            self.events.append(ev)

    def span(self, name, cat="user", sync=None, **args):
        """Nestable timed span. ``sync`` (Tensor/array/pytree/callable)
        inserts a device-sync point before the span closes, so the
        duration covers device work, not just dispatch. Extra kwargs
        become event args (``flops=``/``bytes=`` feed the per-section
        MFU/roofline summary, profiler.cost)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, sync, dict(args))

    def counter(self, name, value=None, cat="gauge", **values):
        """Record a gauge sample (chrome counter event)."""
        if not self.enabled:
            return
        args = dict(values)
        if value is not None:
            args.setdefault("value", value)
        self._record(TraceEvent(
            name=name, ph="C", cat=cat,
            ts=(time.perf_counter() - self._epoch) * _US,
            tid=threading.get_ident() & 0xFFFF, args=args))

    def instant(self, name, cat="marker", **args):
        if not self.enabled:
            return
        self._record(TraceEvent(
            name=name, ph="i", cat=cat,
            ts=(time.perf_counter() - self._epoch) * _US,
            tid=threading.get_ident() & 0xFFFF, args=dict(args)))

    def complete(self, name, t0, t1, cat="user", tid=None, **args):
        """Record a span RETROACTIVELY from ``perf_counter``
        timestamps: the serving request-lifecycle tracer reconstructs
        a request's queued/prefill/decode spans at completion time
        from stamps taken on the hot path (one float store each), so
        tracing a request costs nothing until it finishes. ``tid``
        gives the span its own track (e.g. the request id)."""
        if not self.enabled:
            return
        self._record(TraceEvent(
            name=name, ph="X", cat=cat,
            ts=(t0 - self._epoch) * _US,
            dur=max(0.0, t1 - t0) * _US,
            tid=(threading.get_ident() & 0xFFFF) if tid is None
            else int(tid),
            args=dict(args)))

    def device_sync(self, value, name="device_sync"):
        """Explicit sync point: blocks on ``value`` and records how long
        the host waited (the device-queue depth at this moment)."""
        if not self.enabled:
            return block_on(value)
        t0 = time.perf_counter()
        waited = block_on(value)
        self._record(TraceEvent(
            name=name, ph="X", cat="sync",
            ts=(t0 - self._epoch) * _US, dur=waited * _US,
            tid=threading.get_ident() & 0xFFFF,
            args={"waited_s": round(waited, 6)}))
        return waited

    def clear(self):
        with self._lock:
            self.events = []

    # -- summaries --------------------------------------------------------

    def section_summary(self, peak_flops=None):
        """Aggregate X events by name: count, total/mean ms, and, for
        spans annotated with ``flops``, the achieved FLOP/s and the MFU
        against ``peak_flops``."""
        agg: dict[str, dict] = {}
        with self._lock:
            events = list(self.events)
        for ev in events:
            if ev.ph != "X":
                continue
            a = agg.setdefault(ev.name, {
                "count": 0, "total_ms": 0.0, "flops": 0.0, "bytes": 0.0})
            a["count"] += 1
            a["total_ms"] += ev.dur / 1e3
            a["flops"] += float(ev.args.get("flops", 0.0))
            a["bytes"] += float(ev.args.get("bytes", 0.0))
        for name, a in agg.items():
            a["mean_ms"] = a["total_ms"] / max(a["count"], 1)
            if a["flops"] and a["total_ms"]:
                a["flops_per_s"] = a["flops"] / (a["total_ms"] / 1e3)
                if peak_flops:
                    a["mfu"] = a["flops_per_s"] / peak_flops
        return agg

    # -- export -----------------------------------------------------------

    def to_chrome_dict(self) -> dict:
        pid = os.getpid()
        with self._lock:
            events = list(self.events)
        return {"traceEvents": [ev.to_chrome(pid) for ev in events],
                "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path) -> str:
        """Write the chrome trace-event JSON atomically; returns path."""
        return _atomic_json_dump(self.to_chrome_dict(), path)

    def export_json(self, path) -> str:
        """Raw structured export (events + section summary), atomic."""
        with self._lock:
            events = [{"name": e.name, "ph": e.ph, "cat": e.cat,
                       "ts_us": e.ts, "dur_us": e.dur, "depth": e.depth,
                       "args": e.args} for e in self.events]
        return _atomic_json_dump(
            {"events": events, "sections": self.section_summary()}, path)


def _atomic_write(path, write_fn) -> str:
    """tmp + fsync + os.replace: the export either fully exists or not
    at all (fault-injection-tested; a torn half-written export is worse
    than none). ``write_fn(f)`` serializes onto the open tmp file —
    the one atomic-write skeleton every profiler export (chrome trace,
    metrics JSON, Prometheus text, flight bundles) shares."""
    path = os.fspath(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return path


def _atomic_json_dump(obj, path) -> str:
    return _atomic_write(path, lambda f: json.dump(obj, f))


# -- completed request-trace log --------------------------------------------

class RequestTraceLog:
    """Bounded store of COMPLETED end-to-end request traces — the
    ``/statusz`` "N slowest recent traces" source.

    The chrome tracer captures everything while enabled, but a serving
    fleet needs "what were the slowest requests lately?" answerable at
    any moment without chrome tracing on. Feeders (the fleet at
    delivery; a standalone engine at completion) call :meth:`record`
    with one small summary dict per finished request — ``trace_id``,
    latency, the condensed hop list the request accumulated across
    replicas. Memory is fixed (a deque of ``capacity``), recording is
    O(1), reads copy under the lock — a scrape never observes a
    half-appended entry."""

    def __init__(self, capacity=256):
        from collections import deque
        self.capacity = int(capacity)
        self._entries = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.recorded = 0

    def record(self, trace: dict):
        with self._lock:
            self._entries.append(dict(trace))
            self.recorded += 1

    def recent(self, n=None):
        """Newest-last; the whole resident window by default."""
        with self._lock:
            out = list(self._entries)
        return out if n is None else out[-int(n):]

    def slowest(self, n=10, key="latency_ms"):
        """The N slowest resident traces, slowest first (ties broken
        by trace id for a stable /statusz render)."""
        with self._lock:
            out = list(self._entries)
        out.sort(key=lambda e: (-float(e.get(key, 0.0)),
                                str(e.get("trace_id"))))
        return out[:int(n)]

    def clear(self):
        with self._lock:
            self._entries.clear()


_trace_log = RequestTraceLog()


def get_trace_log() -> RequestTraceLog:
    """The process-wide completed-request trace log (always on; the
    fleet and standalone engines feed it, /statusz reads it)."""
    return _trace_log


_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-wide tracer (disabled until a caller sets
    ``get_tracer().enabled = True``)."""
    return _tracer


def trace_span(name, cat="user", sync=None, **args):
    """Module-level convenience: a span on the global tracer."""
    return _tracer.span(name, cat=cat, sync=sync, **args)


# -- perf event log --------------------------------------------------------

_logged_once: set = set()
_logged_lock = threading.Lock()


def log_perf_event(event: str, message: str, *, level=logging.INFO,
                   once_key=None, **args) -> bool:
    """Log a performance-relevant event at INFO (logger
    ``paddle_tpu_torch.perf``) and mirror it into the trace as an
    instant marker, so a silent fallback becomes observable.

    ``once_key`` dedupes process-wide (the cliff fires every forward;
    the log should not). Returns True iff the line was emitted."""
    if once_key is not None:
        with _logged_lock:
            if once_key in _logged_once:
                return False
            _logged_once.add(once_key)
    perf_logger.log(level, "[%s] %s", event, message)
    _tracer.instant(event, cat="perf_event", message=message, **args)
    return True


def epoch_summary(epoch, steps, seconds, **metrics) -> dict:
    """A training epoch's summary (``hapi.Model.fit`` reports through
    it): one INFO line on ``perf_logger``, the ``hapi/avg_step_ms``
    gauge, and the returned dict (``epoch``, ``steps``, ``epoch_s``,
    ``avg_step_ms``, ``steps_per_s`` and ``metrics``)."""
    avg_ms = seconds / max(steps, 1) * 1e3
    summary = {"epoch": int(epoch), "steps": int(steps),
               "epoch_s": round(seconds, 4),
               "avg_step_ms": round(avg_ms, 3),
               "steps_per_s": round(steps / seconds, 3) if seconds else 0.0}
    summary.update(metrics)
    perf_logger.info("[hapi/epoch] %s", json.dumps(summary, sort_keys=True))
    from .metrics import get_registry
    get_registry().gauge("hapi/avg_step_ms").set(
        summary["avg_step_ms"], epoch=int(epoch))
    return summary
