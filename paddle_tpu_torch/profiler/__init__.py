"""``paddle.profiler`` of the port, and its observability: the typed
metrics registry and its federation, the structured tracer and the
completed-request trace log, the flight recorder and its watchdog, SLO
accounting, the goodput ledger, the ``/metrics`` + ``/statusz``
exposition server, and the cost model (:mod:`.cost`).

Port of ``paddle_tpu/profiler/__init__.py``: ``ProfilerOptions``,
``enable``/``disable`` and their ``PADDLE_PROFILER_*`` environment
variables, ``RecordEvent``, ``make_scheduler``, ``export_chrome_tracing``,
``load_profiler_result`` and ``Profiler``, riding on the port's tracer.
Where the JAX ``Profiler`` records the device with
``jax.profiler.start_trace``/``stop_trace``, the port records it with
``torch.profiler`` (CPU activities, and CUDA ones for the ``GPU``
target) and exports a chrome trace into the log directory when each
recording window closes; ``RecordEvent`` is a
``torch.profiler.record_function`` range there. ``FLAGS_enable_host_trace``
calls ``enable``/``disable``.

Standard library only at import time (the elastic launcher's process
loads no torch): ``torch`` is imported where a recording starts.
"""

from __future__ import annotations

import dataclasses
import os
import time

from . import cost, exposition, flight_recorder, goodput  # noqa: F401
from . import metrics, slo, trace  # noqa: F401
from .exposition import ObservabilityServer
from .flight_recorder import FlightRecorder, Watchdog
from .goodput import GoodputLedger
from .metrics import (Counter, FederatedRegistry, Gauge, Histogram,
                      MetricsRegistry, get_registry)
from .slo import SLORule, SLOTracker
from .trace import (RequestTraceLog, Tracer, block_on, get_trace_log,
                    get_tracer, log_perf_event, trace_span)

__all__ = ["Profiler", "RecordEvent", "ProfilerTarget", "ProfilerState",
           "make_scheduler", "export_chrome_tracing", "load_profiler_result",
           "SortedKeys", "SummaryView", "ProfilerOptions", "enable",
           "disable", "cost", "Counter", "FederatedRegistry",
           "FlightRecorder", "Gauge", "GoodputLedger", "Histogram",
           "MetricsRegistry", "ObservabilityServer", "RequestTraceLog",
           "SLORule", "SLOTracker", "Tracer", "Watchdog", "block_on",
           "get_registry", "get_trace_log", "get_tracer",
           "log_perf_event", "trace_span"]


def _env_bool(name, default=False):
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class ProfilerOptions:
    """Knobs of the structured trace layer. Every field has a
    ``PADDLE_PROFILER_*`` environment twin, so headless runs can turn
    tracing on without code."""

    output_dir: str = "./profiler_log"          # PADDLE_PROFILER_LOG_DIR
    trace_enabled: bool = False                 # PADDLE_PROFILER_TRACE
    with_flops: bool = False                    # PADDLE_PROFILER_WITH_FLOPS
    sync_spans: bool = False                    # PADDLE_PROFILER_SYNC
    export_on_disable: bool = True

    @classmethod
    def from_env(cls) -> "ProfilerOptions":
        return cls(
            output_dir=os.environ.get("PADDLE_PROFILER_LOG_DIR",
                                      "./profiler_log"),
            trace_enabled=_env_bool("PADDLE_PROFILER_TRACE"),
            with_flops=_env_bool("PADDLE_PROFILER_WITH_FLOPS"),
            sync_spans=_env_bool("PADDLE_PROFILER_SYNC"))


def enable(options: ProfilerOptions | None = None) -> Tracer:
    """Turn the structured trace layer on process-wide."""
    tr = get_tracer()
    tr.options = options or ProfilerOptions.from_env()
    tr.enabled = True
    return tr


def disable(export: bool | None = None) -> str | None:
    """Turn tracing off; by default export the chrome trace into
    ``options.output_dir`` if any events were recorded. Returns the
    export path (or None)."""
    tr = get_tracer()
    opts = tr.options or ProfilerOptions()
    tr.enabled = False
    path = None
    if (opts.export_on_disable if export is None else export) \
            and tr.events:
        path = tr.export_chrome_trace(
            os.path.join(opts.output_dir, "paddle_trace.json"))
    return path


def _env_trace_requested() -> bool:
    # FLAGS_enable_host_trace=1 in the environment is the same switch;
    # its on_change fires only through set_flags, so read the variable
    # here (parsed as the flag parses it, without loading the flags)
    return _env_bool("PADDLE_PROFILER_TRACE") or \
        _env_bool("FLAGS_enable_host_trace")


if _env_trace_requested():
    enable()


class ProfilerTarget:
    CPU = "cpu"
    GPU = "gpu"
    CUSTOM_DEVICE = "custom"
    TPU = "tpu"


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class SortedKeys:
    CPUTotal = 0
    CPUAvg = 1
    GPUTotal = 2


class SummaryView:
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """A step -> state callable (``paddle.profiler.make_scheduler``)."""
    cycle = closed + ready + record

    def scheduler(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = s % cycle if cycle else 0
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return scheduler


def export_chrome_tracing(dir_name, worker_name=None):
    """Trace-ready handler directing the capture into ``dir_name``. The
    Profiler reads ``handler.log_dir`` at construction, so the directory
    is set before recording starts."""
    def handler(prof):
        prof._log_dir = dir_name
    handler.log_dir = dir_name
    handler.worker_name = worker_name
    return handler


def load_profiler_result(path):
    return path


class RecordEvent:
    """A user range: a ``torch.profiler.record_function`` range in the
    device trace while a ``Profiler`` records, and a ``trace_span`` in
    the structured tracer's export while that is enabled."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._rf = None
        self._span = None
        self.begin_ts = None

    def begin(self):
        if _recording:
            import torch
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        tr = get_tracer()
        if tr.enabled:
            self._span = tr.span(self.name, cat="record_event")
            self._span.__enter__()
        self.begin_ts = time.perf_counter()

    def end(self):
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


# the torch.profiler sessions recording now (RecordEvent reads it)
_recording: list = []


class Profiler:
    """``paddle.profiler.Profiler``: step timing, the structured tracer
    (with ``with_flops`` or ``options``) and, for the steps its scheduler
    marks ``RECORD``, a ``torch.profiler`` recording of the targets (CPU;
    GPU adds the CUDA activities: every kernel launched, by its device
    symbol), exported as a chrome trace into the log directory when the
    window closes (``trace_paths`` lists the files). ``scheduler`` is a
    callable of the step, or ``(lo, hi)`` for the steps lo..hi-1."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 record_shapes=False, profile_memory=False, timer_only=False,
                 emit_nvtx=False, custom_device_types=None, with_flops=False,
                 options: ProfilerOptions | None = None):
        self._scheduler = scheduler if callable(scheduler) else None
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self._scheduler = lambda step: (
                ProfilerState.RECORD if lo <= step < hi
                else ProfilerState.CLOSED)
        self._targets = list(targets) if targets is not None else None
        self._on_trace_ready = on_trace_ready
        self._log_dir = os.environ.get("PADDLE_PROFILER_LOG_DIR",
                                       "./profiler_log")
        if on_trace_ready is not None and hasattr(on_trace_ready,
                                                  "log_dir"):
            self._log_dir = on_trace_ready.log_dir
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self._step = 0
        self._session = None
        self._timer_only = timer_only
        self._step_times = []
        self._last = None
        self._with_flops = with_flops
        self._options = options
        if options is not None and getattr(options, "output_dir", None):
            self._log_dir = options.output_dir
        self.trace_paths: list[str] = []

    def start(self):
        if self._with_flops or self._options is not None:
            # the structured tracer rides along; a sub-region Profiler
            # must not stomp a whole-process tracing session
            tr = get_tracer()
            self._prev_trace_state = (tr.enabled, tr.options)
            opts = self._options or ProfilerOptions(
                output_dir=self._log_dir, with_flops=self._with_flops)
            enable(opts)
        self._last = time.perf_counter()
        self._maybe_transition()

    def stop(self):
        if self._session is not None:
            self._stop_recording()
        if self._with_flops or self._options is not None:
            prev_enabled, prev_options = getattr(
                self, "_prev_trace_state", (False, None))
            if prev_enabled:
                get_tracer().options = prev_options
            else:
                disable()

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last is not None:
            self._step_times.append(now - self._last)
        self._last = now
        self._step += 1
        self._maybe_transition()

    def _activities(self):
        """CPU for the CPU target, CUDA for the GPU target; no targets:
        CPU, and CUDA where there is a card."""
        import torch
        from torch.profiler import ProfilerActivity
        targets = self._targets
        if targets is None:
            targets = [ProfilerTarget.CPU] + [ProfilerTarget.GPU] * \
                torch.cuda.is_available()
        acts = []
        if ProfilerTarget.CPU in targets:
            acts.append(ProfilerActivity.CPU)
        if ProfilerTarget.GPU in targets:
            if not torch.cuda.is_available():
                raise RuntimeError("Profiler: the GPU target needs a CUDA "
                                   "device")
            acts.append(ProfilerActivity.CUDA)
        return acts or [ProfilerActivity.CPU]

    def _start_recording(self):
        import torch
        os.makedirs(self._log_dir, exist_ok=True)
        self._session = torch.profiler.profile(
            activities=self._activities(), record_shapes=self._record_shapes,
            profile_memory=self._profile_memory)
        self._session.__enter__()
        _recording.append(self._session)

    def _stop_recording(self):
        session, self._session = self._session, None
        _recording.remove(session)
        session.__exit__(None, None, None)
        path = os.path.join(
            self._log_dir,
            f"paddle_tpu_torch_trace_{os.getpid()}_{len(self.trace_paths)}"
            ".json")
        session.export_chrome_trace(path)
        self.trace_paths.append(path)
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def _maybe_transition(self):
        if self._timer_only or self._scheduler is None:
            return
        state = self._scheduler(self._step)
        want = state in (ProfilerState.RECORD,
                         ProfilerState.RECORD_AND_RETURN)
        if want and self._session is None:
            self._start_recording()
        elif not want and self._session is not None:
            self._stop_recording()

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        n = len(self._step_times)
        if not n:
            print("No steps recorded")
            return
        avg = sum(self._step_times) / n
        print(f"steps: {n}  avg step time: {avg * 1e3:.3f} ms  "
              f"throughput: {1.0 / avg:.2f} steps/s")
        sections = get_tracer().section_summary(
            peak_flops=cost.device_peaks().flops)
        for name, a in sorted(sections.items(),
                              key=lambda kv: -kv[1]["total_ms"]):
            mfu_s = f"  MFU {a['mfu'] * 100:.1f}%" if "mfu" in a else ""
            print(f"  {name}: {a['count']}x  total {a['total_ms']:.2f} ms"
                  f"  mean {a['mean_ms']:.3f} ms{mfu_s}")

    def export(self, path=None, format="json"):
        tr = get_tracer()
        if path is not None and tr.events:
            tr.export_chrome_trace(path)
            return path
        return self._log_dir

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
