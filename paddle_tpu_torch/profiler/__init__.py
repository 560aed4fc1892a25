"""Observability of the port: the typed metrics registry and its
federation, the structured tracer and the completed-request trace log,
the flight recorder and its watchdog, SLO accounting, the goodput
ledger, and the ``/metrics`` + ``/statusz`` exposition server."""

from . import exposition, flight_recorder, goodput  # noqa: F401
from . import metrics, slo, trace  # noqa: F401
from .exposition import ObservabilityServer
from .flight_recorder import FlightRecorder, Watchdog
from .goodput import GoodputLedger
from .metrics import (Counter, FederatedRegistry, Gauge, Histogram,
                      MetricsRegistry, get_registry)
from .slo import SLORule, SLOTracker
from .trace import (RequestTraceLog, Tracer, block_on, get_trace_log,
                    get_tracer, log_perf_event, trace_span)

__all__ = ["Counter", "FederatedRegistry", "FlightRecorder", "Gauge",
           "GoodputLedger", "Histogram", "MetricsRegistry",
           "ObservabilityServer", "RequestTraceLog", "SLORule",
           "SLOTracker", "Tracer", "Watchdog", "block_on",
           "get_registry", "get_trace_log", "get_tracer",
           "log_perf_event", "trace_span"]
