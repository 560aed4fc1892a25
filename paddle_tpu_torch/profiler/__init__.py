"""Observability of the port: the typed metrics registry."""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry"]
