"""Typed metrics: the port of ``paddle_tpu/profiler/metrics.py``'s
``Counter``, ``Gauge``, ``Histogram`` and ``MetricsRegistry``.

- :class:`Counter`: a monotonic total (``inc``).
- :class:`Gauge`: the last written value (``set``).
- :class:`Histogram`: a streaming distribution over a BOUNDED reservoir
  (Vitter's algorithm R): ``observe`` is O(1), memory stays at
  ``capacity`` samples, ``percentile(q)`` interpolates linearly over the
  resident samples; count, sum, min and max are exact.

Every name is ``subsystem/name``. Each serving engine owns a private
:class:`MetricsRegistry`, so two engines in one process never mix their
counts; :func:`get_registry` is the process-wide one (the ``quant/*``
gauges of ``nn.quant.quantize_for_serving``). Not ported: labels, the
trace mirror, the metric catalog, the Prometheus and JSON exports and the
federated registry. Standard library only.
"""

from __future__ import annotations

import random
import re
import threading
import zlib

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "METRIC_NAME_RE", "get_registry"]

#: the ``subsystem/name`` convention
METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*/[a-z][a-z0-9_]*$")


class _Metric:
    """Shared base: the checked name, help text and a per-metric lock
    (scheduler and caller threads may update one metric together)."""

    kind = "?"

    def __init__(self, name, help=""):  # noqa: A002
        if not METRIC_NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the subsystem/name "
                "convention (lowercase [a-z0-9_], exactly one '/')")
        self.name = name
        self.help = help
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic total. ``inc`` is exact under concurrent callers."""

    kind = "counter"

    def __init__(self, name, help=""):  # noqa: A002
        super().__init__(name, help)
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n
            return self._value

    def set(self, v):
        """Direct assignment: resets (``reset_gauges``) only; normal
        accounting uses ``inc``."""
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Point-in-time value; the last write wins."""

    kind = "gauge"

    def __init__(self, name, help=""):  # noqa: A002
        super().__init__(name, help)
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Streaming distribution over a bounded reservoir: after
    ``capacity`` samples each new observation replaces a uniformly drawn
    slot with probability capacity/count, so the reservoir stays a
    uniform sample of the whole stream. The draw is seeded from the
    name (crc32, not ``hash``), so a replayed stream keeps the same
    samples."""

    kind = "histogram"

    def __init__(self, name, help="", capacity=1024):  # noqa: A002
        super().__init__(name, help)
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("histogram capacity must be >= 1")
        self._rng = random.Random(0xA5F00D ^ zlib.crc32(name.encode()))
        self._samples: list[float] = []
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if len(self._samples) < self.capacity:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.capacity:
                    self._samples[j] = v

    def percentile(self, q):
        """q in [0, 100]; 0.0 when empty. Linear interpolation between
        the sorted resident samples (numpy's default)."""
        with self._lock:
            if not self._samples:
                return 0.0
            xs = sorted(self._samples)
        if len(xs) == 1:
            return xs[0]
        pos = (len(xs) - 1) * (q / 100.0)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def reset(self):
        with self._lock:
            self._samples = []
            self.count = 0
            self.sum = 0.0
            self.min = None
            self.max = None

    def to_dict(self):
        with self._lock:
            n, s, mn, mx = self.count, self.sum, self.min, self.max
        return {"count": n, "sum": round(s, 6), "min": mn, "max": mx,
                "p50": round(self.percentile(50), 6),
                "p90": round(self.percentile(90), 6),
                "p99": round(self.percentile(99), 6)}


class MetricsRegistry:
    """Get-or-create home for typed metrics: asking again for a name
    returns the same metric; asking for it as another kind raises."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, **kw):  # noqa: A002
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, not {cls.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="") -> Counter:  # noqa: A002
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help="") -> Gauge:  # noqa: A002
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="",  # noqa: A002
                  capacity=1024) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   capacity=capacity)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """{name: value, or a histogram's dict}, JSON-ready."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.to_dict() if isinstance(m, Histogram)
                else m.value for m in metrics}


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry. A serving engine keeps its own private
    one instead, so its gauges stay scoped to it."""
    return _registry
