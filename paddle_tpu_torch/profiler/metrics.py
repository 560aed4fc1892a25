"""Typed metrics: the port of ``paddle_tpu/profiler/metrics.py``.

- :class:`Counter`: a monotonic total (``inc``), exact under concurrent
  increments (a lock per metric).
- :class:`Gauge`: the last written value (``set``).
- :class:`Histogram`: a streaming distribution over a BOUNDED reservoir
  (Vitter's algorithm R): ``observe`` is O(1), memory stays at
  ``capacity`` samples, ``percentile(q)`` interpolates linearly over the
  resident samples; count, sum, min and max are exact.

Every name is ``subsystem/name``. :func:`declare` puts a name, its kind
and its help text into the process-wide catalog (names are one
vocabulary even where values are per component); :func:`catalog_markdown`
renders it as a table. ``metric.labels(k=v)`` gives a labelled child
(``name{k="v"}`` in snapshots and in the Prometheus text).

Exports: ``registry.snapshot()`` (a JSON-ready dict),
``export_prometheus()`` (text exposition v0.0.4: counters and gauges as
they are, histograms as summaries with quantile labels), and
``export(path)`` / ``export_json(path)``, both written atomically
(tmp + fsync + rename).

:func:`get_registry` is the process-wide registry; its counter and gauge
updates mirror into the tracer (``profiler.trace``) while tracing is on.
Each serving engine owns a private :class:`MetricsRegistry`, so two
engines never mix their counts. :class:`FederatedRegistry` is a fleet's
federation point: its own metrics plus any number of source registries
(the replicas' engines), read into one labelled view with monotonic
totals across engine rebuilds. Standard library only.
"""

from __future__ import annotations

import random
import re
import threading
import zlib

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "FederatedRegistry", "get_registry", "declare", "catalog",
           "catalog_markdown", "METRIC_NAME_RE"]

#: the ``subsystem/name`` convention
METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*/[a-z][a-z0-9_]*$")

#: process-wide name -> (kind, help) vocabulary. Every registration in
#: ANY registry lands here (metric NAMES are a global vocabulary even
#: when their values are per-component); :func:`declare` populates it
#: at import time so the docs table and the lint gate can see names
#: before any component is constructed.
_CATALOG: dict[str, tuple[str, str]] = {}
_CATALOG_LOCK = threading.Lock()


def _check_name(name: str) -> str:
    if not METRIC_NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} violates the subsystem/name "
            "convention (lowercase [a-z0-9_], exactly one '/')")
    return name


def declare(name: str, kind: str, help: str) -> str:  # noqa: A002
    """Register ``name`` in the process-wide metric catalog without
    creating a metric. Modules declare their vocabulary at import time;
    the registry pulls help text from here when a metric is later
    instantiated."""
    _check_name(name)
    if kind not in ("counter", "gauge", "histogram"):
        raise ValueError(f"unknown metric kind {kind!r}")
    with _CATALOG_LOCK:
        prev = _CATALOG.get(name)
        if prev is not None and prev[0] != kind:
            raise ValueError(
                f"metric {name!r} re-declared as {kind} (was {prev[0]})")
        _CATALOG[name] = (kind, help)
    return name


def catalog() -> dict[str, tuple[str, str]]:
    """A copy of the process-wide name -> (kind, help) catalog."""
    with _CATALOG_LOCK:
        return dict(_CATALOG)


def catalog_markdown() -> str:
    """The metric table, generated from the
    catalog (one row per declared metric, sorted)."""
    lines = ["| metric | kind | meaning |", "|---|---|---|"]
    for name in sorted(catalog()):
        kind, help_ = _CATALOG[name]
        lines.append(f"| `{name}` | {kind} | {help_} |")
    return "\n".join(lines)


def _mirror_to_trace(name, value, **args):
    """Mirror a counter/gauge update into the structured tracer (one
    enabled-check; zero cost while tracing is off). Keeps chrome-trace
    exports carrying the same gauge streams they did before the
    registry existed."""
    from .trace import get_tracer
    tr = get_tracer()
    if tr.enabled:
        tr.counter(name, value, **args)


class _Metric:
    """Shared base: name, help, per-metric lock, label children."""

    kind = "?"

    def __init__(self, name, help="", mirror=False):  # noqa: A002
        self.name = _check_name(name)
        self.help = help
        self._mirror = bool(mirror)
        self._lock = threading.Lock()
        self._children: dict[tuple, _Metric] = {}
        with _CATALOG_LOCK:
            prev = _CATALOG.get(name)
            if prev is not None and prev[0] != self.kind:
                raise ValueError(
                    f"metric {name!r} registered as {self.kind} but "
                    f"declared as {prev[0]}")
            if prev is None or (help and not prev[1]):
                _CATALOG[name] = (self.kind, help or
                                  (prev[1] if prev else ""))
            elif not help:
                self.help = prev[1]

    def labels(self, **kv):
        """The child metric for a label set (Prometheus idiom):
        ``reg.counter("serving/requests").labels(outcome="eos").inc()``.
        Children share the parent's config and appear in snapshots as
        ``name{k="v"}``."""
        key = tuple(sorted(kv.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.help,
                                   mirror=self._mirror,
                                   **self._child_kwargs())
                child._label_kv = key
                self._children[key] = child
            return child

    def _child_kwargs(self):
        return {}

    def _label_suffix(self):
        kv = getattr(self, "_label_kv", ())
        if not kv:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in kv)
        return "{" + inner + "}"

    def _iter_series(self):
        """(label_suffix, metric) for self + every labeled child."""
        yield self._label_suffix(), self
        with self._lock:
            children = list(self._children.values())
        for c in children:
            yield c._label_suffix(), c


class Counter(_Metric):
    """Monotonic total. ``inc`` is exact under concurrent callers."""

    kind = "counter"

    def __init__(self, name, help="", mirror=False):  # noqa: A002
        super().__init__(name, help, mirror=mirror)
        self._value = 0

    def inc(self, n=1, **args):
        with self._lock:
            self._value += n
            v = self._value
        if self._mirror:
            _mirror_to_trace(self.name, v, **args)
        return v

    def set(self, v, **args):
        """Direct assignment — reset (``reset_gauges``) and restored
        state (ledger reload) only; normal accounting uses ``inc``."""
        with self._lock:
            self._value = v
        if self._mirror:
            _mirror_to_trace(self.name, v, **args)

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Point-in-time value; last write wins."""

    kind = "gauge"

    def __init__(self, name, help="", mirror=False):  # noqa: A002
        super().__init__(name, help, mirror=mirror)
        self._value = 0.0

    def set(self, v, **args):
        with self._lock:
            self._value = v
        if self._mirror:
            _mirror_to_trace(self.name, v, **args)

    def inc(self, n=1, **args):
        with self._lock:
            self._value += n
            v = self._value
        if self._mirror:
            _mirror_to_trace(self.name, v, **args)
        return v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Streaming distribution over a BOUNDED reservoir (Vitter's
    algorithm R): after ``capacity`` samples, each new observation
    replaces a uniformly-random slot with probability capacity/count —
    the reservoir stays a uniform sample of the whole stream, memory
    stays fixed, and percentiles stay faithful. count/sum/min/max are
    exact (not sampled). Deterministically seeded per instance so
    tests are reproducible."""

    kind = "histogram"

    def __init__(self, name, help="", mirror=False,  # noqa: A002
                 capacity=1024):
        super().__init__(name, help, mirror=mirror)
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("histogram capacity must be >= 1")
        # crc32, not hash(): PYTHONHASHSEED must not change which
        # reservoir slots a replayed stream evicts
        self._rng = random.Random(0xA5F00D ^ zlib.crc32(name.encode()))
        self._samples: list[float] = []
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def _child_kwargs(self):
        return {"capacity": self.capacity}

    def observe(self, v, **_args):
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
        """q in [0, 100]; 0.0 when empty (the legacy gauge contract)."""
        with self._lock:
            if not self._samples:
                return 0.0
            xs = sorted(self._samples)
        if len(xs) == 1:
            return xs[0]
        # linear interpolation (numpy default) without importing numpy
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

    @property
    def sample_count(self):
        """Resident reservoir size — bounded by ``capacity`` forever
        (the memory-flat regression tests pin this)."""
        with self._lock:
            return len(self._samples)

    def samples(self):
        """A copy of the resident reservoir (federation merges the
        fleet's per-replica reservoirs from these)."""
        with self._lock:
            return list(self._samples)

    def to_dict(self):
        with self._lock:
            n = self.count
            s = self.sum
            mn, mx = self.min, self.max
        return {"count": n, "sum": round(s, 6),
                "min": mn, "max": mx,
                "p50": round(self.percentile(50), 6),
                "p90": round(self.percentile(90), 6),
                "p99": round(self.percentile(99), 6)}


class MetricsRegistry:
    """Get-or-create home for typed metrics (see module docstring).
    ``mirror=True`` (the process-wide default registry) echoes every
    counter/gauge update into the structured tracer while tracing is
    enabled."""

    def __init__(self, mirror=False):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._mirror = bool(mirror)

    def _get_or_create(self, cls, name, help, **kw):  # noqa: A002
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, not {cls.kind}")
                return m
            m = cls(name, help, mirror=self._mirror, **kw)
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

    def __contains__(self, name):
        with self._lock:
            return name in self._metrics

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready {name: value | histogram-dict}; labeled children
        appear as ``name{k="v"}`` keys."""
        out = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for suffix, series in m._iter_series():
                key = m.name + suffix
                if isinstance(series, Histogram):
                    out[key] = series.to_dict()
                else:
                    out[key] = series.value
        return out

    def export_prometheus(self) -> str:
        """Prometheus text exposition v0.0.4. ``subsystem/name`` maps
        to ``paddle_subsystem_name``; histograms export as summaries
        (quantile labels + _sum/_count)."""
        lines = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda x: x.name):
            prom = "paddle_" + m.name.replace("/", "_")
            if m.help:
                lines.append(f"# HELP {prom} {m.help}")
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "summary"}[m.kind]
            lines.append(f"# TYPE {prom} {ptype}")
            for suffix, series in m._iter_series():
                if isinstance(series, Histogram):
                    if series.count == 0 and suffix == "" \
                            and m._children:
                        continue   # parent unused, only children carry data
                    for q in (0.5, 0.9, 0.99):
                        lbl = suffix[1:-1] + "," if suffix else ""
                        lines.append(
                            f'{prom}{{{lbl}quantile="{q}"}} '
                            f"{series.percentile(q * 100)}")
                    lines.append(f"{prom}_sum{suffix} {series.sum}")
                    lines.append(f"{prom}_count{suffix} {series.count}")
                else:
                    lines.append(f"{prom}{suffix} {series.value}")
        return "\n".join(lines) + "\n"

    def export(self, path=None) -> str:
        """Prometheus text; written ATOMICALLY when ``path`` given
        (a scrape mid-crash reads the previous complete exposition,
        never a torn one). Returns the text."""
        text = self.export_prometheus()
        if path is not None:
            from .trace import _atomic_write
            _atomic_write(path, lambda f: f.write(text))
        return text

    def export_json(self, path) -> str:
        """Atomic JSON snapshot; returns the path."""
        from .trace import _atomic_json_dump
        return _atomic_json_dump(self.snapshot(), path)


def _merge_suffix(suffix, label_key, label):
    """Fold a federation label into an existing Prometheus label
    suffix: ``"" -> {replica="0"}``, ``{k="v"} -> {replica="0",k="v"}``
    (the replica label leads, so federated series group by replica)."""
    mine = f'{label_key}="{label}"'
    if not suffix:
        return "{" + mine + "}"
    return "{" + mine + "," + suffix[1:-1] + "}"


def _percentiles(xs):
    """(p50, p90, p99) of a sample list with the registry's linear
    interpolation — shared by the merged-histogram render."""
    if not xs:
        return 0.0, 0.0, 0.0
    xs = sorted(xs)
    if len(xs) == 1:
        return xs[0], xs[0], xs[0]

    def pct(q):
        pos = (len(xs) - 1) * (q / 100.0)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    return pct(50), pct(90), pct(99)


class FederatedRegistry(MetricsRegistry):
    """A registry that is also a FEDERATION POINT: it holds
    its own local metrics (``counter``/``gauge``/``histogram`` work
    exactly as on :class:`MetricsRegistry` — the fleet's ``fleet/*``
    vocabulary lives here) and aggregates any number of SOURCE
    registries — the fleet's per-replica private engine registries plus
    the process-wide default registry — into one labeled snapshot:

    - **counters** appear twice: per-replica as
      ``name{replica="3"}`` children AND summed into the unlabeled
      fleet total. Totals are MONOTONIC across supervised engine
      rebuilds and scale_down/eject: each source is read through a
      watermark (``base + raw``) that detects a replaced registry
      instance (a rebuilt engine starts a fresh registry at zero) and
      folds the old instance's last-seen value into the base — a
      restart can never make a fleet total go backwards.
    - **gauges** are inherently per-replica (summing two occupancy
      gauges means nothing): only the labeled children appear.
    - **histograms** appear per-replica AND as a deterministic MERGE:
      count/sum/min/max are summed exactly; the merged percentiles are
      computed over the concatenation of the sources' bounded
      reservoirs (sources visited in sorted label order — same fleet
      state, same answer).

    ``add_source(label, provider)`` takes a zero-arg callable returning
    the source registry, read live at every snapshot — so a supervised
    rebuild that swaps ``engine.metrics`` is picked up automatically.
    ``remove_source`` folds the source's final counter contributions
    into retained totals (scale_down must not erase history).

    Snapshots are atomic in the scrape sense: one ``snapshot()`` /
    ``export_prometheus()`` call serializes against concurrent
    snapshots (watermark state is shared) and reads each source metric
    under its own per-metric lock — the serving hot loop is never
    blocked by a scrape, and a scrape never reads a torn multi-field
    histogram.
    """

    def __init__(self, mirror=False, label_key="replica",
                 include_default=True):
        super().__init__(mirror=mirror)
        self._label_key = str(label_key)
        self._include_default = bool(include_default)
        self._fed_lock = threading.Lock()
        self._sources: dict[str, object] = {}       # label -> provider
        self._seen_reg: dict[str, int] = {}         # label -> id(reg)
        #: (label, series_key) -> [base, last_raw] counter watermarks
        self._marks: dict[tuple, list] = {}
        #: unlabeled total key -> counter mass of removed sources
        self._retired: dict[str, float] = {}

    # -- source registry ---------------------------------------------------

    def add_source(self, label, provider):
        """Register a source. ``provider`` is a zero-arg callable
        returning the source :class:`MetricsRegistry`, resolved at
        every snapshot (live — engine rebuilds swap the instance)."""
        label = str(label)
        with self._fed_lock:
            self._sources[label] = provider
        return label

    def remove_source(self, label):
        """Drop a source, folding its final counter contributions into
        the retained (unlabeled) totals so fleet counters stay
        monotonic across scale_down."""
        label = str(label)
        with self._fed_lock:
            self._sources.pop(label, None)
            self._seen_reg.pop(label, None)
            for (lbl, key), (base, last) in list(self._marks.items()):
                if lbl == label:
                    self._retired[key] = self._retired.get(key, 0) \
                        + base + last
                    del self._marks[(lbl, key)]

    def source_labels(self):
        with self._fed_lock:
            return sorted(self._sources)

    # -- the federated read ------------------------------------------------

    def _counter_contribution(self, label, key, raw):
        """Watermarked counter read (caller holds ``_fed_lock``)."""
        mark = self._marks.setdefault((label, key), [0, 0])
        if raw < mark[1]:
            # registry survived but the counter went backwards (an
            # explicit reset): fold what we saw into the base
            mark[0] += mark[1]
        mark[1] = raw
        return mark[0] + raw

    def _iter_source(self, label, provider, out_c, out_g, out_h):
        try:
            reg = provider()
        except Exception:  # noqa: BLE001 — a dead replica's provider
            reg = None     # must not fail the whole scrape
        if reg is None:
            # keep the retired-style contribution of whatever we last
            # saw, so totals never dip while a replica is mid-rebuild
            for (lbl, key), (base, last) in self._marks.items():
                if lbl == label:
                    out_c.setdefault(key, {"total": 0.0, "series": []})
                    out_c[key]["total"] += base + last
            return
        if id(reg) != self._seen_reg.get(label):
            # a REPLACED registry instance (engine rebuild): every
            # counter restarts from zero — bank the old values
            for (lbl, key), mark in self._marks.items():
                if lbl == label:
                    mark[0] += mark[1]
                    mark[1] = 0
            self._seen_reg[label] = id(reg)
        with reg._lock:
            metrics = list(reg._metrics.values())
        visited = set()
        for m in metrics:
            for suffix, series in m._iter_series():
                key = m.name + suffix
                visited.add(key)
                lsuffix = _merge_suffix(suffix, self._label_key, label)
                if isinstance(series, Histogram):
                    slot = out_h.setdefault(key, {
                        "count": 0, "sum": 0.0, "min": None,
                        "max": None, "samples": [], "series": []})
                    d = series.to_dict()
                    slot["count"] += d["count"]
                    slot["sum"] += d["sum"]
                    for agg, fn in (("min", min), ("max", max)):
                        if d[agg] is not None:
                            slot[agg] = d[agg] if slot[agg] is None \
                                else fn(slot[agg], d[agg])
                    slot["samples"].extend(series.samples())
                    slot["series"].append((lsuffix, d))
                elif isinstance(series, Counter):
                    v = self._counter_contribution(label, key,
                                                   series.value)
                    slot = out_c.setdefault(key, {"total": 0.0,
                                                  "series": []})
                    slot["total"] += v
                    slot["series"].append((lsuffix, v))
                else:
                    out_g.setdefault(key, []).append(
                        (lsuffix, series.value))
        # counter families the CURRENT registry has not (re-)minted —
        # a rebuilt engine that cancelled requests in a past life but
        # not this one — still carry banked watermark mass; emitting
        # only present families would make the fleet total DIP, the
        # exact violation the watermark exists to prevent
        for (lbl, key), (base, last) in self._marks.items():
            if lbl != label or key in visited:
                continue
            mass = base + last
            if not mass:
                continue
            slot = out_c.setdefault(key, {"total": 0.0, "series": []})
            slot["total"] += mass
            name = key.split("{")[0]
            suffix = key[len(name):]
            slot["series"].append(
                (_merge_suffix(suffix, self._label_key, label), mass))

    def _collect(self):
        """One atomic federated read: (counters, gauges, histograms)
        keyed by the UNLABELED series key. Sources are visited in
        sorted label order — the deterministic-merge contract."""
        out_c: dict[str, dict] = {}
        out_g: dict[str, list] = {}
        out_h: dict[str, dict] = {}
        with self._fed_lock:
            for key, mass in self._retired.items():
                out_c.setdefault(key, {"total": 0.0, "series": []})
                out_c[key]["total"] += mass
            for label in sorted(self._sources):
                self._iter_source(label, self._sources[label],
                                  out_c, out_g, out_h)
        return out_c, out_g, out_h

    def snapshot(self) -> dict:
        """The federated JSON-ready view: local + default-registry
        series unlabeled, per-source series as ``{replica="N"}``
        children, counter totals summed, histograms merged (module
        docstring). The flight recorder embeds THIS in bundles when a
        fleet is live, so a replica-death post-mortem shows sibling
        state."""
        out = {}
        if self._include_default and get_registry() is not self:
            out.update(get_registry().snapshot())
        out.update(super().snapshot())     # local (fleet/*) metrics
        out_c, out_g, out_h = self._collect()
        for key, slot in sorted(out_c.items()):
            out[key] = out.get(key, 0) + slot["total"]
            for lsuffix, v in slot["series"]:
                out[key.split("{")[0] + lsuffix] = v
        for key, series in sorted(out_g.items()):
            for lsuffix, v in series:
                out[key.split("{")[0] + lsuffix] = v
        for key, slot in sorted(out_h.items()):
            p50, p90, p99 = _percentiles(slot["samples"])
            out[key] = {"count": slot["count"],
                        "sum": round(slot["sum"], 6),
                        "min": slot["min"], "max": slot["max"],
                        "p50": round(p50, 6), "p90": round(p90, 6),
                        "p99": round(p99, 6)}
            for lsuffix, d in slot["series"]:
                out[key.split("{")[0] + lsuffix] = d
        return out

    def export_prometheus(self) -> str:
        """Prometheus text over the federated view: local + default
        series as-is, then each federated family with its summed total
        and ``replica``-labeled children."""
        parts = []
        if self._include_default and get_registry() is not self:
            parts.append(get_registry().export_prometheus())
        parts.append(super().export_prometheus())
        # a family already rendered by the local/default blocks must
        # not get a SECOND # TYPE header from the federated block —
        # Prometheus parsers reject duplicate family headers
        seen = set()
        for p in parts:
            for line in p.splitlines():
                if line.startswith("# TYPE "):
                    seen.add(line.split()[2])
        lines = []
        out_c, out_g, out_h = self._collect()
        kinds = catalog()

        def header(key, ptype):
            name = key.split("{")[0]
            prom = "paddle_" + name.replace("/", "_")
            if prom not in seen:
                seen.add(prom)
                help_ = kinds.get(name, ("", ""))[1]
                if help_:
                    lines.append(f"# HELP {prom} {help_}")
                lines.append(f"# TYPE {prom} {ptype}")
            return prom, key[len(name):]

        for key, slot in sorted(out_c.items()):
            prom, suffix = header(key, "counter")
            lines.append(f"{prom}{suffix} {slot['total']}")
            for lsuffix, v in slot["series"]:
                lines.append(f"{prom}{lsuffix} {v}")
        for key, series in sorted(out_g.items()):
            prom, _ = header(key, "gauge")
            for lsuffix, v in series:
                lines.append(f"{prom}{lsuffix} {v}")
        for key, slot in sorted(out_h.items()):
            prom, suffix = header(key, "summary")
            p50, p90, p99 = _percentiles(slot["samples"])
            for q, v in ((0.5, p50), (0.9, p90), (0.99, p99)):
                lbl = suffix[1:-1] + "," if suffix else ""
                lines.append(f'{prom}{{{lbl}quantile="{q}"}} {v}')
            lines.append(f"{prom}_sum{suffix} {slot['sum']}")
            lines.append(f"{prom}_count{suffix} {slot['count']}")
        parts.append("\n".join(lines) + ("\n" if lines else ""))
        return "".join(parts)


_registry = MetricsRegistry(mirror=True)


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (tracer-mirroring). Component
    instances (e.g. a serving engine) own private
    ``MetricsRegistry()``\\ s instead so their gauges stay scoped."""
    return _registry
