"""Per-tenant SLO accounting with error-budget burn-rate alerts. The
port of ``paddle_tpu/profiler/slo.py``.

- :class:`SLORule`: one declarative objective: a request-level
  predicate (``kind``: first token within ``threshold_ms``, end-to-end
  latency within ``threshold_ms``, or completion without a typed
  error), an attainment ``target`` (0.99: 99% of requests good) and a
  partition (``by``: request attributes, default ``tenant``).
- :class:`SLOTracker`: rolling attainment windows. ``record(req)`` books
  one finished request into every rule, prunes events older than
  ``window_s`` and evaluates the burn rate ``miss_frac / (1 - target)``;
  ``burn_alert`` (default 2.0) times the sustainable rate fires an
  alert, which clears when the burn drops back. Alerts surface as
  ``alerts()``, ``alert_history`` and the ``slo/*`` metric family
  (attainment and burn gauges, event, miss and alert counters, labelled
  ``{rule=...,tenant=...}``); ``summary()`` is the ``/statusz`` view.

The clock is injectable (``now_fn``). The label space is bounded by
``max_labels`` (overflow folds into ``"_overflow"``). Standard library
only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from . import metrics as _metrics

__all__ = ["SLORule", "SLOTracker"]

_metrics.declare("slo/events", "counter",
                 "finished requests booked into an SLO rule's rolling "
                 "window (labeled rule/tenant)")
_metrics.declare("slo/misses", "counter",
                 "requests that violated their SLO rule's objective "
                 "(labeled rule/tenant)")
_metrics.declare("slo/attainment", "gauge",
                 "good-request fraction over the rule's rolling window "
                 "(labeled rule/tenant; 1.0 while empty)")
_metrics.declare("slo/burn_rate", "gauge",
                 "error-budget burn rate over the rolling window: "
                 "miss_frac / (1 - target); 1.0 = budget consumed "
                 "exactly at the sustainable rate (labeled "
                 "rule/tenant)")
_metrics.declare("slo/alerts_fired", "counter",
                 "burn-rate alert activations (burn crossed the "
                 "rule's alert threshold; labeled rule/tenant)")
_metrics.declare("slo/alerts_active", "gauge",
                 "burn-rate alerts currently firing across all rules "
                 "and labels")


@dataclass(frozen=True)
class SLORule:
    """One declarative objective (module docstring).

    ``kind``:

    - ``"ttft"`` — good iff a first token landed within
      ``threshold_ms`` of arrival (no first token at all = miss);
    - ``"e2e"`` — good iff the request finished within
      ``threshold_ms`` of arrival;
    - ``"success"`` — good iff it completed without a typed error
      (``threshold_ms`` unused).

    ``by`` names request attributes whose values partition the
    accounting (default per-tenant; ``("tenant", "priority")`` gives
    per-tenant-per-priority windows). ``min_events`` keeps a
    nearly-empty window from alerting off one unlucky request.
    """

    name: str
    kind: str = "ttft"
    threshold_ms: float | None = None
    target: float = 0.99
    by: tuple = ("tenant",)
    window_s: float = 300.0
    burn_alert: float = 2.0
    min_events: int = 10
    #: client-initiated cancellations are VOLUNTARY: by default they
    #: are excluded from the window entirely (neither good nor miss) —
    #: a tenant abandoning requests must not burn its own error budget
    #: into a false alert. Set True to count them as misses.
    count_cancelled: bool = False

    def __post_init__(self):
        if self.kind not in ("ttft", "e2e", "success"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind in ("ttft", "e2e") and self.threshold_ms is None:
            raise ValueError(
                f"SLO rule {self.name!r}: kind {self.kind!r} needs "
                "threshold_ms")
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1) — an SLO of "
                             "1.0 has no error budget to burn")

    def excludes(self, req) -> bool:
        """True when the request should not be booked at all (a
        voluntary client cancellation, unless ``count_cancelled``)."""
        return not self.count_cancelled and \
            getattr(req, "finish_reason", None) == "cancelled"

    def good(self, req) -> bool:
        """The request-level predicate (arrival-relative, the clock
        the engines already stamp)."""
        if self.kind == "success":
            return req.error is None
        if self.kind == "ttft":
            if not req.t_first:
                return False
            return (req.t_first - req.t_arrive) * 1e3 \
                <= self.threshold_ms
        end = req.t_done or req.t_first
        if not end:
            return False
        return (end - req.t_arrive) * 1e3 <= self.threshold_ms

    def labels_of(self, req) -> tuple:
        return tuple(str(getattr(req, f, None)) for f in self.by)


class _Window:
    """One (rule, label) rolling window: a deque of (t, good)."""

    __slots__ = ("events", "good")

    def __init__(self):
        self.events: deque = deque()
        self.good = 0

    def add(self, t, ok):
        self.events.append((t, ok))
        if ok:
            self.good += 1

    def prune(self, horizon):
        ev = self.events
        while ev and ev[0][0] < horizon:
            _, ok = ev.popleft()
            if ok:
                self.good -= 1


@dataclass
class _AlertState:
    active: bool = False
    fired: int = 0
    record: dict | None = None


class SLOTracker:
    """Rolling SLO accounting over a rule set (module docstring).
    ``registry`` receives the ``slo/*`` metric family (a fleet passes
    its federated registry so ``/metrics`` carries attainment);
    defaults to the process-wide registry."""

    def __init__(self, rules, registry=None, now_fn=None,
                 max_labels=256, alert_history=64):
        self.rules = list(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names: {names}")
        self.registry = registry if registry is not None \
            else _metrics.get_registry()
        self._now = now_fn if now_fn is not None else time.perf_counter
        self.max_labels = int(max_labels)
        self._lock = threading.Lock()
        #: (rule_name, labels) -> _Window
        self._windows: dict[tuple, _Window] = {}
        self._alerts: dict[tuple, _AlertState] = {}
        #: (metric name, rule name, labels) -> its labelled child, made
        #: on first use (a scrape shows a series once it has a value)
        self._series: dict[tuple, object] = {}
        self.alert_history: deque = deque(maxlen=int(alert_history))

    # -- label plumbing ----------------------------------------------------

    def _window(self, rule, labels):
        key = (rule.name, labels)
        w = self._windows.get(key)
        if w is None:
            if len(self._windows) >= self.max_labels \
                    and key not in self._windows:
                labels = ("_overflow",) * len(rule.by)
                key = (rule.name, labels)
                w = self._windows.get(key)
                if w is not None:
                    return key, w
            w = _Window()
            self._windows[key] = w
        return key, w

    def _label_kv(self, rule, labels):
        kv = {"rule": rule.name}
        kv.update(zip(rule.by, labels))
        return kv

    def _child(self, kind, name, key, kv):
        """The ``{rule=...,<by>=...}`` child of metric ``name`` for the
        window ``key``, looked up once (the delivery path books every
        request through it)."""
        child = self._series.get((name,) + key)
        if child is None:
            child = getattr(self.registry, kind)(name).labels(**kv)
            self._series[(name,) + key] = child
        return child

    # -- recording ---------------------------------------------------------

    def record(self, req):
        """Book one FINISHED request into every rule; returns the
        alert records newly fired by this event."""
        now = self._now()
        fired = []
        with self._lock:
            for rule in self.rules:
                if rule.excludes(req):
                    continue
                key, w = self._window(rule, rule.labels_of(req))
                ok = rule.good(req)
                w.add(now, ok)
                w.prune(now - rule.window_s)
                kv = self._label_kv(rule, key[1])
                self._child("counter", "slo/events", key, kv).inc()
                if not ok:
                    self._child("counter", "slo/misses", key, kv).inc()
                a = self._evaluate(rule, key, w, now, kv)
                if a is not None:
                    fired.append(a)
            self.registry.gauge("slo/alerts_active").set(
                sum(1 for st in self._alerts.values() if st.active))
        return fired

    def _evaluate(self, rule, key, w, now, kv):
        """Attainment + burn under the lock; returns a NEWLY-fired
        alert record or None. Gauges are updated on every event, so a
        scrape between requests reads current state."""
        n = len(w.events)
        attain = (w.good / n) if n else 1.0
        budget = 1.0 - rule.target
        burn = ((1.0 - attain) / budget) if n else 0.0
        self._child("gauge", "slo/attainment", key, kv).set(
            round(attain, 6))
        self._child("gauge", "slo/burn_rate", key, kv).set(
            round(burn, 6))
        st = self._alerts.setdefault(key, _AlertState())
        alerting = n >= rule.min_events and burn >= rule.burn_alert
        if alerting and not st.active:
            st.active = True
            st.fired += 1
            st.record = {
                "rule": rule.name, "kind": rule.kind,
                "labels": dict(zip(rule.by, key[1])),
                "burn_rate": round(burn, 4),
                "attainment": round(attain, 6),
                "target": rule.target, "events": n,
                "window_s": rule.window_s, "t": now,
            }
            self.alert_history.append(dict(st.record))
            self._child("counter", "slo/alerts_fired", key, kv).inc()
            return dict(st.record)
        if not alerting and st.active:
            st.active = False
            st.record = None
        elif alerting:
            # refresh the live record so /statusz shows current burn
            st.record.update(burn_rate=round(burn, 4),
                             attainment=round(attain, 6),
                             events=n, t=now)
        return None

    # -- read side ---------------------------------------------------------

    def _refresh_locked(self, now):
        """Prune every window to its rule's horizon and CLEAR alerts
        whose burn has aged out (caller holds the lock). Without this
        a tenant that stopped sending traffic after a bad minute
        would page forever: record() never runs again for its label,
        so only the read side can observe the window emptying."""
        rules = {r.name: r for r in self.rules}
        for (rn, lv), w in self._windows.items():
            rule = rules[rn]
            before = len(w.events)
            w.prune(now - rule.window_s)
            n = len(w.events)
            attain = (w.good / n) if n else 1.0
            burn = ((1.0 - attain) / (1.0 - rule.target)) if n else 0.0
            if n != before:
                # the window changed shape with no record() to rewrite
                # the gauges: a scrape must read the SAME attainment
                # /statusz reports ("1.0 while empty"), not the last
                # pre-silence value frozen forever
                kv = self._label_kv(rule, lv)
                key = (rn, lv)
                self._child("gauge", "slo/attainment", key, kv) \
                    .set(round(attain, 6))
                self._child("gauge", "slo/burn_rate", key, kv) \
                    .set(round(burn, 6))
            st = self._alerts.get((rn, lv))
            if st is not None and st.active and (
                    n < rule.min_events or burn < rule.burn_alert):
                st.active = False
                st.record = None
        self.registry.gauge("slo/alerts_active").set(
            sum(1 for st in self._alerts.values() if st.active))

    def refresh(self):
        """Re-evaluate every window against the clock NOW: prune aged
        events, rewrite the attainment/burn gauges, clear expired
        alerts. ``summary()``/``alerts()`` do this implicitly; the
        exposition layer calls it before rendering ``/metrics`` so a
        Prometheus-only scraper (no /statusz) never reads a burn rate
        frozen from before a tenant went silent."""
        with self._lock:
            self._refresh_locked(self._now())

    def alerts(self):
        """Currently-ACTIVE alert records — re-evaluated against the
        rolling window at read time, so an alert self-resolves once
        its misses age out even if that (rule, tenant) never records
        another event."""
        with self._lock:
            self._refresh_locked(self._now())
            return [dict(st.record) for st in self._alerts.values()
                    if st.active and st.record is not None]

    def attainment(self, rule_name, **labels):
        """Current attainment for one (rule, label) window; 1.0 while
        empty/unknown (no traffic = no misses)."""
        with self._lock:
            for (rn, lv), w in self._windows.items():
                rule = next(r for r in self.rules if r.name == rn)
                if rn == rule_name and \
                        dict(zip(rule.by, lv)) == {
                            k: str(v) for k, v in labels.items()}:
                    n = len(w.events)
                    return (w.good / n) if n else 1.0
        return 1.0

    def summary(self) -> dict:
        """The /statusz + bench projection: per rule, per label —
        events/attainment/burn/alerting — plus the overall worst
        attainment and total alerts fired (the BENCH
        ``obs_slo_attainment`` / ``slo_alerts`` keys)."""
        with self._lock:
            self._refresh_locked(self._now())
            rules_by_name = {r.name: r for r in self.rules}
            out_rules = {}
            worst = 1.0
            total_fired = 0
            for (rn, lv), w in sorted(self._windows.items()):
                rule = rules_by_name[rn]
                n = len(w.events)
                attain = (w.good / n) if n else 1.0
                budget = 1.0 - rule.target
                burn = ((1.0 - attain) / budget) if n else 0.0
                st = self._alerts.get((rn, lv))
                slot = out_rules.setdefault(rn, {
                    "kind": rule.kind, "target": rule.target,
                    "threshold_ms": rule.threshold_ms,
                    "window_s": rule.window_s, "labels": {}})
                slot["labels"][",".join(lv)] = {
                    "events": n, "attainment": round(attain, 6),
                    "burn_rate": round(burn, 4),
                    "alerting": bool(st and st.active),
                    "alerts_fired": st.fired if st else 0,
                }
                if n:
                    worst = min(worst, attain)
                total_fired += st.fired if st else 0
            return {
                "rules": out_rules,
                "worst_attainment": round(worst, 6),
                "alerts_fired": total_fired,
                "alerts_active": [dict(st.record)
                                  for st in self._alerts.values()
                                  if st.active
                                  and st.record is not None],
            }
