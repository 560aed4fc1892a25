"""Deterministic fault injection into the port's serving engine: the
serving plans of ``paddle_tpu/testing/fault_injection.py``.

- :meth:`FaultInjector.poison_request`: harvesting a step (or a legacy
  decode chunk) raises ``FloatingPointError`` (the shape of a NaN
  sampler output reaching the packed fetch) whenever the chosen request
  rode it. The
  engine's containment must quarantine the poison and replay its
  co-scheduled innocents.
- :meth:`FaultInjector.wedge_slot`: the drain skips the chosen slot, so
  a finished stream sits undrained and holds its pages (the stuck-slot
  shape that the deadlock eviction and the ``EngineSupervisor`` answer).
- :meth:`FaultInjector.leak_pages`: the page release drops pages (the
  reclamation bug the page audit exists to catch).

The replica plans match the engine's ``_fleet_replica_id`` (a
``ServingFleet`` tags each replica's engine, and every supervised
rebuild), so one plan targets one replica of the shared engine class:

- :meth:`FaultInjector.kill_replica`: the replica's ``step()`` raises
  before any scheduler work (a crashed worker, seen from the fleet);
- :meth:`FaultInjector.wedge_replica`: ``step()`` returns having done
  nothing (heartbeats without progress: the fleet's no-progress check);
- :meth:`FaultInjector.slow_replica`: ``step()`` burns ``delay_s`` and
  only every ``stride``-th one advances (a straggler: hedging).

Each plan patches methods of ``ContinuousBatchingEngine`` while the
injector is installed, fires at most ``times`` times, and only when the
chosen request, slot or replica is involved. Use it as a context manager so the
engine class is always restored::

    with FaultInjector() as fi:
        fi.poison_request(rid, times=2)
        eng.run()
    assert fi.fires() == 2

Not ported: the filesystem, call-site and process plans.
"""

from __future__ import annotations

import threading
import time

from ..inference.serving import ContinuousBatchingEngine

__all__ = ["FaultInjector", "FaultPlan"]


class FaultPlan:
    """One armed serving fault, fired at most ``times`` times, and only
    after ``after_calls`` matching calls have gone by."""

    def __init__(self, match, times=1, after_calls=0):
        self.match = match
        self.times = int(times)
        self.after_calls = int(after_calls)
        self.fired = 0
        self.calls = 0

    def __repr__(self):
        return f"FaultPlan({self.match!r}, fired={self.fired}/{self.times})"


class FaultInjector:
    """Installable registry of serving fault plans."""

    def __init__(self):
        self.plans = []
        self._lock = threading.Lock()
        self._installed = False
        self._targets = []    # (method name, plan, make_patched)
        self._patched = []    # (method name, original)

    def fires(self):
        """Total number of times any plan fired."""
        return sum(p.fired for p in self.plans)

    def _claim(self, plan):
        """Claim one firing of ``plan`` if it is still live."""
        with self._lock:
            if plan.fired >= plan.times:
                return False
            plan.fired += 1
            return True

    def _take_call(self, plan):
        """Count one matching call and claim a firing once more than
        ``after_calls`` of them have gone by."""
        with self._lock:
            plan.calls += 1
            if plan.fired >= plan.times or plan.calls <= plan.after_calls:
                return False
            plan.fired += 1
            return True

    def _arm(self, methods, plan, make_patched):
        self.plans.append(plan)
        for method in methods:
            self._targets.append((method, plan, make_patched))
            if self._installed:
                self._patch(method, plan, make_patched)
        return plan

    def _patch(self, method, plan, make_patched):
        original = getattr(ContinuousBatchingEngine, method)
        patched = make_patched(original, plan)
        patched.__name__ = method
        setattr(ContinuousBatchingEngine, method, patched)
        self._patched.append((method, original))

    def poison_request(self, request_id, times=1):
        """Harvesting a step or a legacy chunk raises
        ``FloatingPointError`` whenever request ``request_id`` rides it
        (both harvest records' dispatch-time snapshot, index 1)."""
        rid = int(request_id)
        injector = self

        def make(original, plan):
            def patched(eng, rec, *a, **kw):
                if any(r is not None and r.request_id == rid
                       for r in rec[1]) and injector._claim(plan):
                    raise FloatingPointError(
                        f"fault injected: NaN sampler output "
                        f"(poison request {rid})")
                return original(eng, rec, *a, **kw)
            return patched

        return self._arm(("_harvest_step", "_harvest_chunk"),
                         FaultPlan(f"poison_request:{rid}", times), make)

    def wedge_slot(self, slot, times=1):
        """The drain skips slot ``slot`` for ``times`` passes while it is
        occupied: the stream sits finished but undrained, holding its
        pages."""
        slot_i = int(slot)
        injector = self

        def make(original, plan):
            def patched(eng, *a, **kw):
                if not (slot_i < eng.num_slots
                        and eng.slot_req[slot_i] is not None
                        and injector._claim(plan)):
                    return original(eng, *a, **kw)
                # a step in flight that may emit makes the drain defer
                # exactly this slot, touching no device state
                eng._emits_inflight[slot_i] += 1
                try:
                    return original(eng, *a, **kw)
                finally:
                    eng._emits_inflight[slot_i] -= 1
            return patched

        return self._arm(("_drain",),
                         FaultPlan(f"wedge_slot:{slot_i}", times), make)

    def leak_pages(self, n=1, times=1):
        """The page release silently drops the first ``n`` pages it
        would have returned to the pool."""
        n_drop = int(n)
        injector = self

        def make(original, plan):
            def patched(eng, pages, *a, **kw):
                if pages and injector._claim(plan):
                    pages = list(pages)[n_drop:]
                return original(eng, pages, *a, **kw)
            return patched

        return self._arm(("_release_pages",),
                         FaultPlan("leak_pages", times), make)

    # -- replica plans: match the engine's ``_fleet_replica_id`` ----------

    def kill_replica(self, replica_id, times=1, after_steps=0):
        """Replica death the supervisor sees: the replica's ``step()``
        raises ``RuntimeError`` before any scheduler work runs. Its
        ``EngineSupervisor`` salvages and restarts; past its budget the
        fleet opens the breaker and fails its requests over.
        ``after_steps`` counts only the chosen replica's steps."""
        rid = int(replica_id)
        injector = self

        def make(original, plan):
            def patched(eng, *a, **kw):
                if getattr(eng, "_fleet_replica_id", None) == rid \
                        and injector._take_call(plan):
                    raise RuntimeError(
                        f"fault injected: replica {rid} died mid-step")
                return original(eng, *a, **kw)
            return patched

        return self._arm(("step",), FaultPlan(f"kill_replica:{rid}", times,
                                              after_calls=after_steps),
                         make)

    def wedge_replica(self, replica_id, times=10_000):
        """A wedged replica: ``step()`` returns at once having done
        nothing, so the replica still heartbeats but never progresses.
        The fleet's no-progress check must catch it (``step()`` has no
        stall path; only ``run()`` does)."""
        rid = int(replica_id)
        injector = self

        def make(original, plan):
            def patched(eng, *a, **kw):
                if getattr(eng, "_fleet_replica_id", None) == rid \
                        and injector._claim(plan):
                    return []      # a turn that does nothing
                return original(eng, *a, **kw)
            return patched

        return self._arm(("step",), FaultPlan(f"wedge_replica:{rid}",
                                              times), make)

    def slow_replica(self, replica_id, delay_s=0.05, stride=4,
                     times=10_000):
        """A straggler: every matching ``step()`` burns ``delay_s`` of
        wall clock and only every ``stride``-th one runs the scheduler
        turn. It progresses, slowly, so the no-progress check must not
        fire; hedged dispatch is what it exercises."""
        rid = int(replica_id)
        delay = float(delay_s)
        stride_n = max(1, int(stride))
        injector = self

        def make(original, plan):
            def patched(eng, *a, **kw):
                if getattr(eng, "_fleet_replica_id", None) == rid \
                        and injector._claim(plan):
                    time.sleep(delay)
                    if plan.fired % stride_n:
                        return []  # the slice elapsed, no turn ran
                return original(eng, *a, **kw)
            return patched

        return self._arm(("step",), FaultPlan(f"slow_replica:{rid}",
                                              times), make)

    def install(self):
        if self._installed:
            return self
        self._installed = True
        for method, plan, make in self._targets:
            self._patch(method, plan, make)
        return self

    def uninstall(self):
        if not self._installed:
            return
        while self._patched:
            method, original = self._patched.pop()
            setattr(ContinuousBatchingEngine, method, original)
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
