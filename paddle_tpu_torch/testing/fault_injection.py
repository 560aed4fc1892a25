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

Each plan patches methods of ``ContinuousBatchingEngine`` while the
injector is installed, fires at most ``times`` times, and only when the
chosen request or slot is involved. Use it as a context manager so the
engine class is always restored::

    with FaultInjector() as fi:
        fi.poison_request(rid, times=2)
        eng.run()
    assert fi.fires() == 2

Not ported: the filesystem, call-site, replica and process plans.
"""

from __future__ import annotations

import threading

from ..inference.serving import ContinuousBatchingEngine

__all__ = ["FaultInjector", "FaultPlan"]


class FaultPlan:
    """One armed serving fault, fired at most ``times`` times."""

    def __init__(self, match, times=1):
        self.match = match
        self.times = int(times)
        self.fired = 0

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
