"""Stall flight recorder: a diagnosable artifact instead of a timeout.
The port of ``paddle_tpu/profiler/flight_recorder.py``.

A wait-free ring of the last N runtime events (scheduler turns,
admissions, completions, preemptions, fleet ejections and hedges) and,
when something goes wrong, an atomically written debug bundle: the ring,
every live thread's stack, a metrics snapshot (the fleet's federated one
while a fleet runs), the reason, the time and the pid.

Dumps come from the :class:`Watchdog` (a daemon thread armed around a
region that must progress, such as the engine's and the fleet's run
loops: a gap between beats past ``timeout_s`` dumps once per stall),
from the crash hook (:func:`install_crash_hook`: any uncaught exception)
and from periodic persistence (``persist_every``). Incident dumps (any
reason but ``"periodic"``) are kept as ``flight_incident_<n>.json``.

Recording hands out slots from an ``itertools.count`` (atomic under the
GIL) and takes no lock; with no recorder installed, :func:`record_event`
is a None check. Standard library only.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
import traceback

from . import metrics as _metrics
from .trace import _atomic_json_dump

__all__ = ["FlightRecorder", "Watchdog", "install", "uninstall",
           "get_recorder", "record_event", "beat", "install_crash_hook",
           "BUNDLE_SCHEMA"]

# the JAX package's bundle format: either package's tools read the other's
BUNDLE_SCHEMA = "paddle_tpu.flight_recorder/1"
BUNDLE_NAME = "flight_bundle.json"

_metrics.declare("obs/ring_events", "counter",
                 "events recorded into the flight-recorder ring "
                 "(scheduler turns, collective entries, checkpoint "
                 "phases)")
_metrics.declare("obs/bundle_dumps", "counter",
                 "flight-recorder debug bundles written (stall, crash, "
                 "periodic persistence)")
_metrics.declare("obs/stalls_detected", "counter",
                 "watchdog no-progress detections that produced a "
                 "bundle")


class FlightRecorder:
    """Fixed-capacity ring of recent runtime events + atomic bundle
    dumps (module docstring). ``registry`` defaults to the process-wide
    metrics registry so bundles carry the full gauge state."""

    def __init__(self, capacity=512, bundle_dir=None, registry=None,
                 persist_every=0, persist_min_interval_s=0.0,
                 keep_incidents=8):
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.bundle_dir = bundle_dir
        self.registry = registry
        self.persist_every = int(persist_every)
        self.persist_min_interval_s = float(persist_min_interval_s)
        self.keep_incidents = int(keep_incidents)
        self._slots: list = [None] * self.capacity
        self._seq = itertools.count()       # atomic under the GIL
        #: a live ServingFleet registers its FederatedRegistry here
        #: for the duration of run(): bundles dumped while
        #: a fleet is live — a replica-death post-mortem — then carry
        #: the FLEET-WIDE snapshot (every sibling's counters, replica-
        #: labeled), not just the local process registry
        self.fleet_registry = None
        self._last_persist = 0.0
        self._in_dump = threading.local()
        # serializes whole dumps across threads (watchdog vs periodic
        # persist vs crash hook): two writers sharing one tmp path
        # could otherwise interleave and publish a torn bundle
        self._dump_lock = threading.Lock()
        self.dumps = 0
        self.last_bundle_path = None

    # -- recording (hot path) ----------------------------------------------

    def record(self, kind, **fields):
        """Store one event. Wait-free: no lock; each writer owns the
        slot its sequence number maps to."""
        seq = next(self._seq)
        self._slots[seq % self.capacity] = (seq, time.time(), kind,
                                            fields)
        if self.persist_every and (seq + 1) % self.persist_every == 0:
            now = time.monotonic()
            if now - self._last_persist >= self.persist_min_interval_s:
                self._last_persist = now
                try:
                    self.dump("periodic")
                except OSError:
                    pass    # persistence is best-effort; never unwind
                            # the instrumented path over a full disk
        return seq

    def events(self):
        """The ring's current contents, oldest first. A snapshot taken
        while writers race may miss the newest few slots — acceptable
        for a flight recorder; ordering among returned events is exact
        (seq-sorted)."""
        items = [s for s in list(self._slots) if s is not None]
        items.sort(key=lambda s: s[0])
        return [{"seq": s[0], "t": round(s[1], 6), "kind": s[2],
                 **s[3]} for s in items]

    # -- dumping -----------------------------------------------------------

    def _thread_stacks(self):
        names = {t.ident: t.name for t in threading.enumerate()}
        stacks = {}
        for tid, frame in sys._current_frames().items():
            label = f"{names.get(tid, 'unknown')} ({tid})"
            stacks[label] = traceback.format_stack(frame)
        return stacks

    def bundle(self, reason) -> dict:
        reg = self.fleet_registry or self.registry \
            or _metrics.get_registry()
        try:
            metrics = reg.snapshot()
        except Exception:  # noqa: BLE001 — a half-torn-down fleet's
            # federated read must not cost us the rest of the bundle
            metrics = {}
            if reg is not self.registry:
                try:
                    metrics = (self.registry
                               or _metrics.get_registry()).snapshot()
                except Exception:  # noqa: BLE001
                    pass
        return {
            "schema": BUNDLE_SCHEMA,
            "reason": str(reason),
            "ts": time.time(),
            "pid": os.getpid(),
            "restart_round": int(os.environ.get("PADDLE_RESTART_ROUND",
                                                "0")),
            "events": self.events(),
            "threads": self._thread_stacks(),
            "metrics": metrics,
        }

    def incidents(self):
        """The preserved incident bundle filenames (newest last) —
        the /statusz incident list."""
        if self.bundle_dir is None:
            return []
        try:
            names = [f for f in os.listdir(self.bundle_dir)
                     if f.startswith("flight_incident_")
                     and f.endswith(".json")]
        except OSError:
            return []
        try:
            names.sort(key=lambda f: int(
                f[len("flight_incident_"):-len(".json")]))
        except ValueError:
            names.sort()
        return names

    def dump(self, reason, path=None) -> str | None:
        """Atomically write the debug bundle; returns its path (None
        when no destination is configured). Dumps are serialized
        across threads and reentrancy-guarded (a crash inside the dump
        path cannot recurse through the crash hook back into dump).
        INCIDENT dumps — any reason other than ``"periodic"`` — are
        additionally preserved as ``flight_incident_<n>.json``
        (newest ``keep_incidents`` kept), so a later periodic persist
        can never overwrite the stall/crash post-mortem this module
        exists to capture."""
        if getattr(self._in_dump, "active", False):
            return None
        if path is None:
            if self.bundle_dir is None:
                return None
            path = os.path.join(self.bundle_dir, BUNDLE_NAME)
        periodic = reason == "periodic"
        # periodic persists are opportunistic: if another thread is
        # mid-dump, skip instead of blocking the instrumented hot path
        if not self._dump_lock.acquire(blocking=not periodic):
            return None
        self._in_dump.active = True
        try:
            doc = self.bundle(reason)
            _atomic_json_dump(doc, path)
            self.dumps += 1
            if not periodic and self.keep_incidents > 0 \
                    and self.bundle_dir is not None:
                self._keep_incident(doc)
        finally:
            self._in_dump.active = False
            self._dump_lock.release()
        self.last_bundle_path = path
        reg = self.registry or _metrics.get_registry()
        reg.counter("obs/bundle_dumps").inc()
        return path

    def _keep_incident(self, doc):
        """Preserve an incident bundle under its own name and prune to
        the newest ``keep_incidents`` (best-effort: preservation must
        never fail the primary dump)."""
        try:
            inc = os.path.join(self.bundle_dir,
                               f"flight_incident_{self.dumps}.json")
            _atomic_json_dump(doc, inc)
            old = [f for f in os.listdir(self.bundle_dir)
                   if f.startswith("flight_incident_")
                   and f.endswith(".json")]
            old.sort(key=lambda f: int(f[len("flight_incident_"):
                                        -len(".json")]))
            for f in old[:-self.keep_incidents]:
                os.remove(os.path.join(self.bundle_dir, f))
        except (OSError, ValueError):
            pass


class Watchdog:
    """Daemon thread that dumps a bundle when an armed should-progress
    region stops beating. One dump per stall episode: progress resuming
    re-arms it."""

    def __init__(self, recorder, timeout_s=30.0, poll_s=None):
        self.recorder = recorder
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(self.timeout_s / 4.0, 0.01)
        self._last_beat = time.monotonic()
        self._armed = threading.Event()
        self._stop = threading.Event()
        self._dumped_for_episode = False
        self._what = ""
        self._owner = None
        self.stall_dumps = 0
        self._thread = threading.Thread(target=self._run,
                                        name="obs-watchdog", daemon=True)
        self._thread.start()

    def arm(self, what=""):
        """Enter a should-progress region (e.g. a serving run loop).
        Returns an owner token: a ``beat``/``disarm`` carrying a
        DIFFERENT component's token is ignored, so a healthy fit loop
        beating cannot mask a stalled serving engine (and a finishing
        component cannot disarm someone else's region). One armed
        region per watchdog; a later arm takes ownership."""
        token = object()
        self._owner = token
        self._what = what
        self._last_beat = time.monotonic()
        self._dumped_for_episode = False
        self._armed.set()
        return token

    def disarm(self, token=None):
        if token is not None and token is not self._owner:
            return                      # not this component's region
        self._armed.clear()
        self._owner = None

    def beat(self, token=None):
        """Mark progress. ``token=None`` (direct single-component use)
        always counts; a stale token from a component that no longer
        owns the armed region does not."""
        if token is not None and token is not self._owner:
            return
        self._last_beat = time.monotonic()
        self._dumped_for_episode = False

    def stop(self):
        self._stop.set()
        self._armed.clear()
        self._thread.join(timeout=5.0)

    def _run(self):
        while not self._stop.is_set():
            if self._stop.wait(self.poll_s):
                return
            if not self._armed.is_set() or self._dumped_for_episode:
                continue
            gap = time.monotonic() - self._last_beat
            if gap > self.timeout_s:
                self._dumped_for_episode = True
                self.stall_dumps += 1
                reg = self.recorder.registry or _metrics.get_registry()
                reg.counter("obs/stalls_detected").inc()
                try:
                    self.recorder.dump(
                        f"stall: no progress for {gap:.2f}s "
                        f"(timeout {self.timeout_s}s"
                        + (f"; {self._what}" if self._what else "")
                        + ")")
                except OSError:
                    pass


# -- process-wide installation ---------------------------------------------

_RECORDER: FlightRecorder | None = None
_WATCHDOG: Watchdog | None = None


def install(recorder=None, watchdog_timeout_s=None, **kw) -> FlightRecorder:
    """Install ``recorder`` (or build one from ``**kw``) as the
    process-wide flight recorder; optionally start a watchdog. The
    instrumented call sites (the serving scheduler, the fleet router,
    admission control) feed it through :func:`record_event`."""
    global _RECORDER, _WATCHDOG
    if recorder is None:
        recorder = FlightRecorder(**kw)
    _RECORDER = recorder
    if watchdog_timeout_s is not None:
        if _WATCHDOG is not None:
            _WATCHDOG.stop()
        _WATCHDOG = Watchdog(recorder, timeout_s=watchdog_timeout_s)
    elif _WATCHDOG is not None:
        # re-install without a new watchdog: rebind the live watchdog
        # to the new recorder, or its stall dump would snapshot the
        # OLD ring (empty of everything recorded since) into the old
        # bundle_dir
        _WATCHDOG.recorder = recorder
    return recorder


def uninstall():
    global _RECORDER, _WATCHDOG
    if _WATCHDOG is not None:
        _WATCHDOG.stop()
    _RECORDER = None
    _WATCHDOG = None


def get_recorder() -> FlightRecorder | None:
    return _RECORDER


def get_watchdog() -> Watchdog | None:
    return _WATCHDOG


#: cached at import so the per-event hot path pays one lock (the
#: counter's own), not a registry dict lookup per ring event
_RING_EVENTS = _metrics.get_registry().counter("obs/ring_events")


def record_event(kind, **fields):
    """Record into the installed recorder; a None check when none is
    installed (the default) — instrumentation stays in production
    paths for free."""
    rec = _RECORDER
    if rec is None:
        return None
    _RING_EVENTS.inc()
    return rec.record(kind, **fields)


def beat(token=None):
    """Mark progress on the installed watchdog (no-op otherwise);
    pass the token from :func:`arm` so only the owning component's
    beats count."""
    wd = _WATCHDOG
    if wd is not None:
        wd.beat(token)


def arm(what=""):
    """Arm the installed watchdog around a should-progress region;
    returns the owner token. With no watchdog installed the token is
    an INERT object (not None): if a watchdog appears mid-region and
    another component arms it, this region's ``beat(token)`` /
    ``disarm(token)`` must read as foreign and be ignored."""
    wd = _WATCHDOG
    if wd is not None:
        return wd.arm(what)
    return object()


def disarm(token=None):
    wd = _WATCHDOG
    if wd is not None:
        wd.disarm(token)


def install_crash_hook():
    """Chain a ``sys.excepthook`` that dumps a bundle on ANY uncaught
    exception (reason carries the exception repr) before delegating to
    the previous hook. Idempotent; a no-op while no recorder is
    installed at crash time."""
    prev = sys.excepthook
    if getattr(prev, "_paddle_flight_recorder", False):
        return

    def hook(exc_type, exc, tb):
        rec = _RECORDER
        if rec is not None:
            try:
                rec.dump(f"crash: {exc_type.__name__}: {exc}")
            except Exception:  # noqa: BLE001 — the crash must still print
                pass
        prev(exc_type, exc, tb)

    hook._paddle_flight_recorder = True
    sys.excepthook = hook
