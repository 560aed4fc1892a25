"""Process-backed fleet replica: the :class:`~.fleet.FleetReplica` seam
over a real worker process; the port of
``paddle_tpu/inference/proc_replica.py``.

:class:`ProcReplica` slots into :class:`~.fleet.ServingFleet`
(``replica_cls=ProcReplica``) speaking the :mod:`~.wire` frame protocol
to a spawned ``python -m paddle_tpu_torch.inference.worker`` that owns
the actual :class:`~.serving.ContinuousBatchingEngine`. The router
(failover, hedging, breakers, exactly-once delivery, greedy streams
that go on where they stopped) is unchanged: everything it touches
(``admit``/``step``/``salvage``/``load``/``health``) is served by a
parent-side shadow of the worker's state.

The shadow is the whole robustness story:

- **Salvage never needs the corpse.** Every ``step`` reply mirrors new
  tokens and hops into the parent-side :class:`ServedRequest` objects
  and restates the worker's queue and slot occupancy, so when the
  worker dies, ``salvage_unfinished(shadow)`` returns complete replay
  payloads (prompt + every token already delivered) without asking the
  dead process anything.
- **Dead vs hung vs lossy.** ``waitpid``/EOF means dead: respawn under
  the restart budget (exponential backoff and jitter) and replay the
  shadow; past the budget the step raises and the fleet opens the
  breaker. Missed heartbeats or a spent RPC deadline mean hung: a
  flight-recorder bundle, SIGTERM with a grace period, then SIGKILL, and
  the replica reports itself wedged so the fleet ejects it through the
  health check, not the breaker. Truncated, garbage or duplicated
  frames mean lossy: a typed ``WireError`` per incident, a decoder
  resync and a bounded retransmit (the worker's rpc-id reply cache makes
  retransmits exactly-once), never a hang and never a half-applied
  message.
- **Observability survives the boundary.** Step replies carry a
  registry snapshot diff folded into a parent-side shadow registry (the
  registry the fleet federates, so watermark banking keeps fleet totals
  dip-free across respawns), and worker hops merge into the one
  cross-replica timeline through a monotonic-clock offset handshake.

The worker is started by ``subprocess.Popen`` (fork, then exec of a
fresh interpreter) with the socket passed through ``pass_fds``: a parent
that holds a CUDA context is never forked into a child that runs on.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys
import time

import numpy as np

from ..profiler import flight_recorder as _frec
from ..profiler import metrics as _pmetrics
from .fleet import FleetReplica
from .reliability import (AdmissionController, DeadlineExceeded,
                          Overloaded, ReplicaFailed, RequestCancelled,
                          RequestQuarantined, ServingError, record_hop)
from .serving import _StatsView
from .wire import (WireClosed, WireError, WireTimeout, WireTransport,
                   socketpair)

#: the directory holding the ``paddle_tpu_torch`` package: the worker's
#: interpreter imports it from there
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_pmetrics.declare("proc/spawns", "counter",
                  "worker processes launched (initial spawns + "
                  "respawns) by process-backed replicas")
_pmetrics.declare("proc/respawns", "counter",
                  "dead workers relaunched under the replica's "
                  "restart budget (shadow requests replayed)")
_pmetrics.declare("proc/heartbeat_misses", "counter",
                  "worker declared hung: heartbeat silence past "
                  "hb_timeout_s (SIGTERM-with-grace then SIGKILL, "
                  "flight-recorder bundle dumped)")
_pmetrics.declare("proc/rpc_retries", "counter",
                  "RPC retransmits after a deadline or a wire error "
                  "(exactly-once: the worker's reply cache dedupes)")
_pmetrics.declare("wire/errors", "counter",
                  "typed wire faults survived: corrupt, oversized, "
                  "out-of-order or garbage frames (decoder resynced)")
_pmetrics.declare("proc/worker_rss_bytes", "gauge",
                  "resident set size of the replica's worker process "
                  "(from its last step reply)")
_pmetrics.declare("proc/rpc_ms", "histogram",
                  "parent-observed RPC round-trip latency to the "
                  "worker, ms (bounded reservoir)")

#: typed-error reconstruction across the wire (worker sends the class
#: name; isinstance contracts must hold parent-side)
_ERROR_TYPES = {c.__name__: c for c in
                (ServingError, RequestCancelled, DeadlineExceeded,
                 RequestQuarantined, Overloaded, ReplicaFailed)}


def _rebuild_error(type_name, msg):
    cls = _ERROR_TYPES.get(type_name, ServingError)
    err = cls.__new__(cls)
    Exception.__init__(err, msg)
    return err


class _WorkerDied(Exception):
    """Internal: the worker process is gone (EOF / waitpid / fatal)."""


class _WorkerHung(Exception):
    """Internal: heartbeats stopped or the RPC hard deadline passed."""


class _ShadowEngine:
    """The parent-side mirror of the worker's engine: the surface the
    fleet router, the admission controller and ``salvage_unfinished``
    read. ``queue``/``slot_req`` hold the PARENT's ServedRequest
    objects (tokens mirrored on every harvest); geometry comes from
    the worker's init reply; ``metrics`` is a real registry the fleet
    federates."""

    def __init__(self, replica):
        self._replica = replica
        self._fleet_replica_id = replica.id
        self.metrics = _pmetrics.MetricsRegistry()
        self._stats = _StatsView(self.metrics)
        self.queue: list = []
        self.slot_req: list = []
        self.completed: list = []
        # geometry placeholders until the init reply lands
        self.num_slots = 1
        self.page_size = 0
        self.max_len = 0
        self.decode_chunk = 1
        self.num_pages = 2
        self._gauges: dict = {}

    def _adopt_geometry(self, g):
        self.num_slots = int(g["num_slots"])
        self.page_size = int(g["page_size"])
        self.max_len = int(g["max_len"])
        self.decode_chunk = int(g["decode_chunk"])
        self.num_pages = int(g["num_pages"])
        if not self.slot_req:
            self.slot_req = [None] * self.num_slots

    # -- router/admission surface --------------------------------------

    def _check_fits(self, prompt_len, max_new):
        self._replica._ready_for_admission()
        if prompt_len + max_new > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new}) "
                f"exceeds engine max_len {self.max_len}")
        need = -(-(prompt_len + max_new) // self.page_size)
        if need > self.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.num_pages - 1} allocatable")

    def requeue(self, req):
        if req.finished:
            self.completed.append(req)
            return
        self._check_fits(req.prompt.size, req.max_new_tokens)
        self._replica._admit_rpc(req)   # raises before shadow mutates
        self.queue.append(req)

    def cancel(self, request_id):
        return self._replica._cancel_rpc(request_id)

    def handoff(self):
        return self._replica._handoff_rpc()

    def has_work(self):
        return bool(self.queue) or any(
            r is not None and not r.finished for r in self.slot_req)

    def gauges(self):
        return dict(self._gauges)

    def reset_gauges(self):
        try:
            self._replica._rpc_checked("reset_gauges", {})
        except _WorkerHung as e:
            self._replica._declare_hung(e)
        except _WorkerDied as e:
            self._replica._respawn_or_raise(e)
        for k in self._stats:
            self._stats[k] = 0
        self._gauges = {}


class _ProcSupervisor:
    """The supervisor-shaped face the fleet expects: ``engine`` is
    the shadow, ``restarts`` is the respawn count (the SAME budget
    semantics — checked before the counter, raises past it), and
    ``step()`` is one step RPC."""

    def __init__(self, replica):
        self._r = replica
        self.completed: list = []

    @property
    def engine(self):
        return self._r._shadow

    @property
    def restarts(self):
        return self._r.respawns

    @property
    def max_restarts(self):
        return self._r.max_restarts

    def cancel(self, request_id):
        return self._r._cancel_rpc(request_id)

    def gauges(self):
        return self._r._shadow.gauges()

    def has_work(self):
        return self._r._shadow.has_work()

    def step(self):
        return self._r._step_rpc()


class ProcReplica(FleetReplica):
    """A :class:`FleetReplica` whose engine lives in a worker process
    (module docstring). ``spec`` is the worker recipe::

        {"factory": "paddle_tpu_torch.inference.worker:llama_engine",
         "kwargs": {...engine/model kwargs...}}

    A ``_spawn_fn`` entry (callable -> ``(proc, parent_socket)``)
    overrides process launch: the hermetic-test seam. After the first
    use, ``worker_device`` is the device name the worker's ``init``
    reported, ``spawn_ready_s`` the seconds from each spawn to its
    worker's ``init`` reply and ``factory_s`` the seconds of each of
    those its engine factory took."""

    def __init__(self, replica_id, spec, *, max_restarts=2,
                 max_queue=64, default_ttft_slo_s=None,
                 min_retry_after_s=0.05,
                 rpc_deadline_s=1.0, rpc_hard_deadline_s=120.0,
                 init_deadline_s=300.0, rpc_retries=4,
                 hb_interval_s=0.2, hb_timeout_s=1.5,
                 wire_retries=4, term_grace_s=0.5,
                 respawn_backoff_s=0.02, respawn_backoff_cap_s=2.0,
                 respawn_jitter=0.25, seed=0):
        self.id = int(replica_id)
        self.spec = dict(spec)
        self.max_restarts = int(max_restarts)
        self.rpc_deadline_s = float(rpc_deadline_s)
        self.rpc_hard_deadline_s = float(rpc_hard_deadline_s)
        self.init_deadline_s = float(init_deadline_s)
        self.rpc_retries = int(rpc_retries)
        self.hb_interval_s = float(hb_interval_s)
        self.hb_timeout_s = float(hb_timeout_s)
        self.wire_retries = int(wire_retries)
        self.term_grace_s = float(term_grace_s)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.respawn_backoff_cap_s = float(respawn_backoff_cap_s)
        self.respawn_jitter = float(respawn_jitter)
        self._rng = random.Random(seed * 7919 + self.id)

        self._shadow = _ShadowEngine(self)
        self.supervisor = _ProcSupervisor(self)
        self.admission = AdmissionController(
            self._shadow, max_queue=max_queue,
            default_ttft_slo_s=default_ttft_slo_s,
            min_retry_after_s=min_retry_after_s)

        reg = self._shadow.metrics
        self._c_spawns = reg.counter("proc/spawns")
        self._c_respawns = reg.counter("proc/respawns")
        self._c_hb_misses = reg.counter("proc/heartbeat_misses")
        self._c_rpc_retries = reg.counter("proc/rpc_retries")
        self._c_wire_errors = reg.counter("wire/errors")
        self._g_rss = reg.gauge("proc/worker_rss_bytes")
        self._h_rpc = reg.histogram("proc/rpc_ms")

        # FleetReplica health-state surface (no super().__init__ —
        # the in-process supervisor/admission it builds are replaced
        # by the shadow-backed ones above)
        self.state = "ready"
        self.drain_deadline = None
        self.eject_kind = None
        self.last_beat = time.perf_counter()
        self.last_progress = self.last_beat
        self._idle_marker = None
        self._stale_turns = 0

        self.respawns = 0
        self._hung = False
        self._proc = None
        self._tr = None
        self._ready = False
        #: heartbeat liveness only applies once the worker has beaten
        #: at least once — interpreter boot + package import run long
        #: before the hb thread exists (process death still detected
        #: via waitpid; boot is bounded by the init hard deadline)
        self._saw_beat = False
        self._clock_offset = 0.0
        self._next_rpc = 0
        self._pending_init = None
        self.worker_device = None
        self.spawn_ready_s: list[float] = []
        self.factory_s: list[float] = []
        self._t_spawn = 0.0
        self._spawn()           # init RPC in flight; readiness lazy

    # ---- process lifecycle ---------------------------------------------

    @property
    def worker_pid(self):
        return self._proc.pid if self._proc is not None else None

    def _spawn(self):
        spawn_fn = self.spec.get("_spawn_fn")
        if spawn_fn is not None:
            self._proc, parent_sock = spawn_fn(self)
        else:
            parent_sock, child_sock = socketpair()
            env = dict(os.environ)
            env["PYTHONPATH"] = _PKG_ROOT + os.pathsep \
                + env.get("PYTHONPATH", "")
            child_fd = child_sock.fileno()
            self._proc = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.inference.worker",
                 "--fd", str(child_fd),
                 "--hb-interval", str(self.hb_interval_s)],
                pass_fds=(child_fd,), env=env,
                stdout=subprocess.DEVNULL)
            child_sock.close()
        self._tr = WireTransport(parent_sock, replica_id=self.id,
                                 side="parent")
        self._ready = False
        self._saw_beat = False
        self._migrating = []     # rids parked worker-side (step reply)
        self._c_spawns.inc()
        self.last_beat = time.perf_counter()
        self._t_spawn = self.last_beat
        # fire the init without waiting: replicas spawned together
        # import and build concurrently, readiness is drained on first use
        self._pending_init = self._send_rpc(
            "init", {"spec": {"factory": self.spec.get("factory"),
                              "kwargs": self.spec.get("kwargs", {})}})

    def _ensure_ready(self):
        if self._ready:
            return
        if self._pending_init is None:
            raise ReplicaFailed(self.id, "worker has no init in flight")
        reply = self._await_reply(self._pending_init,
                                  deadline_s=self.rpc_deadline_s,
                                  hard_s=self.init_deadline_s,
                                  payload=None, retransmit=False)
        self._pending_init = None
        self.spawn_ready_s.append(time.perf_counter() - self._t_spawn)
        self.factory_s.append(float(reply.get("factory_s", 0.0)))
        self.worker_device = reply.get("device")
        self._shadow._adopt_geometry(reply["geom"])
        self._ready = True
        self._clock_sync()

    def _clock_sync(self):
        """Monotonic-clock offset handshake: 3 pings, keep the
        minimum-RTT sample; worker timestamps map into the parent's
        ``perf_counter`` domain as ``t_worker + offset``."""
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            reply = self._rpc_checked("clock", {})
            t1 = time.perf_counter()
            rtt = t1 - t0
            offset = (t0 + rtt / 2.0) - float(reply["t"])
            if best is None or rtt < best[0]:
                best = (rtt, offset)
        self._clock_offset = best[1]

    def _reap(self, kill=False):
        if self._proc is None:
            return
        try:
            if kill:
                self._proc.kill()
            self._proc.wait(timeout=5.0)
        except (OSError, subprocess.TimeoutExpired):
            pass
        if self._tr is not None:
            self._tr.close()

    def _declare_hung(self, cause):
        """The hung path: bundle, SIGTERM-with-grace, SIGKILL, and
        mark wedged so the fleet ejects via the HEALTH check (not the
        breaker) — SIGKILL also fells a SIGSTOPped process."""
        if self._hung:
            return
        self._c_hb_misses.inc()
        _frec.record_event("proc_worker_hung", replica=self.id,
                           pid=self.worker_pid, cause=str(cause)[:200])
        rec = _frec.get_recorder()
        if rec is not None:
            rec.dump(f"proc replica {self.id} worker hung: {cause}")
        try:
            self._proc.terminate()
            deadline = time.monotonic() + self.term_grace_s
            while time.monotonic() < deadline:
                if self._proc.poll() is not None:
                    break
                time.sleep(0.01)
        except OSError:
            pass
        self._reap(kill=True)
        self._hung = True

    def _respawn_or_raise(self, cause):
        """The dead path: salvage is ALREADY parent-side (the shadow);
        respawn under the restart budget with backoff + jitter and
        replay every unfinished shadow request; past budget, raise —
        the fleet opens the breaker and reroutes the same shadow."""
        _frec.record_event("proc_worker_dead", replica=self.id,
                           cause=str(cause)[:200],
                           respawns=self.respawns)
        self._reap(kill=True)
        # hoist the salvage set ONCE: a replay lap that dies partway
        # through re-admission must not shrink it to the requests it
        # managed to re-append — every lap (and the budget-spent
        # raise) carries the full unfinished set
        salvage = [r for r in self._shadow.queue
                   if not r.finished]
        salvage += [r for r in self._shadow.slot_req
                    if r is not None and not r.finished]
        salvage.sort(key=lambda r: r.request_id)
        while True:
            if self.respawns >= self.max_restarts:
                # leave the shadow holding the full set — the fleet's
                # breaker path salvages from it on eject
                self._shadow.queue = list(salvage)
                self._shadow.slot_req = [None] * max(
                    1, self._shadow.num_slots)
                raise ReplicaFailed(
                    self.id, f"worker respawn budget "
                    f"({self.max_restarts}) spent: {cause}")
            self.respawns += 1
            self._c_respawns.inc()
            back = min(self.respawn_backoff_cap_s,
                       self.respawn_backoff_s
                       * (2.0 ** (self.respawns - 1)))
            back *= 1.0 + self.respawn_jitter * self._rng.random()
            time.sleep(back)
            self._shadow.queue = []
            self._shadow.slot_req = [None] * max(
                1, self._shadow.num_slots)
            try:
                self._spawn()
                self._ensure_ready()
                for req in salvage:
                    record_hop(req, "respawn", replica=self.id,
                               tokens=len(req.tokens))
                    self._rpc_checked("admit",
                                      self._admit_payload(req))
                    self._shadow.queue.append(req)
            except (_WorkerDied, _WorkerHung, WireError) as e:
                cause = e
                continue
            return

    # ---- RPC engine ----------------------------------------------------

    def _send_rpc(self, op, payload):
        rpc_id = self._next_rpc
        self._next_rpc += 1
        msg = {"kind": "rpc", "id": rpc_id, "op": op}
        if payload:
            msg.update(payload)
        try:
            self._tr.send(msg)
        except WireClosed as e:
            raise _WorkerDied(e) from e
        self._pending = msg
        return rpc_id

    def _await_reply(self, rpc_id, *, deadline_s, hard_s, payload,
                     retransmit=True):
        """Drive recv until the reply for ``rpc_id`` lands. Heartbeat
        frames refresh liveness; their absence past ``hb_timeout_s``
        declares the worker hung. A quiet-but-alive worker gets
        bounded retransmits (a dropped frame is the only way an alive
        worker misses an RPC), then patience until the hard deadline
        (a first step's kernel loads run long under fresh heartbeats)."""
        t0 = time.perf_counter()
        t_send = t0
        attempts = 0
        wire_errs = 0
        deadline = t0 + deadline_s
        hard = t0 + hard_s
        while True:
            if self._proc is not None \
                    and self._proc.poll() is not None:
                raise _WorkerDied(
                    f"worker pid {self.worker_pid} exited "
                    f"rc={self._proc.returncode}")
            try:
                frame = self._tr.recv(0.02)
            except WireTimeout:
                frame = None
            except WireClosed as e:
                raise _WorkerDied(e) from e
            except WireError as e:
                self._c_wire_errors.inc()
                wire_errs += 1
                if wire_errs > self.wire_retries:
                    raise _WorkerDied(
                        f"wire unusable after {wire_errs} typed "
                        f"errors: {e}") from e
                if retransmit:
                    self._retransmit(payload)
                    attempts += 1
                continue
            now = time.perf_counter()
            if frame is not None:
                # ANY frame is liveness evidence: from the first one
                # on, heartbeat cadence applies (a worker that stops
                # beating mid-boot is bounded by the init hard
                # deadline instead)
                self.last_beat = now
                self._saw_beat = True
                kind = frame.get("kind")
                if kind == "fatal":
                    etype = frame.get("etype")
                    msg = frame.get("msg", "")
                    if etype == "AssertionError":
                        # the page-accounting audit must NEVER be
                        # laundered into a respawn
                        raise AssertionError(
                            f"worker {self.id} audit: {msg}")
                    raise _WorkerDied(f"worker fatal {etype}: {msg}")
                if kind == "reply" and frame.get("id") == rpc_id:
                    self._h_rpc.observe((now - t_send) * 1e3)
                    return frame
                # a heartbeat or a stale reply: the deadlines below still
                # apply (the JAX loop skips them after any frame, so
                # heartbeats quicker than its 20 ms poll starve the
                # retransmits)
            hb_age = now - self.last_beat
            if self._saw_beat and hb_age > self.hb_timeout_s:
                raise _WorkerHung(
                    f"no heartbeat for {hb_age:.2f}s")
            if now >= hard:
                raise _WorkerHung(
                    f"rpc past hard deadline {hard_s:.1f}s "
                    f"(heartbeats still arriving)")
            if now >= deadline and retransmit \
                    and attempts < self.rpc_retries:
                # exponential backoff + jitter on the retransmit
                # cadence (the fleet's retry discipline)
                back = min(2.0, deadline_s * (2.0 ** attempts))
                back *= 1.0 + 0.25 * self._rng.random()
                self._retransmit(payload)
                attempts += 1
                t_send = now
                deadline = now + back

    def _retransmit(self, payload):
        if payload is None:
            return
        self._c_rpc_retries.inc()
        try:
            self._tr.send(payload)
        except WireClosed as e:
            raise _WorkerDied(e) from e

    def _rpc_checked(self, op, payload, *, deadline_s=None,
                     hard_s=None):
        """Send + await; raises the internal died/hung exceptions for
        the op-level wrappers to classify."""
        rpc_id = self._send_rpc(op, payload)
        msg = dict(self._pending)
        reply = self._await_reply(
            rpc_id,
            deadline_s=deadline_s or self.rpc_deadline_s,
            hard_s=hard_s or self.rpc_hard_deadline_s,
            payload=msg)
        return reply

    # ---- op wrappers (dead/hung classification per caller) -------------

    def _ready_for_admission(self):
        """``_ensure_ready`` with router-grade classification: hung ⇒
        typed :class:`Overloaded` (shed, retry a sibling), dead ⇒
        respawn under budget (:class:`ReplicaFailed` past it)."""
        try:
            self._ensure_ready()
        except _WorkerHung as e:
            self._declare_hung(e)
            raise Overloaded(
                f"replica {self.id} worker hung",
                self.admission.min_retry_after_s) from e
        except _WorkerDied as e:
            self._respawn_or_raise(e)

    @staticmethod
    def _admit_payload(req):
        age = max(0.0, time.perf_counter()
                  - (req.t_arrive or time.perf_counter()))
        return {"req": {
            "rid": int(req.request_id),
            "prompt": [int(t) for t in np.asarray(req.prompt).ravel()],
            "max_new": int(req.max_new_tokens),
            "eos": req.eos_token_id,
            "priority": int(req.priority),
            "ttft_deadline_s": req.ttft_deadline_s,
            "deadline_s": req.deadline_s,
            "tenant": req.tenant,
            "tokens": [int(t) for t in req.tokens],
            "preemptions": int(req.preemptions),
            "no_migrate": bool(getattr(req, "no_migrate", False)),
            "age_s": age}}

    def _admit_rpc(self, req):
        # bounded by the restart budget: every retry lap burned a
        # respawn (or raised), so this terminates
        for _ in range(self.max_restarts + 2):
            try:
                self._ensure_ready()
                self._rpc_checked("admit", self._admit_payload(req))
                return
            except _WorkerHung as e:
                self._declare_hung(e)
                raise Overloaded(
                    f"replica {self.id} worker hung during admit",
                    self.admission.min_retry_after_s) from e
            except _WorkerDied as e:
                # respawn (budget permitting) re-admits the SHADOW —
                # this request is not in it yet, so retry it after
                self._respawn_or_raise(e)
        raise ReplicaFailed(self.id, "admit could not land")

    def _step_rpc(self):
        try:
            self._ensure_ready()
            reply = self._rpc_checked("step", {})
        except _WorkerHung as e:
            self._declare_hung(e)
            return []              # wedged() now says so; fleet ejects
        except _WorkerDied as e:
            self._respawn_or_raise(e)   # raises past budget → breaker
            return []              # restart counts as progress
        return self._apply_step(reply)

    def _cancel_rpc(self, request_id):
        # mark the shadow first: cancellation must stick even if the
        # worker dies before acting on it (the respawn replay carries
        # the flag via the engine's requeue lifecycle check)
        for req in list(self._shadow.queue) + list(
                self._shadow.slot_req):
            if req is not None and req.request_id == request_id \
                    and not req.finished:
                req.cancelled = True
        try:
            reply = self._rpc_checked("cancel",
                                      {"rid": int(request_id)})
        except _WorkerHung as e:
            self._declare_hung(e)
            return True
        except _WorkerDied as e:
            self._respawn_or_raise(e)
            return True
        return bool(reply.get("cancelled"))

    def _handoff_rpc(self):
        try:
            self._rpc_checked("handoff", {})
        except _WorkerHung as e:
            self._declare_hung(e)
        except _WorkerDied:
            pass      # dead worker: the shadow IS the handoff payload
        out = [r for r in self._shadow.queue if not r.finished]
        out += [r for r in self._shadow.slot_req
                if r is not None and not r.finished]
        out.sort(key=lambda r: r.request_id)
        for r in out:
            r.preemptions += 1
        self._shadow.queue = []
        self._shadow.slot_req = [None] * max(1,
                                             self._shadow.num_slots)
        return out

    def audit(self):
        """Worker-side page-accounting audit (the chaos gate's
        survivor check): returns the worker's verdict dict."""
        try:
            self._ensure_ready()
            return self._rpc_checked("audit", {})
        except _WorkerHung as e:
            self._declare_hung(e)
            raise ReplicaFailed(self.id, f"hung during audit: {e}") \
                from e
        except _WorkerDied as e:
            self._respawn_or_raise(e)
            return self._rpc_checked("audit", {})

    # ---- step reply application (mirror-on-harvest) --------------------

    def _apply_step(self, reply):
        shadow = self._shadow
        by_id = {r.request_id: r for r in shadow.queue}
        for r in shadow.slot_req:
            if r is not None:
                by_id[r.request_id] = r
        finished = []
        off = self._clock_offset
        for u in reply.get("updates", ()):
            req = by_id.get(u.get("rid"))
            if req is None:
                continue
            req.tokens.extend(int(t) for t in u.get("toks", ()))
            req.preemptions = int(u.get("preemptions",
                                        req.preemptions))
            for h in u.get("hops", ()):
                h = dict(h)
                if isinstance(h.get("t"), (int, float)):
                    h["t"] = h["t"] + off
                self._append_hop(req, h)
            if u.get("t_first") and not req.t_first:
                req.t_first = float(u["t_first"]) + off
            if u.get("finished"):
                req.finished = True
                req.finish_reason = u.get("reason")
                req.t_done = float(u.get("t_done") or 0.0) + off \
                    if u.get("t_done") else time.perf_counter()
                err = u.get("error")
                if err:
                    req.error = _rebuild_error(err[0], err[1])
                finished.append(req)
        # re-state occupancy from the worker's truth — a request
        # parked for migration occupies NEITHER queue nor slot worker
        # side, but must stay in the shadow (a worker death between
        # parking and pickup salvages it to prompt replay)
        shadow.queue = [by_id[r] for r in reply.get("queue", ())
                        if r in by_id]
        self._migrating = list(reply.get("migrating", ()))
        for rid in self._migrating:
            req = by_id.get(rid)
            if req is not None and req not in shadow.queue:
                shadow.queue.append(req)
        slots = reply.get("slots")
        if slots is not None:
            shadow.slot_req = [
                by_id.get(r) if r is not None else None
                for r in slots]
            if len(shadow.slot_req) < shadow.num_slots:
                shadow.slot_req += [None] * (
                    shadow.num_slots - len(shadow.slot_req))
        # registry snapshot diff -> shadow registry (federation
        # watermarks bank respawn dips upstream)
        for name, v in reply.get("counters", {}).items():
            shadow.metrics.counter(name).set(v)
        for name, v in reply.get("gauges_m", {}).items():
            shadow.metrics.gauge(name).set(v)
        for name, d in reply.get("hists", {}).items():
            h = shadow.metrics.histogram(name)
            with h._lock:
                h.count = int(d.get("count", 0))
                h.sum = float(d.get("sum", 0.0))
                h.min = d.get("min")
                h.max = d.get("max")
                h._samples = [float(x) for x in
                              d.get("samples", ())][:h.capacity]
        g = reply.get("gauges")
        if g:
            shadow._gauges = g
        rss = reply.get("rss")
        if rss:
            self._g_rss.set(int(rss))
        return finished

    # ---- disaggregation seam (RPC-backed; see fleet.FleetReplica) -------

    def take_migrations(self):
        """Pop the worker's parked migrations: mirror each request's
        absolute token list into the shadow object, drop it from this
        replica's shadow occupancy (ownership is moving), and decode
        the KV payload to numpy form. A dead worker loses the payload
        but never the request — it stayed in the shadow through
        ``migrating`` re-statement, so the respawn replays it from its
        prompt (the payload was an optimization, not the record)."""
        from .disagg import kv_payload_from_wire
        # the last step reply said nothing is parked: skip the RPC
        # (the pump polls every fleet turn; this keeps the idle cost
        # zero and gives chaos tests a deterministic pickup window)
        if not self._ready or not getattr(self, "_migrating", None):
            return []
        self._migrating = []
        try:
            reply = self._rpc_checked("take_migrations", {})
        except _WorkerHung as e:
            self._declare_hung(e)
            return []
        except _WorkerDied as e:
            self._respawn_or_raise(e)
            return []
        shadow = self._shadow
        by_id = {r.request_id: r for r in shadow.queue}
        for r in shadow.slot_req:
            if r is not None:
                by_id[r.request_id] = r
        out = []
        for m in reply.get("migrations", ()):
            req = by_id.get(m.get("rid"))
            if req is None:
                continue         # already salvaged off this replica
            toks = [int(t) for t in m.get("tokens", ())]
            if len(toks) >= len(req.tokens):
                req.tokens[:] = toks
            if m.get("t_first") and not req.t_first:
                req.t_first = float(m["t_first"]) + self._clock_offset
            rid = req.request_id
            shadow.queue = [r for r in shadow.queue
                            if r.request_id != rid]
            shadow.slot_req = [
                None if (r is not None and r.request_id == rid) else r
                for r in shadow.slot_req]
            out.append((req, kv_payload_from_wire(m.get("payload")
                                                  or {})))
        return out

    def import_migration(self, req, payload):
        """Land a migrated request + its KV pages on this replica's
        worker. Raises on a dead/hung worker — the caller
        (:meth:`~.disagg.DisaggServingFleet._migrate_one`) degrades to
        plain prompt replay; a worker that actually applied the import
        before dying is harmless because the respawned engine simply
        never saw it (exactly-once is the fleet's attempt ledger)."""
        from .disagg import kv_payload_to_wire
        self._shadow._check_fits(req.prompt.size, req.max_new_tokens)
        body = self._admit_payload(req)
        body["payload"] = kv_payload_to_wire(payload)
        try:
            self._ensure_ready()
            reply = self._rpc_checked("kv_import", body)
        except _WorkerHung as e:
            self._declare_hung(e)
            raise ReplicaFailed(
                self.id, f"hung during kv_import: {e}") from e
        except _WorkerDied as e:
            self._respawn_or_raise(e)
            raise ReplicaFailed(
                self.id, "worker died during kv_import") from e
        self._shadow.queue.append(req)
        return reply.get("import")

    def release_exported(self, request_id):
        """Ack a completed migration: the source worker unpins the
        exported chain (its pages become ordinary prefix-cache
        residents). Best-effort — a dead source has no pins left."""
        try:
            self._ensure_ready()
            reply = self._rpc_checked("kv_release",
                                      {"rid": int(request_id)})
        except _WorkerHung as e:
            self._declare_hung(e)
            return False
        except _WorkerDied as e:
            self._respawn_or_raise(e)
            return False
        return bool(reply.get("released"))

    @staticmethod
    def _append_hop(req, hop):
        from .reliability import MAX_HOPS
        if len(req.hops) >= MAX_HOPS:
            req.hops_dropped += 1
            return
        req.hops.append(hop)

    # ---- health overrides ----------------------------------------------

    def wedged(self, no_progress_turns):
        return self._hung or super().wedged(no_progress_turns)

    # ---- teardown -------------------------------------------------------

    def on_eject(self, kind):
        """Fleet ejection hook: reap the corpse (dead), or the already
        SIGKILLed hung worker — salvage read the shadow, nothing is
        owed by the process."""
        self.close()

    def close(self):
        if self._proc is not None:
            try:
                if self._proc.poll() is None and self._ready \
                        and not self._hung:
                    try:
                        self._send_rpc("shutdown", {})
                    except (_WorkerDied, WireError):
                        pass
                self._proc.terminate()
                self._proc.wait(timeout=2.0)
            except (OSError, subprocess.TimeoutExpired):
                self._reap(kill=True)
        if self._tr is not None:
            self._tr.close()
