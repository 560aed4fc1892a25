"""Deterministic fault injection: the file-operation, call-site and
serving plans of ``paddle_tpu/testing/fault_injection.py``.

**File plans.** While installed, the injector patches ``builtins.open``
(which numpy's ``np.save``/``np.load`` go through) and ``os.replace`` /
``os.rename``, and fires a :class:`FaultPlan` when its ``op`` (``open``,
``write``, ``read``, ``rename``) touches a path containing its
``match``:

- ``action="raise"``: ``OSError(errno_)`` (ENOSPC, EIO, ...), after
  ``after_bytes`` of a write landed (the torn write);
- ``action="truncate"``: only ``after_bytes`` land and success is
  reported (the short write only checksums catch);
- ``action="crash"``: ``os._exit(41)`` at that operation (no atexit, no
  flush: SIGKILL as an observer sees it);
- ``action="pause"``: touch ``marker``, then sleep forever, so a parent
  process can SIGKILL at a known point;
- ``action="sigterm"``: a real SIGTERM to this process, after which the
  operation proceeds (preemption is asynchronous: an installed
  ``PreemptionGuard`` records it and the loop drains at its next step
  boundary). :meth:`FaultInjector.preempt` arms it.

**Call plans** (:meth:`FaultInjector.fail_call`, :meth:`crash_call`)
patch a dotted callable, such as an optimizer's ``step``, and fire once
more than ``after_calls`` calls went by.

**Serving plans** patch methods of ``ContinuousBatchingEngine`` and fire
only when the chosen request, slot or replica is involved:

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

**Worker-process plans** patch ``inference.proc_replica.ProcReplica.
_step_rpc`` and the wire's fault hooks, matched by replica id:

- :meth:`FaultInjector.kill_worker`: a real SIGKILL to the replica's
  worker right before a step RPC (the parent salvages from its shadow
  and respawns under the budget; past it the breaker opens);
- :meth:`FaultInjector.pause_worker`: a real SIGSTOP (heartbeats stop,
  the process lives: the parent must classify it as hung); every pid
  still stopped gets a SIGCONT at :meth:`FaultInjector.uninstall`;
- :meth:`FaultInjector.drop_frame`, :meth:`delay_frame`,
  :meth:`corrupt_frame`: a lost, late or bit-flipped chunk on the
  parent's side of the wire (``direction="rx"`` or ``"tx"``).

Each plan fires at most ``times`` times, in registration order. Use the
injector as a context manager so that everything it patched is
restored::

    with FaultInjector() as fi:
        fi.fail("w.r0.s0.npy", op="write", errno_=errno.ENOSPC)
        save_state_dict(sd, path)     # first write ENOSPCs, retry wins
    assert fi.fires() == 1
"""

from __future__ import annotations

import builtins
import errno as _errno
import importlib
import os
import signal as _signal
import threading
import time

from ..inference.serving import ContinuousBatchingEngine

__all__ = ["FaultInjector", "FaultPlan"]


class FaultPlan:
    """One armed fault: fires when ``op`` touches a path (or, for
    ``op="call"``, a target) containing ``match``, at most ``times``
    times, and only after ``after_calls`` matching calls went by."""

    def __init__(self, match, op="write", errno_=_errno.EIO, times=1,
                 after_bytes=0, action="raise", marker=None,
                 after_calls=0):
        if op not in ("open", "write", "read", "rename", "call"):
            raise ValueError(f"unknown fault op {op!r}")
        if action not in ("raise", "truncate", "crash", "pause",
                          "sigterm"):
            raise ValueError(f"unknown fault action {action!r}")
        self.match = match
        self.op = op
        self.errno = errno_
        self.times = int(times)
        self.after_bytes = int(after_bytes)
        self.after_calls = int(after_calls)
        self.action = action
        self.marker = marker
        self.fired = 0
        self.calls = 0

    def __repr__(self):
        return (f"FaultPlan({self.match!r}, op={self.op}, "
                f"action={self.action}, fired={self.fired}/{self.times})")


class _FaultFile:
    """A file proxy that asks the injector on ``write()`` and ``read()``."""

    def __init__(self, f, path, injector):
        self._f = f
        self._path = path
        self._inj = injector
        self._written = 0
        self._truncated = False

    def write(self, data):
        if self._truncated:
            return len(data)  # the dropped tail of a short write
        plan = self._inj._take(self._path, "write",
                               pending=self._written + len(data))
        if plan is not None:
            if plan.action == "sigterm":
                # the signal is asynchronous: the write proceeds
                self._inj._act(plan, self._path)
            else:
                keep = max(0, plan.after_bytes - self._written)
                if keep:
                    self._f.write(data[:keep])
                    self._written += keep
                if plan.action == "truncate":
                    self._truncated = True
                    return len(data)  # report full success
                self._inj._act(plan, self._path)  # raise/crash/pause
        n = self._f.write(data)
        self._written += len(data)
        return n

    def read(self, *args):
        plan = self._inj._take(self._path, "read")
        if plan is not None:
            self._inj._act(plan, self._path)
        return self._f.read(*args)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False

    def __iter__(self):
        return iter(self._f)

    def __getattr__(self, name):
        return getattr(self._f, name)


class FaultInjector:
    """Installable registry of fault plans (see the module docstring)."""

    def __init__(self):
        self.plans = []
        self._lock = threading.Lock()
        self._installed = False
        self._real_open = None
        self._real_replace = None
        self._real_rename = None
        self._call_targets = []   # (dotted name, plan)
        self._targets = []    # (method name, plan, make_patched)
        self._patched = []    # (owner, attr, original)
        self._proc_targets = []       # (plan, make_patched)
        self._wire_hooks = []         # hooks awaiting install
        self._active_wire_hooks = []  # hooks currently registered
        self._paused_pids = set()     # SIGSTOPped workers owed a SIGCONT

    # -- file and call plans ----------------------------------------------

    def fail(self, match, op="write", errno_=_errno.EIO, times=1,
             after_bytes=0, action="raise", marker=None):
        plan = FaultPlan(match, op=op, errno_=errno_, times=times,
                         after_bytes=after_bytes, action=action,
                         marker=marker)
        self.plans.append(plan)
        return plan

    def fail_write(self, match, errno_=_errno.ENOSPC, times=1,
                   after_bytes=0):
        """A write to a matching path raises ``OSError(errno_)`` after
        ``after_bytes`` bytes landed (a partial write)."""
        return self.fail(match, op="write", errno_=errno_, times=times,
                         after_bytes=after_bytes)

    def fail_read(self, match, errno_=_errno.EIO, times=1):
        return self.fail(match, op="read", errno_=errno_, times=times)

    def truncate_write(self, match, after_bytes):
        """A silent short write: ``after_bytes`` land, success is
        reported."""
        return self.fail(match, op="write", after_bytes=after_bytes,
                         action="truncate")

    def crash(self, match, op="open", after_bytes=0):
        """``os._exit(41)`` when ``op`` touches a matching path."""
        return self.fail(match, op=op, action="crash",
                         after_bytes=after_bytes)

    def pause(self, match, op="open", marker=None):
        """Touch ``marker``, then sleep forever at the matching
        operation, so the test can SIGKILL this process there."""
        return self.fail(match, op=op, action="pause", marker=marker)

    def preempt(self, match, op="open", times=1):
        """A real SIGTERM to this process when ``op`` touches a matching
        path; the operation then proceeds (see the module docstring)."""
        return self.fail(match, op=op, action="sigterm", times=times)

    def fail_call(self, target, action="raise", errno_=_errno.EIO,
                  times=1, after_calls=0):
        """Arm a fault on a dotted callable (a module function or a
        ``Class.method``, e.g. ``"paddle_tpu_torch.optimizer.optimizer.
        Optimizer.step"``): once more than ``after_calls`` calls went
        by, ``action`` runs before the original (``"crash"``: the
        process dies inside it; ``"raise"``: ``OSError``;
        ``"sigterm"``: a preemption notice lands inside it)."""
        plan = FaultPlan(target, op="call", errno_=errno_, times=times,
                         action=action, after_calls=after_calls)
        self.plans.append(plan)
        self._call_targets.append((target, plan))
        if self._installed:
            self._patch_call(target, plan)
        return plan

    def crash_call(self, target, after_calls=0, times=1):
        """``os._exit(41)`` inside the named callable."""
        return self.fail_call(target, action="crash", times=times,
                              after_calls=after_calls)

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
                self._patch(ContinuousBatchingEngine, method, plan,
                            make_patched)
        return plan

    def _patch(self, owner, attr, plan, make_patched):
        """The patch every call plan rides; :meth:`uninstall` restores
        it."""
        original = getattr(owner, attr)
        patched = make_patched(original, plan)
        patched.__name__ = getattr(original, "__name__", attr)
        setattr(owner, attr, patched)
        self._patched.append((owner, attr, original))

    def _patch_call(self, target, plan):
        injector = self

        def make(original, plan_):
            def patched(*a, **kw):
                if injector._take_call(plan_):
                    injector._act(plan_, target)
                return original(*a, **kw)
            return patched

        self._patch(*_resolve_owner(target), plan, make)

    # -- file plans: matching and actions ---------------------------------

    def _take(self, path, op, pending=None):
        """Claim the first live plan matching ``(path, op)``; a write
        plan only once its byte threshold is reached."""
        with self._lock:
            for plan in self.plans:
                if plan.fired >= plan.times or plan.op != op:
                    continue
                if plan.match not in path:
                    continue
                if (op == "write" and pending is not None
                        and pending <= plan.after_bytes):
                    continue
                plan.fired += 1
                return plan
        return None

    def _act(self, plan, path):
        if plan.action == "crash":
            os._exit(41)
        if plan.action == "sigterm":
            os.kill(os.getpid(), _signal.SIGTERM)
            return
        if plan.action == "pause":
            if plan.marker:
                with self._real_open(plan.marker, "w") as m:
                    m.write(path)
            while True:
                time.sleep(60)
        raise OSError(plan.errno,
                      f"fault injected ({plan.op} -> {plan.action})", path)

    def _open(self, file, mode="r", *args, **kwargs):
        path = None
        if isinstance(file, (str, bytes, os.PathLike)):
            path = os.fsdecode(os.fspath(file))
        if path is not None:
            plan = self._take(path, "open")
            if plan is not None:
                self._act(plan, path)
        f = self._real_open(file, mode, *args, **kwargs)
        if path is not None and any(
                p.op in ("write", "read") and p.fired < p.times
                and p.match in path for p in self.plans):
            return _FaultFile(f, path, self)
        return f

    def _rename_like(self, real):
        def patched(src, dst, **kwargs):
            for p in (src, dst):
                sp = os.fsdecode(os.fspath(p))
                plan = self._take(sp, "rename")
                if plan is not None:
                    self._act(plan, sp)
            return real(src, dst, **kwargs)
        return patched

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
                         FaultPlan(f"poison_request:{rid}", op="call",
                                   times=times), make)

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
                         FaultPlan(f"wedge_slot:{slot_i}", op="call",
                                   times=times), make)

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
                         FaultPlan("leak_pages", op="call", times=times),
                         make)

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

        return self._arm(("step",), FaultPlan(f"kill_replica:{rid}",
                                              op="call", times=times,
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
                                              op="call", times=times),
                         make)

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
                                              op="call", times=times),
                         make)

    # -- worker-process plans: real signals and a lossy wire ------------

    def _arm_proc(self, plan, make_patched):
        self.plans.append(plan)
        self._proc_targets.append((plan, make_patched))
        if self._installed:
            self._patch(_proc_replica_cls(), "_step_rpc", plan,
                        make_patched)
        return plan

    def _signal_worker(self, replica_id, times, after_steps, sig, kind):
        rid = int(replica_id)
        injector = self

        def make(original, plan):
            def patched(rep, *a, **kw):
                if rep.id == rid and injector._take_call(plan) \
                        and rep.worker_pid:
                    try:
                        os.kill(rep.worker_pid, sig)
                        if sig == _signal.SIGSTOP:
                            injector._paused_pids.add(rep.worker_pid)
                    except (ProcessLookupError, OSError):
                        pass
                return original(rep, *a, **kw)
            return patched

        return self._arm_proc(FaultPlan(f"{kind}:{rid}", op="call",
                                        times=times,
                                        after_calls=after_steps), make)

    def kill_worker(self, replica_id, times=1, after_steps=0):
        """Real worker death: an actual SIGKILL to the chosen replica's
        worker right before one of its step RPCs. The parent sees
        waitpid/EOF, salvages from its shadow and respawns under the
        restart budget (past it, the breaker opens). ``after_steps``
        counts only the chosen replica's step RPCs."""
        return self._signal_worker(replica_id, times, after_steps,
                                   _signal.SIGKILL, "kill_worker")

    def pause_worker(self, replica_id, times=1, after_steps=0):
        """A hung worker: SIGSTOP the chosen replica's worker. Heartbeats
        stop but the process is not dead, so the parent must classify it
        as hung by heartbeat timeout (SIGTERM with grace, then SIGKILL;
        a wedge ejection, never the breaker). A pid still stopped gets a
        SIGCONT at :meth:`uninstall`."""
        return self._signal_worker(replica_id, times, after_steps,
                                   _signal.SIGSTOP, "pause_worker")

    def _add_wire_hook(self, hook):
        from ..inference import wire as _wire
        _wire.add_fault_hook(hook)
        self._active_wire_hooks.append(hook)

    def _wire_plan(self, kind, replica_id, times, direction, after_frames,
                   act):
        if direction not in ("rx", "tx"):
            raise ValueError(f"unknown wire direction {direction!r}")
        plan = FaultPlan(f"{kind}:{replica_id}", op="call", times=times,
                         after_calls=after_frames)
        self.plans.append(plan)
        rid = int(replica_id)
        injector = self

        def hook(hook_rid, hook_dir, data):
            if hook_rid != rid or hook_dir != direction \
                    or not injector._take_call(plan):
                return data
            return act(data)

        self._wire_hooks.append(hook)
        if self._installed:
            self._add_wire_hook(hook)
        return plan

    def drop_frame(self, replica_id, times=1, direction="rx",
                   after_frames=0):
        """A lossy wire: the matching transport chunk vanishes (a sent
        frame never leaves with ``direction="tx"``, a received chunk
        never arrives with ``"rx"``). The RPC deadline and bounded
        retransmit must absorb it; the worker's reply cache keeps the
        retransmit exactly-once."""
        return self._wire_plan("drop_frame", replica_id, times, direction,
                               after_frames, lambda data: None)

    def delay_frame(self, replica_id, delay_s=0.05, times=1,
                    direction="rx", after_frames=0):
        """A slow wire: the matching chunk is held ``delay_s`` before
        delivery (the RPC deadline and backoff path, no bytes lost)."""
        delay = float(delay_s)

        def act(data):
            time.sleep(delay)
            return data

        return self._wire_plan("delay_frame", replica_id, times, direction,
                               after_frames, act)

    def corrupt_frame(self, replica_id, times=1, direction="rx",
                      after_frames=0):
        """A corrupt wire: one byte in the middle of the matching chunk is
        flipped. The decoder must raise a typed ``WireError`` (bad magic
        or crc), resync, and the RPC layer retransmit: never a hang, never
        a half-applied message."""
        def act(data):
            if not data:
                return data
            buf = bytearray(data)
            buf[len(buf) // 2] ^= 0xFF
            return bytes(buf)

        return self._wire_plan("corrupt_frame", replica_id, times,
                               direction, after_frames, act)

    def install(self):
        if self._installed:
            return self
        self._real_open = builtins.open
        self._real_replace = os.replace
        self._real_rename = os.rename
        builtins.open = self._open
        os.replace = self._rename_like(self._real_replace)
        os.rename = self._rename_like(self._real_rename)
        self._installed = True
        for target, plan in self._call_targets:
            self._patch_call(target, plan)
        for method, plan, make in self._targets:
            self._patch(ContinuousBatchingEngine, method, plan, make)
        for plan, make in self._proc_targets:
            self._patch(_proc_replica_cls(), "_step_rpc", plan, make)
        for hook in self._wire_hooks:
            if hook not in self._active_wire_hooks:
                self._add_wire_hook(hook)
        return self

    def uninstall(self):
        if not self._installed:
            return
        builtins.open = self._real_open
        os.replace = self._real_replace
        os.rename = self._real_rename
        while self._patched:
            owner, attr, original = self._patched.pop()
            setattr(owner, attr, original)
        if self._active_wire_hooks:
            from ..inference import wire as _wire
            while self._active_wire_hooks:
                _wire.remove_fault_hook(self._active_wire_hooks.pop())
        while self._paused_pids:
            try:
                os.kill(self._paused_pids.pop(), _signal.SIGCONT)
            except (ProcessLookupError, OSError):
                pass
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


def _proc_replica_cls():
    from ..inference.proc_replica import ProcReplica
    return ProcReplica


def _resolve_owner(dotted):
    """``(owner, attr)`` of a dotted target: the longest importable module
    prefix, then attributes (``Class.method`` works)."""
    parts = dotted.split(".")
    mod = rest = None
    for i in range(len(parts) - 1, 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:i]))
            rest = parts[i:]
            break
        except ImportError:
            continue
    if mod is None or not rest:
        raise ValueError(f"cannot resolve fault target {dotted!r}")
    owner = mod
    for p in rest[:-1]:
        owner = getattr(owner, p)
    if not hasattr(owner, rest[-1]):
        raise ValueError(f"fault target {dotted!r}: {owner!r} has no "
                         f"attribute {rest[-1]!r}")
    return owner, rest[-1]
