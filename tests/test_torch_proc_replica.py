"""The port's process-backed replica (paddle_tpu_torch.inference.
proc_replica) on the contracts of tests/test_proc_replica.py.

The hermetic cases run as the JAX tests do: a ``_FakeProc`` drives the
port's real ``Worker`` protocol loop (serve, the reply cache, the
incremental harvest, the metrics diff) in a thread over a real
socketpair, with a small deterministic fake engine, through the
``spec["_spawn_fn"]`` seam: admit/step mirroring, shadow salvage and
respawn replay, the restart budget, retransmit dedup, hung by
heartbeat, corrupt-wire recovery, and the ServingFleet router over
``replica_cls=ProcReplica`` (failover, hung ejection, drain).

The real-process cases boot ``python -m paddle_tpu_torch.inference.
worker`` on the CPU (``device="cpu"``): greedy streams across the
process boundary equal an in-process engine's over the same seeded
factory, through a real SIGKILL and respawn, through a breaker opened by
``kill_worker`` with dropped, delayed and corrupted frames on the
survivors (equal to the in-process fleet's streams through
``kill_replica``), and a SIGSTOP (``pause_worker``) is classified as
hung and ejected as wedged. Streams are compared exactly. Every spawn is
bounded by the replica's own ``init_deadline_s``; the workers run at one
torch thread (``OMP_NUM_THREADS=1``), as the parent does."""

import threading
import time

import numpy as np
import pytest

import dataclasses
import os

import torch

from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        ProcReplica, ReplicaFailed,
                                        ServingFleet)
from paddle_tpu_torch.inference.serving import ServedRequest
from paddle_tpu_torch.inference.wire import (WireClosed, WireTransport,
                                             socketpair)
from paddle_tpu_torch.inference.worker import Worker
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.profiler.metrics import MetricsRegistry
from paddle_tpu_torch.testing import FaultInjector

pytestmark = pytest.mark.proc_fleet


# ---- the hermetic worker ---------------------------------------------------

class _FakeEngine:
    """Deterministic engine stand-in: each step admits queue → slots
    and emits token ``1000 + rid*97 + position`` per running request,
    finishing at ``max_new_tokens``. Page accounting is simulated just
    enough for the audit op."""

    def __init__(self, num_slots=2, page_size=8, max_len=64):
        self.metrics = MetricsRegistry()
        self.num_slots = num_slots
        self.page_size = page_size
        self.max_len = max_len
        self.decode_chunk = 1
        self.num_pages = 9
        self.queue = []
        self.slot_req = [None] * num_slots
        self._free_pages = list(range(self.num_pages - 1))
        self._deferred_free = []
        self.slot_pages = [[] for _ in range(num_slots)]
        self.slot_shared = [[] for _ in range(num_slots)]
        self.prefix_cache_pages = 0
        self.steps = 0

    def requeue(self, req):
        if req.finished:
            return
        self.queue.append(req)

    def step(self):
        self.steps += 1
        self.metrics.counter("serving/unified_steps").inc()
        for i in range(self.num_slots):
            if self.slot_req[i] is None and self.queue:
                self.slot_req[i] = self.queue.pop(0)
        finished = []
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            if r.cancelled:
                r.finished = True
                r.finish_reason = "cancelled"
                r.t_done = time.perf_counter()
                finished.append(r)
                self.slot_req[i] = None
                continue
            if not r.t_first:
                r.t_first = time.perf_counter()
            r.tokens.append(1000 + r.request_id * 97 + len(r.tokens))
            self.metrics.counter("serving/tokens_emitted").inc()
            if len(r.tokens) >= r.max_new_tokens:
                r.finished = True
                r.finish_reason = "length"
                r.t_done = time.perf_counter()
                self.metrics.counter(
                    "serving/requests_completed").inc()
                finished.append(r)
                self.slot_req[i] = None
        return finished

    def cancel(self, rid):
        for r in self.queue + self.slot_req:
            if r is not None and r.request_id == rid \
                    and not r.finished:
                r.cancelled = True
                return True
        return False

    def handoff(self):
        out = [r for r in self.queue if not r.finished]
        out += [r for r in self.slot_req
                if r is not None and not r.finished]
        self.queue = []
        self.slot_req = [None] * self.num_slots
        return out

    def reset_gauges(self):
        pass

    def gauges(self):
        return {"steps": self.steps}


def _expected_tokens(rid, n_new):
    return [1000 + rid * 97 + k for k in range(n_new)]


class _FakeWorker(Worker):
    """Real protocol loop; only ``init`` is replaced (no dotted
    factory — the engine comes from the test)."""

    def __init__(self, transport, engine_factory, proc):
        super().__init__(transport)
        self._engine_factory = engine_factory
        self._proc = proc

    def _handle(self, op, msg):
        while self._proc._paused.is_set() \
                and not self._proc._killed.is_set():
            time.sleep(0.002)            # SIGSTOP: silent, not dead
        if self._proc._killed.is_set():
            raise WireClosed("killed")
        if op == "init":
            self.engine = self._engine_factory()
            eng = self.engine
            return {"pid": self._proc.pid,
                    "geom": {"num_slots": eng.num_slots,
                             "page_size": eng.page_size,
                             "max_len": eng.max_len,
                             "decode_chunk": eng.decode_chunk,
                             "num_pages": eng.num_pages}}
        return super()._handle(op, msg)


class _FakeProc:
    """Process façade over a worker thread: pid/poll/terminate/kill/
    wait, plus pause() to model SIGSTOP (heartbeats and replies stop,
    the 'process' stays alive)."""

    _pid_counter = [900_000_001]

    def __init__(self, engine_factory, hb_interval=0.02):
        self.pid = self._pid_counter[0]
        self._pid_counter[0] += 1
        self.returncode = None
        self._paused = threading.Event()
        self._killed = threading.Event()
        self._stop_hb = threading.Event()
        self.parent_sock, worker_sock = socketpair()
        self._tr = WireTransport(worker_sock, side="worker")
        self.worker = _FakeWorker(self._tr, engine_factory, self)
        self._hb = threading.Thread(
            target=self._hb_loop, args=(hb_interval,), daemon=True)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._hb.start()
        self._thread.start()

    def _hb_loop(self, interval):
        while not self._stop_hb.wait(interval):
            if self._paused.is_set():
                continue
            try:
                self._tr.send({"kind": "hb",
                               "t": time.perf_counter()})
            except Exception:  # noqa: BLE001 — transport torn down
                return

    def _run(self):
        try:
            self.worker.serve()
        except Exception:  # noqa: BLE001 — fatal contract
            self.returncode = 1
        else:
            if self.returncode is None:
                self.returncode = 0
        self._stop_hb.set()
        self._tr.close()

    def pause(self):
        self._paused.set()

    def resume(self):
        self._paused.clear()

    # -- subprocess.Popen façade --------------------------------------

    def poll(self):
        return self.returncode

    def terminate(self):
        self.kill()

    def kill(self):
        if self.returncode is None:
            self.returncode = -9
        self._killed.set()
        self._paused.clear()
        self._stop_hb.set()
        self._tr.close()

    def wait(self, timeout=None):
        self._thread.join(timeout)
        return self.returncode


class _Spawner:
    """``spec["_spawn_fn"]``: builds a fresh _FakeProc per (re)spawn
    and remembers them so tests can kill/pause a specific
    incarnation."""

    def __init__(self, engine_factory=None):
        self.engine_factory = engine_factory or _FakeEngine
        self.procs = []

    def __call__(self, replica):
        p = _FakeProc(self.engine_factory)
        self.procs.append(p)
        return p, p.parent_sock

    def spec(self):
        return {"_spawn_fn": self}


def _replica(spawner=None, **kw):
    spawner = spawner or _Spawner()
    kw.setdefault("rpc_deadline_s", 0.1)
    kw.setdefault("hb_timeout_s", 0.25)
    kw.setdefault("term_grace_s", 0.05)
    kw.setdefault("respawn_backoff_s", 0.001)
    rep = ProcReplica(0, spawner.spec(), **kw)
    return rep, spawner


def _submit(rep, rid, n_new=4, prompt_len=3):
    req = ServedRequest(rid, np.arange(prompt_len, dtype=np.int32),
                        n_new, None)
    req.t_arrive = time.perf_counter()
    rep.admission.admit(req)
    return req


def _run(rep, reqs, max_steps=200):
    done = []
    for _ in range(max_steps):
        done.extend(rep.step())
        if all(r.finished for r in reqs):
            return done
    raise AssertionError("requests did not complete")


# ---- happy path ------------------------------------------------------------

def test_admit_step_mirror_and_complete():
    rep, sp = _replica()
    try:
        reqs = [_submit(rep, i, n_new=3 + i) for i in range(3)]
        done = _run(rep, reqs)
        assert sorted(r.request_id for r in done) == [0, 1, 2]
        for r in reqs:
            # the PARENT's objects carry the tokens (the shadow
            # mirror), exactly the deterministic stream
            assert r.tokens == _expected_tokens(r.request_id,
                                                r.max_new_tokens)
            assert r.finish_reason == "length"
            assert r.t_first and r.t_done
        # occupancy restated from the worker's truth
        assert rep.engine.queue == []
        assert all(s is None for s in rep.engine.slot_req)
        assert not rep.engine.has_work()
        # worker-side registry diff landed in the shadow registry
        reg = rep.engine.metrics
        assert reg.counter("serving/tokens_emitted").value \
            == sum(r.max_new_tokens for r in reqs)
        assert rep.engine.gauges().get("steps", 0) > 0
        assert rep.respawns == 0
    finally:
        rep.close()


def test_clock_offset_maps_worker_times():
    rep, sp = _replica()
    try:
        req = _submit(rep, 0, n_new=2)
        t0 = time.perf_counter()
        _run(rep, [req])
        t1 = time.perf_counter()
        # worker timestamps arrive translated into the parent's
        # perf_counter domain (same process here, so the offset is
        # ~0 and the times must bracket)
        assert t0 - 0.5 <= req.t_first <= t1 + 0.5
        assert t0 - 0.5 <= req.t_done <= t1 + 0.5
    finally:
        rep.close()


def test_audit_roundtrip():
    rep, sp = _replica()
    try:
        v = rep.audit()
        assert v["clean"] is True
        assert v["free"] == 8
    finally:
        rep.close()


def test_cancel_rpc():
    rep, sp = _replica()
    try:
        reqs = [_submit(rep, i, n_new=8) for i in range(2)]
        rep.step()
        rep.supervisor.cancel(1)
        done = _run(rep, reqs)
        by = {r.request_id: r for r in done}
        assert by[1].finish_reason == "cancelled"
        assert by[0].tokens == _expected_tokens(0, 8)
    finally:
        rep.close()


# ---- dead: salvage from shadow + respawn replay ----------------------------

def test_worker_death_respawns_and_replays_continuously():
    rep, sp = _replica(max_restarts=2)
    try:
        reqs = [_submit(rep, i, n_new=6) for i in range(3)]
        for _ in range(2):
            rep.step()
        mid = [list(r.tokens) for r in reqs]
        assert any(mid), "no progress before the kill"
        sp.procs[-1].kill()              # the corpse answers nothing
        done = _run(rep, reqs)
        assert rep.respawns == 1
        assert len(sp.procs) == 2
        # exactly-once, and the stream CONTINUED where the shadow had
        # it: full deterministic token identity after replay
        assert sorted(r.request_id for r in done) == [0, 1, 2]
        for r in reqs:
            assert r.tokens == _expected_tokens(r.request_id, 6), \
                (r.request_id, mid)
            assert any(h.get("kind") == "respawn" for h in r.hops)
        reg = rep.engine.metrics
        assert reg.counter("proc/respawns").value == 1
        assert reg.counter("proc/spawns").value == 2
    finally:
        rep.close()


def test_respawn_budget_exhausted_raises_for_breaker():
    rep, sp = _replica(max_restarts=0)
    try:
        _submit(rep, 0, n_new=4)
        sp.procs[-1].kill()
        with pytest.raises(ReplicaFailed):
            rep.step()
        assert rep.respawns == 0          # budget checked BEFORE spend
    finally:
        rep.close()


def test_admit_to_dead_worker_respawns_then_admits():
    rep, sp = _replica(max_restarts=1)
    try:
        sp.procs[-1].kill()
        req = _submit(rep, 0, n_new=3)    # admit rides the respawn
        assert rep.respawns == 1
        done = _run(rep, [req])
        assert done[0].tokens == _expected_tokens(0, 3)
    finally:
        rep.close()


def test_death_mid_replay_loses_no_salvage():
    """A respawned worker that dies PARTWAY through the replay must
    not shrink the salvage set: the next lap (and a budget-spent
    raise) must still carry every unfinished request, not just the
    ones re-admitted before the second death."""
    rep, sp = _replica(max_restarts=3)
    try:
        reqs = [_submit(rep, i, n_new=4) for i in range(3)]
        rep.step()                        # 2 in slots, 1 queued
        orig = rep._rpc_checked
        state = {"armed": False, "admits": 0}

        def wrapper(op, payload, **kw):
            if op == "admit" and state["armed"]:
                state["admits"] += 1
                if state["admits"] == 2:
                    state["armed"] = False
                    sp.procs[-1].kill()   # die mid-replay, after req 1
            return orig(op, payload, **kw)

        rep._rpc_checked = wrapper
        state["armed"] = True
        sp.procs[-1].kill()               # first death → replay lap 1
        done = _run(rep, reqs)
        assert rep.respawns == 2
        assert sorted(r.request_id for r in done) == [0, 1, 2]
        for r in reqs:
            assert r.tokens == _expected_tokens(r.request_id, 4)
    finally:
        rep.close()


# ---- hung: heartbeat classification (wedge, not breaker) -------------------

def test_paused_worker_is_hung_not_dead():
    rep, sp = _replica(hb_timeout_s=0.15)
    try:
        reqs = [_submit(rep, 0, n_new=8)]
        rep.step()
        sp.procs[-1].pause()             # SIGSTOP shape: alive, silent
        out = rep.step()                 # classifies hung, returns []
        assert out == []
        assert rep.wedged(25)            # fleet ejects via HEALTH
        reg = rep.engine.metrics
        assert reg.counter("proc/heartbeat_misses").value == 1
        assert rep.respawns == 0         # hung is NOT the respawn path
        # the hung corpse was SIGKILLed (fake: returncode set)
        assert sp.procs[-1].poll() is not None
        del reqs
    finally:
        rep.close()


def test_slow_reply_with_heartbeats_is_not_hung():
    rep, sp = _replica(rpc_deadline_s=0.02, rpc_retries=2,
                       rpc_hard_deadline_s=5.0)
    try:
        # delay every reply beyond the soft deadline: retransmits
        # fire (deduped by the worker's reply cache), heartbeats keep
        # flowing, and the RPC eventually lands — no hung declaration
        orig = _FakeWorker._handle

        def slow(self, op, msg):
            if op == "step":
                time.sleep(0.06)
            return orig(self, op, msg)

        _FakeWorker._handle = slow
        try:
            reqs = [_submit(rep, 0, n_new=2)]
            done = _run(rep, reqs, max_steps=20)
        finally:
            _FakeWorker._handle = orig
        assert done[0].tokens == _expected_tokens(0, 2)
        assert not rep._hung
        reg = rep.engine.metrics
        assert reg.counter("proc/rpc_retries").value >= 1
    finally:
        rep.close()


# ---- lossy: FaultInjector wire plans ---------------------------------------

def test_dropped_rpc_frame_retransmits_exactly_once():
    rep, sp = _replica(rpc_deadline_s=0.05)
    try:
        req = _submit(rep, 0, n_new=5)
        with FaultInjector() as fi:
            fi.drop_frame(0, times=2, direction="tx")
            done = _run(rep, [req])
            assert fi.fires() == 2
        # the dropped step RPCs were retransmitted and applied ONCE:
        # token stream is exact (a double-applied step would overshoot
        # or duplicate positions)
        assert done[0].tokens == _expected_tokens(0, 5)
        assert rep.engine.metrics.counter(
            "proc/rpc_retries").value >= 2
        assert rep.respawns == 0
    finally:
        rep.close()


def test_corrupt_rx_frame_typed_error_then_recovery():
    rep, sp = _replica(rpc_deadline_s=0.05)
    try:
        req = _submit(rep, 0, n_new=5)
        with FaultInjector() as fi:
            fi.corrupt_frame(0, times=3, direction="rx")
            done = _run(rep, [req])
            assert fi.fires() == 3
        assert done[0].tokens == _expected_tokens(0, 5)
        assert rep.engine.metrics.counter("wire/errors").value >= 1
        assert rep.respawns == 0          # lossy ≠ dead
        assert not rep._hung              # lossy ≠ hung
    finally:
        rep.close()


def test_delayed_frames_only_slow_things_down():
    rep, sp = _replica(rpc_deadline_s=0.05)
    try:
        req = _submit(rep, 0, n_new=3)
        with FaultInjector() as fi:
            fi.delay_frame(0, delay_s=0.08, times=2, direction="rx")
            done = _run(rep, [req])
        assert done[0].tokens == _expected_tokens(0, 3)
        assert rep.respawns == 0 and not rep._hung
    finally:
        rep.close()


# ---- the fleet router over ProcReplica -------------------------------------

def test_fleet_router_over_proc_replicas_failover():
    """The hermetic acceptance shape: a 2-replica process-backed
    fleet, one worker killed hard enough to spend its budget — the
    router fails the shadow over to the sibling, exactly-once, token
    streams deterministic, breaker accounted."""
    spawners = {0: _Spawner(), 1: _Spawner()}
    fleet = ServingFleet(
        lambda: None, num_replicas=0, retry_backoff_s=0.001,
        replica_cls=ProcReplica,
        replica_kwargs=dict(rpc_deadline_s=0.1, hb_timeout_s=0.3,
                            term_grace_s=0.05,
                            respawn_backoff_s=0.001, max_queue=64))
    # hand-add replicas so each gets its own spawner identity
    for i in (0, 1):
        fleet._add_replica(spawners[i].spec())
    assert sorted(fleet.replicas) == [0, 1]
    fids = [fleet.submit(np.arange(3, dtype=np.int32), 4)
            for _ in range(8)]

    # kill replica 1's worker at EVERY step (the fi.kill_worker
    # shape, deterministic): each incarnation dies, the budget (2)
    # spends, the breaker opens, everything lands on replica 0
    rep1 = fleet.replicas[1]
    orig_step = rep1._step_rpc

    def dying_step():
        spawners[1].procs[-1].kill()
        return orig_step()

    rep1._step_rpc = dying_step
    done = fleet.run()
    assert sorted(r.request_id for r in done) == sorted(fids)
    by = {r.request_id: r for r in done}
    for fid in fids:
        assert by[fid].error is None
        assert by[fid].finish_reason == "length"
    g = fleet.gauges()
    assert g["completed"] == len(fids)
    assert fleet.replicas[1].state == "ejected"
    assert fleet.replicas[1].eject_kind == "breaker"
    assert g["breaker_open"] == 1
    # survivor audit across the seam
    assert fleet.replicas[0].audit()["clean"]
    fleet.close()
    # close() reaped every incarnation
    for sp in spawners.values():
        assert all(p.poll() is not None for p in sp.procs)


def test_fleet_ejects_hung_proc_replica_via_health_not_breaker():
    spawners = {0: _Spawner(), 1: _Spawner()}
    fleet = ServingFleet(
        lambda: None, num_replicas=0, retry_backoff_s=0.001,
        no_progress_turns=5, replica_cls=ProcReplica,
        replica_kwargs=dict(rpc_deadline_s=0.1, hb_timeout_s=0.15,
                            term_grace_s=0.05,
                            respawn_backoff_s=0.001))
    for i in (0, 1):
        fleet._add_replica(spawners[i].spec())
    fids = [fleet.submit(np.arange(3, dtype=np.int32), 4)
            for _ in range(6)]
    # let work spread, then freeze replica 1's worker (SIGSTOP shape)
    fleet.step()
    spawners[1].procs[-1].pause()
    done = fleet.run()
    assert sorted(r.request_id for r in done) == sorted(fids)
    assert all(r.error is None for r in done)
    g = fleet.gauges()
    assert g["wedge_ejections"] == 1
    assert g["breaker_open"] == 0        # heartbeat path, NOT breaker
    assert fleet.replicas[1].eject_kind == "wedge"
    fleet.close()


@pytest.mark.parametrize("kill_mid_drain", [False, True])
def test_scale_down_drain_handoff_exactly_once(kill_mid_drain):
    """Drain-based ``scale_down`` composes with
    process-backed replicas. The drain deadline fires ``handoff()``
    over the crc-framed wire; with ``kill_mid_drain`` the worker is
    SIGKILLed between drain-begin and the handoff rpc, so the salvage
    comes from the parent-side shadow (or a respawn replay) instead.
    Either way: every request completes exactly once, token streams
    stay deterministic, the replica RETIRES (never ejects), and the
    survivor's page audit is green."""
    spawners = {0: _Spawner(), 1: _Spawner()}
    fleet = ServingFleet(
        lambda: None, num_replicas=0, retry_backoff_s=0.001,
        replica_cls=ProcReplica,
        replica_kwargs=dict(rpc_deadline_s=0.1, hb_timeout_s=0.3,
                            term_grace_s=0.05,
                            respawn_backoff_s=0.001, max_queue=64))
    for i in (0, 1):
        fleet._add_replica(spawners[i].spec())
    fids = [fleet.submit(np.arange(3, dtype=np.int32), 6)
            for _ in range(8)]
    fleet.step()                      # work spreads, tokens flow
    assert fleet.replicas[1].has_work()
    fleet.scale_down(replica_id=1, deadline_s=0.0)
    if kill_mid_drain:
        spawners[1].procs[-1].kill()
    done = fleet.run()
    # exactly-once: no lost, no duplicated completions
    assert sorted(r.request_id for r in done) == sorted(fids)
    by = {r.request_id: r for r in done}
    for fid in fids:
        assert by[fid].error is None, by[fid].error
        assert by[fid].tokens == _expected_tokens(fid, 6), fid
    assert fleet.replicas[1].state == "retired"
    assert fleet.gauges()["breaker_open"] == 0
    assert fleet.metrics.counter("fleet/drains").value == 1
    assert fleet.replicas[0].audit()["clean"]
    fleet.close()
    for sp in spawners.values():
        assert all(p.poll() is not None for p in sp.procs)



# ---- real worker processes on the CPU ----------------------------------------

EKW = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
           prompt_buckets=(8, 16), greedy=True)
SPEC = {"factory": "paddle_tpu_torch.inference.worker:llama_engine",
        "kwargs": dict(model="tiny", num_hidden_layers=1, seed=0,
                       device="cpu", **EKW)}
#: real-worker deadlines: a spawn is bounded by init_deadline_s, an RPC
#: by rpc_hard_deadline_s (the repo runs no pytest-timeout)
REAL = dict(init_deadline_s=120.0, rpc_hard_deadline_s=60.0,
            hb_timeout_s=5.0, respawn_backoff_s=0.01)

torch.set_num_threads(1)


@pytest.fixture
def one_thread(monkeypatch):
    """The workers' torch runs at one thread, as this process's does."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def ref_model():
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=1,
                              scan_layers=False)
    m = LlamaForCausalLM(cfg, device="cpu", seed=0)
    m.eval()
    return m


def _ref_engine(m):
    return ContinuousBatchingEngine(m, device="cpu", **EKW)


def _real_specs(vocab, n, seed=5, lo=4, hi=12, new=(3, 7)):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (int(rng.randint(lo, hi)),))
             .astype(np.int32), int(rng.randint(*new))) for _ in range(n)]


def test_real_worker_token_identity_and_sigkill_respawn(ref_model,
                                                       one_thread):
    """One real worker: streams across the process boundary equal an
    in-process engine's, and a real SIGKILL mid-decode salvages from the
    shadow, respawns and finishes the same streams exactly once."""
    import signal as _sig
    specs = _real_specs(ref_model.config.vocab_size, 4, new=(5, 6))
    ref_eng = _ref_engine(ref_model)
    for p, n in specs:
        ref_eng.add_request(p, n)
    ref_tokens = {r.request_id: r.tokens for r in ref_eng.run()}
    rep = ProcReplica(0, SPEC, max_restarts=2, **REAL)
    try:
        reqs = []
        for i, (p, n) in enumerate(specs):
            req = ServedRequest(i, p, n, None)
            req.t_arrive = time.perf_counter()
            rep.admission.admit(req)
            reqs.append(req)
        assert rep.worker_device == "cpu"
        done = []
        for _ in range(2):
            done.extend(rep.step())
        pid = rep.worker_pid
        os.kill(pid, _sig.SIGKILL)
        for _ in range(400):
            done.extend(rep.step())
            if all(r.finished for r in reqs):
                break
        assert rep.respawns == 1 and rep.worker_pid != pid
        assert sorted(r.request_id for r in done) == [0, 1, 2, 3]
        for r in reqs:
            assert r.error is None
            assert r.tokens == ref_tokens[r.request_id], r.request_id
        audit = rep.audit()
        assert audit["clean"] and audit["forwards"] > 0
        # the CPU path takes the plain versions: no kernel launched
        assert set(audit["launches"].values()) == {0}
        reg = rep.engine.metrics
        assert reg.counter("proc/respawns").value == 1
        assert reg.counter("proc/spawns").value == 2
        assert reg.histogram("proc/rpc_ms").count > 0
        assert reg.gauge("proc/worker_rss_bytes").value > 0
        assert len(rep.spawn_ready_s) == 2
    finally:
        rep.close()


def _fleet_streams(fleet, specs, plant):
    with FaultInjector() as fi:
        plant(fi)
        fids = [fleet.submit(p, n) for p, n in specs]
        done = fleet.run()
    by = {}
    for r in done:
        assert r.request_id not in by, "delivered twice"
        by[r.request_id] = r
    assert sorted(by) == sorted(fids)
    assert all(by[f].error is None for f in fids)
    return [by[f].tokens for f in fids], fi


def test_real_fleet_equals_inprocess_fleet_through_faults(ref_model,
                                                          one_thread):
    """Two real workers behind the router: replica 1's worker is
    SIGKILLed until its budget is spent and its breaker opens, while
    replica 0's wire drops, delays and corrupts frames. Every fleet id
    is delivered once and the streams equal the in-process fleet's
    through ``kill_replica`` over the same seeded factory (and the
    uncontended engine's)."""
    specs = _real_specs(ref_model.config.vocab_size, 8, seed=11)
    ref_eng = _ref_engine(ref_model)
    ids = [ref_eng.add_request(p, n) for p, n in specs]
    by = {r.request_id: r for r in ref_eng.run()}
    single = [by[i].tokens for i in ids]

    inproc = ServingFleet(lambda: _ref_engine(ref_model), num_replicas=2,
                          max_restarts=1, retry_backoff_s=0.001,
                          hedge_delay_s=1e9)
    want, _ = _fleet_streams(
        inproc, specs,
        lambda fi: fi.kill_replica(1, times=10_000, after_steps=1))
    fleet = ServingFleet(SPEC, num_replicas=2, max_restarts=1,
                         retry_backoff_s=0.001, hedge_delay_s=1e9,
                         replica_cls=ProcReplica,
                         replica_kwargs=dict(REAL, rpc_deadline_s=0.2))
    try:
        got, fi = _fleet_streams(fleet, specs, lambda fi: (
            fi.kill_worker(1, times=2, after_steps=1),
            fi.drop_frame(0, times=2, direction="tx", after_frames=4),
            fi.delay_frame(0, delay_s=0.05, times=2, after_frames=6),
            fi.corrupt_frame(0, times=2, direction="rx", after_frames=8)))
        assert all(p.fired == p.times for p in fi.plans), fi.plans
        g = fleet.gauges()
        assert fleet.replicas[1].eject_kind == "breaker"
        assert g["breaker_open"] == 1
        rep0 = fleet.replicas[0]
        assert rep0.respawns == 0 and not rep0._hung
        reg = rep0.engine.metrics
        assert reg.counter("wire/errors").value >= 1
        assert reg.counter("proc/rpc_retries").value >= 2
        assert rep0.audit()["clean"]
    finally:
        fleet.close()
    assert got == want == single


def test_real_paused_worker_is_hung_and_ejected_as_wedged(ref_model,
                                                         one_thread):
    """A real SIGSTOP: heartbeats stop, the parent classifies the worker
    as hung (SIGTERM, then SIGKILL) and the fleet ejects it as wedged,
    never through the breaker; its requests finish on the sibling with
    the in-process engine's streams. The injector's uninstall sends the
    owed SIGCONT."""
    specs = _real_specs(ref_model.config.vocab_size, 6, seed=13)
    ref_eng = _ref_engine(ref_model)
    ids = [ref_eng.add_request(p, n) for p, n in specs]
    by = {r.request_id: r for r in ref_eng.run()}
    single = [by[i].tokens for i in ids]
    fleet = ServingFleet(SPEC, num_replicas=2, max_restarts=1,
                         retry_backoff_s=0.001, hedge_delay_s=1e9,
                         no_progress_turns=5, replica_cls=ProcReplica,
                         replica_kwargs=dict(REAL, hb_timeout_s=1.0,
                                             term_grace_s=0.2))
    try:
        got, fi = _fleet_streams(
            fleet, specs, lambda fi: fi.pause_worker(1, after_steps=1))
        assert fi.fires() == 1
        g = fleet.gauges()
        assert fleet.replicas[1].eject_kind == "wedge"
        assert g["wedge_ejections"] == 1 and g["breaker_open"] == 0
        assert fleet.replicas[1].engine.metrics.counter(
            "proc/heartbeat_misses").value == 1
        assert fleet.replicas[1]._proc.poll() is not None
    finally:
        fleet.close()
    assert got == single
