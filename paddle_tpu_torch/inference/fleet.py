"""Fault-tolerant multi-replica serving fleet: the port of
``paddle_tpu/inference/fleet.py``.

N engines behind a router, where a dead, wedged or merely slow replica
degrades the fleet gracefully. Outside in:

- :class:`ServingFleet` owns N :class:`FleetReplica` handles and the
  router. Dispatch is least-loaded (outstanding generation work per
  slot), then a prefix-affinity hint (the replica that last served the
  same first-page prefix, whose cache is warm), then the
  ``serving/ttft_ms`` p99, then the id. Admission per replica rides the
  :class:`~.reliability.AdmissionController`; when every ready replica
  sheds, the fleet raises :class:`~.reliability.Overloaded` with the
  largest of their retry-afters, and its own retries wait at least that
  long.
- Health has two checks. Liveness rides the flight-recorder watchdog:
  ``run()`` arms it and beats once a fleet turn, so a replica step that
  hangs stops the beats and dumps a bundle. Progress is the fleet's own
  check: a replica whose steps return but whose observable state
  (tokens, completions, admissions, queue, occupancy, restarts) has not
  moved for ``no_progress_turns`` turns while it has work is wedged,
  ejected, and its requests go to siblings.
- Failover: a replica's death inside its step is absorbed by its
  :class:`~.reliability.EngineSupervisor` (salvage, rebuild, replay).
  Past ``max_restarts`` the failure escapes and the fleet opens the
  replica's circuit breaker: the replica is ejected, its queue and
  in-flight requests are salvaged and re-routed under bounded retries
  with exponential backoff and jitter. A replay carries its emitted
  tokens through the engines' recompute path, so a greedy stream goes
  on where it stopped. A request whose retries are spent completes with
  the typed :class:`~.reliability.ReplicaFailed`.
- Hedged dispatch: a request still waiting for its first token after
  ``hedge_factor`` times the best ready replica's ttft p99 is copied to
  a sibling; the first completion wins and the loser is cancelled.
  Exactly one completion is delivered per fleet id.
- Elasticity: :meth:`ServingFleet.scale_down` stops admission to a
  replica, lets its requests finish until a deadline, then evicts the
  stragglers through the engine's ``handoff()`` for recompute on
  siblings; :meth:`ServingFleet.scale_up` registers a replica and warms
  it (a sacrificial request runs its kernels, then its gauges are
  reset) before it takes weight.

Every replica's engine registry is a labelled source of the fleet's
:class:`~..profiler.metrics.FederatedRegistry` (``fleet.metrics``);
``statusz_sections()`` and :meth:`ServingFleet.observability_server`
serve it with the fleet's health, SLO, trace and flight-recorder views.

The fleet is driven cooperatively: each fleet turn gives every live
replica one serial supervised ``step()``, on one host thread, which
keeps every chaos scenario deterministic. The engines run where
``engine_factory`` builds them (``cuda`` unless it passes another
device). :class:`FleetReplica` is the seam the router talks through
(``admit``/``step``/``salvage``/``load``/``health``, the migration
verbs, ``on_eject``/``close``): ``replica_cls=ProcReplica``
(``proc_replica.py``) puts each engine in a worker process behind the
same surface, ``disagg.DisaggServingFleet`` adds roles and KV-page
migration, and ``autoscaler.FleetAutoscaler`` drives ``scale_up`` /
``scale_down`` from the pressure signals (its decision log is the
``autoscaler`` section of ``/statusz``).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np

from ..profiler import flight_recorder as _frec
from ..profiler import metrics as _pmetrics
from ..profiler.slo import SLOTracker
from ..profiler.trace import get_trace_log, get_tracer
from .reliability import (AdmissionController, DeadlineExceeded,
                          EngineSupervisor, Overloaded, ReplicaFailed,
                          RequestCancelled, salvage_unfinished)
from .serving import ServedRequest, record_hop, request_trace_summary

__all__ = ["ServingFleet", "FleetReplica"]

# the fleet metric vocabulary; each fleet owns a private registry of
# these
_pmetrics.declare("fleet/submitted", "counter",
                  "requests accepted by the fleet router (fleet-global "
                  "ids)")
_pmetrics.declare("fleet/completed", "counter",
                  "fleet requests delivered exactly once (tokens or "
                  "typed error)")
_pmetrics.declare("fleet/shed_rejections", "counter",
                  "fleet submissions rejected Overloaded: every ready "
                  "replica shed (retry-after = max across replicas) or "
                  "no replica takes weight (all breakers open)")
_pmetrics.declare("fleet/retries", "counter",
                  "failover replays scheduled after a request's "
                  "replica died or wedged (bounded exponential backoff "
                  "with jitter)")
_pmetrics.declare("fleet/requeued", "counter",
                  "queued + in-flight requests salvaged off a dead, "
                  "wedged or drained replica for re-routing to "
                  "siblings")
_pmetrics.declare("fleet/hedges", "counter",
                  "hedged duplicate dispatches launched against "
                  "straggler replicas (p99-derived delay)")
_pmetrics.declare("fleet/hedge_wins", "counter",
                  "completions delivered by the hedge copy (the "
                  "duplicate beat the straggler)")
_pmetrics.declare("fleet/hedge_cancels", "counter",
                  "losing hedge copies cancelled after the winner "
                  "finished (cancel path)")
_pmetrics.declare("fleet/breaker_open", "counter",
                  "circuit breakers tripped: replica ejected after its "
                  "supervisor restart budget was spent")
_pmetrics.declare("fleet/wedge_ejections", "counter",
                  "replicas ejected by the no-progress health check "
                  "(heartbeats arriving, nothing moving)")
_pmetrics.declare("fleet/drains", "counter",
                  "graceful scale-down drains completed (clean, or "
                  "deadline-evicted onto siblings)")
_pmetrics.declare("fleet/scale_ups", "counter",
                  "replicas registered and warmed by scale_up before "
                  "taking router weight")
_pmetrics.declare("fleet/affinity_hits", "counter",
                  "requests routed to the replica that last served "
                  "their prefix-hash")
_pmetrics.declare("fleet/replicas_ready", "gauge",
                  "replicas currently taking router weight")
_pmetrics.declare("fleet/queue_depth", "gauge",
                  "requests waiting in admission queues summed across "
                  "live replicas — the fleet-level pressure signal "
                  "/statusz reads")
_pmetrics.declare("fleet/shed_rate", "gauge",
                  "admission sheds per second summed across live "
                  "replicas (each controller's trailing-window rate)")
_pmetrics.declare("fleet/failover_ms", "histogram",
                  "per salvaged request: replica ejection -> "
                  "re-admission on a sibling, ms — retry backoff "
                  "included (bounded reservoir)")


class FleetReplica:
    """One in-process serving replica: an EngineSupervisor-wrapped
    engine plus its admission controller and health/progress state.

    The engine is tagged with ``_fleet_replica_id`` (re-applied on
    every supervised rebuild) so replica-level fault plans
    (``FaultInjector.kill_replica`` / ``wedge_replica`` /
    ``slow_replica``) can target exactly one replica of a shared
    engine class.

    States: ``ready`` (takes router weight) → ``draining`` (admission
    stopped, in-flight finishing) → ``retired`` (clean scale-down) |
    ``ejected`` (breaker open / wedged); ``warming`` while
    :meth:`ServingFleet.scale_up` warms its engine.
    """

    def __init__(self, replica_id, engine_factory, *, max_restarts=2,
                 max_queue=64, default_ttft_slo_s=None,
                 min_retry_after_s=0.05):
        self.id = int(replica_id)

        def build():
            eng = engine_factory()
            eng._fleet_replica_id = self.id
            return eng

        self.supervisor = EngineSupervisor(build,
                                           max_restarts=max_restarts)
        self.admission = AdmissionController(
            self.supervisor, max_queue=max_queue,
            default_ttft_slo_s=default_ttft_slo_s,
            min_retry_after_s=min_retry_after_s)
        self.state = "ready"
        self.drain_deadline = None
        #: why this replica left the fleet ("breaker" / "wedge" /
        #: "operator"); None while live — the /statusz health render
        self.eject_kind = None
        self.last_beat = time.perf_counter()
        self.last_progress = self.last_beat
        self._idle_marker = None
        self._stale_turns = 0

    @property
    def engine(self):
        return self.supervisor.engine

    def takes_weight(self):
        return self.state == "ready"

    def live(self):
        return self.state in ("ready", "draining")

    def has_work(self):
        eng = self.engine
        return bool(eng.queue) or any(
            r is not None and not r.finished for r in eng.slot_req)

    def load(self):
        """Router load signal: outstanding generation work (remaining
        tokens across queued + running requests), per slot — the
        least-loaded key."""
        eng = self.engine
        rem = sum(max(0, r.max_new_tokens - len(r.tokens))
                  for r in eng.queue)
        rem += sum(max(0, r.max_new_tokens - len(r.tokens))
                   for r in eng.slot_req
                   if r is not None and not r.finished)
        return rem / max(1, eng.num_slots)

    def queue_depth(self):
        """Requests waiting in this replica's admission queue — the
        per-replica pressure signal; the fleet mirrors it
        into the ``serving/queue_depth`` gauge each turn."""
        return len(self.engine.queue)

    def shed_rate(self):
        """This replica's windowed admission-shed rate (sheds/s) —
        :meth:`~.reliability.AdmissionController.shed_rate`."""
        return self.admission.shed_rate()

    def ttft_p99_s(self):
        """The replica's observed ttft p99 (reservoir), seconds —
        the router's latency tiebreak and the hedge-delay input; None
        while cold."""
        h = self.engine.metrics.get("serving/ttft_ms")
        if h is None or h.count == 0:
            return None
        return h.percentile(99) / 1e3

    def _marker(self):
        """Progress fingerprint: any observable movement resets the
        no-progress clock (a supervised restart counts as movement —
        recovery in progress is not a wedge)."""
        eng = self.engine
        s = eng._stats
        return (s["tokens_emitted"], s["requests_completed"],
                s["prefills"], len(eng.queue),
                sum(r is not None for r in eng.slot_req),
                self.supervisor.restarts)

    def step(self):
        """One supervised scheduler turn. Returning at all stamps the
        liveness heartbeat; the progress clock advances only when the
        fingerprint moved. Raises past the supervisor's restart budget
        (the fleet opens the breaker)."""
        done = self.supervisor.step()
        self.last_beat = time.perf_counter()
        marker = self._marker()
        if done or marker != self._idle_marker:
            self._idle_marker = marker
            self._stale_turns = 0
            self.last_progress = self.last_beat
        elif self.has_work():
            self._stale_turns += 1
        return done

    def wedged(self, no_progress_turns):
        """The no-progress health check: work pending, heartbeats
        arriving, nothing moving for N consecutive turns."""
        return self.has_work() and self._stale_turns >= int(
            no_progress_turns)

    # -- disaggregation seam: the migration verbs a role-aware fleet
    # drives. In-process they reach the engine directly; ProcReplica
    # overrides them with RPCs over the wire.

    def take_migrations(self):
        """Drain the replica's outbound (request, kv payload) pairs."""
        return self.engine.take_migrations()

    def import_migration(self, req, payload):
        """Adopt a migrated request + its KV pages on this replica."""
        return self.engine.import_migration(req, payload)

    def release_exported(self, request_id):
        """Ack a completed transfer back to this (source) replica so
        its pinned exported pages become ordinary evictable cache."""
        return self.engine.release_exported(request_id)

    def on_eject(self, kind):
        """Ejection hook for replica subclasses holding external
        resources (a process-backed replica reaps its worker here);
        no-op for the in-process replica."""

    def close(self):
        """Teardown hook (scale-down retire / fleet close); no-op for
        the in-process replica."""


@dataclass(eq=False)
class _Tracked:
    """Fleet-side view of one client request across attempts: the
    primary dispatch, an optional hedge copy, and failover replays."""

    fid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: int | None
    priority: int
    ttft_deadline_s: float | None
    deadline_s: float | None
    t_submit: float
    #: replica_id -> live ServedRequest attempt on that replica
    attempts: dict = field(default_factory=dict)
    #: salvaged attempt awaiting reassignment (tokens kept — the
    #: idempotent-replay payload)
    carry: ServedRequest | None = None
    retries: int = 0
    not_before: float = 0.0
    #: when the current carry was salvaged off its replica — the
    #: failover clock (fleet/failover_ms observes at re-admission)
    t_failed: float = 0.0
    hedged: bool = False
    hedge_rid: int | None = None
    #: first-page token-block hash (engine page_size granularity) —
    #: the prefix-affinity routing hint; None for prompts
    #: shorter than one page
    prefix_hash: int | None = None
    cancelled: bool = False
    last_error: Exception | None = None
    done: ServedRequest | None = None
    t_assign: float = 0.0
    #: SLO accounting label, copied onto every attempt
    tenant: str | None = None
    #: the ONE cross-replica hop list every attempt shares (the fleet
    #: trace: hedge winner + cancelled loser interleave here)
    hops: list = field(default_factory=list)


class ServingFleet:
    """N supervised engine replicas behind a fault-tolerant router
    (module docstring). ``engine_factory`` builds one replica's engine
    (same model/geometry for every replica); the fleet is driven
    cooperatively — :meth:`run` round-robins one supervised scheduler
    turn per live replica per fleet turn, which keeps every chaos
    scenario deterministic and is the contract a process-backed
    :class:`FleetReplica` would relax."""

    def __init__(self, engine_factory, num_replicas=2, *,
                 max_restarts=2, max_queue=64, default_ttft_slo_s=None,
                 min_retry_after_s=0.05, max_retries=3,
                 retry_backoff_s=0.02, retry_backoff_cap_s=2.0,
                 retry_jitter=0.25, hedge_delay_s=None,
                 hedge_factor=3.0, hedge_min_delay_s=0.05,
                 no_progress_turns=25, drain_deadline_s=30.0,
                 all_open_retry_after_s=1.0, seed=0, slo_rules=None,
                 replica_cls=None, replica_kwargs=None):
        self._factory = engine_factory
        #: a FleetReplica subclass (ProcReplica, whose "factory" is a
        #: worker spec dict) slots in here; the router never knows
        self._replica_cls = replica_cls or FleetReplica
        self._rep_kw = dict(max_restarts=int(max_restarts),
                            max_queue=int(max_queue),
                            default_ttft_slo_s=default_ttft_slo_s,
                            min_retry_after_s=float(min_retry_after_s))
        if replica_kwargs:
            self._rep_kw.update(replica_kwargs)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        self.retry_jitter = float(retry_jitter)
        self.hedge_delay_s = hedge_delay_s
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_delay_s = float(hedge_min_delay_s)
        self.no_progress_turns = int(no_progress_turns)
        self.drain_deadline_s = float(drain_deadline_s)
        self.all_open_retry_after_s = float(all_open_retry_after_s)
        self._rng = random.Random(seed)
        #: the fleet's FEDERATION POINT: local fleet/*
        #: metrics live here, and every replica's private engine
        #: registry is a labeled source — /metrics and flight-recorder
        #: bundles read the whole fleet through this one handle
        self.metrics = _pmetrics.FederatedRegistry()
        #: per-tenant SLO accounting (profiler/slo.py); None without
        #: rules — attainment/burn gauges land in the federated
        #: registry so the exposition endpoint carries them
        self.slo = SLOTracker(slo_rules, registry=self.metrics) \
            if slo_rules else None
        #: self-measured observability overhead on the FLEET hot loop
        #: (SLO booking, trace-log feeds, tracer reconstruction) — the
        #: <2% obs/overhead_frac pin extends to the fleet tier
        self._obs_s = 0.0
        self._run_s = 0.0
        self.replicas: dict[int, FleetReplica] = {}
        self._next_replica_id = 0
        for _ in range(int(num_replicas)):
            self._add_replica(engine_factory)
        #: PENDING requests only — delivered entries are popped at
        #: _deliver, so the per-turn retry/hedge/reap scans and
        #: has_work() never degrade with the fleet's served history
        #: (the memory-flat discipline; ``completed`` below is
        #: the caller-owned history, exactly like engine.completed)
        self._reqs: dict[int, _Tracked] = {}
        self._next_id = 0
        #: prefix-hash -> replica that last served it:
        #: the router's cache-affinity memory — bounded (LRU by
        #: insertion order) so a high-cardinality prefix stream cannot
        #: grow it without limit
        self._affinity: dict[int, int] = {}
        self._affinity_cap = 4096
        self.completed: list[ServedRequest] = []
        self._h_failover = self.metrics.histogram("fleet/failover_ms")

    # ---- replica registry ------------------------------------------------

    def _add_replica(self, factory, federate=True):
        rid = self._next_replica_id
        self._next_replica_id += 1
        rep = self._replica_cls(rid, factory, **self._rep_kw)
        self.replicas[rid] = rep
        if federate:
            self._federate(rep)
        return rep

    def _federate(self, rep):
        # federate the replica's private engine registry, read LIVE
        # through the supervisor (a rebuilt engine swaps the instance;
        # the federation watermark keeps the fleet totals monotonic)
        self.metrics.add_source(str(rep.id),
                                lambda rep=rep: rep.engine.metrics)

    # ---- the router door -------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens, eos_token_id=None,
               priority=0, ttft_deadline_s=None,
               deadline_s=None, tenant=None) -> int:
        """Route one request to the best ready replica; returns the
        fleet-global request id. Raises :class:`ValueError` for a
        request no replica geometry can ever satisfy, and
        :class:`Overloaded` — ``retry_after_s`` = max of the
        controllers' computed retry-afters across the replicas that
        shed, or ``all_open_retry_after_s`` when no replica takes
        weight at all (all breakers open / everything draining)."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        ref = next((r for r in self.replicas.values() if r.live()),
                   None)
        if ref is not None:
            # structural validation once, against the shared geometry
            ref.engine._check_fits(prompt.size, int(max_new_tokens))
        fid = self._next_id
        tr = _Tracked(fid=fid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id,
                      priority=int(priority),
                      ttft_deadline_s=ttft_deadline_s,
                      deadline_s=deadline_s,
                      t_submit=time.perf_counter(),
                      tenant=tenant)
        # the trace is born HERE: one id, one hop list, shared by
        # every attempt this request will ever make
        tr.hops.append({"kind": "submit", "t": tr.t_submit,
                        "tenant": tenant})
        # prefix-affinity hint: hash the first full page's
        # token block — requests sharing >= page_size prefix tokens
        # carry the same hash, and the engines' prefix caches index at
        # exactly this granularity
        if ref is not None:
            ps = int(getattr(ref.engine, "page_size", 0))
            if ps and prompt.size >= ps:
                tr.prefix_hash = hash(prompt[:ps].tobytes())
        self._assign(tr, self._make_attempt(tr))  # raises Overloaded
        self._next_id += 1   # only an accepted submission consumes an
        self._reqs[fid] = tr                # id (and is ever tracked)
        self.metrics.counter("fleet/submitted").inc()
        return fid

    def _make_attempt(self, tr):
        req = ServedRequest(tr.fid, tr.prompt, tr.max_new_tokens,
                            tr.eos_token_id, priority=tr.priority,
                            ttft_deadline_s=tr.ttft_deadline_s,
                            deadline_s=tr.deadline_s,
                            tenant=tr.tenant)
        req.t_arrive = tr.t_submit  # deadlines stay client-relative
        # fleet trace context: every attempt (the primary, a hedge
        # duplicate, a failover replay) carries the SAME trace id and
        # appends into the SAME hop list — the engines' admit/preempt/
        # finish hops from different replicas interleave into one
        # cross-replica timeline
        req.trace_id = tr.fid
        req.hops = tr.hops
        return req

    def _candidates(self, exclude=(), prefer=None):
        reps = [r for r in self.replicas.values()
                if r.takes_weight() and r.id not in exclude]
        # least outstanding work first; among equally-loaded healthy
        # replicas the prefix-affinity hint wins (the preferred
        # replica's prefix cache is warm for this prompt), then the
        # observed ttft p99, then id for determinism. Affinity sits
        # strictly BELOW health (non-ready replicas — breakers open,
        # draining — were never candidates) and below least-loaded:
        # a warm cache never outranks an idle sibling.
        reps.sort(key=lambda r: (r.load(),
                                 0 if r.id == prefer else 1,
                                 r.ttft_p99_s() or 0.0, r.id))
        return reps

    def _assign(self, tr, req, exclude=()):
        """Admit one attempt on the best replica that will take it;
        raises :class:`Overloaded` with the fleet-wide retry-after."""
        h = tr.prefix_hash
        prefer = self._affinity.get(h) if h is not None else None
        cands = self._candidates(exclude, prefer=prefer)
        if not cands:
            self.metrics.counter("fleet/shed_rejections").inc()
            raise Overloaded(
                "no replica taking weight (all breakers open or "
                "draining)", self.all_open_retry_after_s)
        retry_afters = []
        for rep in cands:
            try:
                rep.admission.admit(req)
            except Overloaded as exc:
                retry_afters.append(exc.retry_after_s)
                continue
            tr.attempts[rep.id] = req
            tr.t_assign = time.perf_counter()
            record_hop(req, "assign", replica=rep.id,
                       retries=tr.retries)
            if h is not None:
                if rep.id == prefer:
                    self.metrics.counter("fleet/affinity_hits").inc()
                # pop-then-insert moves a re-served prefix to the
                # dict's end, so the cap evicts the LEAST recently
                # used hash, not the hottest long-lived one
                self._affinity.pop(h, None)
                self._affinity[h] = rep.id
                if len(self._affinity) > self._affinity_cap:
                    self._affinity.pop(next(iter(self._affinity)))
            return rep.id
        self.metrics.counter("fleet/shed_rejections").inc()
        raise Overloaded(
            f"every ready replica shed ({len(cands)} tried)",
            max(retry_afters))

    # ---- lookup / cancel -------------------------------------------------

    def request(self, fid):
        """The live ServedRequest view of a fleet id: the carried
        replay or primary attempt while pending, the delivered
        completion afterwards (scanned from ``completed``, like
        ``engine.request``)."""
        tr = self._reqs.get(fid)
        if tr is not None:
            if tr.carry is not None:
                return tr.carry
            for req in tr.attempts.values():
                return req
            return None
        for req in self.completed:
            if req.request_id == fid:
                return req
        return None

    def cancel(self, fid) -> bool:
        """Cancel every live attempt of a fleet request (honored at
        each replica's next scheduler turn); a carried replay completes
        with ``RequestCancelled`` at the fleet's next turn."""
        tr = self._reqs.get(fid)
        if tr is None or tr.done is not None:
            return False
        tr.cancelled = True
        for rid, req in list(tr.attempts.items()):
            rep = self.replicas.get(rid)
            if rep is not None and rep.live():
                rep.supervisor.cancel(req.request_id)
        return True

    def has_work(self):
        return bool(self._reqs)     # pending-only by construction

    # ---- the fleet loop --------------------------------------------------

    def step(self):
        """One fleet turn: one supervised scheduler turn per live
        replica, then health checks, drain deadlines, due retries,
        hedge decisions and pending-request reaping. Returns the fleet
        completions produced by this turn."""
        done = []
        for rep in list(self.replicas.values()):
            if not rep.live():
                continue
            try:
                finished = rep.step()
            except (KeyboardInterrupt, SystemExit, AssertionError):
                raise
            except Exception as exc:  # noqa: BLE001 — breaker opens
                done.extend(self._eject(rep, exc, kind="breaker"))
                continue
            for req in finished:
                out = self._absorb(rep, req)
                if out is not None:
                    done.append(out)
            if rep.wedged(self.no_progress_turns):
                done.extend(self._eject(
                    rep,
                    RuntimeError(
                        f"replica {rep.id} wedged: heartbeats without "
                        f"progress for {rep._stale_turns} turns"),
                    kind="wedge"))
                continue
            if rep.state == "draining":
                done.extend(self._check_drain(rep))
        now = time.perf_counter()
        # reap BEFORE firing retries: a carried request that was
        # cancelled or expired while waiting out its backoff must
        # complete with its typed error, never be resurrected onto a
        # sibling (regression-tested)
        done.extend(self._reap_pending(now))
        done.extend(self._fire_retries(now))
        self._check_hedges(now)
        return done

    def run(self):
        """Drive until every submitted request completes; returns the
        completions (exactly one per fleet id) in completion order.
        Armed with the flight-recorder watchdog: a replica step that
        HANGS stops the beats and the recorder dumps a diagnosable
        bundle (the liveness half of the health model)."""
        done = []
        token = _frec.arm("fleet run loop")
        # while the fleet is live, flight-recorder bundles carry the
        # FEDERATED snapshot: a replica-death post-mortem shows every
        # sibling's state at the moment of failure
        rec = _frec.get_recorder()
        prev_fleet_reg = None
        if rec is not None:
            prev_fleet_reg = rec.fleet_registry
            rec.fleet_registry = self.metrics
        t_run = time.perf_counter()
        try:
            while True:
                _frec.beat(token)
                out = self.step()
                done.extend(out)
                if not self.has_work():
                    break
                if not out:
                    # nothing moved this turn: if everything left is
                    # gated on backoff timers, sleep toward the
                    # earliest instead of busy-spinning
                    gates = [tr.not_before
                             for tr in self._reqs.values()
                             if tr.done is None
                             and tr.carry is not None]
                    if gates and not any(
                            r.live() and r.has_work()
                            for r in self.replicas.values()):
                        wait = min(gates) - time.perf_counter()
                        if wait > 0:
                            time.sleep(min(wait, 0.05))
        finally:
            self._run_s += time.perf_counter() - t_run
            if rec is not None:
                rec.fleet_registry = prev_fleet_reg
            _frec.disarm(token)
            self._emit_gauges()
        return done

    # ---- completion plumbing ---------------------------------------------

    def _deliver(self, tr, req):
        tr.done = req
        tr.carry = None
        self._reqs.pop(tr.fid, None)   # pending set stays bounded
        self.completed.append(req)
        self.metrics.counter("fleet/completed").inc()
        # ---- the fleet observability block (self-measured: rides the
        # obs_overhead_frac pin) — SLO booking, the completed-trace
        # log, chrome reconstruction. The delivered object may be a
        # fresh failover attempt, but every attempt shares tr.hops,
        # so the summary carries the WHOLE cross-replica timeline
        _t_obs = time.perf_counter()
        record_hop(req, "deliver", reason=req.finish_reason,
                   retries=tr.retries, hedged=tr.hedged)
        if self.slo is not None:
            try:
                self.slo.record(req)
            except Exception:  # noqa: BLE001 — accounting must never
                pass           # fail a delivery
        get_trace_log().record(request_trace_summary(req))
        self._emit_fleet_trace(tr, req)
        self._obs_s += time.perf_counter() - _t_obs
        _frec.record_event("fleet_finish", fid=tr.fid,
                           reason=req.finish_reason,
                           tokens=len(req.tokens))
        return req

    def _emit_fleet_trace(self, tr, req):
        """Reconstruct the request's cross-replica timeline into the
        chrome trace (Tracer.complete, retroactive): one parent span
        on the trace-id track, one child span per replica ATTEMPT
        (admit → finish/preempt/salvage — the hedge winner and its
        cancelled loser appear as sibling spans of the one trace), and
        zero-length hop markers at their true timestamps."""
        tracer = get_tracer()
        if not tracer.enabled:
            return
        t_end = req.t_done or time.perf_counter()
        tid = int(tr.fid)
        tracer.complete("fleet/request", tr.t_submit, t_end,
                        cat="fleet_req", tid=tid, trace_id=tid,
                        reason=req.finish_reason,
                        tokens=len(req.tokens), tenant=tr.tenant,
                        retries=tr.retries, hedged=tr.hedged)
        open_attempts: dict = {}
        for h in tr.hops:
            kind = h.get("kind")
            rep = h.get("replica")
            if kind == "admit":
                open_attempts.setdefault(rep, h["t"])
            elif kind in ("finish", "preempt", "evict",
                          "engine_restart", "salvage") \
                    and rep in open_attempts:
                tracer.complete(
                    "fleet/attempt", open_attempts.pop(rep), h["t"],
                    cat="fleet_req", tid=tid, replica=rep,
                    outcome=h.get("reason", kind))
            tracer.complete("req/hop", h["t"], h["t"],
                            cat="fleet_req", tid=tid, **h)

    def _absorb(self, rep, req):
        """Fold one replica completion into the fleet view; returns
        the fleet completion to deliver, or None (hedge loser,
        duplicate, or an attempt whose sibling copy still runs)."""
        tr = self._reqs.get(req.request_id)
        if tr is None:
            return None        # warmup internals (id -1) and the like
        was_hedge = tr.hedge_rid == rep.id
        tr.attempts.pop(rep.id, None)
        if tr.done is not None:
            return None        # the losing copy of a decided request
        if req.error is not None and tr.attempts and not tr.cancelled:
            # a failed attempt with a live sibling copy: the sibling
            # decides — this one is discarded, not delivered
            tr.last_error = req.error
            return None
        if req.error is None and tr.attempts:
            # winner: cancel the losing copies (they complete with
            # RequestCancelled on their replicas and are discarded)
            for orid, oreq in list(tr.attempts.items()):
                orep = self.replicas.get(orid)
                if orep is not None and orep.live():
                    orep.supervisor.cancel(oreq.request_id)
                self.metrics.counter("fleet/hedge_cancels").inc()
        if was_hedge and req.error is None:
            self.metrics.counter("fleet/hedge_wins").inc()
        return self._deliver(tr, req)

    # ---- failure handling: breaker, wedge, reroute -----------------------

    def _eject(self, rep, exc, kind):
        """Eject a replica: mark it, salvage its queue + in-flight
        and re-route to siblings. ``kind`` is ``"breaker"`` (restart
        budget spent), ``"wedge"`` (the no-progress health check) or
        ``"operator"`` (an explicit :meth:`eject` — no failure
        counter, and the reroute does not burn retry budget)."""
        rep.state = "ejected"
        rep.eject_kind = kind
        if kind == "wedge":
            self.metrics.counter("fleet/wedge_ejections").inc()
        elif kind == "breaker":
            self.metrics.counter("fleet/breaker_open").inc()
        _frec.record_event("fleet_eject", replica=rep.id, cause=kind,
                           error=repr(exc)[:200])
        salvage = salvage_unfinished(rep.engine)
        rep.on_eject(kind)   # after salvage: the shadow was the source
        return self._reroute(salvage, rep, exc,
                             count_retry=kind != "operator")

    def _reroute(self, reqs, rep, cause, count_retry=True):
        """Schedule salvaged requests for replay on siblings (backoff
        + jitter when ``count_retry``; immediate for drain evictions).
        Returns the completions produced when a retry budget is
        already spent."""
        now = time.perf_counter()
        done, n = [], 0
        for req in reqs:
            tr = self._reqs.get(req.request_id)
            if tr is None or req.finished:
                continue
            tr.attempts.pop(rep.id, None)
            if tr.done is not None:
                continue   # losing hedge copy dies with its replica
            if tr.attempts:
                continue   # a live sibling copy still runs
            n += 1
            record_hop(req, "salvage", replica=rep.id,
                       tokens=len(req.tokens))
            if count_retry:
                tr.retries += 1
                if tr.retries > self.max_retries:
                    done.append(self._finish_failed(tr, req, cause))
                    continue
                self.metrics.counter("fleet/retries").inc()
                tr.carry = req
                tr.not_before = now + self._backoff_s(tr.retries)
            else:
                tr.carry = req
                tr.not_before = now
            tr.t_failed = now   # failover clock: observed at
        self.metrics.counter("fleet/requeued").inc(n)   # re-admission
        return done

    def _backoff_s(self, attempt, floor_s=0.0):
        """Exponential backoff with jitter:
        ``base * 2^(attempt-1)``, jittered ±``retry_jitter``, capped —
        then FLOORED by any fleet-wide ``Overloaded.retry_after_s``
        (the router's computed estimate outranks the blind schedule)."""
        b = self.retry_backoff_s * (2 ** max(0, attempt - 1))
        b *= 1.0 + self.retry_jitter * (2 * self._rng.random() - 1.0)
        return max(floor_s, min(self.retry_backoff_cap_s, b))

    def _finish_failed(self, tr, req, cause):
        req.finished = True
        req.error = ReplicaFailed(tr.fid, cause=repr(cause)[:200])
        req.finish_reason = "failed"
        req.t_done = time.perf_counter()
        record_hop(req, "failed", retries=tr.retries,
                   cause=repr(cause)[:80])
        return self._deliver(tr, req)

    def _fire_retries(self, now):
        done = []
        fleet_alive = any(r.state in ("ready", "warming")
                          for r in self.replicas.values())
        for tr in list(self._reqs.values()):
            if tr.done is not None or tr.carry is None:
                continue
            if tr.cancelled:
                continue       # the reap owns it (typed completion)
            if not fleet_alive:
                # nothing will ever take this request again: typed
                # failure, never a silent hang
                done.append(self._finish_failed(
                    tr, tr.carry,
                    RuntimeError("no replica left in the fleet")))
                continue
            if now < tr.not_before:
                continue
            req = tr.carry
            try:
                self._assign(tr, req)
            except Overloaded as exc:
                # the computed retry-after is the backoff FLOOR; an
                # admission shed does not burn the retry budget
                record_hop(req, "shed",
                           retry_after_s=round(exc.retry_after_s, 4))
                tr.not_before = now + self._backoff_s(
                    tr.retries, floor_s=exc.retry_after_s)
                continue
            tr.carry = None
            if tr.t_failed:
                # the failover the client actually experienced:
                # ejection -> re-admission, backoff included
                self._h_failover.observe(
                    (time.perf_counter() - tr.t_failed) * 1e3)
                tr.t_failed = 0.0
        return done

    # ---- hedging ---------------------------------------------------------

    def _hedge_delay(self):
        """The straggler threshold: an explicit ``hedge_delay_s``, or
        ``hedge_factor`` x the BEST ready replica's observed ttft p99
        (the best — a straggler must not inflate its own threshold).
        None while no replica has latency history: with nothing to
        compare against, nobody is a straggler."""
        if self.hedge_delay_s is not None:
            return float(self.hedge_delay_s)
        p99s = [p for rep in self.replicas.values()
                if rep.takes_weight()
                and (p := rep.ttft_p99_s()) is not None]
        if not p99s:
            return None
        return max(self.hedge_min_delay_s,
                   self.hedge_factor * min(p99s))

    def _check_hedges(self, now):
        delay = self._hedge_delay()
        if delay is None:
            return
        for tr in self._reqs.values():
            if tr.done is not None or tr.hedged \
                    or tr.carry is not None or tr.cancelled:
                continue
            if len(tr.attempts) != 1:
                continue
            (rid, req), = tr.attempts.items()
            if req.t_first or req.tokens:
                continue       # first token landed: not a straggler
            if now - tr.t_assign < delay:
                continue
            copy = self._make_attempt(tr)
            try:
                nrid = self._assign(tr, copy, exclude=(rid,))
            except Overloaded:
                continue       # no sibling has room: the straggler
            tr.hedged = True   # keeps the request (one hedge max)
            tr.hedge_rid = nrid
            record_hop(copy, "hedge", replica=nrid, straggler=rid)
            self.metrics.counter("fleet/hedges").inc()
            _frec.record_event(
                "fleet_hedge", fid=tr.fid, straggler=rid,
                sibling=nrid,
                waited_ms=round((now - tr.t_assign) * 1e3, 2))

    # ---- pending reap ----------------------------------------------------

    def _reap_pending(self, now):
        """Lifecycle control for requests the FLEET is holding (backoff
        gate between assignments): cancellations and deadline expiries
        complete with typed errors instead of waiting forever."""
        done = []
        for tr in list(self._reqs.values()):   # _deliver pops entries
            if tr.done is not None or tr.carry is None:
                continue
            req = tr.carry
            err = None
            if tr.cancelled:
                err = RequestCancelled(tr.fid)
                req.finish_reason = "cancelled"
            elif tr.deadline_s is not None \
                    and now - tr.t_submit > tr.deadline_s:
                err = DeadlineExceeded(tr.fid, "total", tr.deadline_s)
                req.finish_reason = "deadline"
            elif tr.ttft_deadline_s is not None and not req.t_first \
                    and now - tr.t_submit > tr.ttft_deadline_s:
                err = DeadlineExceeded(tr.fid, "ttft",
                                       tr.ttft_deadline_s)
                req.finish_reason = "deadline"
            if err is None:
                continue
            req.finished = True
            req.error = err
            req.t_done = now
            done.append(self._deliver(tr, req))
        return done

    # ---- elasticity ------------------------------------------------------

    def scale_down(self, replica_id=None, deadline_s=None):
        """Begin a graceful drain: admission stops immediately (the
        router drops the replica's weight), in-flight requests keep
        running until done or until ``deadline_s`` (default
        ``drain_deadline_s``) expires — stragglers are then evicted
        through the engine's ``handoff()`` hook and recomputed on
        siblings. Returns the replica id chosen (least-loaded ready
        replica when not given)."""
        if replica_id is None:
            cands = [r for r in self.replicas.values()
                     if r.state == "ready"]
            if not cands:
                raise ValueError("no ready replica to drain")
            rep = min(cands, key=lambda r: (r.load(), r.id))
        else:
            rep = self.replicas[replica_id]
            if rep.state != "ready":
                raise ValueError(
                    f"replica {replica_id} is {rep.state}, not ready")
        rep.state = "draining"
        dl = self.drain_deadline_s if deadline_s is None \
            else float(deadline_s)
        rep.drain_deadline = time.perf_counter() + dl
        _frec.record_event("fleet_drain_begin", replica=rep.id,
                           deadline_s=round(dl, 3))
        return rep.id

    def _check_drain(self, rep):
        done = []
        if not rep.has_work():
            rep.state = "retired"
            self.metrics.counter("fleet/drains").inc()
            _frec.record_event("fleet_drain_done", replica=rep.id,
                               evicted=0)
            rep.close()
        elif rep.drain_deadline is not None \
                and time.perf_counter() >= rep.drain_deadline:
            stragglers = rep.engine.handoff()
            rep.state = "retired"
            self.metrics.counter("fleet/drains").inc()
            _frec.record_event("fleet_drain_done", replica=rep.id,
                               evicted=len(stragglers))
            rep.close()
            done.extend(self._reroute(
                stragglers, rep,
                RuntimeError("drain deadline"), count_retry=False))
        return done

    def scale_up(self, engine_factory=None, warm=True):
        """Register a new replica. With ``warm`` (default) it is
        WARMED before taking router weight: a sacrificial request
        builds and runs its kernels, then its gauges are reset so warmup
        latencies cannot pollute the routing signal. Returns the new
        replica id."""
        # federation waits until AFTER warmup: a concurrent scrape
        # landing between the sacrificial request and reset_gauges()
        # would otherwise record the warmup counters into the
        # federation watermark, and the reset would bank them into the
        # fleet totals forever (scrape-timing-dependent totals)
        rep = self._add_replica(engine_factory or self._factory,
                                federate=False)
        if warm:
            rep.state = "warming"
            self._warm(rep)
        self._federate(rep)
        rep.state = "ready"
        self.metrics.counter("fleet/scale_ups").inc()
        _frec.record_event("fleet_scale_up", replica=rep.id,
                           warmed=bool(warm))
        return rep.id

    def _warm(self, rep):
        eng = rep.engine
        # enough decode budget for several scheduler turns: the first
        # steps build and load the kernels and run the prefill and the
        # decode shapes — a one-turn warmup would leave first-use work
        # inside the serving path
        n_new = max(2, min(3 * eng.decode_chunk,
                           eng.max_len - 5))
        # id -1: outside the fleet id space, so its completion can
        # never be confused with a client request (and the engine
        # leaves it out of the trace log)
        wreq = ServedRequest(-1, np.zeros((4,), np.int32), n_new, None)
        wreq.t_arrive = time.perf_counter()
        eng.requeue(wreq)
        for _ in range(512):
            if not rep.has_work():
                break
            rep.step()
        # the warm-up's model forwards outlive the reset: a count of
        # kernel launches over the fleet's life is held against them
        self.metrics.counter("fleet/warmup_forwards").inc(
            eng._stats["forwards"])
        eng.reset_gauges()

    def close(self):
        """Release every replica's external resources (a process-
        backed replica reaps its worker here); results and gauges
        remain readable — only the replicas' backends are gone."""
        for rep in self.replicas.values():
            rep.close()

    def eject(self, replica_id, reason="operator"):
        """Operator-initiated immediate ejection (no drain): the
        replica's queue + in-flight fail over to siblings right away —
        without counting a breaker trip or burning the salvaged
        requests' retry budget (an operator action is not a failure)."""
        rep = self.replicas[replica_id]
        if not rep.live():
            return []
        return self._eject(rep, RuntimeError(f"ejected: {reason}"),
                           kind="operator")

    # ---- observability ---------------------------------------------------

    def gauges(self) -> dict:
        """Fleet observability surface: the router/health/failover
        economics plus per-replica states."""
        ready = sum(1 for r in self.replicas.values()
                    if r.takes_weight())
        self.metrics.gauge("fleet/replicas_ready").set(ready)

        def c(name):
            return self.metrics.counter(name).value

        return {
            "replicas": len(self.replicas),
            "replicas_ready": ready,
            "replica_states": {r.id: r.state
                               for r in self.replicas.values()},
            "submitted": c("fleet/submitted"),
            "completed": c("fleet/completed"),
            "shed_rejections": c("fleet/shed_rejections"),
            "retries": c("fleet/retries"),
            "requeued": c("fleet/requeued"),
            "hedges": c("fleet/hedges"),
            "affinity_hits": c("fleet/affinity_hits"),
            "hedge_wins": c("fleet/hedge_wins"),
            "hedge_cancels": c("fleet/hedge_cancels"),
            "breaker_open": c("fleet/breaker_open"),
            "wedge_ejections": c("fleet/wedge_ejections"),
            "drains": c("fleet/drains"),
            "scale_ups": c("fleet/scale_ups"),
            "queue_depth": sum(r.queue_depth()
                               for r in self.replicas.values()
                               if r.live()),
            "shed_rate": round(sum(r.shed_rate()
                                   for r in self.replicas.values()
                                   if r.live()), 4),
            "failover_ms_p99": self._h_failover.percentile(99),
            "obs_overhead_frac": (self._obs_s / self._run_s)
            if self._run_s else 0.0,
        }

    def _emit_gauges(self):
        self.metrics.gauge("fleet/replicas_ready").set(
            sum(1 for r in self.replicas.values()
                if r.takes_weight()))
        self.metrics.gauge("obs/overhead_frac").set(
            (self._obs_s / self._run_s) if self._run_s else 0.0)
        # the pressure signals, fleet-level AND mirrored
        # onto each live replica's own registry (labeled children on
        # the federated scrape) — the router and /statusz read the
        # same numbers
        q_total = s_total = 0.0
        for r in self.replicas.values():
            if not r.live():
                continue
            try:
                q, s = r.queue_depth(), r.shed_rate()
            except Exception:  # noqa: BLE001 — a replica mid-teardown
                continue       # must not tear the gauge sweep
            q_total += q
            s_total += s
            r.engine.metrics.gauge("serving/queue_depth").set(q)
            r.engine.metrics.gauge("serving/shed_rate").set(s)
        self.metrics.gauge("fleet/queue_depth").set(q_total)
        self.metrics.gauge("fleet/shed_rate").set(round(s_total, 4))

    # ---- /statusz + exposition --------------------------------

    def _statusz_replicas(self):
        """Per-replica health: state, breaker/eject cause, supervisor
        restarts, load + latency signal, prefix-cache hit rate — the
        fleet-operator view of the health model."""
        out = {}
        for r in self.replicas.values():
            entry = {"state": r.state, "eject_kind": r.eject_kind,
                     "restarts": r.supervisor.restarts,
                     "breaker_open": r.eject_kind == "breaker",
                     "stale_turns": r._stale_turns}
            try:
                p99 = r.ttft_p99_s()
                g = r.supervisor.gauges()
                entry.update(
                    load=round(r.load(), 4),
                    queued=r.queue_depth(),
                    shed_rate=round(r.shed_rate(), 4),
                    ttft_p99_ms=round(p99 * 1e3, 3)
                    if p99 is not None else None,
                    tokens_emitted=g.get("tokens_emitted", 0),
                    requests_completed=g.get("requests_completed", 0),
                    prefix_cache_hit_rate=round(
                        g.get("prefix_cache_hit_rate", 0.0), 4),
                    preempt_evictions=g.get("preempt_evictions", 0))
            except Exception as exc:  # noqa: BLE001 — a replica mid-
                # teardown must not tear the whole health render
                entry["error"] = f"{type(exc).__name__}: {exc}"
            out[str(r.id)] = entry
        return out

    def _statusz_traces(self, n=10):
        """The N slowest recent end-to-end request traces."""
        return get_trace_log().slowest(n)

    def statusz_sections(self) -> dict:
        """The named /statusz section providers (each a zero-arg
        callable, evaluated per scrape and individually guarded by the
        ObservabilityServer): fleet router economics, per-replica
        health/breaker state, SLO attainment + burn-rate alerts, the
        slowest recent traces, flight-recorder incidents, and the
        current goodput summary (the ledger registered with
        ``goodput.set_current``, when there is one)."""
        from ..profiler import goodput as _goodput

        def _slo():
            return self.slo.summary() if self.slo is not None else None

        def _goodput_section():
            ledger = _goodput.get_current()
            return ledger.summary() if ledger is not None else None

        def _autoscaler():
            # attached by FleetAutoscaler's constructor: the decision
            # log (signals in, rule fired, action out); None for an
            # operator-scaled fleet
            ctl = getattr(self, "autoscaler", None)
            return ctl.statusz() if ctl is not None else None

        def _flight():
            rec = _frec.get_recorder()
            if rec is None:
                return None
            return {"dumps": rec.dumps,
                    "last_bundle": rec.last_bundle_path,
                    "incidents": rec.incidents()}

        return {
            "fleet": self.gauges,
            "replicas": self._statusz_replicas,
            "slo": _slo,
            "autoscaler": _autoscaler,
            "slowest_traces": self._statusz_traces,
            "flight_recorder": _flight,
            "goodput": _goodput_section,
        }

    def statusz(self) -> dict:
        """The /statusz document as a dict — the SAME guarded
        evaluation the HTTP render uses (one loop, cannot drift)."""
        from ..profiler.exposition import evaluate_sections
        return evaluate_sections(self.statusz_sections())

    def observability_server(self, host="127.0.0.1", port=0,
                             start=True):
        """The fleet's operational front door: an
        :class:`~..profiler.exposition.ObservabilityServer`
        wired to the federated registry (``/metrics``) and the statusz
        sections (``/statusz``). ``port=0`` binds an ephemeral port;
        the caller owns ``stop()``."""
        from ..profiler.exposition import ObservabilityServer
        srv = ObservabilityServer(
            registry=self.metrics, sections=self.statusz_sections(),
            host=host, port=port,
            # /metrics-only scrapers must read CURRENT slo gauges —
            # a tenant gone silent after a bad minute self-resolves
            # on the scrape path too, not just /statusz
            pre_scrape=(self.slo.refresh if self.slo is not None
                        else None))
        return srv.start() if start else srv
