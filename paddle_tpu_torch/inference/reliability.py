"""Serving reliability: typed failures, SLO-aware admission control and
supervised engine recovery. The port of
``paddle_tpu/inference/reliability.py``.

The engine handles overload inside its pool (preemption with recompute,
deadlines, cancellation, step-failure containment: ``serving.py``); this
module stands in front of it and around it:

- **Typed errors.** A request never just disappears: it finishes with
  tokens, or with :class:`RequestCancelled`, :class:`DeadlineExceeded`
  or :class:`RequestQuarantined` on ``ServedRequest.error``; a
  submission the system cannot absorb raises :class:`Overloaded` with a
  computed ``retry_after_s``.
- :class:`AdmissionController`: a bounded admission queue that sheds at
  the door when the queue is full or when the engine's
  ``serving/ttft_ms`` and ``serving/itl_ms`` histograms predict that the
  request would miss its TTFT deadline anyway.
- :class:`EngineSupervisor`: when the engine dies anyway (the stall
  ``RuntimeError``, a containment budget spent, a crash below the step
  boundary) it dumps a flight-recorder bundle, tears the engine down,
  requeues every queued and in-flight request into a fresh one (replay
  from prompt plus the tokens already delivered, the path preemption
  uses) and retries, a bounded number of times. Its ``step()`` is the
  fleet's unit of work: one supervised scheduler turn.
- :class:`ReplicaFailed`: the fleet's typed error for a request whose
  replica died and whose retry budget is spent.

Nothing here imports ``serving.py``: the controller and the supervisor
duck-type the engine (``queue``, ``slot_req``, ``metrics``, ``requeue``
...).
"""

from __future__ import annotations

import time
from collections import deque

from ..profiler import flight_recorder as _frec
from ..profiler import metrics as _metrics

__all__ = ["ServingError", "RequestCancelled", "DeadlineExceeded",
           "RequestQuarantined", "Overloaded", "ReplicaFailed",
           "AdmissionController", "EngineSupervisor",
           "salvage_unfinished", "record_hop", "MAX_HOPS"]

_metrics.declare("restart/engine_restarts", "counter",
                 "supervised serving-engine teardown+restart cycles "
                 "(EngineSupervisor)")
_metrics.declare("restart/engine_requeued", "counter",
                 "queued + in-flight requests salvaged into a fresh "
                 "engine at a supervised restart (idempotent replay "
                 "from prompt + emitted tokens)")


# ---- typed failures --------------------------------------------------------

class ServingError(RuntimeError):
    """Base of every typed serving failure; ``request_id`` is set for
    per-request errors (None for :class:`Overloaded`)."""

    request_id: int | None = None


class RequestCancelled(ServingError):
    """The request's ``cancel()`` was honoured: pages freed, tokens
    already emitted kept on the request."""

    def __init__(self, request_id):
        super().__init__(f"request {request_id} cancelled")
        self.request_id = request_id


class DeadlineExceeded(ServingError):
    """A TTFT or total deadline expired, queued, mid-prefill or
    mid-decode. ``kind`` is ``"ttft"`` or ``"total"``."""

    def __init__(self, request_id, kind, deadline_s):
        super().__init__(
            f"request {request_id} missed its {kind} deadline "
            f"({deadline_s}s)")
        self.request_id = request_id
        self.kind = kind
        self.deadline_s = deadline_s


class RequestQuarantined(ServingError):
    """The request rode ``max_strikes`` failed steps and was isolated by
    the containment boundary (the poison-request shape)."""

    def __init__(self, request_id, cause=""):
        super().__init__(
            f"request {request_id} quarantined after repeated step "
            f"failures" + (f": {cause}" if cause else ""))
        self.request_id = request_id
        self.cause = cause


class Overloaded(ServingError):
    """Admission-control rejection: the system is shedding load.
    ``retry_after_s`` is the controller's estimate of when a retry has a
    fair chance. The fleet router propagates the largest value across
    the replicas that shed, and its own retries wait at least that
    long."""

    def __init__(self, reason, retry_after_s):
        super().__init__(
            f"overloaded: {reason} (retry after "
            f"{retry_after_s:.3f}s)")
        self.retry_after_s = float(retry_after_s)


class ReplicaFailed(ServingError):
    """The request's serving replica died (or the whole fleet became
    unavailable) and the fleet's bounded retry budget was spent. Tokens
    already emitted stay on the request: a failed stream delivers its
    partial prefix and this typed error."""

    def __init__(self, request_id, cause=""):
        super().__init__(
            f"request {request_id} abandoned after replica failure"
            + (f": {cause}" if cause else ""))
        self.request_id = request_id
        self.cause = cause


#: per-request hop bound: a preemption storm replaying one victim many
#: times must not grow its trace without limit; past the bound, hops are
#: counted, not stored
MAX_HOPS = 64


def record_hop(req, kind, replica=None, **fields):
    """Append one hop (admission, preemption, restart, completion ...)
    to a request's trace. Duck-typed: requests without a ``hops`` list
    are skipped. Past ``MAX_HOPS`` the list's last entry becomes a
    ``truncated`` marker that counts the overflow."""
    hops = getattr(req, "hops", None)
    if hops is None:
        return
    if len(hops) >= MAX_HOPS:
        req.hops_dropped += 1
        last = hops[-1]
        if last.get("kind") == "truncated":
            last["dropped"] += 1
        else:
            # dropped=2: the displaced final hop and the current one
            hops[-1] = {"kind": "truncated",
                        "t": time.perf_counter(), "dropped": 2}
        return
    h = {"kind": kind, "t": time.perf_counter()}
    if replica is not None:
        h["replica"] = replica
    if fields:
        h.update(fields)
    hops.append(h)


def salvage_unfinished(engine):
    """Every queued and in-flight request of an engine being torn down
    or ejected, in id order: the replay set (prompt plus tokens already
    emitted) a fresh engine or a sibling replica requeues through the
    recompute path. Reads host-side containers only, so it is safe on an
    engine whose device state is no longer trusted. The supervisor's
    restarts and the fleet's ejections share it."""
    salvage = [r for r in engine.queue if not r.finished]
    salvage += [r for r in engine.slot_req
                if r is not None and not r.finished]
    # requests a prefill-role engine migrated out of a slot but the
    # router has not picked up live in neither container: an engine
    # dying mid-transfer salvages them too (the KV payload dies with it;
    # prompt replay is the fallback, as for any preemption)
    salvage += [req for req, _ in getattr(engine, "migrations_out", ())
                if not req.finished]
    salvage.sort(key=lambda r: r.request_id)
    return salvage


# ---- SLO-aware admission control -------------------------------------------

class AdmissionController:
    """Bounded admission queue and SLO predictor in front of an engine
    (or an :class:`EngineSupervisor`: anything exposing ``.engine`` or
    being one).

    Shedding policy, checked at :meth:`submit`:

    1. **Queue bound.** More than ``max_queue`` requests waiting: reject
       with a retry-after from the queue's estimated drain time.
    2. **SLO prediction.** With latency history (the engine's
       ``serving/ttft_ms`` and ``serving/itl_ms`` reservoirs), predicted
       TTFT = ttft_p99 + the queued work's drain time; a request whose
       TTFT deadline (or ``default_ttft_slo_s``) is below it is shed.

    A cold engine (no completed request yet) admits on the queue bound
    alone. :meth:`admit` applies the same policy to a request the fleet
    built (fleet-wide ids, failover replays carrying their tokens).
    """

    def __init__(self, target, max_queue=64, default_ttft_slo_s=None,
                 min_retry_after_s=0.05, shed_window_s=10.0):
        self._target = target
        self.max_queue = int(max_queue)
        self.default_ttft_slo_s = default_ttft_slo_s
        self.min_retry_after_s = float(min_retry_after_s)
        self.accepted = 0
        self.shed = 0
        #: recent shed instants (bounded): the windowed shed rate the
        #: fleet's gauges read (``shed`` is a lifetime total)
        self.shed_window_s = float(shed_window_s)
        self._shed_times = deque(maxlen=1024)

    @property
    def engine(self):
        return getattr(self._target, "engine", self._target)

    # -- prediction --------------------------------------------------------

    def _rates(self, eng):
        """(ttft_p99_s, itl_p50_s) from the engine's latency reservoirs
        (its public ``metrics`` registry), or None without history."""
        h_ttft = eng.metrics.get("serving/ttft_ms")
        h_itl = eng.metrics.get("serving/itl_ms")
        if h_ttft is None or h_ttft.count == 0:
            return None
        itl = (h_itl.percentile(50) / 1e3) \
            if h_itl is not None and h_itl.count else 0.0
        return h_ttft.percentile(99) / 1e3, itl

    def _queued_drain_s(self, eng, itl_s):
        """Seconds to drain the current queue: its remaining tokens at
        the observed per-token latency across ``num_slots`` lanes."""
        queued_tok = sum(r.max_new_tokens - len(r.tokens)
                         for r in eng.queue)
        return queued_tok * itl_s / max(1, eng.num_slots)

    def predicted_ttft_s(self):
        """The TTFT predicted for a request submitted now (None while
        the engine has no latency history)."""
        eng = self.engine
        rates = self._rates(eng)
        if rates is None:
            return None
        ttft_p99, itl = rates
        return ttft_p99 + self._queued_drain_s(eng, itl)

    def _retry_after_s(self, eng):
        rates = self._rates(eng)
        if rates is None:
            return self.min_retry_after_s
        _, itl = rates
        # time for the queue to drain below half the bound
        excess = max(0, len(eng.queue) - self.max_queue // 2)
        per_req = itl * (
            sum(r.max_new_tokens for r in eng.queue)
            / max(1, len(eng.queue))) / max(1, eng.num_slots)
        return max(self.min_retry_after_s, excess * per_req)

    def retry_after_s(self):
        """The current retry-after estimate, shedding nothing: the fleet
        router's fleet-wide ``Overloaded.retry_after_s`` is the largest
        of these across the replicas that shed."""
        return self._retry_after_s(self.engine)

    def shed_rate(self, now=None):
        """Sheds per second over the trailing ``shed_window_s``. Prunes
        as it reads, so an idle controller decays to 0.0 with no
        writer."""
        now = time.perf_counter() if now is None else now
        horizon = now - self.shed_window_s
        while self._shed_times and self._shed_times[0] < horizon:
            self._shed_times.popleft()
        return len(self._shed_times) / self.shed_window_s

    # -- the door ----------------------------------------------------------

    def _shed(self, eng, reason, floor_s=0.0):
        """``floor_s``: an SLO-prediction shed tells the client to wait at
        least the prediction's overshoot (the queue-drain estimate alone
        reads about 0 below half the bound)."""
        retry = max(self._retry_after_s(eng), floor_s)
        self.shed += 1
        self._shed_times.append(time.perf_counter())
        eng.metrics.counter("serving/shed_rejections").inc()
        eng.metrics.gauge("serving/shed_retry_after_s").set(retry)
        _frec.record_event("shed", reason=reason,
                           queued=len(eng.queue),
                           retry_after_s=round(retry, 4))
        raise Overloaded(reason, retry)

    def _gate(self, eng, ttft_deadline_s):
        """The shed decision: the queue bound first, then the SLO
        prediction."""
        if len(eng.queue) >= self.max_queue:
            self._shed(eng, f"admission queue full "
                            f"({len(eng.queue)}/{self.max_queue})")
        slo = ttft_deadline_s if ttft_deadline_s is not None \
            else self.default_ttft_slo_s
        if slo is not None:
            pred = self.predicted_ttft_s()
            if pred is not None and pred > slo:
                self._shed(eng, f"predicted TTFT {pred:.3f}s exceeds "
                                f"deadline {slo:.3f}s",
                           floor_s=pred - slo)

    def submit(self, prompt_ids, max_new_tokens, eos_token_id=None,
               priority=0, ttft_deadline_s=None,
               deadline_s=None, tenant=None) -> int:
        """Admit or shed. Returns the request id; raises
        :class:`Overloaded` (with ``retry_after_s``) when the queue is
        full or the predictor says the deadline is already lost."""
        eng = self.engine
        self._gate(eng, ttft_deadline_s)
        rid = eng.add_request(prompt_ids, max_new_tokens,
                              eos_token_id=eos_token_id,
                              priority=priority,
                              ttft_deadline_s=ttft_deadline_s,
                              deadline_s=deadline_s, tenant=tenant)
        self.accepted += 1   # after validation: a rejected oversize
        return rid           # submission does not count as accepted

    def admit(self, req) -> int:
        """Router-side admission: the policy of :meth:`submit` applied to
        a pre-built ``ServedRequest`` (the fleet mints fleet-wide ids,
        and a failover replay arrives carrying its emitted tokens), which
        the engine adopts through ``requeue()``'s recompute path."""
        eng = self.engine
        self._gate(eng, req.ttft_deadline_s)
        eng.requeue(req)     # validates the fit; raises before counting
        self.accepted += 1
        return req.request_id


# ---- supervised recovery ---------------------------------------------------

class EngineSupervisor:
    """Bounded-restart supervision around a serving engine.

    ``engine_factory`` builds a fresh engine (same model and geometry);
    the first is built at once as ``self.engine``. :meth:`run` drives it
    to completion; when the engine dies, or returns with a slot it could
    never drain, the supervisor salvages every queued and in-flight
    request, builds a fresh engine, requeues them (prompt plus tokens
    already emitted re-prefill, so delivered prefixes are never served
    twice) and retries, at most ``max_restarts`` times; then the
    original failure propagates. ``AssertionError`` (the page audit)
    always propagates.
    """

    def __init__(self, engine_factory, max_restarts=2):
        self._factory = engine_factory
        self.engine = engine_factory()
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self.completed: list = []
        self._returned: set[int] = set()   # id()s already handed back
        # monotonic counters salvaged from torn-down engines, so
        # gauges() covers the whole supervised lifetime
        self._carried: dict = {}

    def add_request(self, *a, **kw):
        """The live engine's ``add_request``."""
        return self.engine.add_request(*a, **kw)

    def cancel(self, request_id):
        """The live engine's ``cancel``."""
        return self.engine.cancel(request_id)

    def request(self, request_id):
        """The live engine's ``request``."""
        return self.engine.request(request_id)

    #: gauges() keys that are monotonic counters, summable across the
    #: engines a supervised lifetime burns through
    _COUNTER_GAUGES = (
        "preempt_evictions", "preempt_recompute_tokens",
        "requests_cancelled", "deadline_expired", "shed_rejections",
        "quarantined", "containments", "tokens_emitted", "prefills",
        "requests_completed", "chunks_dispatched", "unified_steps",
        "prefix_cache_hits", "prefix_cache_misses",
        "prefix_cache_tokens_saved", "prefix_cache_evictions",
        "prefix_cache_cow_forks")

    def gauges(self):
        """The live engine's gauges, with the monotonic counters summed
        over every engine this supervisor has torn down."""
        g = dict(self.engine.gauges())
        for k, v in self._carried.items():
            g[k] = g.get(k, 0) + v
        # the hit rate must agree with the summed counters
        if "prefix_cache_hit_rate" in g:
            tot = g.get("prefix_cache_hits", 0) \
                + g.get("prefix_cache_misses", 0)
            g["prefix_cache_hit_rate"] = \
                g.get("prefix_cache_hits", 0) / tot if tot else 0.0
        return g

    def has_work(self):
        return self.engine.has_work() \
            or any(r is not None for r in self.engine.slot_req)

    def step(self):
        """One supervised scheduler turn, the fleet's unit of work: a
        step failure that escapes the engine's containment tears the
        engine down, salvages its queue and in-flight requests into a
        fresh one and returns nothing this turn; past ``max_restarts``
        the failure propagates (the fleet opens the replica's breaker).
        Returns the requests completed by this turn, each once across
        ``step()`` and ``run()``."""
        try:
            done = self.engine.step()
        except (KeyboardInterrupt, SystemExit, AssertionError):
            raise               # the audit is never laundered
        except Exception as exc:  # noqa: BLE001 — supervised
            self._restart(exc)
            done = []
        out = []
        for r in done:
            if id(r) not in self._returned:
                self._returned.add(id(r))
                out.append(r)
        self.completed.extend(out)
        return out

    def run(self):
        """Drive to completion across restarts; returns every request
        completed by this call (tokens or typed error), once each (the
        supervisor hands a request out only once over its lifetime).
        Requests finished before a budget-exhausting failure stay on
        ``self.completed`` even when the failure propagates."""
        done: list = []

        def absorb(reqs):
            for r in reqs:
                if id(r) not in self._returned:
                    self._returned.add(id(r))
                    done.append(r)

        try:
            while True:
                try:
                    absorb(self.engine.run())
                except (KeyboardInterrupt, SystemExit,
                        AssertionError):
                    # the page audit speaking: the engine refuses to
                    # contain it and the supervisor does not restart
                    raise
                except Exception as exc:  # noqa: BLE001 — supervised
                    absorb(self.engine.completed)
                    self._restart(exc)
                    continue
                absorb(self.engine.completed)
                leftover = [r for r in self.engine.slot_req
                            if r is not None and not r.finished]
                if leftover:
                    # a clean return with occupants left is an engine
                    # fault too (a slot that never drained)
                    self._restart(RuntimeError(
                        f"engine run() returned with {len(leftover)} "
                        f"undrained slot(s)"))
                    continue
                return done
        finally:
            self.completed.extend(done)

    def _restart(self, exc):
        """Dump a flight-recorder bundle, then tear down and rebuild, or
        re-raise once the budget is spent (the failing attempt past the
        budget is not a restart)."""
        rec = _frec.get_recorder()
        if rec is not None:
            try:
                rec.dump(f"engine supervisor restart: {exc!r}")
            except OSError:
                pass           # the post-mortem is best-effort
        if self.restarts >= self.max_restarts:
            raise exc
        self.restarts += 1
        reg = _metrics.get_registry()
        reg.counter("restart/engine_restarts").inc()
        old = self.engine
        try:
            g = old.gauges()
            for k in self._COUNTER_GAUGES:
                self._carried[k] = self._carried.get(k, 0) \
                    + int(g.get(k, 0))
        except Exception:  # noqa: BLE001 — a dead engine's gauges are
            pass           # best-effort salvage, never block a restart
        salvage = salvage_unfinished(old)
        for r in salvage:
            # the hop that tells "my engine was rebuilt under me" from a
            # scheduler preemption
            record_hop(r, "engine_restart", attempt=self.restarts,
                       replica=getattr(old, "_fleet_replica_id", None),
                       tokens=len(r.tokens), error=repr(exc)[:80])
        # the dead engine's pools go before the fresh one allocates its
        # own (two sets at once may not fit); the engine itself stays in
        # place until the swap, so a scrape from another thread reads it
        old.pools = []
        fresh = self._factory()
        # carry the id counter: a fresh engine must not re-mint an id
        # the old one already completed
        fresh._next_id = max(fresh._next_id, old._next_id)
        for r in salvage:
            fresh.requeue(r)
        self.engine = fresh
        reg.counter("restart/engine_requeued").inc(len(salvage))
        _frec.record_event("engine_restart", attempt=self.restarts,
                           requeued=len(salvage),
                           error=repr(exc)[:200])
