"""SLO-driven fleet autoscaler: the controller that closes the loop over
the serving stack; the port of ``paddle_tpu/inference/autoscaler.py``,
its rules kept decision for decision.

The fleet has every actuator (:meth:`~.fleet.ServingFleet.scale_up` /
:meth:`~.fleet.ServingFleet.scale_down` / :meth:`~.fleet.ServingFleet.
eject`) and every sensor (the federated metrics plane, per-tenant SLO
burn rates, admission queue depth and shed rate, slot occupancy,
prefix-cache hit rate, per-role pressure on a
:class:`~.disagg.DisaggServingFleet`) — this module connects them.

**Control loop.** :meth:`FleetAutoscaler.tick` samples one signal
snapshot, evaluates the rule chain, and drives at most ONE actuator
call. Scale-ups are warm-spare: the base fleet's ``scale_up`` runs the new
replica's kernels on a sacrificial request before it takes router
weight, so a flash crowd never lands on a cold replica.
Scale-downs are drain-based: ``scale_down`` stops admission
immediately and in-flight work finishes (or hands off through the
engine's ``handoff()`` hook) — the autoscaler never ejects.

**Rules** (first match fires):

- *scale up* when any pressure signal crosses its high-water mark:
  worst per-tenant SLO burn rate >= ``burn_high`` (the error budget is
  burning faster than it refills), observed shed rate > ``shed_high``,
  admission queue depth per ready replica >= ``queue_high``, or slot
  occupancy >= ``occupancy_high``.
- *scale down* when EVERY signal sits below its low-water mark
  (``queue_low`` / ``occupancy_low``, zero sheds, burn < 1) for
  ``down_stable_ticks`` consecutive ticks — one idle tick is noise,
  a stable idle plateau is capacity.
- otherwise *hold* — the deadband between the marks is where a
  well-provisioned fleet lives.

**Hysteresis.** Any applied action opens a quiet period
(``up_cooldown_s`` after a scale-up, ``down_cooldown_s`` after a
scale-down) during which EVERY further action is blocked — by
construction no up+down pair can land within one cooldown, the
flapping invariant the scenario gate asserts. Bounds
(``min_replicas`` / ``max_replicas``) and the chip budget are checked
after the rule fires; a wanted-but-blocked action is recorded as a
``blocked`` decision so the operator can see the controller straining
against its limits.

**Role awareness.** On a :class:`~.disagg.DisaggServingFleet` the
scale-up rule picks the role under pressure — ``prefill`` when the
prefill admission queue is deep, ``decode`` when the decode pool's
slots are saturated, ``both`` when both are hot — and scale-down never
drains the last prefill-capable or last decode-capable replica.

**Cost model.** ``chips_per_replica`` prices a replica;
``chip_seconds`` integrates ready-replica chip time across ticks (the
denominator of the bench's goodput-per-chip frontier), and an optional
``chip_budget`` caps the fleet's instantaneous chip footprint.

**Explainability.** Every evaluation produces a structured record —
signals in, rule fired, action out — kept in a bounded log, exposed as
the fleet's ``autoscaler`` /statusz section, and counted in the
``autoscale/*`` metrics.
"""

from __future__ import annotations

import time
from collections import deque

from ..profiler import flight_recorder as _frec
from ..profiler import metrics as _pmetrics

__all__ = ["FleetAutoscaler"]

_pmetrics.declare("autoscale/ticks", "counter",
                  "autoscaler control-loop evaluations (one signal "
                  "snapshot + rule-chain pass each)")
_pmetrics.declare("autoscale/scale_ups", "counter",
                  "warm-spare scale_up actions the autoscaler applied "
                  "(role-tagged on a disagg fleet)")
_pmetrics.declare("autoscale/scale_downs", "counter",
                  "drain-based scale_down actions the autoscaler "
                  "applied")
_pmetrics.declare("autoscale/blocked", "counter",
                  "actions a rule wanted but hysteresis refused "
                  "(cooldown quiet period, min/max replica bounds, "
                  "chip budget)")
_pmetrics.declare("autoscale/decisions", "counter",
                  "non-hold decision records appended to the bounded "
                  "decision log (scale_ups + scale_downs + blocked)")
_pmetrics.declare("autoscale/chip_seconds", "counter",
                  "integral of ready-replica chip time across ticks "
                  "(chips_per_replica x ready replicas x seconds) — "
                  "the goodput-per-chip frontier denominator")
_pmetrics.declare("autoscale/slo_burn", "gauge",
                  "worst per-(rule, tenant) SLO burn rate in the "
                  "fleet tracker at the last tick (1.0 = burning the "
                  "error budget exactly as fast as it refills)")


class FleetAutoscaler:
    """The closed-loop controller over one :class:`~.fleet.
    ServingFleet` (or :class:`~.disagg.DisaggServingFleet`) — module
    docstring. Construction attaches the controller as
    ``fleet.autoscaler`` so the fleet's /statusz carries the decision
    log; the caller drives :meth:`tick` (the scenario harness does it
    once per harness tick).

    ``now_fn`` injects the clock for deterministic tests, mirroring
    :class:`~..profiler.slo.SLOTracker`."""

    def __init__(self, fleet, *, min_replicas=1, max_replicas=4,
                 chips_per_replica=1.0, chip_budget=None,
                 up_cooldown_s=2.0, down_cooldown_s=4.0,
                 queue_high=4.0, queue_low=0.5,
                 occupancy_high=0.85, occupancy_low=0.35,
                 burn_high=2.0, shed_high=0.0,
                 down_stable_ticks=3, max_decisions=256,
                 warm=True, now_fn=None):
        if max_replicas < min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if queue_low >= queue_high or occupancy_low >= occupancy_high:
            raise ValueError("deadband inverted: the low-water mark "
                             "must sit strictly below the high one")
        self.fleet = fleet
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.chips_per_replica = float(chips_per_replica)
        self.chip_budget = None if chip_budget is None \
            else float(chip_budget)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.occupancy_high = float(occupancy_high)
        self.occupancy_low = float(occupancy_low)
        self.burn_high = float(burn_high)
        self.shed_high = float(shed_high)
        self.down_stable_ticks = int(down_stable_ticks)
        self.warm = bool(warm)
        self._now = now_fn or time.perf_counter
        self._tick = 0
        self._quiet_until = 0.0     # after ANY action: no action at
        self._quiet_kind = None     # all until this instant (flapping
        self._idle_ticks = 0        # invariant by construction)
        self._last_t = None
        self.decisions = deque(maxlen=int(max_decisions))
        m = fleet.metrics
        self._c_ticks = m.counter("autoscale/ticks")
        self._c_ups = m.counter("autoscale/scale_ups")
        self._c_downs = m.counter("autoscale/scale_downs")
        self._c_blocked = m.counter("autoscale/blocked")
        self._c_decisions = m.counter("autoscale/decisions")
        self._c_chip_s = m.counter("autoscale/chip_seconds")
        self._g_burn = m.gauge("autoscale/slo_burn")
        fleet.autoscaler = self

    # ---- signals ---------------------------------------------------------

    @property
    def _disagg(self):
        return getattr(self.fleet, "roles", None) is not None

    def _worst_burn(self):
        slo = getattr(self.fleet, "slo", None)
        if slo is None:
            return 0.0
        worst = 0.0
        for rule in slo.summary()["rules"].values():
            for lbl in rule["labels"].values():
                worst = max(worst, lbl["burn_rate"])
        return worst

    def signals(self) -> dict:
        """One snapshot of every pressure signal the rules read —
        embedded verbatim in the tick's decision record, so any
        decision reconstructs from its log entry alone."""
        fleet = self.fleet
        ready = [r for r in fleet.replicas.values()
                 if r.takes_weight()]
        queue = sum(r.queue_depth() for r in ready)
        shed = sum(r.shed_rate() for r in ready)
        slots = busy = 0
        hits = []
        for r in ready:
            eng = r.engine
            slots += max(1, int(getattr(eng, "num_slots", 1)))
            busy += sum(1 for q in eng.slot_req
                        if q is not None and not q.finished)
            try:
                hits.append(float(r.supervisor.gauges().get(
                    "prefix_cache_hit_rate", 0.0)))
            except Exception:  # noqa: BLE001 — a replica mid-teardown
                pass           # must not blind the whole snapshot
        sig = {
            "replicas": len(fleet.replicas),
            "ready": len(ready),
            "queue_depth": queue,
            "queue_per_replica": queue / max(1, len(ready)),
            "shed_rate": round(shed, 4),
            "slot_occupancy": busy / max(1, slots),
            "prefix_cache_hit_rate": round(
                sum(hits) / len(hits), 4) if hits else 0.0,
            "slo_burn": round(self._worst_burn(), 4),
        }
        if self._disagg:
            n_pre = [r for r in ready
                     if fleet._prefill_capable(r)]
            n_dec = [r for r in ready if fleet._decode_capable(r)]
            dec_slots = sum(max(1, r.engine.num_slots) for r in n_dec)
            dec_busy = sum(1 for r in n_dec for q in r.engine.slot_req
                           if q is not None and not q.finished)
            sig["prefill_queue_per_replica"] = (
                fleet.prefill_queue_depth() / max(1, len(n_pre)))
            sig["decode_occupancy"] = dec_busy / max(1, dec_slots)
            sig["prefill_ready"] = len(n_pre)
            sig["decode_ready"] = len(n_dec)
        return sig

    # ---- the rule chain --------------------------------------------------

    def _up_rule(self, sig):
        """First pressure signal over its high-water mark, or None.
        The capacity floor outranks every pressure signal: a fleet
        below ``min_replicas`` ready (an operator drain, an ejection)
        reads ZERO queue/occupancy/shed precisely because nothing can
        admit — pressure rules alone would never backfill it."""
        if sig["ready"] < self.min_replicas:
            return "below_min_replicas"
        if sig["slo_burn"] >= self.burn_high:
            return "slo_burn_high"
        if sig["shed_rate"] > self.shed_high:
            return "shed_rate_high"
        if sig["queue_per_replica"] >= self.queue_high:
            return "queue_depth_high"
        if sig["slot_occupancy"] >= self.occupancy_high:
            return "occupancy_high"
        return None

    def _idle(self, sig):
        return (sig["queue_per_replica"] <= self.queue_low
                and sig["slot_occupancy"] <= self.occupancy_low
                and sig["shed_rate"] <= 0.0
                and sig["slo_burn"] < 1.0)

    def _pick_role(self, sig):
        """Which role is under pressure on a disagg fleet: deep
        prefill admission queue -> ``prefill``, saturated decode slots
        -> ``decode``, both hot -> ``both``. A colocated fleet has no
        roles — returns None."""
        if not self._disagg:
            return None
        pre_hot = sig["prefill_queue_per_replica"] >= self.queue_high \
            or sig["prefill_ready"] == 0
        dec_hot = sig["decode_occupancy"] >= self.occupancy_high \
            or sig["decode_ready"] == 0
        if pre_hot and dec_hot:
            return "both"
        if dec_hot:
            return "decode"
        return "prefill"

    def _down_target(self):
        """The replica a drain should take: the least-loaded ready
        one, never the last prefill-capable or decode-capable replica
        of a disagg fleet (a role going dark is an outage, not a
        saving). None when no replica can be spared."""
        fleet = self.fleet
        ready = [r for r in fleet.replicas.values()
                 if r.state == "ready"]
        if len(ready) <= self.min_replicas:
            return None
        for rep in sorted(ready, key=lambda r: (r.load(), r.id)):
            if self._disagg:
                pre = [r for r in ready if fleet._prefill_capable(r)]
                dec = [r for r in ready if fleet._decode_capable(r)]
                if fleet._prefill_capable(rep) and len(pre) <= 1:
                    continue
                if fleet._decode_capable(rep) and len(dec) <= 1:
                    continue
            return rep
        return None

    # ---- the loop --------------------------------------------------------

    def tick(self) -> dict:
        """One control-loop evaluation; returns this tick's decision
        record (always — ``hold`` included), having applied at most
        one actuator call."""
        now = self._now()
        self._tick += 1
        self._c_ticks.inc()
        if self._last_t is not None:
            ready = sum(1 for r in self.fleet.replicas.values()
                        if r.takes_weight())
            self._c_chip_s.inc(max(0.0, now - self._last_t)
                               * ready * self.chips_per_replica)
        self._last_t = now
        sig = self.signals()
        self._g_burn.set(sig["slo_burn"])
        # keep the scrape surface (gauges the fleet normally refreshes
        # only at end-of-run) fresh while the controller drives step()
        emit = getattr(self.fleet, "_emit_gauges", None)
        if emit is not None:
            emit()

        rule = self._up_rule(sig)
        if rule is not None:
            self._idle_ticks = 0
            return self._act_up(rule, sig, now)
        if self._idle(sig):
            self._idle_ticks += 1
            if self._idle_ticks >= self.down_stable_ticks:
                return self._act_down("idle_stable", sig, now)
            return self._record("hold", "idle_warming", sig, now,
                                reason=f"idle {self._idle_ticks}/"
                                       f"{self.down_stable_ticks} "
                                       "ticks")
        self._idle_ticks = 0
        return self._record("hold", "deadband", sig, now,
                            reason="every signal inside the deadband")

    # ---- actions ---------------------------------------------------------

    def _act_up(self, rule, sig, now):
        if now < self._quiet_until:
            return self._blocked(rule, sig, now, "scale_up",
                                 f"cooldown ({self._quiet_kind}) for "
                                 f"{self._quiet_until - now:.3f}s more")
        live = sum(1 for r in self.fleet.replicas.values()
                   if r.live() or r.state == "warming")
        if live >= self.max_replicas:
            return self._blocked(rule, sig, now, "scale_up",
                                 f"at max_replicas={self.max_replicas}")
        if self.chip_budget is not None and \
                (live + 1) * self.chips_per_replica > self.chip_budget:
            return self._blocked(rule, sig, now, "scale_up",
                                 f"chip budget {self.chip_budget} "
                                 "would be exceeded")
        role = self._pick_role(sig)
        if role is not None:
            rid = self.fleet.scale_up(warm=self.warm, role=role)
        else:
            rid = self.fleet.scale_up(warm=self.warm)
        self._c_ups.inc()
        self._quiet_until = self._now() + self.up_cooldown_s
        self._quiet_kind = "scale_up"
        return self._record("scale_up", rule, sig, now, replica=rid,
                            role=role,
                            reason=f"{rule} -> warm spare"
                                   + (f" ({role})" if role else ""))

    def _act_down(self, rule, sig, now):
        if now < self._quiet_until:
            return self._blocked(rule, sig, now, "scale_down",
                                 f"cooldown ({self._quiet_kind}) for "
                                 f"{self._quiet_until - now:.3f}s more")
        rep = self._down_target()
        if rep is None:
            return self._blocked(rule, sig, now, "scale_down",
                                 f"at min_replicas={self.min_replicas}"
                                 " or last replica of a role")
        role = self.fleet.roles.get(rep.id) if self._disagg else None
        self.fleet.scale_down(replica_id=rep.id)
        self._c_downs.inc()
        self._idle_ticks = 0
        self._quiet_until = self._now() + self.down_cooldown_s
        self._quiet_kind = "scale_down"
        return self._record("scale_down", rule, sig, now,
                            replica=rep.id, role=role,
                            reason=f"{rule} -> drain least-loaded "
                                   f"replica {rep.id}")

    # ---- the decision log ------------------------------------------------

    def _blocked(self, rule, sig, now, wanted, why):
        self._c_blocked.inc()
        return self._record("blocked", rule, sig, now, wanted=wanted,
                            reason=why)

    def _record(self, action, rule, sig, now, *, replica=None,
                role=None, wanted=None, reason=""):
        rec = {"tick": self._tick, "t": round(now, 6),
               "action": action, "rule": rule, "reason": reason,
               "signals": sig}
        if replica is not None:
            rec["replica"] = replica
        if role is not None:
            rec["role"] = role
        if wanted is not None:
            rec["wanted"] = wanted
        self.decisions.append(rec)
        if action != "hold":
            self._c_decisions.inc()
            _frec.record_event("autoscale_" + action, rule=rule,
                               reason=reason)
        return rec

    @property
    def chip_seconds(self):
        """Accrued chip-seconds (the cost-model integral so far)."""
        return float(self._c_chip_s.value)

    def actions(self):
        """The applied-action subset of the log, oldest first — what
        the no-flapping assertion and the scenario gates read."""
        return [d for d in self.decisions
                if d["action"] in ("scale_up", "scale_down")]

    def statusz(self) -> dict:
        """The ``autoscaler`` /statusz section: config, cost model,
        counters, and the full bounded decision log (newest last) —
        every decision reconstructable from here."""
        return {
            "config": {
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "chips_per_replica": self.chips_per_replica,
                "chip_budget": self.chip_budget,
                "up_cooldown_s": self.up_cooldown_s,
                "down_cooldown_s": self.down_cooldown_s,
                "queue_high": self.queue_high,
                "queue_low": self.queue_low,
                "occupancy_high": self.occupancy_high,
                "occupancy_low": self.occupancy_low,
                "burn_high": self.burn_high,
                "shed_high": self.shed_high,
                "down_stable_ticks": self.down_stable_ticks,
            },
            "ticks": int(self._c_ticks.value),
            "scale_ups": int(self._c_ups.value),
            "scale_downs": int(self._c_downs.value),
            "blocked": int(self._c_blocked.value),
            "chip_seconds": round(self.chip_seconds, 4),
            "quiet_until": round(self._quiet_until, 6),
            "decisions": list(self.decisions),
        }
