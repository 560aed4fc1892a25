"""The port's FleetAutoscaler (paddle_tpu_torch.inference.autoscaler)
on the contracts of tests/test_autoscaler.py and the fast cases of
tests/test_autoscale_scenarios.py, and against the JAX controller.

The unit cases are the JAX file's, on the same fake fleet (no engines,
an injected clock): every rule, each hysteresis guard, the cost model,
the role choice on a disaggregated fleet, the metrics and the bounded
log. Then both controllers run side by side over seeded random signal
sequences (a colocated and a disaggregated fake fleet, one per package,
moved alike): every decision record, every applied action and the
/statusz section must be equal. The scenario cases drive the load
harness's ``flash_crowd`` and ``rolling_upgrade`` through a real tiny
fleet of the port (f32, CPU, paced on the harness's TickClock) and hold
each to its own criteria (attainment bar, nothing lost, the scale-up
window, the flapping invariant, fewer chip-seconds than the largest
fixed fleet, every decision in /statusz). Exact; no tolerance (the JAX
fleet's scenario runs are not compared: their first ticks carry XLA
compiles, which the SLO burn reads)."""

import dataclasses
import os
import random
import sys

import pytest
import torch

from paddle_tpu import inference as jinf
from paddle_tpu.profiler import metrics as _jmetrics

from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        FleetAutoscaler, Overloaded,
                                        ServingFleet)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.profiler import metrics as _pmetrics
from paddle_tpu_torch.profiler.slo import SLORule

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import load_harness  # noqa: E402

pytestmark = pytest.mark.autoscale


# ---- the fake fleet --------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeEngine:
    def __init__(self, num_slots=2, metrics=_pmetrics):
        self.num_slots = num_slots
        self.slot_req = [None] * num_slots
        self.metrics = metrics.MetricsRegistry()


class _Busy:
    finished = False


class _FakeSupervisor:
    def gauges(self):
        return {"prefix_cache_hit_rate": 0.5}


class _FakeReplica:
    def __init__(self, rid, metrics=_pmetrics):
        self.id = rid
        self.state = "ready"
        self.engine = _FakeEngine(metrics=metrics)
        self.supervisor = _FakeSupervisor()
        self.queue = 0
        self.sheds = 0.0
        self.load_val = 0.0

    def takes_weight(self):
        return self.state == "ready"

    def live(self):
        return self.state in ("ready", "draining")

    def queue_depth(self):
        return self.queue

    def shed_rate(self):
        return self.sheds

    def load(self):
        return self.load_val

    def set_busy(self, n):
        self.engine.slot_req = [_Busy() if i < n else None
                                for i in range(self.engine.num_slots)]


class _FakeFleet:
    def __init__(self, n=2, metrics=_pmetrics):
        self._mod = metrics
        self.metrics = metrics.MetricsRegistry()
        self.replicas = {i: _FakeReplica(i, metrics) for i in range(n)}
        self.slo = None
        self.scale_up_calls = []
        self.scale_down_calls = []

    def scale_up(self, warm=True, **kw):
        rid = max(self.replicas) + 1
        self.replicas[rid] = _FakeReplica(rid, self._mod)
        self.scale_up_calls.append(dict(kw, warm=warm))
        return rid

    def scale_down(self, replica_id=None):
        self.replicas[replica_id].state = "draining"
        self.scale_down_calls.append(replica_id)
        return replica_id


class _FakeSLO:
    def __init__(self, burn):
        self.burn = burn

    def summary(self):
        return {"rules": {"ttft": {"labels": {
            "tenantA": {"burn_rate": self.burn}}}}}


class _FakeDisagg(_FakeFleet):
    def __init__(self, roles, metrics=_pmetrics):
        super().__init__(len(roles), metrics)
        self.roles = dict(enumerate(roles))

    def _prefill_capable(self, rep):
        return self.roles.get(rep.id, "both") != "decode"

    def _decode_capable(self, rep):
        return self.roles.get(rep.id, "both") != "prefill"

    def prefill_queue_depth(self):
        return sum(r.queue for r in self.replicas.values()
                   if r.live() and self._prefill_capable(r))

    def scale_up(self, warm=True, role="both", **kw):
        rid = super().scale_up(warm=warm, role=role, **kw)
        self.roles[rid] = role
        return rid


def _ctl(fleet, clock, cls=FleetAutoscaler, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("up_cooldown_s", 3.0)
    kw.setdefault("down_cooldown_s", 5.0)
    kw.setdefault("down_stable_ticks", 2)
    return cls(fleet, now_fn=clock, **kw)


def _tick(ctl, clock, dt=1.0):
    rec = ctl.tick()
    clock.t += dt
    return rec


# ---- scale-up rules --------------------------------------------------------

def test_queue_pressure_scales_up_with_explainable_record():
    fleet, clock = _FakeFleet(2), _Clock()
    ctl = _ctl(fleet, clock)
    for r in fleet.replicas.values():
        r.queue = 10
    rec = _tick(ctl, clock)
    assert rec["action"] == "scale_up"
    assert rec["rule"] == "queue_depth_high"
    assert rec["replica"] == 2
    # signals in, rule fired, action out — reconstructable alone
    assert rec["signals"]["queue_per_replica"] == 10.0
    assert fleet.scale_up_calls == [{"warm": True}]
    assert ctl.statusz()["scale_ups"] == 1
    assert ctl.decisions[-1] is rec


def test_occupancy_shed_and_burn_each_trigger():
    for setup, rule in [
        (lambda f: [r.set_busy(2) for r in f.replicas.values()],
         "occupancy_high"),
        (lambda f: setattr(f.replicas[0], "sheds", 2.0),
         "shed_rate_high"),
        (lambda f: setattr(f, "slo", _FakeSLO(burn=3.0)),
         "slo_burn_high"),
    ]:
        fleet, clock = _FakeFleet(2), _Clock()
        ctl = _ctl(fleet, clock)
        setup(fleet)
        rec = _tick(ctl, clock)
        assert rec["action"] == "scale_up", rule
        assert rec["rule"] == rule


def test_capacity_floor_outranks_pressure_signals():
    """A fleet below min_replicas ready (operator drain, ejection)
    reads zero pressure — the floor rule must backfill it anyway."""
    fleet, clock = _FakeFleet(2), _Clock()
    ctl = _ctl(fleet, clock, min_replicas=2)
    fleet.replicas[0].state = "draining"
    rec = _tick(ctl, clock)
    assert rec["action"] == "scale_up"
    assert rec["rule"] == "below_min_replicas"


def test_deadband_holds():
    fleet, clock = _FakeFleet(2), _Clock()
    ctl = _ctl(fleet, clock)
    fleet.replicas[0].queue = 2       # above queue_low*2, below high
    rec = _tick(ctl, clock)
    assert rec["action"] == "hold"
    assert rec["rule"] == "deadband"
    assert not fleet.scale_up_calls and not fleet.scale_down_calls


# ---- hysteresis ------------------------------------------------------------

def test_up_cooldown_blocks_and_is_recorded():
    fleet, clock = _FakeFleet(2), _Clock()
    ctl = _ctl(fleet, clock)
    for r in fleet.replicas.values():
        r.queue = 10
    assert _tick(ctl, clock)["action"] == "scale_up"
    rec = _tick(ctl, clock)           # still hot, 1s into 3s cooldown
    assert rec["action"] == "blocked"
    assert rec["wanted"] == "scale_up"
    assert "cooldown" in rec["reason"]
    clock.t = 10.0                    # past the cooldown
    assert ctl.tick()["action"] == "scale_up"
    assert ctl.statusz()["blocked"] == 1


def test_max_replicas_and_chip_budget_block():
    fleet, clock = _FakeFleet(2), _Clock()
    ctl = _ctl(fleet, clock, max_replicas=2)
    fleet.replicas[0].queue = 99
    assert _tick(ctl, clock)["reason"] == "at max_replicas=2"

    fleet, clock = _FakeFleet(2), _Clock()
    ctl = _ctl(fleet, clock, chips_per_replica=2.0, chip_budget=4.0)
    fleet.replicas[0].queue = 99
    rec = _tick(ctl, clock)
    assert rec["action"] == "blocked"
    assert "chip budget" in rec["reason"]


def test_scale_down_needs_stable_idle_then_cooldown():
    fleet, clock = _FakeFleet(3), _Clock()
    ctl = _ctl(fleet, clock, down_stable_ticks=3)
    recs = [_tick(ctl, clock) for _ in range(4)]
    assert [r["action"] for r in recs[:2]] == ["hold", "hold"]
    assert recs[0]["rule"] == "idle_warming"
    assert recs[2]["action"] == "scale_down"
    assert recs[2]["rule"] == "idle_stable"
    # the drained replica is the least-loaded ready one
    assert fleet.scale_down_calls == [recs[2]["replica"]]
    # idle again, but inside the down cooldown: blocked, not flapped
    assert recs[3]["action"] in ("hold", "blocked")
    acts = ctl.actions()
    assert [a["action"] for a in acts] == ["scale_down"]


def test_min_replicas_floor_blocks_scale_down():
    fleet, clock = _FakeFleet(1), _Clock()
    ctl = _ctl(fleet, clock, down_stable_ticks=1)
    rec = _tick(ctl, clock)
    assert rec["action"] == "blocked"
    assert rec["wanted"] == "scale_down"
    assert not fleet.scale_down_calls


def test_no_up_down_pair_within_one_cooldown_under_noise():
    """The flapping invariant: drive an adversarial alternating
    hot/idle signal and assert no adjacent action pair lands closer
    than the first action's cooldown."""
    fleet, clock = _FakeFleet(2), _Clock()
    ctl = _ctl(fleet, clock, down_stable_ticks=1,
               up_cooldown_s=3.0, down_cooldown_s=5.0)
    for i in range(30):
        q = 10 if i % 2 == 0 else 0
        for r in fleet.replicas.values():
            if r.state == "ready":
                r.queue = q
        _tick(ctl, clock)
    acts = ctl.actions()
    assert acts, "noise never produced a single action?"
    cool = {"scale_up": 3.0, "scale_down": 5.0}
    for a, b in zip(acts, acts[1:]):
        assert b["t"] - a["t"] >= cool[a["action"]], (a, b)


# ---- cost model ------------------------------------------------------------

def test_chip_seconds_integrates_ready_replicas():
    fleet, clock = _FakeFleet(2), _Clock()
    ctl = _ctl(fleet, clock, chips_per_replica=2.0)
    fleet.replicas[0].queue = 2       # deadband: hold at 2 ready
    for _ in range(5):
        _tick(ctl, clock)             # 2 ready x 2 chips x 1s per gap
    # 4 inter-tick gaps have elapsed at the 5th tick
    assert ctl.chip_seconds == pytest.approx(4 * 2 * 2.0)
    assert ctl.statusz()["chip_seconds"] == pytest.approx(16.0)


# ---- role awareness (disagg) ----------------------------------------------

def test_role_pick_prefill_decode_both():
    # deep prefill queue -> prefill
    fleet, clock = _FakeDisagg(["prefill", "decode"]), _Clock()
    ctl = _ctl(fleet, clock)
    fleet.replicas[0].queue = 20
    rec = _tick(ctl, clock)
    assert (rec["action"], rec["role"]) == ("scale_up", "prefill")
    assert fleet.roles[rec["replica"]] == "prefill"

    # saturated decode slots (and queue pressure there) -> decode
    fleet, clock = _FakeDisagg(["prefill", "decode"]), _Clock()
    ctl = _ctl(fleet, clock)
    fleet.replicas[1].queue = 20
    fleet.replicas[1].set_busy(2)
    rec = _tick(ctl, clock)
    assert (rec["action"], rec["role"]) == ("scale_up", "decode")

    # both hot -> both
    fleet, clock = _FakeDisagg(["prefill", "decode"]), _Clock()
    ctl = _ctl(fleet, clock)
    fleet.replicas[0].queue = 20
    fleet.replicas[1].set_busy(2)
    rec = _tick(ctl, clock)
    assert (rec["action"], rec["role"]) == ("scale_up", "both")


def test_scale_down_never_drains_last_replica_of_a_role():
    fleet, clock = _FakeDisagg(["prefill", "decode", "decode"]), \
        _Clock()
    ctl = _ctl(fleet, clock, down_stable_ticks=1, min_replicas=1)
    # prefill replica 0 is the least loaded, but it is the LAST
    # prefill-capable one — the drain must take a decode sibling
    fleet.replicas[1].load_val = 1.0
    fleet.replicas[2].load_val = 2.0
    rec = ctl.tick()
    assert rec["action"] == "scale_down"
    assert rec["replica"] == 1
    assert fleet.roles[rec["replica"]] == "decode"

    # one prefill + one decode left: nothing can be spared
    fleet2, clock2 = _FakeDisagg(["prefill", "decode"]), _Clock()
    ctl2 = _ctl(fleet2, clock2, down_stable_ticks=1, min_replicas=1)
    rec2 = ctl2.tick()
    assert rec2["action"] == "blocked"
    assert rec2["wanted"] == "scale_down"


# ---- metrics + log bounds --------------------------------------------------

def test_autoscale_metrics_and_bounded_log():
    fleet, clock = _FakeFleet(2), _Clock()
    ctl = _ctl(fleet, clock, max_decisions=8)
    for r in fleet.replicas.values():
        r.queue = 10
    for _ in range(20):
        _tick(ctl, clock, dt=0.1)     # mostly blocked by cooldown
    m = fleet.metrics
    assert m.counter("autoscale/ticks").value == 20
    ups = m.counter("autoscale/scale_ups").value
    blocked = m.counter("autoscale/blocked").value
    assert ups >= 1 and blocked >= 1
    assert m.counter("autoscale/decisions").value == ups + blocked
    assert len(ctl.decisions) == 8    # bounded, newest kept
    assert m.gauge("autoscale/slo_burn").value == 0.0


# ---- decision for decision against the JAX controller ----------------------

def _random_walk(fleet, rng, tick):
    """One tick's signals, drawn from ``rng``: queue, occupancy, sheds,
    loads and SLO burn on every ready replica."""
    for rid in sorted(fleet.replicas):
        r = fleet.replicas[rid]
        r.queue = rng.choice((0, 0, 1, 2, 5, 12))
        r.sheds = rng.choice((0.0, 0.0, 0.0, 1.5))
        r.load_val = rng.random()
        r.set_busy(rng.choice((0, 0, 1, 2)))
    fleet.slo = _FakeSLO(rng.choice((0.0, 0.5, 0.5, 3.0))) \
        if tick % 3 else None


@pytest.mark.parametrize("kind", ["colocated", "disagg"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decisions_equal_the_jax_controllers(kind, seed):
    """The same random signal sequence through both packages'
    controllers over twin fake fleets: the same decision records (rule,
    action, replica, role, reason, signals), the same applied actions,
    and the same /statusz section."""
    out = {}
    for side, (cls, mod) in {"jax": (jinf.FleetAutoscaler, _jmetrics),
                             "torch": (FleetAutoscaler, _pmetrics)}.items():
        fleet = _FakeDisagg(["prefill", "decode", "both"], metrics=mod) \
            if kind == "disagg" else _FakeFleet(2, metrics=mod)
        clock = _Clock()
        ctl = _ctl(fleet, clock, cls=cls, down_stable_ticks=2,
                   max_replicas=5, chip_budget=9.0, chips_per_replica=2.0)
        rng = random.Random(seed)
        for tick in range(60):
            _random_walk(fleet, rng, tick)
            if tick % 17 == 5:
                fleet.replicas[min(fleet.replicas)].state = "draining"
            _tick(ctl, clock, dt=rng.choice((0.5, 1.0, 2.0)))
        out[side] = (list(ctl.decisions), ctl.actions(), ctl.statusz(),
                     fleet.scale_up_calls, fleet.scale_down_calls)
    assert out["torch"] == out["jax"]
    assert out["torch"][1], "the walk never moved the controller"


# ---- production scenarios on a real tiny fleet -----------------------------

_CTL_KW = dict(min_replicas=1, max_replicas=3,
               up_cooldown_s=2.0, down_cooldown_s=3.0,
               queue_high=3.0, queue_low=0.5,
               occupancy_high=0.85, occupancy_low=0.35,
               down_stable_ticks=3)
_ENG = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
            prompt_buckets=(8, 16), greedy=True)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    """A tiny one-layer Llama in f32 (seed 0), the JAX scenario tests'
    geometry."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=1,
                              scan_layers=False)
    m = LlamaForCausalLM(cfg, device="cpu", seed=0)
    m.eval()
    return m


def _run(model, name, *, num_replicas=1, ctl_kw=None, steps_per_tick=4):
    sc = load_harness.SCENARIOS[name]
    schedule = load_harness.build_scenario(
        name, vocab=model.config.vocab_size, seed=0)

    def make(role=None, **_):
        return ContinuousBatchingEngine(model, device="cpu", **_ENG)

    fleet = ServingFleet(make, num_replicas,
                         slo_rules=[SLORule(**d) for d in sc["slo_rules"]],
                         hedge_delay_s=None, seed=0)
    clock = load_harness.TickClock()
    ctl = FleetAutoscaler(fleet, **dict(_CTL_KW, now_fn=clock,
                                        **(ctl_kw or {})))
    try:
        report = load_harness.run_fleet_scenario(
            fleet, schedule, autoscaler=ctl, clock=clock,
            events=sc.get("events"), shed_exc=Overloaded,
            steps_per_tick=steps_per_tick)
    finally:
        fleet.close()
    return sc, fleet, ctl, clock, report


def _assert_common(sc, ctl, clock, report):
    assert report["failed"] == 0, report
    assert report["slo"]["worst_attainment"] >= sc["attainment_bar"], \
        report["slo"]
    cool = {"scale_up": ctl.up_cooldown_s,
            "scale_down": ctl.down_cooldown_s}
    acts = ctl.actions()
    for a, b in zip(acts, acts[1:]):
        assert b["t"] - a["t"] >= cool[a["action"]], (a, b)
    assert report["chip_seconds"] < ctl.max_replicas \
        * ctl.chips_per_replica * clock.t, report["chip_seconds"]
    for d in report["decisions"]:
        assert {"tick", "t", "action", "rule", "reason",
                "signals"} <= set(d), d
        assert "queue_per_replica" in d["signals"], d


def _statusz_autoscaler(fleet):
    sections = fleet.statusz_sections()
    assert "autoscaler" in sections
    return sections["autoscaler"]()


def test_flash_crowd_scales_up_within_onset_window(model):
    sc, fleet, ctl, clock, report = _run(model, "flash_crowd")
    _assert_common(sc, ctl, clock, report)
    assert report["goodput_frac"] >= 0.95, report
    ups = [a for a in ctl.actions() if a["action"] == "scale_up"]
    assert ups, "flash crowd never triggered a scale-up"
    assert ups[0]["tick"] <= sc["window"][0] + 7, ups[0]
    assert report["peak_ready"] >= 2, report
    downs = [a for a in ctl.actions() if a["action"] == "scale_down"]
    assert downs, "idle tail never gave capacity back"
    final_ready = sum(1 for r in fleet.replicas.values()
                      if r.takes_weight())
    assert final_ready < report["peak_ready"], report
    sz = _statusz_autoscaler(fleet)
    assert sz["scale_ups"] == len(ups)
    assert sz["scale_downs"] == len(downs)
    logged = [(d["tick"], d["action"]) for d in sz["decisions"]]
    for a in ctl.actions():
        assert (a["tick"], a["action"]) in logged


def test_rolling_upgrade_backfills_drained_capacity(model):
    sc, fleet, ctl, clock, report = _run(
        model, "rolling_upgrade", num_replicas=2,
        ctl_kw=dict(min_replicas=2, max_replicas=3))
    _assert_common(sc, ctl, clock, report)
    assert report["shed"] == 0 and report["goodput_frac"] == 1.0, report
    ups = [a for a in ctl.actions() if a["action"] == "scale_up"]
    drain_ticks = sorted(sc["events"])
    assert len(ups) >= 2, "no backfill after the operator drains"
    assert any(a["tick"] > drain_ticks[0] for a in ups), ups
    assert any(a["tick"] > drain_ticks[1] for a in ups), ups
    assert all(a["rule"] == "below_min_replicas" for a in ups), ups
    assert report["min_ready"] >= 1, report
    assert all(a["action"] == "scale_up" for a in ctl.actions())
