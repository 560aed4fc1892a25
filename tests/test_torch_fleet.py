"""The port's ServingFleet (paddle_tpu_torch.inference.fleet) against the
JAX package's, on the scenarios of tests/test_fleet_reliability.py,
tests/test_fleet_chaos.py's smoke and tests/test_fleet_trace.py.

Each scenario runs twice, once through each package's fleet, over a
one-layer LlamaConfig.tiny() in f32 whose weights the port takes from
the JAX model through ``convert``, with the same submissions and the
same fault plans (each package's own FaultInjector). Both sides must
meet the JAX test's contract (every fleet id delivered once, each greedy
stream equal to its uncontended single-engine run), and the sides must
agree exactly: the stream of every fleet id, the typed error names, and
the ``breaker_open``, ``requeued`` and ``retries`` gauges. Streams are
compared exactly; there is no tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.profiler import trace as jtrace
from paddle_tpu.testing import FaultInjector as JFaultInjector

from paddle_tpu_torch import convert
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.inference.reliability import MAX_HOPS
from paddle_tpu_torch.inference.serving import (ServedRequest, record_hop,
                                                request_trace_summary)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.profiler import trace as ttrace
from paddle_tpu_torch.testing import FaultInjector as TFaultInjector

pytestmark = pytest.mark.fault

torch.set_num_threads(1)

ENGINE = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
              prompt_buckets=(8, 16), greedy=True)
#: the fleet gauges the sides must agree on
GAUGES = ("breaker_open", "requeued", "retries")

SIDES = {"jax": dict(inf=jinf, fi=JFaultInjector, trace=jtrace, kw={}),
         "torch": dict(inf=tinf, fi=TFaultInjector, trace=ttrace,
                       kw=dict(device="cpu"))}


@pytest.fixture(scope="module")
def models():
    """The JAX tests' model (tiny, one layer, seed 0) and the port's
    with its weights."""
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.num_hidden_layers = 1
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=1)
    tm = convert.from_numpy_state_dict(
        LlamaForCausalLM(tcfg, device="cpu"), arrays)
    return {"jax": jm, "torch": tm, "vocab": cfg.vocab_size}


def _factory(models, side, **kw):
    s = SIDES[side]
    kw = {**ENGINE, **s["kw"], **kw}
    return lambda: s["inf"].ContinuousBatchingEngine(models[side], **kw)


_REF = {}


def _reference(models, side, prompt, n_new):
    """The uncontended single-engine greedy stream of one request."""
    key = (side, prompt.tobytes(), int(n_new))
    if key not in _REF:
        eng = _factory(models, side)()
        eng.add_request(prompt, n_new)
        _REF[key] = eng.run()[-1].tokens
    return _REF[key]


def _prompts(models, seed, n, lo=3, hi=10):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, models["vocab"],
                        (int(rng.randint(lo, hi)),)).astype(np.int32)
            for _ in range(n)]


def _fleet(models, side, engine_kw=None, **kw):
    """Hedging is off unless a scenario turns it on: its p99-derived
    delay reads the clock, and the sides must route alike."""
    kw.setdefault("hedge_delay_s", 1e9)
    return SIDES[side]["inf"].ServingFleet(
        _factory(models, side, **(engine_kw or {})), **kw)


def _outcome(fleet, done):
    g = fleet.gauges()
    return {"streams": {r.request_id: list(r.tokens) for r in done},
            "errors": {r.request_id: type(r.error).__name__
                       if r.error is not None else None for r in done},
            "gauges": {k: g[k] for k in GAUGES}}


def _both(scenario):
    """Run ``scenario(side) -> (fleet, done)`` through each package;
    the sides' outcomes must be equal. Returns {side: (fleet, done)}."""
    out = {side: scenario(side) for side in SIDES}
    assert _outcome(*out["torch"]) == _outcome(*out["jax"])
    return out


def _assert_identity(models, side, done, fids, specs):
    """Every fid delivered exactly once, error-free, equal to its
    uncontended single-engine stream."""
    assert len(done) == len(fids), "lost or duplicated completions"
    by = {r.request_id: r for r in done}
    assert sorted(by) == sorted(fids)
    for fid, (prompt, n_new) in zip(fids, specs):
        r = by[fid]
        assert r.error is None, (side, fid, r.error)
        assert r.tokens == _reference(models, side, prompt, n_new), fid


def _balanced(fleet):
    for rep in fleet.replicas.values():
        if not rep.live():
            continue            # ejected/retired engines are discarded
        eng = rep.engine
        assert len(eng._free_pages) + eng.prefix_cache_pages \
            == eng.num_pages - 1, rep.id
        assert not eng._deferred_free
        assert all(not p for p in eng.slot_pages)
        assert all(not s for s in eng.slot_shared)


# ---- failover --------------------------------------------------------------

def test_failover_token_identity_supervisor_restart(models):
    """A replica dying mid-stream loses no request and every stream is
    its uncontended one: the death is absorbed by the supervisor."""
    specs = [(p, 5) for p in _prompts(models, 1, 6)]

    def scenario(side):
        fleet = _fleet(models, side, num_replicas=2, max_restarts=2,
                       retry_backoff_s=0.01)
        fids = [fleet.submit(p, n) for p, n in specs]
        with SIDES[side]["fi"]() as fi:
            fi.kill_replica(0, times=1, after_steps=2)
            done = fleet.run()
            assert fi.fires() == 1
        _assert_identity(models, side, done, fids, specs)
        assert fleet.replicas[0].supervisor.restarts == 1
        assert fleet.gauges()["breaker_open"] == 0
        assert fleet.replicas[0].state == "ready"
        return fleet, done

    _both(scenario)


def test_breaker_ejection_requeues_to_siblings(models):
    """A replica that keeps dying past its supervisor budget trips the
    breaker: ejected, its requests requeued to the sibling under
    bounded retries, the streams unchanged."""
    specs = [(p, 5) for p in _prompts(models, 2, 4, lo=6, hi=7)]

    def scenario(side):
        fleet = _fleet(models, side, num_replicas=2, max_restarts=1,
                       retry_backoff_s=0.01)
        fids = [fleet.submit(p, n) for p, n in specs]
        with SIDES[side]["fi"]() as fi:
            fi.kill_replica(0, times=10_000)
            done = fleet.run()
        _assert_identity(models, side, done, fids, specs)
        g = fleet.gauges()
        assert fleet.replicas[0].state == "ejected"
        assert g["breaker_open"] == 1
        assert g["requeued"] >= 1 and g["retries"] >= 1
        assert g["failover_ms_p99"] > 0.0
        _balanced(fleet)
        return fleet, done

    _both(scenario)


# ---- health model ----------------------------------------------------------

def test_wedged_replica_ejected_by_no_progress(models):
    """A wedged replica (its step returns, nothing moves) is ejected by
    the no-progress check, not the breaker, and run() returns
    normally."""
    specs = [(p, 5) for p in _prompts(models, 3, 4, lo=6, hi=7)]

    def scenario(side):
        fleet = _fleet(models, side, num_replicas=2, no_progress_turns=5,
                       retry_backoff_s=0.01, hedge_delay_s=1e9)
        fids = [fleet.submit(p, n) for p, n in specs]
        with SIDES[side]["fi"]() as fi:
            fi.wedge_replica(0, times=10_000)
            done = fleet.run()
            assert fi.fires() >= 5
        _assert_identity(models, side, done, fids, specs)
        g = fleet.gauges()
        assert g["wedge_ejections"] == 1
        assert g["breaker_open"] == 0
        assert fleet.replicas[0].state == "ejected"
        return fleet, done

    _both(scenario)


# ---- hedging ---------------------------------------------------------------

def test_hedge_winner_cancels_loser(models):
    """A straggler's request is copied to the sibling after the hedge
    delay; the copy wins, the loser is cancelled, and exactly one
    completion is delivered."""
    spec = (_prompts(models, 4, 1, lo=6, hi=7)[0], 5)

    def scenario(side):
        fleet = _fleet(models, side, num_replicas=2, hedge_delay_s=0.03,
                       retry_backoff_s=0.01)
        with SIDES[side]["fi"]() as fi:
            fi.slow_replica(0, delay_s=0.05, stride=6)
            fid = fleet.submit(*spec)
            done = fleet.run()
        _assert_identity(models, side, done, [fid], [spec])
        g = fleet.gauges()
        assert g["hedges"] == 1 and g["hedge_wins"] == 1
        assert g["hedge_cancels"] >= 1
        assert g["completed"] == 1
        return fleet, done

    _both(scenario)


# ---- draining and elasticity -------------------------------------------

@pytest.mark.parametrize("deadline_s", [60.0, 0.0])
def test_drain(models, deadline_s):
    """scale_down with room lets the replica finish its requests (no
    eviction); with an expired deadline its stragglers go through the
    engine's handoff() to the sibling. Either way nothing is lost and
    the streams are unchanged."""
    specs = [(p, 5) for p in _prompts(models, 5 if deadline_s else 6, 4,
                                      lo=6, hi=7)]

    def scenario(side):
        fleet = _fleet(models, side, num_replicas=2)
        fids = [fleet.submit(p, n) for p, n in specs]
        rid = fleet.scale_down(0, deadline_s=deadline_s)
        done = fleet.run()
        _assert_identity(models, side, done, fids, specs)
        g = fleet.gauges()
        assert fleet.replicas[rid].state == "retired"
        assert g["drains"] == 1
        if deadline_s:
            assert g["requeued"] == 0
        else:
            assert g["requeued"] >= 1
        _balanced(fleet)
        return fleet, done

    _both(scenario)


def test_scale_up_warms_before_taking_weight(models):
    """A scaled-up replica runs a sacrificial request (id -1) and resets
    its gauges before it takes weight; the warm-up stays out of the
    trace log."""
    specs = [(p, 4) for p in _prompts(models, 7, 2, lo=6, hi=7)]

    def scenario(side):
        log = SIDES[side]["trace"].get_trace_log()
        log.clear()
        fleet = _fleet(models, side, num_replicas=1)
        rid = fleet.scale_up()
        rep = fleet.replicas[rid]
        assert rep.state == "ready"
        assert rep.engine._compiled
        assert rep.engine._stats["tokens_emitted"] == 0
        assert not log.recent()
        assert fleet.gauges()["scale_ups"] == 1
        fids = [fleet.submit(p, n) for p, n in specs]
        done = fleet.run()
        assert sorted(e["trace_id"] for e in log.recent()) == sorted(fids)
        _assert_identity(models, side, done, fids, specs)
        return fleet, done

    _both(scenario)


def test_operator_eject_is_not_a_breaker_trip(models):
    """fleet.eject() fails the replica's work over at once without a
    breaker trip or a spent retry."""
    specs = [(p, 5) for p in _prompts(models, 12, 3, lo=6, hi=7)]

    def scenario(side):
        fleet = _fleet(models, side, num_replicas=2, max_retries=0)
        fids = [fleet.submit(p, n) for p, n in specs]
        fleet.eject(0)
        done = fleet.run()
        _assert_identity(models, side, done, fids, specs)
        g = fleet.gauges()
        assert fleet.replicas[0].state == "ejected"
        assert g["breaker_open"] == 0 and g["retries"] == 0
        assert g["requeued"] >= 1
        return fleet, done

    _both(scenario)


# ---- shedding and retry-after ----------------------------------------------

def test_all_breakers_open_sheds_fleet_wide(models):
    """Every replica dead: outstanding requests complete with the typed
    ReplicaFailed, and a new submission raises Overloaded with the
    configured fleet-wide retry-after."""
    prompts = _prompts(models, 8, 2, lo=6, hi=7)

    def scenario(side):
        inf = SIDES[side]["inf"]
        fleet = _fleet(models, side, num_replicas=2, max_restarts=0,
                       retry_backoff_s=0.01, max_retries=2,
                       all_open_retry_after_s=0.7)
        fids = [fleet.submit(p, 5) for p in prompts]
        with SIDES[side]["fi"]() as fi:
            fi.kill_replica(0, times=10_000)
            fi.kill_replica(1, times=10_000)
            done = fleet.run()
        by = {r.request_id: r for r in done}
        assert sorted(by) == sorted(fids)
        for fid in fids:
            assert isinstance(by[fid].error, inf.ReplicaFailed)
            assert by[fid].finish_reason == "failed"
        assert fleet.gauges()["breaker_open"] == 2
        with pytest.raises(inf.Overloaded) as exc:
            fleet.submit(prompts[0], 5)
        assert exc.value.retry_after_s == pytest.approx(0.7)
        return fleet, done

    _both(scenario)


def test_overloaded_retry_after_is_max_across_replicas(models):
    """When every ready replica sheds, Overloaded carries the largest of
    the controllers' retry-afters."""
    prompts = _prompts(models, 9, 3, lo=6, hi=7)
    for side in SIDES:
        fleet = _fleet(models, side, num_replicas=2, max_queue=1)
        fleet.replicas[0].admission.min_retry_after_s = 0.3
        fleet.replicas[1].admission.min_retry_after_s = 0.7
        fleet.submit(prompts[0], 4)
        fleet.submit(prompts[1], 4)
        with pytest.raises(SIDES[side]["inf"].Overloaded) as exc:
            fleet.submit(prompts[2], 4)
        assert exc.value.retry_after_s == pytest.approx(0.7)
        assert fleet.gauges()["shed_rejections"] == 1
        assert fleet.gauges()["submitted"] == 2


def test_retry_backoff_matches_jax_schedule(models):
    """The retry schedule (exponential, jittered, capped, floored by a
    computed retry-after) draws the same values from the same seed."""
    fleets = {side: _fleet(models, side, num_replicas=1,
                           retry_backoff_s=0.05, retry_backoff_cap_s=2.0,
                           retry_jitter=0.25, seed=7) for side in SIDES}
    for attempt in (1, 2, 3, 4):
        base = 0.05 * 2 ** (attempt - 1)
        for _ in range(20):
            b = fleets["torch"]._backoff_s(attempt)
            assert b == fleets["jax"]._backoff_s(attempt)
            assert base * 0.75 - 1e-9 <= b <= min(2.0, base * 1.25) + 1e-9
    assert fleets["torch"]._backoff_s(1, floor_s=5.0) == 5.0
    assert fleets["torch"]._backoff_s(12) == 2.0


def test_cancel_while_carried_is_not_resurrected(models):
    """A request cancelled while it waits out its failover backoff
    completes with RequestCancelled and is never re-admitted."""
    prompt = _prompts(models, 11, 1, lo=6, hi=7)[0]

    def scenario(side):
        fleet = _fleet(models, side, num_replicas=2, max_restarts=0,
                       retry_backoff_s=30.0)
        with SIDES[side]["fi"]() as fi:
            fi.kill_replica(0, times=10_000)
            fid = fleet.submit(prompt, 5)
            out = fleet.step()
            assert not out and fleet.request(fid) is not None
            assert fleet.cancel(fid)
            done = fleet.step()
        assert len(done) == 1
        assert isinstance(done[0].error,
                          SIDES[side]["inf"].RequestCancelled)
        assert fleet.gauges()["completed"] == 1
        return fleet, done

    _both(scenario)


def test_fleet_cancel_and_request_surface(models):
    """fleet.cancel(fid) completes the request with RequestCancelled at
    the next turn; fleet.request(fid) follows it to its completion."""
    prompt = _prompts(models, 10, 1, lo=6, hi=7)[0]

    def scenario(side):
        fleet = _fleet(models, side, num_replicas=1)
        fid = fleet.submit(prompt, 5)
        assert fleet.request(fid) is not None
        assert fleet.cancel(fid)
        done = fleet.run()
        assert len(done) == 1
        assert isinstance(done[0].error,
                          SIDES[side]["inf"].RequestCancelled)
        assert fleet.request(fid) is done[0]
        assert not fleet.cancel(fid)
        return fleet, done

    _both(scenario)


# ---- the chaos smoke -------------------------------------------------------

def test_kill_one_of_four_replicas_smoke(models):
    """A four-replica fleet, one replica killed hard enough to trip its
    breaker: no request lost, every stream its uncontended one, no page
    leaked on the survivors."""
    rng = np.random.RandomState(11)
    specs = [(rng.randint(0, models["vocab"],
                          (int(rng.randint(3, 10)),)).astype(np.int32),
              int(rng.randint(2, 7))) for _ in range(10)]

    def scenario(side):
        fleet = _fleet(models, side, num_replicas=4, max_restarts=1,
                       retry_backoff_s=0.01)
        fids = [fleet.submit(p, n) for p, n in specs]
        with SIDES[side]["fi"]() as fi:
            fi.kill_replica(1, times=10_000, after_steps=1)
            done = fleet.run()
            assert fi.fires() >= 2
        _assert_identity(models, side, done, fids, specs)
        _balanced(fleet)
        g = fleet.gauges()
        assert fleet.replicas[1].state == "ejected"
        assert g["breaker_open"] == 1
        assert g["completed"] == len(fids)
        return fleet, done

    _both(scenario)


# ---- traces ------------------------------------------------------------

def _kinds(req):
    return [h["kind"] for h in req.hops]


def _drive_until(fleet, pred, max_turns=200):
    for _ in range(max_turns):
        fleet.step()
        if pred():
            return True
    return False


def test_standalone_engine_hops_and_trace_log(models):
    """Without a fleet the engine records admit/finish hops and feeds
    the trace log at completion (trace id = request id); the two
    packages log the same summary, times excepted."""
    logged = {}
    for side in SIDES:
        log = SIDES[side]["trace"].get_trace_log()
        log.clear()
        eng = _factory(models, side, num_slots=2)()
        rid = eng.add_request(_prompts(models, 0, 1, 6, 7)[0], 3,
                              tenant="solo")
        req = eng.run()[-1]
        assert req.trace_id is None
        assert _kinds(req) == ["admit", "finish"]
        (e,) = [e for e in log.recent() if e["trace_id"] == rid]
        assert e["tenant"] == "solo" and e["tokens"] == 3
        logged[side] = {k: v for k, v in e.items()
                        if k not in ("latency_ms", "ttft_ms", "hops")}
        logged[side]["hops"] = [{k: v for k, v in h.items() if k != "t"}
                                for h in e["hops"]]
        log.clear()
    assert logged["torch"] == logged["jax"]


def test_preemption_replay_hops(models):
    """A priority preemption inside one engine shows as admit, preempt,
    admit on the victim's hop list, the same kinds in both packages."""
    kinds = {}
    for side in SIDES:
        eng = _factory(models, side, num_slots=1, max_len=64)()
        victim = eng.add_request(_prompts(models, 0, 1, 6, 7)[0], 6)
        for _ in range(50):
            eng.step()
            if eng.slot_req[0] is not None:
                break
        assert eng.slot_req[0] is not None
        eng.add_request(_prompts(models, 1, 1, 5, 6)[0], 3, priority=5)
        v = {r.request_id: r for r in eng.run()}[victim]
        assert v.preemptions >= 1
        kinds[side] = _kinds(v)
        assert kinds[side].count("admit") >= 2
        assert kinds[side].index("preempt") > kinds[side].index("admit")
        assert kinds[side][-1] == "finish"
    assert kinds["torch"] == kinds["jax"]


def test_single_trace_id_through_preempt_restart_failover_and_hedge(models):
    """One client request goes through a priority preemption, a
    supervised restart, a failover past the restart budget and a hedge,
    all under one trace id, with exactly one delivery; the packages
    record the same hop kinds in the same order."""
    long_prompt = np.random.RandomState(0).randint(
        0, models["vocab"], (30,)).astype(np.int32)
    short = np.random.RandomState(2).randint(
        0, models["vocab"], (5,)).astype(np.int32)
    kinds_by_side = {}
    for side in SIDES:
        trace = SIDES[side]["trace"]
        trace.get_trace_log().clear()
        fleet = _fleet(models, side, dict(num_slots=1, max_len=64),
                       num_replicas=1, max_restarts=1,
                       retry_backoff_s=0.001, hedge_delay_s=1e9)
        vfid = fleet.submit(long_prompt, 4, priority=0)
        assert fleet.request(vfid).trace_id == vfid
        assert _drive_until(
            fleet, lambda: "admit" in _kinds(fleet.request(vfid)))
        hfid = fleet.submit(short, 2, priority=5)
        assert _drive_until(
            fleet, lambda: "preempt" in _kinds(fleet.request(vfid)))
        fleet.scale_up(warm=False)
        fleet.scale_up(warm=False)
        with SIDES[side]["fi"]() as fi:
            fi.kill_replica(0, times=10_000, after_steps=0)
            assert _drive_until(
                fleet, lambda: "salvage" in _kinds(fleet.request(vfid)))
            fleet.hedge_delay_s = 0.0005
            fleet.run()
        by = {}
        for r in fleet.completed:
            assert r.request_id not in by, "duplicated delivery"
            by[r.request_id] = r
        assert sorted(by) == sorted([vfid, hfid])
        vreq = by[vfid]
        assert vreq.error is None and vreq.trace_id == vfid
        kinds = _kinds(vreq)
        for stage in ("submit", "assign", "admit", "preempt",
                      "engine_restart", "salvage", "hedge", "finish",
                      "deliver"):
            assert stage in kinds, (side, stage, kinds)
        assert kinds.index("preempt") < kinds.index("engine_restart") \
            < kinds.index("salvage") < kinds.index("hedge")
        assert kinds.count("deliver") == 1 and kinds.count("finish") >= 2
        admit_reps = {h.get("replica") for h in vreq.hops
                      if h["kind"] == "admit"}
        assert 0 in admit_reps and admit_reps & {1, 2}, admit_reps
        g = fleet.gauges()
        assert (g["hedges"], g["breaker_open"], g["completed"]) == (1, 1, 2)
        (entry,) = [e for e in trace.get_trace_log().recent()
                    if e["trace_id"] == vfid]
        logged = [h["kind"] for h in entry["hops"]]
        assert logged == kinds[:len(logged)] and "deliver" in logged
        kinds_by_side[side] = logged
        trace.get_trace_log().clear()
    assert kinds_by_side["torch"] == kinds_by_side["jax"]


def test_failover_timeline_rebuilt_in_tracer(models):
    """With the tracer on, the port's fleet rebuilds the cross-replica
    timeline on one track: a fleet/request span, fleet/attempt spans on
    two replicas, and req/hop markers, all with tid = the trace id."""
    tracer = ttrace.get_tracer()
    tracer.clear()
    tracer.enabled = True
    try:
        fleet = _fleet(models, "torch", dict(num_slots=1, max_len=64),
                       num_replicas=2, max_restarts=0,
                       retry_backoff_s=0.001)
        fid = fleet.submit(np.random.RandomState(4).randint(
            0, models["vocab"], (30,)).astype(np.int32), 4)
        assert _drive_until(
            fleet, lambda: "admit" in _kinds(fleet.request(fid)))
        (rid0,) = {h.get("replica") for h in fleet.request(fid).hops
                   if h["kind"] == "admit"}
        with TFaultInjector() as fi:
            fi.kill_replica(rid0, times=10_000, after_steps=0)
            done = fleet.run()
        assert done[-1].error is None
    finally:
        tracer.enabled = False
    evs = list(tracer.events)
    tracer.clear()
    (parent,) = [e for e in evs if e.name == "fleet/request"]
    assert parent.tid == fid and parent.args["reason"] in ("eos", "length")
    attempts = [e for e in evs if e.name == "fleet/attempt"]
    assert len({e.args["replica"] for e in attempts}) >= 2
    assert all(e.tid == fid for e in attempts)
    hops = [e for e in evs if e.name == "req/hop"]
    assert hops and all(e.tid == fid for e in hops)
    assert any(e.args["kind"] == "salvage" for e in hops)


def test_hop_list_is_bounded():
    """Past MAX_HOPS the list's last slot becomes a truncation marker
    counting the overflow, visible to a sibling attempt sharing the
    list."""
    req = ServedRequest(0, np.zeros((4,), np.int32), 4)
    for _ in range(MAX_HOPS + 10):
        record_hop(req, "preempt")
    assert len(req.hops) == MAX_HOPS
    assert req.hops[-1] == {"kind": "truncated", "t": req.hops[-1]["t"],
                            "dropped": 11}
    sibling = ServedRequest(0, np.zeros((4,), np.int32), 4)
    sibling.hops = req.hops
    assert request_trace_summary(sibling)["hops_dropped"] == 11


def test_fleet_builds_engines_on_cuda_by_default(models, monkeypatch):
    """A fleet whose factory names no device builds its engines on
    cuda, so with no GPU the fleet refuses instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.ServingFleet(lambda: tinf.ContinuousBatchingEngine(
            models["torch"], **ENGINE), num_replicas=1)
