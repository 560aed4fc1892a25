"""The port's serving reliability (paddle_tpu_torch.inference: preemption
and recompute, deadlines and cancellation, admission control, step-
failure containment, supervised restarts) against the JAX engine's, on
the workloads of tests/test_serving_reliability.py: the same greedy
streams token for token, the same finish reasons and typed errors, the
same scheduling counters and a balanced page audit after each workload,
on a one-layer LlamaConfig.tiny() in f32 whose weights both engines
share. Deadlines run on a frozen clock patched into both serving
modules (never a sleep); the fault plans are each package's own
FaultInjector."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.inference.serving as jserving
from paddle_tpu import inference as jinf
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.testing import FaultInjector as JFaultInjector

import paddle_tpu_torch.inference.serving as tserving
from paddle_tpu_torch import convert
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.testing import FaultInjector as TFaultInjector

torch.set_num_threads(1)

VOCAB = 256
ENGINE = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
              prompt_buckets=(8, 16), greedy=True)
COUNTERS = ("prefills", "unified_steps", "tokens_emitted",
            "requests_completed", "chunks_empty", "prefill_waves",
            "prefix_cache_hits", "prefix_cache_misses",
            "prefix_cache_tokens_saved", "prefix_cache_cow_forks",
            "prefix_cache_evictions", "prefix_cache_pages",
            "preempt_evictions", "preempt_recompute_tokens",
            "requests_cancelled", "deadline_expired", "shed_rejections",
            "containments", "quarantined")


@pytest.fixture(scope="module")
def models():
    """The JAX test's model (tiny, one layer, seed 0) and the port's
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
    return jm, tm


#: the two packages, side by side: engine class, the module whose clock
#: the engine reads, its typed errors and reliability classes, its
#: fault injector, and the extra arguments its engine takes
SIDES = {"jax": dict(inf=jinf, mod=jserving, fi=JFaultInjector, kw={}),
         "torch": dict(inf=tinf, mod=tserving, fi=TFaultInjector,
                       kw=dict(device="cpu"))}


def _factory(models, side, **kw):
    model = models[0] if side == "jax" else models[1]
    s = SIDES[side]
    kw = {**ENGINE, **s["kw"], **kw}
    return lambda: s["inf"].ContinuousBatchingEngine(model, **kw)


def _summary(eng):
    g = eng.gauges()
    return {"requests": [(r.request_id, list(r.tokens), r.finish_reason,
                          type(r.error).__name__ if r.error else None)
                         for r in sorted(eng.completed,
                                         key=lambda r: r.request_id)],
            "counters": {k: g[k] for k in COUNTERS}}


def _balanced(eng):
    assert len(eng._free_pages) + eng.prefix_cache_pages \
        == eng.num_pages - 1, (
        len(eng._free_pages), eng.prefix_cache_pages, eng.num_pages)
    assert not eng._deferred_free
    assert all(not p for p in eng.slot_pages)
    assert all(not s for s in eng.slot_shared)
    eng._audit_pages("test")


def _same(models, workload, **kw):
    """Run ``workload(eng, side)`` on a fresh engine of each package;
    the summaries must be equal and both audits balanced. Returns
    {side: (engine, workload result)}."""
    out = {}
    for side in SIDES:
        eng = _factory(models, side, **kw)()
        out[side] = (eng, workload(eng, side))
        _balanced(eng)
    assert _summary(out["torch"][0]) == _summary(out["jax"][0])
    return out


def _prompts(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (p,)).astype(np.int32) for p in shapes]


def _refs(models, specs, **kw):
    """Uncontended single-slot streams of the port (the recompute
    oracle)."""
    out = []
    for p, n in specs:
        eng = _factory(models, "torch", num_slots=1, **kw)()
        eng.add_request(p, n)
        out.append(eng.run()[0].tokens)
    return out


# ---- preemption and recompute ------------------------------------------------

def test_priority_preemption_recompute_parity(models):
    pA, pB, pH = _prompts(7, (6, 9, 7))

    def workload(eng, side):
        ids = [eng.add_request(pA, 30), eng.add_request(pB, 28)]
        for _ in range(3):
            eng.step()           # both slots admitted and decoding
        ids.append(eng.add_request(pH, 20, priority=5))
        by = {r.request_id: r for r in eng.run()}
        return [by[i] for i in ids]

    res = _same(models, workload)
    eng, (a, b, h) = res["torch"]
    assert [r.tokens for r in (a, b, h)] == _refs(
        models, [(pA, 30), (pB, 28), (pH, 20)])
    assert a.preemptions + b.preemptions >= 1
    assert eng.gauges()["preempt_evictions"] >= 1
    assert eng.gauges()["preempt_recompute_tokens"] >= 1


@pytest.mark.parametrize("admit_batch", [None, 1])
def test_equal_priority_overload_queues_without_preemption(models,
                                                           admit_batch):
    """Pure overload queues without preemption; ``admit_batch=1`` lets
    one prefilling slot ride a step at a time."""
    specs = list(zip(_prompts(11, [5, 9, 7, 11, 4, 8]), [6, 4, 7, 5, 8, 3]))

    def workload(eng, side):
        ids = [eng.add_request(p, n) for p, n in specs]
        by = {r.request_id: r for r in eng.run()}
        return [by[i].tokens for i in ids]

    res = _same(models, workload, admit_batch=admit_batch)
    assert res["torch"][1] == _refs(models, specs)
    assert res["torch"][0].gauges()["preempt_evictions"] == 0


def test_preemption_replay_composes_with_int8_kv(models):
    """tests/test_quant_serving.py's starved int8 pool: one request's
    pages at a time, each later arrival of higher priority preempting
    the running one; every stream equals an unpressured int8 engine's."""
    specs = [(p, 6) for p in _prompts(13, (9, 11, 8))]
    geo = dict(kv_quant="int8", prompt_buckets=(16,))

    def workload(eng, side):
        ids = [eng.add_request(p, n, priority=i)
               for i, (p, n) in enumerate(specs)]
        by = {r.request_id: r for r in eng.run()}
        return [by[i] for i in ids]

    res = _same(models, workload, num_pages=4, **geo)
    reqs = res["torch"][1]
    assert all(r.error is None for r in reqs)
    calm = _factory(models, "torch", num_slots=3, **geo)()
    ids = [calm.add_request(p, n) for p, n in specs]
    by = {r.request_id: r.tokens for r in calm.run()}
    assert [r.tokens for r in reqs] == [by[i] for i in ids]


# ---- deadlines and cancellation ---------------------------------------------

def test_cancel_mid_decode(models):
    pA, pB = _prompts(13, (6, 9))

    def workload(eng, side):
        c1 = eng.add_request(pA, 30)
        c2 = eng.add_request(pB, 5)
        while not eng.request(c1).tokens:
            eng.step()
        assert eng.cancel(c1)
        assert not eng.cancel(999)          # unknown id
        eng.run()
        by = {r.request_id: r for r in eng.completed}
        return by[c1], by[c2]

    res = _same(models, workload)
    eng, (r1, r2) = res["torch"]
    assert isinstance(r1.error, tinf.RequestCancelled)
    assert r1.finish_reason == "cancelled"
    assert r1.tokens and len(r1.tokens) < 30     # partial stream kept
    assert r2.tokens == _refs(models, [(pB, 5)])[0]
    assert eng.gauges()["requests_cancelled"] == 1


def test_cancel_mid_prefill(models):
    (pLong,) = _prompts(17, (30,))

    def workload(eng, side):
        rid = eng.add_request(pLong, 8)
        eng.step()                            # first prefill chunk only
        req = eng.request(rid)
        assert not req.tokens and eng._prefilling.any()
        eng.cancel(rid)
        eng.run()
        return req

    res = _same(models, workload, max_len=64, prefill_chunk=8,
                prompt_buckets=(8,))
    req = res["torch"][1]
    assert req.finished and req.tokens == []
    assert isinstance(req.error, tinf.RequestCancelled)


def test_ttft_deadline_expires_while_queued(models, monkeypatch):
    """The second request's TTFT deadline lapses while it waits behind
    the first (one slot): it is shed with DeadlineExceeded('ttft')
    without ever taking a slot. The clock both engines read is frozen
    and moved by hand."""
    pA, pB = _prompts(23, (6, 9))
    clock = types.SimpleNamespace(t=1000.0)
    fake = types.SimpleNamespace(perf_counter=lambda: clock.t)
    for side in SIDES:
        monkeypatch.setattr(SIDES[side]["mod"], "time", fake)

    def workload(eng, side):
        clock.t = 1000.0
        d1 = eng.add_request(pA, 10)
        d2 = eng.add_request(pB, 5, ttft_deadline_s=1e-4)
        clock.t += 1.0
        by = {r.request_id: r for r in eng.run()}
        return by[d1], by[d2]

    res = _same(models, workload, num_slots=1)
    eng, (r1, r2) = res["torch"]
    assert isinstance(r2.error, tinf.DeadlineExceeded)
    assert r2.error.kind == "ttft"
    assert r2.tokens == [] and r2.finish_reason == "deadline"
    assert r1.error is None and len(r1.tokens) == 10
    assert eng.gauges()["deadline_expired"] == 1


def test_total_deadline_expires_mid_stream(models):
    (pA,) = _prompts(29, (6,))

    def workload(eng, side):
        rid = eng.add_request(pA, 30, deadline_s=3600.0)
        while len(eng.request(rid).tokens) < 2:
            eng.step()
        req = eng.request(rid)
        req.deadline_s = 1e-9                 # already lapsed
        eng.run()
        return req

    req = _same(models, workload)["torch"][1]
    assert isinstance(req.error, tinf.DeadlineExceeded)
    assert req.error.kind == "total" and len(req.tokens) >= 2


# ---- admission control and load shedding -------------------------------------

def test_admission_queue_bound_sheds_with_retry_after(models):
    pA, pB, pH = _prompts(31, (5, 6, 7))

    def workload(eng, side):
        inf = SIDES[side]["inf"]
        adm = inf.AdmissionController(eng, max_queue=2)
        adm.submit(pA, 4)
        adm.submit(pB, 4)
        with pytest.raises(inf.Overloaded) as ei:
            adm.submit(pH, 4)
        assert ei.value.retry_after_s > 0
        assert adm.shed == 1 and adm.accepted == 2
        assert eng.metrics.gauge("serving/shed_retry_after_s").value > 0
        return eng.run()

    res = _same(models, workload)
    eng, done = res["torch"]
    assert len(done) == 2 and eng.gauges()["shed_rejections"] == 1


def test_admission_slo_prediction_sheds_doomed_request(models):
    pA, pB = _prompts(37, (6, 8))

    def workload(eng, side):
        inf = SIDES[side]["inf"]
        adm = inf.AdmissionController(eng, max_queue=32)
        adm.submit(pA, 6)
        eng.run()                             # seeds ttft/itl reservoirs
        assert adm.predicted_ttft_s() is not None
        adm.submit(pB, 8)                     # queued work ahead
        with pytest.raises(inf.Overloaded):
            adm.submit(pA, 4, ttft_deadline_s=1e-7)
        rid = adm.submit(pA, 4, ttft_deadline_s=3600.0)
        done = eng.run()
        assert rid in {r.request_id for r in done}
        return adm.shed, adm.accepted

    res = _same(models, workload)
    assert res["torch"][1] == res["jax"][1] == (1, 3)


# ---- containment and supervision ---------------------------------------------

def test_containment_quarantines_poison_and_recomputes_innocents(models):
    pP, pI = _prompts(41, (6, 9))

    def workload(eng, side):
        rp = eng.add_request(pP, 8)
        ri = eng.add_request(pI, 6)
        with SIDES[side]["fi"]() as fi:
            fi.poison_request(rp, times=2)
            done = eng.run()
            assert fi.fires() == 2
        by = {r.request_id: r for r in eng.completed}
        return by[rp], by[ri], len(done)

    res = _same(models, workload, max_strikes=2)
    eng, (rp, ri, n_done) = res["torch"]
    assert isinstance(rp.error, tinf.RequestQuarantined)
    assert rp.finish_reason == "quarantined"
    assert ri.error is None and n_done == 2
    assert ri.tokens == _refs(models, [(pI, 6)])[0]
    assert eng.gauges()["containments"] >= 1
    assert eng.gauges()["quarantined"] == 1
    # the sampler's generator restarts from seed + containments
    assert eng._gen.initial_seed() == eng._containments_run == 2


def test_containment_escapes_a_kernel_failure(models):
    """A kernel that cannot be built or launched is never contained:
    the step's KernelError propagates at once, budget or not."""
    from paddle_tpu_torch.ops.kernels._build import KernelError
    eng = _factory(models, "torch")()
    eng.add_request(_prompts(3, (6,))[0], 4)

    def broken(inputs):
        raise KernelError("ragged_paged_attention: CUDA error 700")

    eng._device_step = broken
    with pytest.raises(KernelError):
        eng.run()
    assert eng.gauges()["containments"] == 0


def _dying_factory(models, side, deaths):
    """Engines whose harvest raises for the first ``deaths`` calls in
    all (counted across the engines the factory builds), with no
    containment budget: each failure escapes to the supervisor."""
    calls = {"n": 0}
    make = _factory(models, side, max_containments=0)

    def factory():
        eng = make()
        orig = eng._harvest_step

        def dying(rec):
            calls["n"] += 1
            if calls["n"] <= deaths:
                raise RuntimeError("injected engine death")
            return orig(rec)

        eng._harvest_step = dying
        return eng
    return factory


def test_supervisor_restarts_dead_engine_and_replays(models):
    (pA,) = _prompts(43, (6,))
    out = {}
    for side in SIDES:
        sup = SIDES[side]["inf"].EngineSupervisor(
            _dying_factory(models, side, deaths=2), max_restarts=3)
        rid = sup.add_request(pA, 8)
        by = {r.request_id: r for r in sup.run()}
        _balanced(sup.engine)
        out[side] = (sup.restarts, by[rid].tokens,
                     {k: sup.gauges()[k] for k in COUNTERS})
    assert out["torch"] == out["jax"]
    assert out["torch"][0] >= 1
    assert out["torch"][1] == _refs(models, [(pA, 8)])[0]


def test_supervisor_restart_budget_exhausts(models):
    (pA,) = _prompts(47, (5,))
    for side in SIDES:
        sup = SIDES[side]["inf"].EngineSupervisor(
            _dying_factory(models, side, deaths=10 ** 6), max_restarts=1)
        sup.add_request(pA, 4)
        with pytest.raises(RuntimeError, match="injected engine death"):
            sup.run()
        assert sup.restarts == 1, side


def test_wedged_slot_recovers(models):
    """A slot that stops draining (the wedge-slot plan) cannot wedge
    the service: the deadlock eviction or the supervisor replays it,
    and the request completes with its full stream."""
    (prompt,) = _prompts(5, (6,))
    out = {}
    for side in SIDES:
        sup = SIDES[side]["inf"].EngineSupervisor(
            _factory(models, side), max_restarts=2)
        rid = sup.add_request(prompt, 5)
        with SIDES[side]["fi"]() as fi:
            fi.wedge_slot(0, times=10_000)
            by = {r.request_id: r for r in sup.run()}
            assert fi.fires() >= 1
        _balanced(sup.engine)
        out[side] = (sup.restarts, by[rid].tokens, by[rid].error)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == _refs(models, [(prompt, 5)])[0]
    assert out["torch"][0] >= 1


def test_supervisor_and_controller_raise_where_there_is_no_gpu(
        models, monkeypatch):
    """With no GPU and no device, neither the engine a supervisor's
    factory builds nor a controller in front of it runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = models
    kw = {k: v for k, v in ENGINE.items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.AdmissionController(tinf.EngineSupervisor(
            lambda: tinf.ContinuousBatchingEngine(tm, **kw)))


# ---- churn ------------------------------------------------------------------

def test_churn_cancel_preempt_zero_leak_fast(models):
    """24 requests with priorities, preemptions and mid-flight cancels
    through a pool that cannot hold them at once: the same completions
    in both engines, zero pages leaked."""
    def workload(eng, side):
        rng = np.random.RandomState(59)
        ids = []
        for _ in range(24):
            plen = int(rng.randint(3, 12))
            n_new = int(rng.randint(1, 8))
            prio = int(rng.randint(0, 3))
            rid = eng.add_request(
                rng.randint(0, VOCAB, (plen,)).astype(np.int32), n_new,
                priority=prio)
            ids.append(rid)
            if rng.rand() < 0.2:
                eng.cancel(rid)
            if rng.rand() < 0.3:
                eng.step()                # interleave admission/decode
                if rng.rand() < 0.3 and ids:
                    eng.cancel(int(rng.choice(ids)))   # mid-flight
        eng.run()
        return ids

    res = _same(models, workload)
    eng, ids = res["torch"]
    by = {r.request_id: r for r in eng.completed}
    assert sorted(by) == sorted(ids)
    for r in by.values():
        assert r.finished
        assert (r.error is None) == (r.finish_reason in ("eos", "length"))
