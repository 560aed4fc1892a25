"""The port's legacy engine (``ContinuousBatchingEngine(unified=False)``:
prefill waves and adaptive decode chunks) against the JAX package's,
on the CPU: tests/test_serving_parity.py's workload (the same greedy
streams as the JAX legacy engine and the port's unified engine, with and
without a mid-stream eos), its ``compiled_programs`` shape set and its
scheduling counters; the adaptive ladder's zero empty chunks
(tests/test_serving.py:307); the shared scheduler through the legacy
engine (cancellation mid-decode and mid-prefill, preemption, a total
deadline, containment, churn, the prefix cache, int8 pools,
weight-only int8, Qwen2-MoE), each with a balanced page audit; serial
``step()`` turns against ``run()``; seeded sampling; and speculative
decoding refused.

A one-layer LlamaConfig.tiny() in f32 (the JAX parity gate's model)
whose weights both packages share; inputs from numpy seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models import Qwen2MoeConfig as JQwen2MoeConfig
from paddle_tpu.models import Qwen2MoeForCausalLM as JQwen2MoeForCausalLM
from paddle_tpu.testing import FaultInjector as JFaultInjector

from paddle_tpu_torch import convert
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     Qwen2MoeConfig, Qwen2MoeForCausalLM)
from paddle_tpu_torch.testing import FaultInjector as TFaultInjector

torch.set_num_threads(1)

VOCAB = 256
#: tests/test_serving_parity.py's engine and mixed workload: a
#: multi-chunk prompt, a drain and re-admission mid-stream, a one-token
#: request, and room for a per-request eos
ENGINE = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
              prompt_buckets=(8, 16), greedy=True)
SPECS = [(5, 6), (11, 3), (19, 5), (4, 1), (8, 4)]
COUNTERS = ("prefills", "unified_steps", "chunks_dispatched",
            "chunks_empty", "prefill_waves", "tokens_emitted",
            "requests_completed", "prefix_cache_hits",
            "prefix_cache_misses", "prefix_cache_tokens_saved",
            "prefix_cache_cow_forks", "prefix_cache_pages",
            "preempt_evictions", "preempt_recompute_tokens",
            "requests_cancelled", "deadline_expired", "containments",
            "quarantined")
STATS = ("chunk_slot_steps", "active_slot_steps")


def _tie(jcls, jcfg, tcls, tcfg):
    paddle.seed(0)
    jm = jcls(jcfg)
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = convert.from_numpy_state_dict(tcls(tcfg, device="cpu"), arrays)
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module")
def models():
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.num_hidden_layers = 1
    return _tie(JLlamaForCausalLM, cfg, LlamaForCausalLM,
                dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=1))


SIDES = {"jax": dict(inf=jinf, fi=JFaultInjector, kw={}),
         "torch": dict(inf=tinf, fi=TFaultInjector, kw=dict(device="cpu"))}


def _engine(models, side, **kw):
    model = models[0] if side == "jax" else models[1]
    s = SIDES[side]
    return s["inf"].ContinuousBatchingEngine(
        model, **{**ENGINE, "unified": False, **s["kw"], **kw})


def _summary(eng):
    g = eng.gauges()
    return {"requests": [(r.request_id, list(r.tokens), r.finish_reason,
                          type(r.error).__name__ if r.error else None)
                         for r in sorted(eng.completed,
                                         key=lambda r: r.request_id)],
            "counters": {k: g[k] for k in COUNTERS},
            "stats": {k: eng._stats[k] for k in STATS},
            "compiled": sorted(eng._compiled)}


def _balanced(eng):
    assert len(eng._free_pages) + eng.prefix_cache_pages \
        == eng.num_pages - 1, (
        len(eng._free_pages), eng.prefix_cache_pages, eng.num_pages)
    assert not eng._deferred_free
    assert all(not p for p in eng.slot_pages)
    assert not eng._pending_first.any() and not eng._echo_inflight.any()
    eng._audit_pages("test")


def _same(models, workload, **kw):
    """``workload(eng, side)`` on a fresh legacy engine of each package:
    the same completions, counters, slot steps and compiled shapes, and
    both audits balanced. Returns {side: (engine, workload result)}."""
    out = {}
    for side in SIDES:
        eng = _engine(models, side, **kw)
        out[side] = (eng, workload(eng, side))
        _balanced(eng)
    assert _summary(out["torch"][0]) == _summary(out["jax"][0])
    return out


def _prompts(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (p,)).astype(np.int32) for p in shapes]


def _parity(eng, side, eos_for=None):
    """tests/test_serving_parity.py's ``_serve``."""
    rng = np.random.RandomState(21)
    ids = []
    for i, (plen, n) in enumerate(SPECS):
        prompt = rng.randint(0, VOCAB, (plen,)).astype(np.int32)
        ids.append(eng.add_request(
            prompt, n, eos_token_id=eos_for.get(i) if eos_for else None))
    by = {r.request_id: r for r in eng.run()}
    return [(by[i].tokens, by[i].finish_reason) for i in ids]


# ---- the parity workload ----------------------------------------------------

@pytest.mark.parametrize("with_eos", [False, True])
def test_streams_match_jax_legacy_and_unified(models, with_eos):
    """The JAX legacy engine's streams, counters and compiled shapes,
    and the port's unified engine's streams (the serving_parity gate).
    With eos: request 0 stops at its second token."""
    eos_for = None
    if with_eos:
        probe = _parity(_engine(models, "torch"), "torch")
        eos_for = {0: int(probe[0][0][min(1, len(probe[0][0]) - 1)])}
    res = _same(models, lambda e, s: _parity(e, s, eos_for))
    legacy = res["torch"][1]
    unified = _parity(_engine(models, "torch", unified=True), "torch",
                      eos_for)
    assert legacy == unified
    if with_eos:
        assert legacy[0][1] == "eos"
    eng = res["torch"][0]
    g = eng.gauges()
    # a prefill shape and a pow-2 ladder of chunk shapes, no unified step
    C = eng.prefill_chunk
    assert ("prefill", C) in eng._compiled and g["compiled_programs"] > 1
    assert {n for k, n in eng._compiled if k == "chunk"} <= {1, 2, 4}
    assert g["unified_steps"] == 0 and g["prefill_waves"] > 0


def test_adaptive_chunks_waste_no_dispatch(models):
    """tests/test_serving.py:307: on eos-free traffic the ladder ends
    each drain wave at the chunk boundary: no empty chunk, and every
    active slot-step emits a token (plus each prompt's first token)."""
    specs = list(zip(_prompts(10, (5, 9, 12, 4)), (7, 3, 6, 5)))

    def workload(eng, side):
        for p, n in specs:
            eng.add_request(p, n)
        return [r.tokens for r in eng.run()]

    eng, _ = _same(models, workload)["torch"]
    g = eng.gauges()
    assert g["tokens_emitted"] == sum(n for _, n in specs)
    assert g["chunks_empty"] == 0
    assert g["tokens_emitted"] == eng._stats["active_slot_steps"] + len(specs)


def test_fixed_chunks_without_the_ladder(models):
    """``adaptive_chunk=False``: one chunk shape, the same streams."""
    res = _same(models, _parity, adaptive_chunk=False)
    eng, streams = res["torch"]
    assert sorted(eng._compiled) == [("chunk", 4),
                                     ("prefill", eng.prefill_chunk)]
    assert streams == _parity(_engine(models, "torch"), "torch")


def test_serial_step_turns_match_run(models):
    """``step()`` streams every pending wave, then one chunk: the same
    streams as ``run()``, and the JAX legacy engine's turn for turn."""
    def workload(eng, side):
        rng = np.random.RandomState(21)
        ids = [eng.add_request(rng.randint(0, VOCAB, (p,)).astype(np.int32),
                               n) for p, n in SPECS]
        while eng.has_work():
            eng.step()
        by = {r.request_id: r for r in eng.completed}
        return [(by[i].tokens, by[i].finish_reason) for i in ids]

    res = _same(models, workload)
    assert res["torch"][1] == _parity(_engine(models, "torch"), "torch")


def test_sampling_follows_the_seed(models):
    def run(seed):
        eng = _engine(models, "torch", greedy=False, temperature=0.8,
                      seed=seed)
        return [t for t, _ in _parity(eng, "torch")]

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    assert [len(t) for t in a] == [n for _, n in SPECS]


def test_spec_decoding_needs_the_unified_engine(models):
    with pytest.raises(ValueError, match="unified=True"):
        _engine(models, "torch", spec_k=2)


# ---- the shared scheduler through the legacy engine --------------------------

def test_cancel_mid_decode(models):
    """tests/test_serving_reliability.py:188: cancelling mid-decode
    reclaims the pages (pending first tokens and echoes included); the
    other stream is untouched."""
    pA, pB = _prompts(19, (6, 7))

    def workload(eng, side):
        c1 = eng.add_request(pA, 25)
        c2 = eng.add_request(pB, 4)
        while not eng.request(c1).tokens:
            eng.step()
        assert eng.cancel(c1)
        eng.run()
        by = {r.request_id: r for r in eng.completed}
        return by[c1], by[c2]

    eng, (r1, r2) = _same(models, workload)["torch"]
    assert isinstance(r1.error, tinf.RequestCancelled)
    assert r1.tokens and len(r1.tokens) < 25
    solo = _engine(models, "torch", num_slots=1)
    solo.add_request(pB, 4)
    assert r2.tokens == solo.run()[0].tokens


def test_cancel_between_prefill_and_echo(models):
    """A cancel after the prefill wave sampled the first token but
    before a chunk echoed it: the token is neither delivered twice nor
    leaked, and the pages come back."""
    (p,) = _prompts(31, (9,))

    def workload(eng, side):
        rid = eng.add_request(p, 6)
        eng._admit()
        eng._pump_prefill()
        assert eng._pending_first.any()
        eng.cancel(rid)
        eng.run()
        return eng.request(rid)

    req = _same(models, workload)["torch"][1]
    assert isinstance(req.error, tinf.RequestCancelled)
    assert req.tokens == []


def test_cancel_mid_prefill(models):
    (pLong,) = _prompts(17, (30,))

    def workload(eng, side):
        rid = eng.add_request(pLong, 8)
        eng._admit()
        eng._pump_prefill(max_waves=1)        # the first wave only
        assert eng._prefilling.any()
        eng.cancel(rid)
        eng.run()
        return eng.request(rid)

    req = _same(models, workload, max_len=64, prompt_buckets=(8,))["torch"][1]
    assert req.finished and req.tokens == []


def test_priority_preemption_recompute(models):
    pA, pB, pH = _prompts(7, (6, 9, 7))

    def workload(eng, side):
        ids = [eng.add_request(pA, 30), eng.add_request(pB, 28)]
        for _ in range(3):
            eng.step()
        ids.append(eng.add_request(pH, 20, priority=5))
        by = {r.request_id: r for r in eng.run()}
        return [by[i].tokens for i in ids]

    eng, streams = _same(models, workload)["torch"]
    assert eng.gauges()["preempt_evictions"] >= 1
    calm = _engine(models, "torch", num_slots=3)
    ids = [calm.add_request(p, n) for p, n in ((pA, 30), (pB, 28), (pH, 20))]
    by = {r.request_id: r.tokens for r in calm.run()}
    assert streams == [by[i] for i in ids]


def test_total_deadline_expires_mid_stream(models):
    (pA,) = _prompts(29, (6,))

    def workload(eng, side):
        rid = eng.add_request(pA, 30, deadline_s=3600.0)
        while len(eng.request(rid).tokens) < 2:
            eng.step()
        req = eng.request(rid)
        req.deadline_s = 1e-9
        eng.run()
        return req

    req = _same(models, workload)["torch"][1]
    assert isinstance(req.error, tinf.DeadlineExceeded)
    assert req.error.kind == "total" and len(req.tokens) >= 2


def test_containment_quarantines_poison(models):
    """A harvest that fails whenever the poison rides its chunk: the
    poison is quarantined, the innocent replays to its full stream."""
    pP, pI = _prompts(41, (6, 9))

    def workload(eng, side):
        rp = eng.add_request(pP, 8)
        ri = eng.add_request(pI, 6)
        with SIDES[side]["fi"]() as fi:
            fi.poison_request(rp, times=2)
            eng.run()
            assert fi.fires() == 2
        by = {r.request_id: r for r in eng.completed}
        return by[rp], by[ri]

    eng, (rp, ri) = _same(models, workload, max_strikes=2)["torch"]
    assert isinstance(rp.error, tinf.RequestQuarantined)
    assert ri.error is None and len(ri.tokens) == 6
    assert eng.gauges()["quarantined"] == 1


def test_churn_zero_leak(models):
    """Priorities, preemptions and cancels through a pool that cannot
    hold every request at once."""
    def workload(eng, side):
        rng = np.random.RandomState(59)
        ids = []
        for _ in range(16):
            rid = eng.add_request(
                rng.randint(0, VOCAB, (int(rng.randint(3, 12)),)).astype(
                    np.int32), int(rng.randint(1, 8)),
                priority=int(rng.randint(0, 3)))
            ids.append(rid)
            if rng.rand() < 0.2:
                eng.cancel(rid)
            if rng.rand() < 0.3:
                eng.step()
                if rng.rand() < 0.3:
                    eng.cancel(int(rng.choice(ids)))
        eng.run()
        return ids

    eng, ids = _same(models, workload)["torch"]
    assert sorted(r.request_id for r in eng.completed) == sorted(ids)


def test_prefix_cache_streams_equal_cache_off(models):
    """Shared 16-token prefixes: the cache attaches pages (a full-prompt
    hit forks its last page copy-on-write) and the streams equal a
    cache-off engine's."""
    base = _prompts(43, (16,))[0]
    tails = _prompts(44, (3, 0, 5, 0))
    prompts = [np.concatenate([base, t]) for t in tails]

    def workload(eng, side):
        ids = [eng.add_request(p, 5) for p in prompts]
        by = {r.request_id: r.tokens for r in eng.run()}
        return [by[i] for i in ids]

    res = _same(models, workload, num_slots=1, prefix_cache=True)
    eng, streams = res["torch"]
    g = eng.gauges()
    assert g["prefix_cache_hits"] >= 2 and g["prefix_cache_cow_forks"] >= 1
    off = _engine(models, "torch", num_slots=1, prefix_cache=False)
    assert streams == workload(off, "torch")


def test_int8_pools(models):
    """tests/test_quant_serving.py:310: the legacy engine over int8
    pools gives the unified engine's int8 streams and the JAX legacy
    engine's."""
    prompts = _prompts(4, (5, 9, 7, 12))

    def workload(eng, side):
        ids = [eng.add_request(p, 6) for p in prompts]
        by = {r.request_id: r.tokens for r in eng.run()}
        return [by[i] for i in ids]

    res = _same(models, workload, kv_quant="int8")
    uni = workload(_engine(models, "torch", kv_quant="int8", unified=True),
                   "torch")
    assert res["torch"][1] == uni
    assert res["torch"][0].gauges()["kv_quant_bits"] == 8


def test_weight_only_int8_projections(models):
    """A weight-only int8 model through the legacy engine: the unified
    engine's streams on the same converted weights."""
    tcfg = dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=1,
                               weight_quant="weight_only_int8")
    tm = LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(models[1].state_dict())
    prompts = _prompts(6, (5, 9, 7))
    streams = []
    for unified in (False, True):
        eng = tinf.ContinuousBatchingEngine(tm, unified=unified,
                                            device="cpu", **ENGINE)
        ids = [eng.add_request(p, 6) for p in prompts]
        by = {r.request_id: r.tokens for r in eng.run()}
        streams.append([by[i] for i in ids])
        _balanced(eng)
    assert streams[0] == streams[1]


def test_qwen2_moe_matches_jax_legacy():
    """Qwen2-MoE tiny (dropless) through both legacy engines."""
    jcfg = JQwen2MoeConfig.tiny()
    jcfg.tensor_parallel = False
    jcfg.moe_dropless = True
    tcfg = dataclasses.replace(Qwen2MoeConfig.tiny(), moe_dropless=True)
    models = _tie(JQwen2MoeForCausalLM, jcfg, Qwen2MoeForCausalLM, tcfg)
    specs = list(zip(_prompts(6, (5, 13, 9)), (5, 4, 6)))

    def workload(eng, side):
        ids = [eng.add_request(p, n) for p, n in specs]
        by = {r.request_id: r.tokens for r in eng.run()}
        return [by[i] for i in ids]

    res = _same(models, workload)
    assert [len(t) for t in res["torch"][1]] == [n for _, n in specs]
