"""The port's radix prefix cache with copy-on-write
(paddle_tpu_torch.inference.serving) against the JAX engine's, on the
workloads of tests/test_prefix_cache.py: the same greedy streams token
for token, the same finish reasons and typed errors, the same scheduling
and cache counters (hits, misses, tokens saved, COW forks, evictions,
resident pages) and a balanced page audit after each workload, on a
one-layer LlamaConfig.tiny() in f32 whose weights both engines share.
Plus the int8 pools of tests/test_quant_serving.py's composition case."""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import convert
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

VOCAB = 256
ENGINE = dict(num_slots=2, page_size=8, max_len=64, decode_chunk=4,
              prompt_buckets=(32,), greedy=True)
#: gauges both engines must agree on, after every workload
COUNTERS = ("prefills", "unified_steps", "tokens_emitted",
            "requests_completed", "chunks_empty", "prefill_waves",
            "prefix_cache_hits", "prefix_cache_misses",
            "prefix_cache_tokens_saved", "prefix_cache_cow_forks",
            "prefix_cache_evictions", "prefix_cache_pages",
            "preempt_evictions", "preempt_recompute_tokens",
            "requests_cancelled", "deadline_expired", "containments",
            "quarantined")


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


def _engines(models, **kw):
    jm, tm = models
    kw = {**ENGINE, **kw}
    return (JEngine(jm, audit=True, **kw),
            ContinuousBatchingEngine(tm, audit=True, device="cpu", **kw))


def _summary(eng):
    """Every completed request (tokens, finish reason, error type) and
    the scheduling counters."""
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
    """Drive both engines through ``workload(eng)``; the summaries must
    be equal and both audits balanced. Returns (jax, port) engines and
    the port's workload result."""
    jeng, teng = _engines(models, **kw)
    workload(jeng)
    out = workload(teng)
    assert _summary(teng) == _summary(jeng)
    _balanced(jeng)
    _balanced(teng)
    return jeng, teng, out


def _rand(rng, n):
    return rng.randint(0, VOCAB, (n,)).astype(np.int32)


def _run_all(specs):
    def workload(eng):
        ids = [eng.add_request(p, n) for p, n in specs]
        by = {r.request_id: r for r in eng.run()}
        return [by[i].tokens for i in ids]
    return workload


def _sequential(specs):
    """One run() per request: each admission sees the cache the earlier
    ones left."""
    def workload(eng):
        ids = []
        for p, n in specs:
            ids.append(eng.add_request(p, n))
            eng.run()
        by = {r.request_id: r for r in eng.completed}
        return [by[i].tokens for i in ids]
    return workload


def _off_streams(models, specs, **kw):
    """The port's cache-off streams: the transparency oracle."""
    _, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", prefix_cache=False,
                                   **{**ENGINE, **kw})
    return _run_all(specs)(eng)


def test_cache_on_off_token_identical(models):
    rng = np.random.RandomState(7)
    shared = _rand(rng, 19)
    specs = [(np.concatenate([shared, _rand(rng, int(rng.randint(0, 6)))]),
              int(rng.randint(3, 7))) for _ in range(6)]
    _, teng, streams = _same(models, _run_all(specs))
    assert streams == _off_streams(models, specs)
    g = teng.gauges()
    assert g["prefix_cache_hits"] >= 1
    # 19-token shared prefix = 2 full pages -> >= 16 tokens per hit
    assert g["prefix_cache_tokens_saved"] >= 16
    assert g["prefix_cache_pages"] >= 2


def test_cow_fork_on_fully_cached_prompt(models):
    rng = np.random.RandomState(11)
    prompt = _rand(rng, 16)
    specs = [(prompt, 5), (prompt, 5)]
    _, teng, streams = _same(models, _sequential(specs))
    assert streams == _off_streams(models, specs)
    g = teng.gauges()
    assert g["prefix_cache_cow_forks"] >= 1
    assert g["prefix_cache_tokens_saved"] >= 15


def test_divergence_mid_page_shares_only_full_blocks(models):
    rng = np.random.RandomState(13)
    a = _rand(rng, 20)
    b = a.copy()
    b[11] = (b[11] + 1) % VOCAB               # mid-page-2 divergence
    specs = [(a, 4), (b, 4)]
    _, teng, streams = _same(models, _sequential(specs))
    assert streams == _off_streams(models, specs)
    g = teng.gauges()
    assert g["prefix_cache_hits"] == 1
    assert g["prefix_cache_tokens_saved"] == 8   # exactly one block
    assert g["prefix_cache_cow_forks"] == 0


def test_cancel_shared_page_owner_no_double_free(models):
    rng = np.random.RandomState(17)
    shared = _rand(rng, 17)
    pb = np.concatenate([shared, _rand(rng, 3)])

    def workload(eng):
        rid_a = eng.add_request(shared, 24)   # long-running owner
        for _ in range(2):
            eng.step()                        # A admitted + published
        assert eng.prefix_cache_pages >= 2
        rid_b = eng.add_request(pb, 6)
        eng.step()                            # B attached to A's pages
        assert any(eng.slot_shared)
        assert eng.cancel(rid_a)
        for _ in range(200):
            eng.step()
            if not eng.has_work():
                break
        by = {r.request_id: r for r in eng.completed}
        return by[rid_a], by[rid_b]

    _, _, (a, b) = _same(models, workload)
    assert type(a.error).__name__ == "RequestCancelled"
    assert b.error is None
    assert b.tokens == _off_streams(models, [(pb, 6)])[0]


def test_preempt_shared_page_owner_replay_token_identical(models):
    rng = np.random.RandomState(19)
    shared = _rand(rng, 17)
    pb = np.concatenate([shared, _rand(rng, 2)])
    pc = _rand(rng, 9)
    specs = [(shared, 24), (pb, 20), (pc, 5)]

    def workload(eng):
        ids = [eng.add_request(shared, 24, priority=0),
               eng.add_request(pb, 20, priority=1)]
        for _ in range(2):
            eng.step()                # both mid-decode, slots full
        ids.append(eng.add_request(pc, 5, priority=2))
        by = {r.request_id: r for r in eng.run()}
        return [by[i] for i in ids]

    _, teng, reqs = _same(models, workload)
    assert teng.gauges()["preempt_evictions"] >= 1
    assert reqs[0].preemptions >= 1
    assert [r.tokens for r in reqs] == _off_streams(models, specs)


def test_eviction_is_refcount_aware_lru(models):
    rng = np.random.RandomState(23)
    # 5 allocatable pages, 3-page requests: each run caches 2 pages, so
    # the third distinct prompt must evict
    geo = dict(num_pages=6, max_len=32, prompt_buckets=(16,))
    specs = [(_rand(rng, 16), 6) for _ in range(3)]
    _, teng, streams = _same(models, _sequential(specs), **geo)
    assert teng.gauges()["prefix_cache_evictions"] >= 2
    assert streams == _off_streams(models, specs, **geo)


def test_audit_catches_refcount_corruption(models):
    rng = np.random.RandomState(29)
    _, teng, _ = _same(models, _run_all([(_rand(rng, 16), 4)]))
    assert teng.prefix_cache_pages >= 2
    node = next(iter(teng._pc_nodes.values()))
    node.ref += 1
    with pytest.raises(AssertionError, match="refcount"):
        teng._audit_pages("corrupted")
    node.ref -= 1
    teng._audit_pages("restored")
    teng._free_pages.pop()                    # a vanished free page
    with pytest.raises(AssertionError, match="page accounting"):
        teng._audit_pages("leaked")


def test_warm_cache_saves_prefill_work(models):
    rng = np.random.RandomState(31)
    shared = _rand(rng, 24)
    specs = [(np.concatenate([shared, _rand(rng, int(rng.randint(0, 4)))]),
              4) for _ in range(4)]
    prompt_tokens = sum(len(p) for p, _ in specs)

    def workload(eng):
        cold = _run_all(specs)(eng)
        cold_saved = eng.gauges()["prefix_cache_tokens_saved"]
        eng.reset_gauges()
        warm = _run_all(specs)(eng)
        return cold, warm, cold_saved

    _, teng, (cold, warm, cold_saved) = _same(models, workload,
                                              num_slots=4)
    g = teng.gauges()
    assert g["prefix_cache_hit_rate"] == 1.0
    assert g["prefix_cache_tokens_saved"] > cold_saved
    assert g["prefix_cache_tokens_saved"] >= 0.5 * prompt_tokens
    assert cold == warm == _off_streams(models, specs, num_slots=4)
    # the cold/warm reset: every unreferenced page goes back
    assert teng.reset_prefix_cache() == g["prefix_cache_pages"]
    assert len(teng._free_pages) == teng.num_pages - 1


def test_prefix_cache_composes_with_int8_kv(models):
    """Warm shared-prefix attach over int8 pools and their scales pools
    (the COW fork copies both), against the JAX engine and a cache-off
    int8 engine."""
    rng = np.random.RandomState(11)
    prefix = _rand(rng, 16)
    prompts = [np.concatenate([prefix, _rand(rng, int(rng.randint(1, 4)))])
               for _ in range(4)] + [prefix]
    specs = [(p, 4) for p in prompts]
    geo = dict(kv_quant="int8", max_len=48, prompt_buckets=(16,))

    def workload(eng):
        return _run_all(specs)(eng), _run_all(specs)(eng)

    _, teng, (cold, warm) = _same(models, workload, **geo)
    g = teng.gauges()
    assert g["prefix_cache_hits"] > 0 and g["prefix_cache_cow_forks"] > 0
    assert cold == warm == _off_streams(models, specs, **geo)
