"""The port's speculative decoding (paddle_tpu_torch.inference.spec_decode
and the engine's spec step) against the JAX package's, on the CPU, on the
2-layer LlamaConfig.tiny() of tests/test_spec_decode.py (seed 0) whose
weights both packages share (convert.from_numpy_state_dict):

- the host helpers (``rejection_sample``, ``ngram_propose``,
  ``get_draft_source``) equal the JAX functions on the same inputs;
- the engine's batched verification rule (``verify_drafts``) gives p's
  marginals exactly under sampling (a chi-square test over seeded draws
  of a fixed generator: deterministic, so it cannot flake), and the host
  rule under greedy;
- the mixed batch of test_spec_decode.py with n-gram and self-speculative
  drafts: the port's spec streams equal the JAX spec engine's and the
  port's plain engine's, with the JAX engine's ``spec_*`` gauges;
- the workloads of test_spec_decode.py (eos inside a chunk, K not
  dividing the length, the oracle/adversarial extremes, sampling, a warm
  prefix attach, priority preemption, a supervised restart, gauges
  reset) and spec over int8 pools, each with a balanced page audit;
- ``skip_layers`` logits equal the JAX model's; ``SelfSpecDraftSource``'s
  drafts equal the JAX source's from the same engine state;
- the port's self-speculative draft writes the pools in place, so a
  draft whose positions run past the slot's row must leave every
  committed pool position bit for bit as it was;
- ``paged_verify_write`` and ``paged_verify_write_quant`` equal the JAX
  functions on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import spec_decode as jspec
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models import Qwen2Config as JQwen2Config
from paddle_tpu.models import Qwen2ForCausalLM as JQwen2ForCausalLM
from paddle_tpu.ops import paged_attention as JPA

from paddle_tpu_torch import convert
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        EngineSupervisor)
from paddle_tpu_torch.inference import spec_decode as tspec
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     Qwen2Config, Qwen2ForCausalLM)
from paddle_tpu_torch.ops import paged_attention as TPA
from paddle_tpu_torch.testing import OracleDraftSource

torch.set_num_threads(1)

VOCAB = 256
ENGINE = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
              prompt_buckets=(8, 16), greedy=True, audit=True)
SPEC_GAUGES = ("spec_steps", "spec_tokens_drafted", "spec_tokens_accepted",
               "spec_tokens_rejected", "spec_accept_rate")
#: the scheduling gauges both engines must also agree on
COUNTERS = ("prefills", "unified_steps", "tokens_emitted",
            "requests_completed", "chunks_empty", "prefill_waves",
            "slot_occupancy", "active_occupancy", "compiled_programs")
#: the chi-square critical value at 3 degrees of freedom and a
#: significance of 1e-3; the draws are from a fixed seed, so the
#: statistic is one number, not a random one
CHI2_3DOF_1E3 = 16.266


@pytest.fixture(scope="module")
def models():
    """The JAX test's model (tiny, two layers, seed 0) and the port's
    with its weights. Two layers: the self-speculative default skips the
    top half, which is empty at one layer."""
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.num_hidden_layers = 2
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = convert.from_numpy_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), arrays)
    return jm, tm


def _engine(models, side="torch", **kw):
    jm, tm = models
    kw = {**ENGINE, **kw}
    if side == "jax":
        return JEngine(jm, **kw)
    return ContinuousBatchingEngine(tm, device="cpu", **kw)


def _prompts(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (p,)).astype(np.int32) for p in shapes]


def _streams(eng, prompts, news, eos=None):
    ids = [eng.add_request(p, n, eos_token_id=eos)
           for p, n in zip(prompts, news)]
    by = {r.request_id: r for r in eng.run()}
    return [by[i].tokens for i in ids], [by[i].finish_reason for i in ids]


def _ref(models, prompt, n, eos=None, **kw):
    """The uncontended one-slot plain stream of the port (the identity
    oracle)."""
    eng = _engine(models, num_slots=1, **kw)
    return _streams(eng, [prompt], [n], eos)[0][0]


def _balanced(eng):
    assert len(eng._free_pages) + eng.prefix_cache_pages \
        == eng.num_pages - 1, (
        len(eng._free_pages), eng.prefix_cache_pages, eng.num_pages)
    assert not eng._deferred_free
    assert all(not p for p in eng.slot_pages)
    assert all(not s for s in eng.slot_shared)
    eng._audit_pages("test")


def _spec_gauges(eng):
    g = eng.gauges()
    return {k: g[k] for k in SPEC_GAUGES}


# ---- the host helpers ------------------------------------------------------

def test_rejection_sample_matches_jax():
    rng = np.random.RandomState(3)
    for trial in range(40):
        k = int(rng.randint(1, 6))
        logits = rng.randn(k + 1, 16) * 2.0
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        drafts = rng.randint(0, 16, (k,))
        # half the trials draft the argmax chain, so acceptances happen
        if trial % 2:
            drafts = np.argmax(probs[:k], -1)
        for greedy in (True, False):
            want = jspec.rejection_sample(
                probs, drafts, np.random.default_rng(trial), greedy=greedy)
            got = tspec.rejection_sample(
                probs, drafts, np.random.default_rng(trial), greedy=greedy)
            assert got == want, (trial, greedy, got, want)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_ngram_propose_matches_jax(k):
    rng = np.random.RandomState(k)
    hists = [[1, 2, 3, 9, 4, 1, 2, 3], [1, 2, 3, 4, 5], [7, 8, 9, 7, 8, 9],
             [1, 2, 3, 7, 8, 3, 9, 1, 2, 3], [1, 2, 5, 1, 2, 6, 1, 2], [5],
             [4, 4]]
    hists += [rng.randint(0, 6, (int(rng.randint(2, 40)),)).tolist()
              for _ in range(30)]
    for hist in hists:
        for max_n, min_n in ((3, 1), (2, 2), (4, 1)):
            want = jspec.ngram_propose(hist, k, max_n, min_n)
            got = tspec.ngram_propose(hist, k, max_n, min_n)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_get_draft_source_resolution():
    for name in ("ngram", "self", "skip_layer", "self_spec"):
        assert type(tspec.get_draft_source(name)).__name__ == \
            type(jspec.get_draft_source(name)).__name__
    src = tspec.NGramDraftSource()
    assert tspec.get_draft_source(src) is src
    # the n-gram source matches the JAX source's default sizes
    jsrc = jspec.NGramDraftSource()
    assert (tspec.NGRAM_MAX_N, tspec.NGRAM_MIN_N) == (jsrc.max_n,
                                                      jsrc.min_n)
    for side in (tspec, jspec):
        with pytest.raises(ValueError, match="unknown draft source"):
            side.get_draft_source("medusa")


def test_engine_rejects_a_chunk_too_short_to_verify(models):
    with pytest.raises(ValueError, match="prefill_chunk >= 2"):
        _engine(models, prefill_chunk=1, spec_decode=True)
    # the knobs' static fallbacks (the port has no tuner), and the clamp
    eng = _engine(models, spec_decode=True)
    assert eng._spec_k == 4
    assert isinstance(eng._spec_source, tspec.NGramDraftSource)
    eng = _engine(models, spec_k=40, spec_draft="self")
    assert eng._spec_k == eng.prefill_chunk - 1
    assert isinstance(eng._spec_source, tspec.SelfSpecDraftSource)


# ---- the engine's verification rule ------------------------------------

def test_verify_rule_gives_exact_marginals_under_sampling():
    """20000 rows of one fixed target table through ``verify_drafts``:
    position 0's tokens follow p0, position 1's (present iff draft 0 was
    accepted, with probability p0[1]) follow p1, and the bonus after both
    drafts held follows p2. Chi-square at 3 degrees of freedom against
    CHI2_3DOF_1E3; the acceptance share within 4 binomial sigmas."""
    p = np.array([[0.5, 0.2, 0.2, 0.1],
                  [0.1, 0.1, 0.2, 0.6],
                  [0.25, 0.25, 0.25, 0.25]])
    n = 20000
    logits = torch.tensor(np.log(p), dtype=torch.float32)[None].expand(
        n, -1, -1).contiguous()
    drafts = torch.tensor([[1, 3]], dtype=torch.int32).expand(n, -1)
    gen = torch.Generator().manual_seed(1234)
    n_acc, fin = tspec.verify_drafts(logits, drafts,
                                     torch.full((n,), 2), greedy=False,
                                     gen=gen)
    n_acc, fin = n_acc.numpy(), fin.numpy()
    pos0 = np.where(n_acc >= 1, 1, fin)
    has1 = n_acc >= 1
    pos1 = np.where(n_acc[has1] >= 2, 3, fin[has1])
    bonus = fin[n_acc == 2]

    def chi2(tokens, probs):
        counts = np.bincount(tokens, minlength=4)
        want = probs * len(tokens)
        return float(((counts - want) ** 2 / want).sum())

    assert chi2(pos0, p[0]) < CHI2_3DOF_1E3
    assert chi2(pos1, p[1]) < CHI2_3DOF_1E3
    assert chi2(bonus, p[2]) < CHI2_3DOF_1E3
    share, q = has1.mean(), p[0, 1]
    assert abs(share - q) < 4 * np.sqrt(q * (1 - q) / n)
    # a resample never emits the draft it rejected
    assert not np.any((n_acc == 0) & (fin == 1))
    assert not np.any((n_acc == 1) & (fin == 3))


def test_verify_rule_greedy_equals_the_host_rule():
    rng = np.random.RandomState(5)
    b, k, v = 64, 4, 12
    logits = rng.randn(b, k + 1, v).astype(np.float32)
    drafts = rng.randint(0, v, (b, k)).astype(np.int32)
    # every other row drafts the argmax chain for a random prefix
    arg = np.argmax(logits, -1)
    cut = rng.randint(0, k + 1, (b,))
    for i in range(0, b, 2):
        drafts[i, :cut[i]] = arg[i, :cut[i]]
    nd = rng.randint(0, k + 1, (b,))
    n_acc, fin = tspec.verify_drafts(torch.from_numpy(logits),
                                     torch.from_numpy(drafts),
                                     torch.from_numpy(nd))
    for i in range(b):
        emitted, acc = tspec.rejection_sample(logits[i], drafts[i, :nd[i]],
                                              None, greedy=True)
        assert int(n_acc[i]) == acc
        assert int(fin[i]) == emitted[-1]


# ---- streams and gauges against the JAX spec engine -----------------------

@pytest.mark.parametrize("source", ["ngram", "self"])
def test_mixed_batch_matches_jax_spec_engine(models, source):
    """The mixed batch of tests/test_spec_decode.py (three requests
    through two slots): the port's spec streams equal the JAX spec
    engine's and the port's plain engine's; the spec gauges and the
    scheduling counters equal the JAX engine's."""
    specs = [(6, 12), (13, 8), (9, 14)]
    prompts = _prompts(11, [p for p, _ in specs])
    news = [n for _, n in specs]
    plain, _ = _streams(_engine(models), prompts, news)
    out = {}
    for side in ("jax", "torch"):
        eng = _engine(models, side, spec_k=4, spec_draft=source)
        streams, reasons = _streams(eng, prompts, news)
        assert reasons == ["length"] * 3
        g = eng.gauges()
        out[side] = (streams, _spec_gauges(eng),
                     {k: g[k] for k in COUNTERS})
        _balanced(eng)
    assert out["torch"][0] == plain
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1:] == out["jax"][1:]
    g = out["torch"][1]
    assert g["spec_steps"] >= 1 and g["spec_tokens_drafted"] >= 1
    assert g["spec_tokens_drafted"] == (g["spec_tokens_accepted"]
                                        + g["spec_tokens_rejected"])


@pytest.mark.parametrize("source", ["ngram", "self", "oracle"])
def test_eos_inside_a_chunk(models, source):
    """An eos that lands inside a verification chunk stops the stream
    where the plain engine stops: the eos is emitted, nothing after it.
    The oracle drafts the continuation past the eos, so the chunk rides
    over it."""
    (prompt,) = _prompts(2, (6,))
    full = _ref(models, prompt, 12)
    eos = next(t for t in full if t != full[0])
    n_stop = full.index(eos) + 1
    assert 1 < n_stop < 12
    ref = _ref(models, prompt, 12, eos=eos)
    assert ref == full[:n_stop]
    eng = _engine(models, num_slots=1, spec_k=4,
                  spec_draft=OracleDraftSource({0: full}, VOCAB)
                  if source == "oracle" else source)
    eng.add_request(prompt, 12, eos_token_id=eos)
    (req,) = eng.run()
    assert req.finish_reason == "eos"
    assert req.tokens == ref, (source, req.tokens, ref)
    if source == "oracle":
        assert eng.gauges()["spec_tokens_drafted"] >= 1
    _balanced(eng)


def test_k_not_dividing_the_length(models):
    """K 5, 14 new tokens, every draft accepted: chunks of 6 + 6 + 2, the
    last one's drafts clamped by the budget."""
    (prompt,) = _prompts(5, (9,))
    ref = _ref(models, prompt, 14)
    eng = _engine(models, num_slots=1, spec_k=5,
                  spec_draft=OracleDraftSource({0: ref}, VOCAB))
    eng.add_request(prompt, 14)
    (req,) = eng.run()
    assert req.tokens == ref
    g = eng.gauges()
    assert g["spec_accept_rate"] == 1.0
    assert g["spec_tokens_drafted"] >= 6
    _balanced(eng)


@pytest.mark.parametrize("shift,rate", [(0, 1.0), (1, 0.0)])
def test_acceptance_extremes_match_jax(models, shift, rate):
    """Oracle drafts accept at exactly 1.0, adversarial ones (the oracle
    + 1) at exactly 0.0, both with the plain stream; both packages count
    the same."""
    (prompt,) = _prompts(13, (7,))
    ref = _ref(models, prompt, 13)
    gauges = {}
    oracle = OracleDraftSource({0: ref}, VOCAB, shift)
    for side in ("jax", "torch"):
        if side == "torch":
            eng = _engine(models, side, num_slots=1, spec_k=4,
                          spec_draft=oracle)
        else:
            # the JAX constructor takes its own DraftSource class only;
            # the JAX engine calls its source by duck type, as its own
            # test installs an oracle
            eng = _engine(models, side, num_slots=1, spec_k=4)
            eng._spec_source = oracle
        eng.add_request(prompt, 13)
        (req,) = eng.run()
        assert req.tokens == ref, (side, req.tokens, ref)
        gauges[side] = _spec_gauges(eng)
        _balanced(eng)
    assert gauges["torch"] == gauges["jax"]
    assert gauges["torch"]["spec_accept_rate"] == rate
    assert gauges["torch"]["spec_tokens_drafted"] >= 4


def test_sampling_completes(models):
    prompts = _prompts(17, (6, 9))
    eng = _engine(models, greedy=False, spec_k=4)
    streams, _ = _streams(eng, prompts, (8, 6))
    assert [len(t) for t in streams] == [8, 6]
    assert all(0 <= t < VOCAB for s in streams for t in s)
    assert eng.gauges()["spec_steps"] >= 1
    _balanced(eng)


def test_warm_prefix_attach(models):
    """Only committed prompt KV is published: a warm run attaches cached
    pages and still gives the plain stream."""
    rng = np.random.RandomState(19)
    prompt = np.tile(rng.randint(0, VOCAB, (4,)).astype(np.int32), 4)
    ref = _ref(models, prompt, 8)
    eng = _engine(models, num_slots=1, spec_k=4)
    for _ in range(2):
        assert _streams(eng, [prompt], [8])[0] == [ref]
    g = eng.gauges()
    assert g["prefix_cache_hits"] >= 1
    assert g["prefix_cache_tokens_saved"] >= 8
    _balanced(eng)


def test_priority_preemption(models):
    """A higher-priority arrival evicts a drafting slot; the replay
    rebuilds from prompt + tokens, and every stream is the uncontended
    plain one."""
    pA, pB, pH = _prompts(7, (6, 9, 7))
    refs = [_ref(models, pA, 30), _ref(models, pB, 28),
            _ref(models, pH, 20)]
    eng = _engine(models, spec_k=4)
    ids = [eng.add_request(pA, 30), eng.add_request(pB, 28)]
    for _ in range(3):
        eng.step()
    ids.append(eng.add_request(pH, 20, priority=5))
    by = {r.request_id: r for r in eng.run()}
    assert [by[i].tokens for i in ids] == refs
    assert all(by[i].error is None for i in ids)
    assert by[ids[0]].preemptions + by[ids[1]].preemptions >= 1
    assert eng.gauges()["preempt_evictions"] >= 1
    _balanced(eng)


def test_supervisor_restart(models):
    """The engine dies twice mid-stream; the supervisor rebuilds a spec
    engine that replays from prompt + tokens."""
    (pA,) = _prompts(43, (6,))
    ref = _ref(models, pA, 8)
    calls = {"n": 0}

    def factory():
        eng = _engine(models, max_containments=0, spec_k=4)
        orig = eng._harvest_step

        def dying(rec):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("injected engine death")
            return orig(rec)

        eng._harvest_step = dying
        return eng

    sup = EngineSupervisor(factory, max_restarts=3)
    rid = sup.add_request(pA, 8)
    by = {r.request_id: r for r in sup.run()}
    assert sup.restarts >= 1
    assert by[rid].tokens == ref
    _balanced(sup.engine)


def test_gauges_reset(models):
    prompt = np.tile(np.arange(4, dtype=np.int32), 3)
    eng = _engine(models, num_slots=1, spec_k=4)
    _streams(eng, [prompt], [6])
    assert eng.gauges()["spec_steps"] >= 1
    eng.reset_gauges()
    assert all(v == 0 for v in _spec_gauges(eng).values())
    _balanced(eng)


def test_spec_over_int8_pools_matches_plain_and_jax(models):
    """tests/test_quant_serving.py:301: spec over int8 pools gives the
    int8 plain engine's streams, and the JAX int8 spec engine's."""
    prompts = [np.tile(p, 3) for p in _prompts(7, (5, 9, 6))]
    news = (8, 8, 8)
    plain, _ = _streams(_engine(models, kv_quant="int8"), prompts, news)
    spec = {}
    for side in ("jax", "torch"):
        eng = _engine(models, side, kv_quant="int8", spec_k=4,
                      spec_draft="ngram")
        spec[side] = _streams(eng, prompts, news)[0]
        _balanced(eng)
    assert spec["torch"] == plain
    assert spec["torch"] == spec["jax"]


# ---- skip_layers and the self-speculative draft ----------------------------

def test_skip_layers_logits_match_jax(models):
    jm, tm = models
    cfg = LlamaConfig.tiny()
    rng = np.random.RandomState(2)
    B, C, page, pages = 2, 6, 4, 4
    P = B * pages + 1
    shape = (cfg.num_key_value_heads, P, page, cfg.head_dim)
    pools = [rng.randn(*shape).astype(np.float32)
             for _ in range(2 * cfg.num_hidden_layers)]
    tables = np.arange(1, P, dtype=np.int32).reshape(B, pages)
    ids = rng.randint(0, VOCAB, (B, C)).astype(np.int32)
    ctx = np.array([3, 5], np.int32)
    lengths = np.array([6, 2], np.int32)
    for skip in ((1,), (0,), (0, 1)):
        jl, jpools = jm(paddle.to_tensor(ids),
                        caches=[paddle.to_tensor(p) for p in pools],
                        pos=paddle.to_tensor(ctx[:, None]),
                        tables=(paddle.to_tensor(tables),
                                paddle.to_tensor(lengths)),
                        skip_layers=skip)
        tpools = [torch.from_numpy(p.copy()) for p in pools]
        tl, _ = tm(torch.from_numpy(ids), caches=tpools,
                   pos=torch.from_numpy(ctx),
                   tables=(torch.from_numpy(tables),
                           torch.from_numpy(lengths)),
                   skip_layers=skip)
        # f32 on both sides; matmul and softmax sum in another order
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                                   rtol=1e-4, atol=1e-4)
        for i, (tp, jp) in enumerate(zip(tpools, jpools)):
            if i // 2 in skip:     # a skipped layer writes nothing
                np.testing.assert_array_equal(tp.numpy(), pools[i])
            np.testing.assert_allclose(tp.numpy()[:, 1:],
                                       np.asarray(jp.numpy())[:, 1:],
                                       rtol=1e-5, atol=1e-5)
    # without caches: the JAX model refuses it (its causal LM drops the
    # argument there; the port's passes it on, so it refuses it too)
    for model in (jm.llama, tm.llama, tm):
        ids_ = paddle.to_tensor(ids) if model is jm.llama \
            else torch.from_numpy(ids)
        with pytest.raises(ValueError, match="skip_layers requires"):
            model(ids_, skip_layers=(1,))


def test_qwen2_has_no_skip_layers():
    """The JAX package's Qwen2 takes no skip_layers, so self-speculation
    cannot run on it; the port's refuses it the same way."""
    jcfg = JQwen2Config.tiny()
    jcfg.scan_layers = False
    jm = JQwen2ForCausalLM(jcfg)
    tm = Qwen2ForCausalLM(Qwen2Config.tiny(), device="cpu")
    with pytest.raises(TypeError, match="skip_layers"):
        jm(paddle.to_tensor(np.zeros((1, 2), np.int32)), skip_layers=(1,))
    with pytest.raises(TypeError, match="skip_layers"):
        tm(torch.zeros((1, 2), dtype=torch.int32), skip_layers=(1,))


def _drafting_state(models, side, prompts, news, steps):
    eng = _engine(models, side, spec_k=4, spec_draft="self")
    for p, n in zip(prompts, news):
        eng.add_request(p, n)
    for _ in range(steps):
        eng.step()
    return eng


def test_self_spec_drafts_match_jax(models):
    """From the same engine state (both engines driven through the same
    spec steps), the port's self-speculative source proposes the JAX
    source's drafts, every one of them inside the slots' budgets."""
    prompts = _prompts(23, (9, 12))
    news = (20, 18)
    k = 4
    for steps in (2, 4):
        jeng = _drafting_state(models, "jax", prompts, news, steps)
        teng = _drafting_state(models, "torch", prompts, news, steps)
        slots = [s for s in range(2) if teng.active[s]]
        assert slots == [s for s in range(2) if jeng.active[s]] == [0, 1]
        assert [r.tokens for r in teng.slot_req] == \
            [r.tokens for r in jeng.slot_req]
        assert all(teng.limits[s] - teng._pred_ctx[s] > k for s in slots)
        jd, jc = jeng._spec_source.propose(jeng, slots, k)
        td, tc = teng._spec_source.propose(teng, slots, k)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(td[slots], jd[slots])
        assert ("spec_draft", k) in teng._compiled


def test_self_spec_draft_past_the_row_leaves_committed_kv_untouched(
        models):
    """The in-place hazard: a slot at ctx 44 of a 48-position row (6
    pages of 8) drafting K 8 would write positions 44..51; 48..51 fall
    past the row and would be clamped onto its last page, over the
    committed positions 40..43. The port's draft writes only below the
    slot's limit (47) and sends the rest to the trash page, so every
    committed position of every pool stays bit for bit as it was."""
    (prompt,) = _prompts(31, (44,))
    eng = _engine(models, num_slots=1, prefill_chunk=16, spec_k=8,
                  spec_draft="self", prefix_cache=False)
    eng.add_request(prompt, 4)
    eng.step()                  # admits, streams the first chunk
    while eng._prefilling.any():
        eng.step()
    ctx = int(eng._pred_ctx[0])
    assert ctx == 44 and eng.active[0]
    assert ctx + eng._spec_k - 1 >= eng.pages_per_slot * eng.page_size
    page = eng.page_size
    row = eng.tables[0]
    pages = [int(row[p // page]) for p in range(ctx)]
    offs = [p % page for p in range(ctx)]
    before = [pool[:, pages, offs].clone() for pool in eng.pools]
    drafts, counts = eng._spec_source.propose(eng, [0], eng._spec_k)
    assert counts[0] == eng._spec_k
    for pool, was in zip(eng.pools, before):
        assert torch.equal(pool[:, pages, offs], was)
    # and the stream still completes as the plain engine's
    (req,) = eng.run()
    assert req.tokens == _ref(models, prompt, 4, prefill_chunk=16,
                              prefix_cache=False)
    _balanced(eng)


# ---- the verify writes -----------------------------------------------------

def test_verify_write_matches_jax():
    """A 1 + K verification chunk (K 3) over two slots: slot 0 with all
    four rows, slot 1 with two (padding to trash page 0), slot 1's chunk
    crossing a page edge."""
    kvh, P, page, d = 2, 7, 4, 8
    B, C = 2, 4
    rng = np.random.RandomState(4)
    k = rng.randn(B, C, kvh, d).astype(np.float32)
    v = rng.randn(B, C, kvh, d).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    ctx = np.array([2, 3], np.int32)
    valid = np.array([4, 2], np.int32)
    kp0 = rng.randn(kvh, P, page, d).astype(np.float32)
    vp0 = rng.randn(kvh, P, page, d).astype(np.float32)
    jk, jv = JPA.paged_verify_write(
        jnp.asarray(kp0), jnp.asarray(vp0), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(ctx), jnp.asarray(valid))
    tk, tv = torch.from_numpy(kp0.copy()), torch.from_numpy(vp0.copy())
    TPA.paged_verify_write(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(tables), torch.from_numpy(ctx),
                           torch.from_numpy(valid))
    # real pages equal bit for bit (page 0 takes the padding's writes in
    # an order neither package promises)
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])


def test_verify_write_quant_matches_jax():
    kvh, P, page, d = 2, 7, 4, 8
    B, C = 2, 4
    rng = np.random.RandomState(6)
    k = (rng.randn(B, C, kvh, d) * 3).astype(np.float32)
    v = (rng.randn(B, C, kvh, d) * 3).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    ctx = np.array([1, 3], np.int32)
    valid = np.array([3, 4], np.int32)
    jp = JPA.paged_verify_write_quant(
        jnp.zeros((kvh, P, page, d), jnp.int8),
        jnp.zeros((kvh, P, page, d), jnp.int8),
        jnp.zeros((kvh, P, page), jnp.float32),
        jnp.zeros((kvh, P, page), jnp.float32),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(valid))
    tp = [torch.zeros(kvh, P, page, d, dtype=torch.int8),
          torch.zeros(kvh, P, page, d, dtype=torch.int8),
          torch.zeros(kvh, P, page), torch.zeros(kvh, P, page)]
    TPA.paged_verify_write_quant(*tp, torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(tables),
                                 torch.from_numpy(ctx),
                                 torch.from_numpy(valid))
    for i in (0, 1):
        np.testing.assert_array_equal(tp[i].numpy()[:, 1:],
                                      np.asarray(jp[i])[:, 1:])
    for i in (2, 3):
        # an f32 quotient absmax / 127 on both sides: within two ulps
        np.testing.assert_allclose(tp[i].numpy()[:, 1:],
                                   np.asarray(jp[i])[:, 1:],
                                   rtol=2 ** -22, atol=0)
