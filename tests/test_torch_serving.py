"""The port's continuous-batching engine (paddle_tpu_torch.inference)
against the JAX package's on LlamaConfig.tiny(): the five mixed-length
requests through 2 slots of tests/test_serving.py, whose greedy streams
must be token-identical to the JAX engine's; eos stops; the page free
list; sampling from a seeded generator; the device rule."""

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

SPECS = [(5, 7), (13, 4), (9, 11), (21, 6), (3, 8)]   # (prompt, new)
ENGINE = dict(num_slots=2, page_size=8, max_len=64, decode_chunk=4)


def _prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (p,)).astype(np.int32) for p, _ in SPECS]


@pytest.fixture(scope="module")
def models():
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = convert.from_numpy_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), arrays)
    return jm, tm


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's greedy streams (prefill chunk 32, as its
    prompt_buckets (8, 16, 32) give)."""
    jm, _ = models
    eng = JEngine(jm, prompt_buckets=(8, 16, 32), greedy=True,
                  prefix_cache=False, **ENGINE)
    ids = [eng.add_request(p, n) for p, (_, n) in zip(_prompts(), SPECS)]
    by_id = {r.request_id: r.tokens for r in eng.run()}
    return [by_id[i] for i in ids]


def _port_engine(tm, **kw):
    return ContinuousBatchingEngine(tm, prefill_chunk=32, device="cpu",
                                    **{**ENGINE, **kw})


def test_mixed_length_streams_match_jax_engine(models, jax_streams):
    _, tm = models
    eng = _port_engine(tm)
    free_before = len(eng._free_pages)
    ids = [eng.add_request(p, n) for p, (_, n) in zip(_prompts(), SPECS)]
    done = eng.run()
    assert sorted(r.request_id for r in done) == sorted(ids)
    by_id = {r.request_id: r for r in done}
    for rid, ref, (_, n) in zip(ids, jax_streams, SPECS):
        assert by_id[rid].tokens == ref, (rid, by_id[rid].tokens, ref)
        assert len(ref) == n and by_id[rid].finish_reason == "length"
    # 5 requests through 2 slots: slots drained and were re-admitted,
    # and every page came back (free, or resident in the prefix cache)
    assert eng._stats["prefills"] == 5
    assert free_before == eng.num_pages - 1
    assert len(eng._free_pages) + eng.prefix_cache_pages == free_before
    assert not eng.active.any() and all(r is None for r in eng.slot_req)


def test_eos_stops_stream_early(models, jax_streams):
    _, tm = models
    # a stream that does not repeat one token throughout
    i = next(i for i, s in enumerate(jax_streams) if len(set(s)) > 1)
    prompt, ref = _prompts()[i], jax_streams[i]
    # the first token that differs from its predecessor, so the stop
    # lands mid-stream and not at the prefill token
    eos = next(t for t in ref[1:] if t != ref[0])
    n_stop = ref.index(eos) + 1
    assert 1 < n_stop < len(ref)
    eng = _port_engine(tm, num_slots=1)
    eng.add_request(prompt, len(ref), eos_token_id=eos)
    (req,) = eng.run()
    assert req.finish_reason == "eos"
    assert req.tokens == ref[:n_stop]
    assert len(eng._free_pages) + eng.prefix_cache_pages \
        == eng.num_pages - 1


def test_chunked_prefill_is_token_identical_to_one_chunk(models):
    """A prompt streamed in 8-token chunks gives the stream of the same
    prompt in one 32-token chunk (the chunk contract of the pool)."""
    _, tm = models
    prompt, n = _prompts()[3], 6
    streams = []
    for chunk in (8, 32):
        eng = ContinuousBatchingEngine(tm, num_slots=1, page_size=8,
                                       max_len=64, decode_chunk=3,
                                       prefill_chunk=chunk, device="cpu")
        eng.add_request(prompt, n)
        streams.append(eng.run()[0].tokens)
    assert streams[0] == streams[1]


def test_temperature_sampling_follows_the_seed(models):
    _, tm = models

    def run(seed):
        eng = _port_engine(tm, greedy=False, temperature=0.8, seed=seed)
        for p, (_, n) in zip(_prompts()[:3], SPECS):
            eng.add_request(p, n)
        return [r.tokens for r in sorted(eng.run(),
                                         key=lambda r: r.request_id)]

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    assert [len(t) for t in a] == [n for _, n in SPECS[:3]]
    assert all(0 <= t < 256 for s in a for t in s)


def test_request_that_cannot_fit_is_rejected(models):
    _, tm = models
    eng = _port_engine(tm)
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(np.arange(60), 10)


def test_engine_without_device_raises_where_there_is_no_gpu(models,
                                                            monkeypatch):
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(tm, **ENGINE)
