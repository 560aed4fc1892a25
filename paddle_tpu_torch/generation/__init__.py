"""Autoregressive text generation (``model.generate``) over a dense KV
cache.

Port of ``paddle_tpu/generation/__init__.py``: ``GenerationConfig``,
``_process_and_sample`` (repetition penalty, temperature, top-k, top-p,
the pick, the logprob and the eos/pad rule) and ``GenerationMixin`` with
``generate``. The model implements ``init_kv_cache(batch_size,
max_length)`` and ``forward(ids, caches=, pos=)`` over those caches
(``models.llama``, ``models.qwen2``, ``models.gpt2``,
``models.deepseek``), writing them in place. The caches are the model's
own: the loop only passes the list back, so a layer's two tensors need
not be k and v of one shape (DeepSeek-V2's are a [B, T, R] latent and a
[B, T, 1, rope] key).

The JAX package has two drivers and the port keeps both contracts as
eager loops on the weights' device:

- no eos: the prefill and every decode step in one loop that makes no
  host synchronisation (positions are Python ints, every tensor stays on
  the device; the JAX package compiles it into one program with a
  ``lax.scan``);
- an eos: one step a token that polls ``finished`` once (one host
  synchronisation a token) and stops when every row has finished.

Sampling draws from a ``torch.Generator`` on the weights' device seeded
by ``seed`` (Gumbel-max, as the serving engine samples), so sampled
streams differ from the JAX package's ``jax.random`` ones; ``seed=None``
draws the seed from torch's default CPU generator (``torch.manual_seed``
makes it reproducible). Greedy decoding draws nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["GenerationConfig", "GenerationMixin"]


@dataclass
class GenerationConfig:
    max_new_tokens: int = 64
    decode_strategy: str = "sampling"  # "greedy_search" | "sampling"
    temperature: float = 1.0
    top_k: int = 0                     # 0 = disabled
    top_p: float = 1.0                 # 1.0 = disabled
    repetition_penalty: float = 1.0
    eos_token_id: int | None = None
    pad_token_id: int | None = None
    use_cache: bool = True
    seed: int | None = None


def _process_logits(logits, buf, write_pos, *, temperature, top_k, top_p,
                    rep, greedy):
    """The processed f32 logits [B, V] from which a token is picked and
    its logprob taken: the repetition penalty over ``buf[:, :write_pos]``
    (the tokens so far), then, only when sampling, the temperature, top-k
    (``lg < kth`` is dropped, so ties at the k-th value stay) and top-p
    (the smallest set whose mass reaches ``top_p``: the shifted rule
    ``cum - p > top_p`` keeps the first token crossing it)."""
    b, vocab = logits.shape
    lg = logits.float()
    if rep != 1.0:
        # ids outside the vocabulary (a pad sentinel past it) count for
        # nothing, as the JAX scatter drops them
        inside = (buf >= 0) & (buf < vocab)
        valid = torch.arange(buf.shape[1], device=buf.device) < write_pos
        seen = torch.zeros(b, vocab, device=lg.device).scatter_add_(
            1, buf.long().clamp(0, vocab - 1), (inside & valid).float())
        pen = torch.where(lg > 0, lg / rep, lg * rep)
        lg = torch.where(seen > 0, pen, lg)
    if greedy:
        return lg
    if temperature != 1.0:
        lg = lg / temperature
    if top_k and top_k > 0:
        kth = torch.topk(lg, min(top_k, vocab)).values[:, -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    if top_p < 1.0:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lg, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff = torch.where(cum - probs > top_p, float("inf"),
                             sorted_lg).amin(dim=-1, keepdim=True)
        lg = lg.masked_fill(lg < cutoff, float("-inf"))
    return lg


def _process_and_sample(logits, gen, buf, write_pos, finished, *,
                        temperature, top_k, top_p, rep, greedy, eos_id,
                        pad_id):
    """The next token of every row from the last position's logits [B, V]:
    processed (:func:`_process_logits`), then the argmax (greedy) or a
    Gumbel-max draw from ``gen``; the logprob of the pick under the
    processed logits. With an eos (``eos_id >= 0``) a finished row picks
    ``pad_id`` with logprob 0, and a row that picks the eos finishes. The
    token is written into ``buf[:, write_pos]`` (in place). Returns
    ``(token [B] int32, logprob [B] f32, finished [B] bool)``."""
    lg = _process_logits(logits, buf, write_pos, temperature=temperature,
                         top_k=top_k, top_p=top_p, rep=rep, greedy=greedy)
    if greedy:
        tok = torch.argmax(lg, dim=-1)
    else:
        u = torch.rand(lg.shape, generator=gen,
                       device=lg.device).clamp_(min=1e-20)
        tok = torch.argmax(lg - (-u.log()).log(), dim=-1)
    logprob = torch.log_softmax(lg, dim=-1).gather(1, tok[:, None])[:, 0]
    tok = tok.to(buf.dtype)
    if eos_id >= 0:
        tok = torch.where(finished, pad_id, tok)
        logprob = torch.where(finished, 0.0, logprob)
        finished = finished | (tok == eos_id)
    buf[:, write_pos] = tok
    return tok, logprob, finished


class GenerationMixin:
    """Adds ``generate`` to a causal LM (an ``nn.Module``) that implements
    ``init_kv_cache(batch_size, max_length)`` and ``forward(ids,
    caches=, pos=) -> (logits, caches)`` over dense caches written in
    place."""

    generation_config: GenerationConfig | None = None

    def init_kv_cache(self, batch_size, max_length, dtype=None):
        raise NotImplementedError

    @torch.no_grad()
    def generate(self, input_ids, generation_config=None,
                 max_new_tokens=None, max_length=None, decode_strategy=None,
                 temperature=None, top_k=None, top_p=None,
                 repetition_penalty=None, eos_token_id=None,
                 pad_token_id=None, use_cache=None, seed=None, **kwargs):
        """Generate token ids on the device of the weights (the prompt
        goes there; the weights never move). Returns ``(ids, scores)``:
        ``ids`` [B, new_len] int32, the prompt excluded (PaddleNLP's
        convention), and ``scores`` [B] f32, the mean logprob of each
        row's generated tokens (a row stops counting once it has
        finished). ``new_len`` is ``max_new_tokens``, or fewer when an
        eos finished every row; ``max_length`` (prompt included) stands
        in for an absent ``max_new_tokens``."""
        cfg = generation_config or self.generation_config or \
            GenerationConfig()
        pick = lambda v, d: d if v is None else v  # noqa: E731
        greedy = pick(decode_strategy, cfg.decode_strategy) in (
            "greedy_search", "greedy")
        eos = pick(eos_token_id, cfg.eos_token_id)
        pad = pick(pad_token_id, cfg.pad_token_id)
        pad = int((eos if pad is None else pad) or 0)
        proc = dict(temperature=float(pick(temperature, cfg.temperature)),
                    top_k=int(pick(top_k, cfg.top_k)),
                    top_p=float(pick(top_p, cfg.top_p)),
                    rep=float(pick(repetition_penalty,
                                   cfg.repetition_penalty)),
                    greedy=greedy, pad_id=pad)
        dev = next(self.parameters()).device
        ids = torch.as_tensor(np.asarray(input_ids)) \
            if not isinstance(input_ids, torch.Tensor) else input_ids
        ids = ids.to(device=dev, dtype=torch.int32)
        b, prompt_len = ids.shape
        if max_new_tokens is None and max_length is not None:
            max_new_tokens = int(max_length) - prompt_len
        n_new = int(pick(max_new_tokens, cfg.max_new_tokens))
        if n_new <= 0:
            raise ValueError(
                f"max_new_tokens must be positive, got {n_new} "
                f"(max_length={max_length}, prompt length {prompt_len})")
        gen = None
        if not greedy:
            seed_ = pick(seed, cfg.seed)
            if seed_ is None:
                seed_ = int(torch.randint(0, 2 ** 62, ()).item())
            gen = torch.Generator(device=dev).manual_seed(int(seed_))
        # the prompt, then the generated tokens (pad until written)
        buf = torch.cat([ids, torch.full((b, n_new), pad, dtype=torch.int32,
                                         device=dev)], dim=1)
        caches = self.init_kv_cache(b, prompt_len + n_new)
        if eos is None or int(eos) < 0:
            return self._generate_static(ids, buf, caches, gen, n_new, proc)
        return self._generate_eos(ids, buf, caches, gen, n_new, int(eos),
                                  proc)

    def _generate_static(self, ids, buf, caches, gen, n_new, proc):
        """No eos: the prefill and ``n_new - 1`` decode steps, no host
        synchronisation (the JAX package's ``_gen_fused_static``)."""
        b, prompt_len = ids.shape
        fin = torch.zeros(b, dtype=torch.bool, device=ids.device)
        logits, _ = self(ids, caches=caches, pos=0)
        tok, lp, _ = _process_and_sample(logits[:, -1], gen, buf, prompt_len,
                                         fin, eos_id=-1, **proc)
        acc = lp.float()
        for i in range(n_new - 1):
            logits, _ = self(tok[:, None], caches=caches, pos=prompt_len + i)
            tok, lp, _ = _process_and_sample(
                logits[:, -1], gen, buf, prompt_len + 1 + i, fin, eos_id=-1,
                **proc)
            acc = acc + lp.float()
        return buf[:, prompt_len:prompt_len + n_new], acc / float(n_new)

    def _generate_eos(self, ids, buf, caches, gen, n_new, eos, proc):
        """With an eos: one step a token, polling ``finished`` (one host
        synchronisation a token); stops once every row has finished. A
        row's score is the mean over the tokens it generated up to and
        including its eos."""
        b, prompt_len = ids.shape
        finished = torch.zeros(b, dtype=torch.bool, device=ids.device)
        logits, _ = self(ids, caches=caches, pos=0)
        tok, lp, finished = _process_and_sample(
            logits[:, -1], gen, buf, prompt_len, finished, eos_id=eos,
            **proc)
        lp_sum = lp.float()
        counts = torch.ones(b, device=ids.device)
        steps = 1
        for i in range(1, n_new):
            if bool(finished.all()):
                break
            counts += (~finished).float()
            logits, _ = self(tok[:, None], caches=caches,
                             pos=prompt_len + i - 1)
            tok, lp, finished = _process_and_sample(
                logits[:, -1], gen, buf, prompt_len + i, finished,
                eos_id=eos, **proc)
            lp_sum = lp_sum + lp.float()
            steps += 1
        return buf[:, prompt_len:prompt_len + steps], lp_sum / counts
