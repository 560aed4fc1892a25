"""Speculative decoding: draft sources and exact verification.

Port of ``paddle_tpu/inference/spec_decode.py``. A drafting decode slot
rides ``1 + K`` tokens through the engine's ragged mixed pass (its
pending token in column 0, then ``K`` drafts), so verification is a
short prefill-shaped chunk through the ragged paged attention (K12, or
K13 over int8/fp8 pools): no kernel of its own.

- **Draft sources** propose up to ``K`` tokens per drafting slot:
  :class:`NGramDraftSource` (prompt lookup over ``prompt + emitted``, host
  only) and :class:`SelfSpecDraftSource` (``K`` greedy micro-steps of the
  same model with layers skipped).
- **Verification** is the speculative-sampling rule for point-mass
  drafts: accept draft ``d_j`` with probability ``min(1, p_j[d_j])``, at
  the first rejection resample from ``p_j`` with ``d_j`` zeroed, and draw
  a bonus token from ``p_K`` when every draft holds. Each emitted
  position is distributed exactly as the target; greedy reduces to
  exact-match acceptance, so greedy spec streams equal the plain
  engine's. :func:`rejection_sample` is the host form (numpy, the
  numeric contract), :func:`verify_drafts` the engine's batched form on
  the device.

Draft state is invisible to every replay path (preemption recompute,
supervised restart, prefix-cache attach): they rebuild from ``prompt +
tokens``, and rejected draft KV is fenced by ctx
(``ops.paged_attention.paged_verify_write``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DraftSource", "NGramDraftSource", "SelfSpecDraftSource",
           "get_draft_source", "ngram_propose", "rejection_sample",
           "verify_drafts"]


def rejection_sample(probs, drafts, rng, greedy=False):
    """Verify point-mass drafts against the target distributions.

    probs [K+1, V] (position j conditions on the pending token and drafts
    ``d_1..d_j``), drafts [K] ints, rng a ``np.random.Generator`` (unused
    under greedy). Returns ``(emitted, n_accepted)``: at least one token;
    ``emitted[j] == drafts[j]`` for ``j < n_accepted``, and the last entry
    is the rejection resample or the bonus token.

    Exactness, for a point-mass draft: P(emit t at j) = min(1, p_j[d_j])
    1[t == d_j] + (1 - p_j[d_j]) p_j(t) 1[t != d_j] / (1 - p_j[d_j]) =
    p_j(t)."""
    probs = np.asarray(probs, np.float64)
    drafts = [int(d) for d in drafts]
    k = len(drafts)
    assert probs.shape[0] >= k + 1
    emitted = []
    for j, d in enumerate(drafts):
        p = probs[j]
        if greedy:
            accept = d == int(np.argmax(p))
        else:
            accept = rng.random() < min(1.0, float(p[d]))
        if accept:
            emitted.append(d)
            continue
        if greedy:
            t = int(np.argmax(p))
        else:
            resid = p.copy()
            resid[d] = 0.0
            tot = resid.sum()
            # p a point mass at d that still lost: impossible, stay exact
            t = d if tot <= 0.0 else int(rng.choice(len(resid),
                                                    p=resid / tot))
        emitted.append(t)
        return emitted, j
    p = probs[k]
    t = int(np.argmax(p)) if greedy else int(
        rng.choice(len(p), p=p / p.sum()))
    emitted.append(t)
    return emitted, k


def _gumbel_argmax(logp, gen):
    """A draw per row from softmax(logp) by the Gumbel-max trick (no host
    synchronisation, unlike ``torch.multinomial``'s checks)."""
    u = torch.rand(logp.shape, generator=gen,
                   device=logp.device).clamp_(min=1e-20)
    return torch.argmax(logp - (-u.log()).log(), -1)


def verify_drafts(logits, drafts, n_drafts, greedy=True, temperature=1.0,
                  gen=None):
    """The batched verification rule of the spec step, on the device.

    logits [B, K+1, V] f32 (the target at each chunk position), drafts
    [B, K] int, n_drafts [B] (drafts past it do not count), ``gen`` the
    engine's ``torch.Generator`` (sampling only). Returns ``(n_acc [B],
    fin [B])``, both int64: the leading run of accepted drafts, and the
    token after it (the rejection resample with the rejected draft
    zeroed, or the bonus draw from ``p_K``). The same rule as
    :func:`rejection_sample`, one row per slot; the uniform draws come
    first, then the resample's Gumbel noise."""
    b, k1, _ = logits.shape
    k = k1 - 1
    d = drafts.long()
    jk = torch.arange(k, device=logits.device)
    if greedy:
        tgt = torch.argmax(logits, -1)                          # [B, K+1]
        acc = d == tgt[:, :k]
    else:
        p = torch.softmax(logits / temperature, -1)
        u = torch.rand((b, k), generator=gen, device=logits.device)
        acc = u < p[:, :k].gather(2, d[:, :, None])[:, :, 0]
    acc = acc & (jk[None, :] < n_drafts.long()[:, None])
    n_acc = torch.cumprod(acc.long(), 1).sum(1)
    if greedy:
        return n_acc, tgt.gather(1, n_acc[:, None])[:, 0]
    row = p.gather(1, n_acc[:, None, None].expand(-1, 1, p.shape[2]))[:, 0]
    d_at = d.gather(1, n_acc.clamp(max=k - 1)[:, None])
    rejected = (n_acc < n_drafts.long())[:, None]
    v_ax = torch.arange(p.shape[2], device=logits.device)[None, :]
    row = torch.where(rejected & (v_ax == d_at), 0.0, row)
    logp = torch.where(row > 0, row.log(), float("-inf"))
    return n_acc, _gumbel_argmax(logp, gen)


class DraftSource:
    """Strategy seam: propose up to ``k`` draft tokens per drafting slot.
    ``propose`` sees the engine and returns host arrays; the engine clamps
    the counts to each slot's budget. A source keeps no state that
    correctness depends on: replay paths never see drafts."""

    name = "base"

    def propose(self, eng, slots, k):
        """-> (drafts [num_slots, k] int32, counts [num_slots] int32).
        Rows of slots not in ``slots`` are ignored; a count of 0 makes
        that slot a plain one-token decode inside the spec step."""
        raise NotImplementedError


#: the n-gram sizes the n-gram source matches, longest first
NGRAM_MAX_N, NGRAM_MIN_N = 3, 1


def ngram_propose(hist, k, max_n=NGRAM_MAX_N, min_n=NGRAM_MIN_N):
    """Prompt-lookup proposal: match the trailing ``n``-gram of ``hist``
    (``prompt + emitted``) against every earlier window, longest ``n``
    first, the most recent match winning; propose the (up to) ``k``
    tokens that followed it. Returns int32 [<= k], possibly empty."""
    hist = np.asarray(hist, np.int32).reshape(-1)
    ln = hist.shape[0]
    for n in range(min(max_n, ln - 1), max(min_n, 1) - 1, -1):
        suffix = hist[ln - n:]
        # windows hist[j:j+n] with j <= ln-n-1: strictly before the suffix
        win = np.lib.stride_tricks.sliding_window_view(hist[:-1], n)
        hits = np.nonzero((win == suffix[None, :]).all(axis=1))[0]
        if hits.size == 0:
            continue
        j = int(hits[-1])
        prop = hist[j + n:j + n + k]
        if prop.size:
            return prop.astype(np.int32)
    return np.zeros((0,), np.int32)


class NGramDraftSource(DraftSource):
    """Prompt-lookup drafts: the continuation of the most recent matching
    n-gram of the slot's own history (n from ``NGRAM_MAX_N`` down to
    ``NGRAM_MIN_N``). Host work only."""

    name = "ngram"

    def propose(self, eng, slots, k):
        b = eng.num_slots
        drafts = np.zeros((b, k), np.int32)
        counts = np.zeros((b,), np.int32)
        for slot in slots:
            req = eng.slot_req[slot]
            if req is None:
                continue
            hist = np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(req.tokens, np.int32)])
            prop = ngram_propose(hist, k, NGRAM_MAX_N, NGRAM_MIN_N)
            counts[slot] = prop.shape[0]
            drafts[slot, :prop.shape[0]] = prop
        return drafts, counts


class SelfSpecDraftSource(DraftSource):
    """Self-speculative drafts: ``K`` greedy micro-steps of the engine's
    own model at ``[B, 1]`` with the top half of its layers passed
    through (:func:`draft_skip_layers`), from the device's pending
    tokens and ctx over the host block tables; one copy of the ``[B, K]``
    drafts to the host at the end.

    The JAX package's micro-steps update copies of the pools and drop
    them. The port's write the pools in place, which is safe only inside
    the slot's budget: a position at or past the row's end would be
    clamped onto the row's last page and overwrite committed KV there.
    So a micro-step writes only while ``ctx < limit`` (the slot's ctx
    budget, inside its own pages) and sends every later write to the
    trash page. What it writes at ``ctx .. ctx + nd`` the verify step
    rewrites; what lies past that stays fenced by ctx. Drafts made past
    the budget are never dispatched (the engine clamps the counts to
    ``limit - ctx - 1``). Needs a model with ``skip_layers`` (Llama; the
    JAX package's Qwen2 has none, so neither has the port's)."""

    name = "self"

    @torch.no_grad()
    def propose(self, eng, slots, k):
        b = eng.num_slots
        counts = np.zeros((b,), np.int32)
        if not slots or k <= 0:
            return np.zeros((b, max(k, 0)), np.int32), counts
        eng._compiled.add(("spec_draft", int(k)))
        skip = draft_skip_layers(eng.model.config)
        mask_np = np.zeros((b,), bool)
        mask_np[list(slots)] = True
        # one upload: the drafting mask, the ctx limits, the table rows
        up = np.concatenate([mask_np[:, None].astype(np.int32),
                             eng.limits[:, None], eng.tables], 1)
        up = torch.from_numpy(up).to(eng.device)
        mask, lim, tbl = up[:, 0].bool(), up[:, 1], up[:, 2:].contiguous()
        tok, ctx = eng._dev_tok, eng._dev_ctx
        toks = []
        for _ in range(k):
            valid = mask & (ctx < lim)
            lg, _ = eng.model(tok[:, None], caches=eng.pools, pos=ctx,
                              tables=(tbl, valid), skip_layers=skip)
            nx = torch.argmax(lg[:, -1].float(), -1).to(torch.int32)
            tok = torch.where(mask, nx, tok)
            ctx = ctx + mask.to(torch.int32)
            toks.append(tok)
        eng._stats.inc("draft_forwards", k)
        drafts = torch.stack(toks, 1).cpu().numpy().astype(np.int32)
        counts[mask_np] = k
        return drafts, counts


def draft_skip_layers(config):
    """The layers a self-speculative draft passes through: the top half,
    ``range((n + 1) // 2, n)`` of ``n``."""
    n = int(config.num_hidden_layers)
    return tuple(range((n + 1) // 2, n))


def get_draft_source(spec):
    """A :class:`DraftSource` passes through; ``"ngram"`` and ``"self"``
    (also ``"skip_layer"``, ``"self_spec"``) build the default ones."""
    if isinstance(spec, DraftSource):
        return spec
    if spec == "ngram":
        return NGramDraftSource()
    if spec in ("self", "skip_layer", "self_spec"):
        return SelfSpecDraftSource()
    raise ValueError(f"unknown draft source {spec!r} "
                     "(want 'ngram', 'self', or a DraftSource)")
