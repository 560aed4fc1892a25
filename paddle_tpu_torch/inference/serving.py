"""Continuous-batching serving engine over paged KV pools.

Port of the unified core of ``paddle_tpu/inference/serving.py``:
``ServedRequest`` and ``ContinuousBatchingEngine`` with ``unified=True``
(pools and slot state, ``add_request``/``_check_fits``, ``step``/``run``,
the batching step of ``_unified_static``, ``_dispatch_step``/
``_harvest_step``, ``_admit``, ``_stage_slot``, ``_alloc_pages``/
``_release_pages`` and ``_drain``), with ``num_pages`` and quantized KV
pools (``kv_quant="int8"|"fp8"``) and the ``kv_quant_*`` gauges.

One batching step is a ragged mixed pass (prefilling slots stream their
next ``prefill_chunk`` prompt tokens, decoding slots ride their pending
token as a length-1 sequence, idle slots are length 0: one
``[num_slots, prefill_chunk]`` forward) followed by ``decode_chunk - 1``
decode micro-steps. The JAX engine compiles that step into one program;
here it runs eagerly on the device as a Python loop over tensors, with
no host transfer inside it: the step's inputs go up as one int32 tensor
and its results come back as one packed int32 tensor (one ``.cpu()``).
The host loop is serial: dispatch, then harvest.

Quantized KV (the JAX engine's ``kv_quant``): each layer holds four pools,
``[k, v, k_scales, v_scales]``: int8 or ``float8_e4m3fn`` codes
``[KVH, num_pages, page, D]`` and f32 scales ``[KVH, num_pages, page]``,
one scale per (token, kv head), written with the token; attention goes
through K13.

Not ported yet: the prefix cache and copy-on-write, priorities,
preemption and deadlines, containment and the page audit, speculative
decoding, disaggregation, weight-only quantization, the legacy engine,
tuner surfaces, the metrics registry (and with it every gauge but the
``kv_quant_*`` ones) and tracing.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ContinuousBatchingEngine", "ServedRequest"]

# kv_quant mode -> pool dtype (None: the model's float dtype)
_KV_QUANT = {"none": None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}


@dataclass(eq=False)
class ServedRequest:
    request_id: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    eos_token_id: int | None = None
    tokens: list = field(default_factory=list)   # generated ids
    finished: bool = False
    finish_reason: str | None = None   # "eos" | "length"


class ContinuousBatchingEngine:
    """Schedules mixed-length generation streams through one batching
    step. Greedy, or temperature sampling from a ``torch.Generator``
    seeded by ``seed``.

    ``model`` implements ``forward(ids, caches=, pos=, tables=) ->
    (logits, caches)`` and writes the pools in place (``models.llama``,
    ``models.qwen2``; a MoE model routes every row of the step's input,
    padding included, as the JAX engine's does). The
    engine runs on ``device`` (``cuda`` unless given; it raises with no
    GPU and no device), where the model's weights must already be.
    Page 0 of the pool is the reserved trash page."""

    def __init__(self, model, num_slots=4, page_size=16, num_pages=None,
                 max_len=512, decode_chunk=16, prefill_chunk=128,
                 greedy=True, temperature=1.0, seed=0, kv_quant="none",
                 device=None):
        if kv_quant not in _KV_QUANT:
            raise ValueError(f"unknown kv_quant {kv_quant!r} "
                             "(expected 'none', 'int8' or 'fp8')")
        self.kv_quant = kv_quant
        self.device = resolve_device(device)
        params = list(model.parameters())
        wrong = {str(p.device) for p in params
                 if p.device.type != self.device.type}
        if wrong:
            raise ValueError(f"the model's weights are on {sorted(wrong)}, "
                             f"the engine on {self.device}")
        self.model = model
        cfg = model.config
        self.cfg = cfg
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.pages_per_slot = -(-self.max_len // self.page_size)
        # default: every slot can hold max_len; +1: page 0 is the trash
        # page. Fewer pages make admission wait for free ones.
        self.num_pages = int(num_pages) if num_pages is not None else \
            self.num_slots * self.pages_per_slot + 1
        self.decode_chunk = int(decode_chunk)
        self._n_decode = max(0, self.decode_chunk - 1)
        self.prefill_chunk = max(1, min(int(prefill_chunk), self.max_len))
        self.greedy = bool(greedy)
        self.temperature = float(temperature)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(seed))

        dtype = next(p.dtype for p in params if p.is_floating_point())
        kvh = cfg.num_key_value_heads
        self._pool_shape = (kvh, self.num_pages, self.page_size,
                            cfg.head_dim)
        # per layer (key_pages, value_pages) and, quantized, their scales
        # pools (key_scales, value_scales), flat; written in place
        layer = [(self._pool_shape, _KV_QUANT[kv_quant] or dtype)] * 2
        if kv_quant != "none":
            layer += [((kvh, self.num_pages, self.page_size),
                       torch.float32)] * 2
        self.pools = [torch.zeros(shape, dtype=dt, device=self.device)
                      for _ in range(cfg.num_hidden_layers)
                      for shape, dt in layer]
        self._free_pages = deque(range(1, self.num_pages))

        # host-side slot bookkeeping (admission decisions, drain)
        B, MP = self.num_slots, self.pages_per_slot
        self.active = np.zeros((B,), bool)        # mirror (packed fetch)
        self.limits = np.zeros((B,), np.int32)    # ctx budget per slot
        self.slot_req: list[ServedRequest | None] = [None] * B
        self.slot_pages: list[list] = [[] for _ in range(B)]
        # a slot whose prompt is still streaming is PREFILLING: inactive
        # for decode, not drainable
        self._prefilling = np.zeros((B,), bool)
        self._prefill_off = np.zeros((B,), np.int32)   # tokens dispatched
        # host prediction of the device ctx (exact for length-limited
        # slots; an eos stop only makes it an overestimate)
        self._pred_ctx = np.zeros((B,), np.int32)

        # device-resident slot state: never round-trips between steps
        def dev(fill, shape=(B,), dt=torch.int32):
            return torch.full(shape, fill, dtype=dt, device=self.device)
        self._dev_tok = dev(0)
        self._dev_ctx = dev(0)
        self._dev_act = dev(False, dt=torch.bool)
        self._dev_tbl = dev(0, (B, MP))
        self._dev_lim = dev(0)
        self._dev_eos = dev(-1)

        self.queue: deque[ServedRequest] = deque()
        self.completed: list[ServedRequest] = []
        self._next_id = 0
        #: plain counters: steps, model forwards, admissions
        self.stats = {"steps": 0, "forwards": 0, "admitted": 0}

    # ---- public API ------------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens,
                    eos_token_id=None) -> int:
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        self._check_fits(prompt.size, int(max_new_tokens))
        req = ServedRequest(self._next_id, prompt, int(max_new_tokens),
                            eos_token_id)
        self._next_id += 1
        self.queue.append(req)
        return req.request_id

    def _check_fits(self, prompt_len, max_new):
        if prompt_len < 1 or max_new < 1:
            raise ValueError("a request needs a prompt and at least one "
                             "new token")
        if prompt_len + max_new > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({max_new}) exceeds engine max_len {self.max_len}")
        # what the pool can never hold would wait for pages forever
        need = -(-(prompt_len + max_new) // self.page_size)
        if need > self.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.num_pages - 1} allocatable")

    def gauges(self):
        """The JAX engine's ``kv_quant_*`` gauges: bits of a pool element,
        bytes of the data pools and of the scales pools (0 unquantized)."""
        data = [p for p in self.pools if p.dim() == 4]
        return {
            "kv_quant_bits": 8 * data[0].element_size(),
            "kv_quant_pool_bytes": sum(p.numel() * p.element_size()
                                       for p in data),
            "kv_quant_scale_pool_bytes": sum(
                p.numel() * p.element_size() for p in self.pools
                if p.dim() == 3),
        }

    def step(self):
        """Admit what fits, run one batching step if it advances anything,
        drain finished slots. Returns the requests completed here."""
        self._admit()
        if self._worth_step():
            self._harvest_step(self._dispatch_step())
        return self._drain()

    def run(self):
        """Drive until every queued request completes; returns them in
        completion order."""
        done = []
        while self.queue or any(r is not None for r in self.slot_req):
            before = (self.stats["steps"], self.stats["admitted"],
                      len(self.completed))
            done.extend(self.step())
            if (self.stats["steps"], self.stats["admitted"],
                    len(self.completed)) == before:
                raise RuntimeError(
                    f"serving engine stalled: {len(self.queue)} queued, "
                    f"{len(self._free_pages)} free pages, no slot can "
                    "advance")
        return done

    # ---- the batching step -----------------------------------------------

    def _worth_step(self):
        """Would a step advance anything? Prefilling slots always do;
        decode slots while the host's ctx prediction leaves budget."""
        return bool(self._prefilling.any()
                    or np.any(self.active & (self.limits > self._pred_ctx)))

    def _sample(self, logits):
        """Next token per row of f32 logits [B, V]: argmax, or a draw
        from softmax(logits / temperature) by the Gumbel-max trick (no
        host sync, unlike ``torch.multinomial``'s checks)."""
        if self.greedy:
            return torch.argmax(logits, -1).to(torch.int32)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device).clamp_(min=1e-20)
        return torch.argmax(logits / self.temperature - (-u.log()).log(),
                            -1).to(torch.int32)

    @torch.no_grad()
    def _device_step(self, inputs):
        """The batching step, on the device. ``inputs`` [B, C + 3] int32
        holds the stream ids and, per slot, the prompt tokens streamed
        (nq), whether the prompt completes (last) and whether the slot
        decodes afterwards (tgt). Returns the packed [B, 2 * n + 2] int32
        output: emitted tokens, emitted flags, final ctx, final active."""
        C = self.prefill_chunk
        model = self.model
        B = self.num_slots
        ids = inputs[:, :C]
        nq = inputs[:, C]
        last = inputs[:, C + 1].bool()
        tgt = inputs[:, C + 2].bool()
        tok, ctx, tbl = self._dev_tok, self._dev_ctx, self._dev_tbl
        lim, eos = self._dev_lim, self._dev_eos
        # stale instant-eos guard
        act = self._dev_act & ((eos < 0) | (tok != eos))
        is_pre = nq > 0
        lengths = torch.where(is_pre, nq, act.to(torch.int32))
        # decode slots carry their device-resident pending token in
        # stream column 0
        ids[:, 0] = torch.where(is_pre, ids[:, 0], tok)
        logits, _ = model(ids, caches=self.pools, pos=ctx,
                          tables=(tbl, lengths))
        idx = (lengths - 1).clamp(0, C - 1).long()
        last_lg = logits[torch.arange(B, device=ids.device), idx].float()
        sampled = self._sample(last_lg)
        # a next token fires for completing prompts and advancing decodes
        fire = (is_pre & last) | (act & ~is_pre)
        nxt = torch.where(fire, sampled, tok)
        ctx1 = ctx + lengths
        hit_eos = (eos >= 0) & (nxt == eos)
        still_dec = act & ~is_pre & (ctx1 < lim) & ~hit_eos
        act_pre = is_pre & last & tgt & (ctx1 < lim) & ~hit_eos
        act_c = torch.where(is_pre, act_pre, still_dec)
        toks = [torch.where(fire, nxt, -1)]
        emitted = [fire]
        tok_c, ctx_c = nxt, ctx1
        for _ in range(self._n_decode):
            lg, _ = model(tok_c[:, None], caches=self.pools, pos=ctx_c,
                          tables=(tbl, act_c))
            nx = torch.where(act_c, self._sample(lg[:, -1].float()), tok_c)
            ctx_n = ctx_c + act_c.to(torch.int32)
            still = act_c & (ctx_n < lim) & ((eos < 0) | (nx != eos))
            toks.append(torch.where(act_c, nx, -1))
            emitted.append(act_c)
            tok_c, ctx_c, act_c = nx, ctx_n, still
        self.stats["forwards"] += 1 + self._n_decode
        self._dev_tok, self._dev_ctx, self._dev_act = tok_c, ctx_c, act_c
        return torch.cat([torch.stack(toks, 1).to(torch.int32),
                          torch.stack(emitted, 1).to(torch.int32),
                          ctx_c[:, None], act_c[:, None].to(torch.int32)],
                         dim=1)

    def _dispatch_step(self):
        """Stage the step's inputs on the host, launch the step and
        update the host's bookkeeping (prompt progress is exact; decode
        activity is a prediction the harvest refines)."""
        B, C = self.num_slots, self.prefill_chunk
        inputs = np.zeros((B, C + 3), np.int32)
        for slot in range(B):
            if not self._prefilling[slot]:
                continue
            req = self.slot_req[slot]
            prm = req.prompt
            off = int(self._prefill_off[slot])
            v = min(C, len(prm) - off)
            inputs[slot, :v] = prm[off:off + v]
            inputs[slot, C] = v
            inputs[slot, C + 1] = off + v == len(prm)
            # a one-token request never decodes
            inputs[slot, C + 2] = req.max_new_tokens > 1
        n_steps = 1 + self._n_decode
        packed = self._device_step(
            torch.from_numpy(inputs).to(self.device))
        self.stats["steps"] += 1
        for slot in range(B):
            if inputs[slot, C] > 0:
                self._prefill_off[slot] += inputs[slot, C]
                if inputs[slot, C + 1]:
                    tl = self.slot_req[slot].prompt.size
                    self._prefilling[slot] = False
                    self.active[slot] = bool(inputs[slot, C + 2])
                    self._pred_ctx[slot] = min(int(self.limits[slot]),
                                               tl + self._n_decode)
            elif self.active[slot] \
                    and self.limits[slot] > self._pred_ctx[slot]:
                self._pred_ctx[slot] = min(
                    int(self.limits[slot]),
                    int(self._pred_ctx[slot]) + n_steps)
        return packed, n_steps

    def _harvest_step(self, rec):
        """Fetch the step's packed output (the one device-to-host copy)
        and apply it: append emitted tokens, refresh the ctx/active
        mirrors."""
        packed, n_steps = rec
        arr = packed.cpu().numpy()
        toks = arr[:, :n_steps]
        emitted = arr[:, n_steps:2 * n_steps].astype(bool)
        ctx_m = arr[:, 2 * n_steps]
        act_m = arr[:, 2 * n_steps + 1].astype(bool)
        for slot in range(self.num_slots):
            req = self.slot_req[slot]
            if req is None:
                continue
            self.active[slot] = act_m[slot]
            self._pred_ctx[slot] = max(int(self._pred_ctx[slot]),
                                       int(ctx_m[slot]))
            req.tokens.extend(int(t) for t in toks[slot][emitted[slot]])

    # ---- admission, pages, drain -----------------------------------------

    def _alloc_pages(self, n):
        if len(self._free_pages) < n:
            return None
        return [self._free_pages.popleft() for _ in range(n)]

    def _release_pages(self, pages):
        """Return a drained slot's pages: the slot is inactive in the
        device state, so its later writes go to the trash page."""
        self._free_pages.extend(pages)

    def _admit(self):
        """Move queued requests (FIFO) into free slots: allocate their
        pages and stage the slot as PREFILLING."""
        while self.queue:
            req = self.queue[0]
            slot = next((s for s in range(self.num_slots)
                         if self.slot_req[s] is None
                         and not self.active[s]), None)
            if slot is None:
                return
            need = -(-(req.prompt.size + req.max_new_tokens)
                     // self.page_size)
            pages = self._alloc_pages(need)
            if pages is None:
                return
            self.queue.popleft()
            self._stage_slot(slot, req, pages)

    def _stage_slot(self, slot, req, pages):
        """Bind an admitted request to a slot: block-table row, device
        state, prefill progress."""
        tl = req.prompt.size
        remaining = req.max_new_tokens
        self.slot_pages[slot] = pages
        row = np.zeros((self.pages_per_slot,), np.int32)
        row[:len(pages)] = pages
        self._dev_tbl[slot] = torch.from_numpy(row).to(self.device)
        self.slot_req[slot] = req
        self._prefilling[slot] = True
        self._prefill_off[slot] = 0
        self._pred_ctx[slot] = 0
        self._dev_ctx[slot] = 0
        # ctx counts CACHE entries; one generated token is always
        # pending outside the cache, so the n-th token lands when ctx
        # reaches tl + n - 1
        self.limits[slot] = tl + remaining - 1
        self._dev_lim[slot] = int(self.limits[slot])
        self._dev_eos[slot] = -1 if req.eos_token_id is None \
            else int(req.eos_token_id)
        self.stats["admitted"] += 1

    def _clear_slot(self, slot):
        self.slot_pages[slot] = []
        self.slot_req[slot] = None
        self._pred_ctx[slot] = 0
        self.limits[slot] = 0
        self._prefill_off[slot] = 0

    def _complete(self, req):
        req.finished = True
        eos = req.eos_token_id
        req.finish_reason = "eos" if (
            eos is not None and req.tokens
            and req.tokens[-1] == eos) else "length"
        self.completed.append(req)

    def _drain(self):
        """Finish every occupied slot that is done prefilling and no
        longer active; its pages return to the free list."""
        done = []
        for slot in range(self.num_slots):
            req = self.slot_req[slot]
            if req is None or self._prefilling[slot] or self.active[slot]:
                continue
            self._release_pages(self.slot_pages[slot])
            self._clear_slot(slot)
            self._complete(req)
            done.append(req)
        return done
