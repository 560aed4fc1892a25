"""Continuous-batching serving engine over paged KV pools.

Port of ``paddle_tpu/inference/serving.py``: ``ServedRequest`` and
``ContinuousBatchingEngine``, with its unified scheduler (the default)
and its legacy one (``unified=False``).

One batching step is a ragged mixed pass (prefilling slots stream their
next ``prefill_chunk`` prompt tokens, decoding slots ride their pending
token as a length-1 sequence, idle slots are length 0: one
``[num_slots, prefill_chunk]`` forward) followed by ``decode_chunk - 1``
decode micro-steps. The JAX engine compiles that step into one program;
here it runs eagerly on the device as a Python loop over tensors, with no
host transfer inside it: its inputs go up as one int32 tensor (the
prompt chunks, the block tables, the per-slot limits and eos ids, and
the resets that admission and eviction ask of the device state) and its
results come back as one packed int32 tensor. ``compiled_programs``
counts the distinct shapes of that step (steady state 1).

The scheduler around the step is the JAX engine's, decision for decision:

- **Pipelined loop.** ``run()`` dispatches the next step before it
  harvests the previous one, so the harvest, the drain and the admission
  of new requests overlap a step that is already on the device. On the
  card, the inputs go up from pinned host memory without blocking, and
  the packed result is copied into pinned memory right behind the
  step's kernels, with an event; the harvest waits on that event alone.
  ``step()`` is the serial turn (admit, dispatch, harvest, drain).
- **Radix prefix cache** (default on; ``prefix_cache=False`` or
  ``PADDLE_TPU_PREFIX_CACHE=0`` turns it off). A completed prefill
  publishes its full prompt pages into a radix index keyed by token
  blocks of ``page_size``; an admission whose prompt prefix is resident
  attaches those pages (refcounted, read-shared) and prefills only its
  suffix. A fully cached prompt forks its last page copy-on-write to
  recompute the last token's logits. Unreferenced cache pages are
  evicted LRU, leaf first, under allocation pressure.
- **Priorities and preemption.** Admission is FIFO until a non-zero
  priority is seen, then priority-first; a strictly higher-priority
  request evicts lower-priority occupants (recompute preemption: the
  victim requeues with its tokens and re-prefills them).
- **Deadlines and cancellation**, honoured once a scheduler turn, with
  typed errors (``reliability.py``).
- **Step-failure containment.** A failed step strikes the requests that
  rode it, quarantines a request past ``max_strikes``, rebuilds the
  device state and replays the others; a suspect re-enters alone.
  ``AssertionError`` (the audit), kernel build and launch failures and a
  spent budget escape.
- **The page audit** (``audit=True`` or ``PADDLE_TPU_SERVING_AUDIT=1``):
  free + private + cached + deferred + trash == ``num_pages`` with exact
  refcounts, after every drain, containment and cache reset. Pages of an
  evicted slot that is still active on the device wait until every step
  dispatched before the eviction has been harvested.

Quantized KV (``kv_quant="int8"|"fp8"``): each layer holds four pools,
``[k, v, k_scales, v_scales]``: int8 or ``float8_e4m3fn`` codes
``[KVH, num_pages, page, D]`` and f32 scales ``[KVH, num_pages, page]``,
one scale per (token, kv head); attention goes through K13.

Speculative decoding (``spec_k`` or ``spec_draft`` given;
``spec_decode=True`` is the JAX signature's switch and means ``spec_k=4,
spec_draft="ngram"``, the JAX engine's fallbacks when its tuner has no
entry): every step is a spec step, one ``[num_slots, prefill_chunk]``
forward in which a decoding slot rides its pending token and up to ``K``
drafts (``inference.spec_decode``: n-gram or self-speculative), verified
exactly (greedy: exact match, so the streams are the plain engine's);
no decode tail. ``run()`` drives it serially: a draft depends on the
harvested stream. Weight-only quantization: a model whose config sets
``weight_quant`` has its projections converted at construction
(``nn.quant.quantize_for_serving``).

The legacy engine (``unified=False``), the JAX engine's scheduling-parity
oracle: batched prefill waves (one ``[num_slots, prefill_chunk]``
forward over the prefilling slots; a prompt's first token is sampled on
the device where it ends and stays there) interleaved with decode chunks
(``n`` ``[num_slots, 1]`` forwards over the active slots; the chunk after
a prefill echoes its first token in the packed output). ``n`` follows
the adaptive power-of-two ladder (``adaptive_chunk``): the least
remaining budget of the active slots, rounded down to a power of two,
at most ``decode_chunk``. ``run()`` dispatches the next chunk before it
harvests the previous one and streams one prefill wave a turn;
``step()`` streams every pending wave, then one chunk. It shares the
scheduler above (prefix cache, priorities, deadlines, containment, the
audit, quantized pools, weight-only projections); speculative decoding
needs the unified engine. ``compiled_programs`` counts the JAX engine's
shapes, ``("prefill", C)`` and ``("chunk", n)`` for each ``n`` run.

Not ported yet: disaggregation and KV migration (``handoff``,
``import_migration``, ``role``), the tuner lookup of the chunk sizes and
of ``spec_k``, tracing, the flight recorder and
``request_trace_summary``.
"""

from __future__ import annotations

import heapq
import inspect
import os
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..nn.quant import quantize_for_serving
from ..ops.kernels._build import KernelError
from ..profiler.metrics import MetricsRegistry
from .reliability import (DeadlineExceeded, RequestCancelled,
                          RequestQuarantined, record_hop)
from .spec_decode import get_draft_source, verify_drafts

__all__ = ["ContinuousBatchingEngine", "ServedRequest"]

# kv_quant mode -> pool dtype (None: the model's float dtype)
_KV_QUANT = {"none": None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}

#: failures the containment boundary never absorbs: the audit, and a
#: kernel that could not be built or launched (a CUDA error is sticky,
#: so every later step would fail the same way)
_UNCONTAINABLE = (AssertionError, KernelError,
                  getattr(torch, "AcceleratorError", KernelError))

#: the JAX engine's ``_stats`` key set, plus the port's counts of model
#: forwards (one batching step is ``decode_chunk`` of them) and of the
#: self-speculative draft's layer-skipping ones
_STAT_KEYS = ("chunks", "chunk_slot_steps", "active_slot_steps",
              "tokens_emitted", "prefills", "prefills_overlapped",
              "prefill_waves", "chunks_empty", "unified_steps",
              "requests_completed", "run_seconds",
              "preempt_evictions", "preempt_pages_reclaimed",
              "preempt_recompute_tokens", "requests_cancelled",
              "deadline_ttft_expired", "deadline_total_expired",
              "quarantined", "containments", "shed_rejections",
              "prefix_cache_hits", "prefix_cache_misses",
              "prefix_cache_tokens_saved", "prefix_cache_evictions",
              "prefix_cache_cow_forks", "forwards", "draft_forwards")


def _env_bool(name, default=False):
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


class _StatsView:
    """Dict-shaped view over the engine's registry counters
    (``eng._stats["prefills"]``); the registry holds the truth."""

    __slots__ = ("_c",)

    def __init__(self, registry):
        self._c = {k: registry.counter("serving/" + k) for k in _STAT_KEYS}

    def __getitem__(self, k):
        return self._c[k].value

    def __setitem__(self, k, v):
        self._c[k].set(v)

    def inc(self, k, n=1):
        self._c[k].inc(n)

    def __iter__(self):
        return iter(self._c)

    def as_dict(self):
        return {k: c.value for k, c in self._c.items()}


class _PrefixCacheNode:
    """One cached full KV page of a token prefix: a node of the radix
    index over prompt-token blocks of ``page_size``. Two sequences reach
    the same node iff their first ``depth * page_size`` tokens are
    identical, so the page content is exact. ``ref`` counts the slots
    attached (read-sharing the page); 0 means resident and evictable.
    Every attachment references a contiguous chain from the root, so
    refcounts never grow from root to leaf and a ref-0 node's whole
    subtree is ref-0: leaf-first LRU eviction is safe."""

    __slots__ = ("key", "page", "parent", "children", "ref", "stamp")

    def __init__(self, key, page, parent):
        self.key = key          # the page's token block (bytes)
        self.page = page        # physical page id it owns
        self.parent = parent
        self.children = {}      # token-block bytes -> child node
        self.ref = 0            # attached readers (slots)
        self.stamp = 0          # LRU clock (engine _pc_clock)


class _PinnedRing:
    """Pinned host buffers for the steps that may be in flight: a step's
    inputs go up from one buffer and its packed result comes back into
    the other, behind an event recorded after the step. A pair is reused
    only once its event has completed, so the host never rewrites a
    buffer that a pending copy still reads or writes."""

    def __init__(self, n, in_shape, out_shape):
        self._bufs = [
            (torch.empty(in_shape, dtype=torch.int32, pin_memory=True),
             torch.empty(out_shape, dtype=torch.int32, pin_memory=True),
             torch.cuda.Event()) for _ in range(n)]
        self._i = 0

    def take(self):
        buf = self._bufs[self._i]
        self._i = (self._i + 1) % len(self._bufs)
        if not buf[2].query():
            buf[2].synchronize()    # an abandoned step still in flight
        return buf


@dataclass(eq=False)
class ServedRequest:
    request_id: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    eos_token_id: int | None = None
    tokens: list = field(default_factory=list)   # generated ids
    finished: bool = False
    finish_reason: str | None = None   # "eos" | "length" | "cancelled"
    #                                  # | "deadline" | "quarantined"
    # latency accounting (seconds, perf_counter clock)
    t_arrive: float = 0.0              # add_request
    t_admit: float = 0.0               # admitted into a slot
    t_prefill_done: float = 0.0        # prompt fully streamed
    t_first: float = 0.0               # first token visible host-side
    t_done: float = 0.0                # finished
    #: higher wins admission order; a strictly-higher-priority arrival
    #: may preempt running lower-priority sequences for pages or slots
    priority: int = 0
    #: seconds from arrival within which the first token must land
    ttft_deadline_s: float | None = None
    #: seconds from arrival within which the request must finish
    deadline_s: float | None = None
    #: cancellation requested; honoured at the next scheduler turn
    cancelled: bool = False
    #: typed failure (RequestCancelled / DeadlineExceeded /
    #: RequestQuarantined); None for a normal completion
    error: Exception | None = None
    #: times this request was evicted and requeued for recompute
    preemptions: int = 0
    #: failed steps this request rode; reaching the engine's
    #: ``max_strikes`` quarantines it
    strikes: int = 0
    #: lifecycle hops (admit, preempt, evict, finish, ...), bounded by
    #: ``reliability.MAX_HOPS``
    hops: list = field(default_factory=list)
    hops_dropped: int = 0
    #: SLO accounting label
    tenant: str | None = None

    def cancel(self):
        """Request cancellation. Safe from any thread; the engine honours
        it at its next scheduler turn: pages are freed and the request
        completes with ``RequestCancelled`` (tokens already emitted are
        kept)."""
        self.cancelled = True


class ContinuousBatchingEngine:
    """Schedules mixed-length generation streams through one batching
    step. Greedy, or temperature sampling from a ``torch.Generator``
    seeded by ``seed`` (reseeded with ``seed + containments`` after a
    contained step failure).

    ``model`` implements ``forward(ids, caches=, pos=, tables=) ->
    (logits, caches)`` and writes the pools in place (``models.llama``,
    ``models.qwen2``, ``models.gpt2``; a MoE model routes every row of the
    step's input, padding included, as the JAX engine's does). A model
    whose forward takes no ``tables`` (DeepSeek-V2's latent cache has no
    paged path) is refused with a ``TypeError`` when the engine is built;
    the JAX engine fails each of its requests on that ``TypeError``.
    Pools take ``num_key_value_heads`` and ``head_dim`` from the config,
    or the attention heads and ``hidden_size / heads`` where it has none
    (GPT-2). The engine runs on ``device`` (``cuda`` unless given; it
    raises with no GPU and no device), where the model's weights must
    already be. Page 0 of the pool is the reserved trash page.

    ``prompt_buckets`` is kept for the JAX engine's signature: its
    largest bucket seeds the default ``prefill_chunk``. ``admit_batch``
    bounds the prefilling slots one step carries (default all).
    ``unified=False`` runs the legacy prefill-wave/decode-chunk engine
    (module docstring), whose chunk lengths follow the power-of-two
    ladder unless ``adaptive_chunk=False`` fixes them at
    ``decode_chunk``.

    ``spec_decode`` / ``spec_k`` / ``spec_draft``: speculative decoding
    (any of them turns it on). ``spec_k`` drafts a step (default 4,
    clamped to ``prefill_chunk - 1``; ``prefill_chunk >= 2`` is
    required), ``spec_draft`` ``"ngram"`` (default), ``"self"`` or a
    ``spec_decode.DraftSource``. The port has no tuner, so knobs left
    None take the JAX engine's static fallbacks."""

    def __init__(self, model, num_slots=4, page_size=16, num_pages=None,
                 max_len=512, decode_chunk=16,
                 prompt_buckets=(32, 64, 128), eos_token_id=None,
                 greedy=True, temperature=1.0, seed=0, prefill_chunk=None,
                 admit_batch=None, adaptive_chunk=True, unified=True,
                 latency_reservoir=2048, max_strikes=2,
                 max_containments=8, audit=None, prefix_cache=None,
                 spec_decode=False, spec_k=None, spec_draft=None,
                 kv_quant="none", device=None):
        if kv_quant not in _KV_QUANT:
            raise ValueError(f"unknown kv_quant {kv_quant!r} "
                             "(expected 'none', 'int8' or 'fp8')")
        self.kv_quant = kv_quant
        self.device = resolve_device(device)
        wrong = {str(p.device) for p in model.parameters()
                 if p.device.type != self.device.type}
        if wrong:
            raise ValueError(f"the model's weights are on {sorted(wrong)}, "
                             f"the engine on {self.device}")
        if "tables" not in inspect.signature(model.forward).parameters:
            raise TypeError(
                f"{type(model).__name__} has no paged serving path (its "
                "forward takes no 'tables'), so the engine cannot serve "
                "it; decode it with model.generate()")
        self.model = model
        cfg = model.config
        self.cfg = cfg
        # weight-only serving quantization, once (a converted model, or a
        # second engine over it, is left as it is)
        if getattr(cfg, "weight_quant", None):
            quantize_for_serving(model)
        params = list(model.parameters())
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.pages_per_slot = -(-self.max_len // self.page_size)
        # default: every slot can hold max_len; +1: page 0 is the trash
        # page. Fewer pages make admission wait for free ones.
        self.num_pages = int(num_pages) if num_pages is not None else \
            self.num_slots * self.pages_per_slot + 1
        self.decode_chunk = int(decode_chunk)
        self.adaptive_chunk = bool(adaptive_chunk)
        self._unified = bool(unified)
        self._n_decode = max(0, self.decode_chunk - 1)
        self.prompt_buckets = tuple(sorted(prompt_buckets)) \
            if prompt_buckets else ()
        if prefill_chunk is None:
            prefill_chunk = self.prompt_buckets[-1] \
                if self.prompt_buckets else 32
        self.prefill_chunk = max(1, min(int(prefill_chunk), self.max_len))
        if admit_batch is None:
            admit_batch = self.num_slots
        self.admit_batch = max(1, min(int(admit_batch), self.num_slots))
        self.eos = -1 if eos_token_id is None else int(eos_token_id)
        # speculative decoding: K drafts ride a [B, prefill_chunk] step
        self._spec = bool(spec_decode) or spec_k is not None \
            or spec_draft is not None
        if self._spec and not self._unified:
            raise ValueError("speculative decoding requires the unified "
                             "batching-step engine (unified=True)")
        self._spec_k = 0
        self._spec_source = None
        if self._spec:
            if self.prefill_chunk < 2:
                raise ValueError("speculative decoding needs "
                                 "prefill_chunk >= 2 to carry a "
                                 "verification chunk")
            self._spec_k = max(1, min(int(4 if spec_k is None else spec_k),
                                      self.prefill_chunk - 1))
            self._spec_source = get_draft_source(
                "ngram" if spec_draft is None else spec_draft)
        self.greedy = bool(greedy)
        self.temperature = float(temperature)
        self._seed = int(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(
            self._seed)

        # per layer (key_pages, value_pages) and, quantized, their scales
        # pools (key_scales, value_scales), flat; written in place. The
        # geometry is kept so containment can rebuild the pools.
        dtype = next(p.dtype for p in params if p.is_floating_point())
        # MHA models (GPT-2) carry no kv-head or head-dim fields
        kvh = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
        d = getattr(cfg, "head_dim",
                    cfg.hidden_size // cfg.num_attention_heads)
        self._pool_shape = (kvh, self.num_pages, self.page_size, d)
        self._scale_shape = (kvh, self.num_pages, self.page_size)
        layer = [(self._pool_shape, _KV_QUANT[kv_quant] or dtype)] * 2
        if kv_quant != "none":
            layer += [(self._scale_shape, torch.float32)] * 2
        self._pool_layout = layer * cfg.num_hidden_layers
        self.pools = self._new_pools()
        self._free_pages = deque(range(1, self.num_pages))

        # host-side slot bookkeeping (admission decisions, drain)
        B, MP = self.num_slots, self.pages_per_slot
        self.tables = np.zeros((B, MP), np.int32)
        self.active = np.zeros((B,), bool)        # mirror (packed fetch)
        self.limits = np.zeros((B,), np.int32)    # ctx budget per slot
        self.slot_eos = np.full((B,), -1, np.int32)  # per-request eos
        self.slot_req: list[ServedRequest | None] = [None] * B
        self.slot_pages: list[list] = [[] for _ in range(B)]
        # the ADMISSION prompt per slot: the prompt plus, for a preempted
        # request re-admitted for recompute, every token it had already
        # generated (chunked prefill is token-identical to the decode it
        # replays, so the stream continues where the eviction cut it)
        self._slot_prompt: list[np.ndarray | None] = [None] * B
        # a slot whose prompt is still streaming is PREFILLING: inactive
        # for decode, not drainable
        self._prefilling = np.zeros((B,), bool)
        self._prefill_off = np.zeros((B,), np.int32)   # tokens dispatched
        self._act_target = np.zeros((B,), bool)  # decode after the prompt
        # host prediction of the device ctx (exact for length-limited
        # slots; an eos stop only makes it an overestimate)
        self._pred_ctx = np.zeros((B,), np.int32)
        # device resets the next step applies (admission: ctx = the
        # cached prefix, inactive; eviction: ctx 0, inactive), so
        # admission and eviction never touch the device themselves
        self._reset = np.zeros((B,), bool)
        self._reset_ctx = np.zeros((B,), np.int32)
        # monotone dispatch counter and per-slot activation seq: a step
        # dispatched BEFORE a slot's final prefill chunk has a stale
        # view of that slot, so its mirrors must not be applied
        self._seq = 0
        self._act_since = np.zeros((B,), np.int64)
        # per slot: dispatched-but-unharvested steps that may emit
        # tokens for it; the drain defers while any are in flight
        self._emits_inflight = np.zeros((B,), np.int32)
        # legacy: slots whose prefill wave sampled a first token the host
        # has not seen yet (the next chunk echoes it), and slots whose
        # echo rides a dispatched, unharvested chunk (no drain until then)
        self._pending_first = np.zeros((B,), bool)
        self._echo_inflight = np.zeros((B,), bool)

        # device-resident slot state, chained from step to step
        self._dev_tok, self._dev_ctx, self._dev_act = self._new_dev_state()
        # the step's input row: C prompt ids, nq, last, tgt, MP table
        # entries, limit, eos, reset, reset ctx, and under spec the draft
        # count. The packed output: n_steps tokens and emitted flags,
        # ctx, active, and under spec the committed and drafted counts.
        # The legacy chunk's output: n tokens and emitted flags, the
        # echoed first token, ctx and active.
        self._in_width = self.prefill_chunk + 3 + MP + 4 + int(self._spec)
        if self._spec:
            out_width = 2 * (1 + self._spec_k) + 4
        elif self._unified:
            out_width = 2 * (1 + self._n_decode) + 2
        else:
            out_width = 2 * self.decode_chunk + 3
        # in flight at once: two steps (unified), or two chunks and the
        # prefill wave between them (legacy)
        self._ring = _PinnedRing(2 if self._unified else 3,
                                 (B, self._in_width), (B, out_width)) \
            if self.device.type == "cuda" else None

        self.queue: deque[ServedRequest] = deque()
        self.completed: list[ServedRequest] = []
        self._next_id = 0
        # ---- reliability state ---------------------------------------
        # pages reclaimed from an EVICTED (still device-active) slot wait
        # until every step dispatched before the eviction is harvested:
        # an in-flight step still writes the old owner's kv through its
        # dispatch-time block table. (gate_seq, pages) entries.
        self._deferred_free: list[tuple[int, list]] = []
        self._last_fetch_dispatch_seq = 0   # newest dispatched seq
        self._last_harvest_seq = 0          # newest harvested seq
        # admission is plain FIFO until a non-zero priority is seen
        self._has_priorities = False
        # the per-turn reap sweeps the queue once lifecycle control (a
        # deadline or an engine-level cancel) is in play, and every 32nd
        # turn (a direct handle cancel() of a queued request)
        self._lifecycle_seen = False
        self._reap_turn = 0
        # completions made outside the drain (already-complete replays
        # adopted at admission), handed out by the next drain
        self._done_pending: list[ServedRequest] = []
        # containment: blame threshold and a budget per run() (a bare
        # step() loop spends it until the next run())
        self.max_strikes = int(max_strikes)
        self.max_containments = int(max_containments)
        self._containments_run = 0
        self._audit = _env_bool("PADDLE_TPU_SERVING_AUDIT") \
            if audit is None else bool(audit)
        # ---- prefix cache --------------------------------------------
        self._prefix_cache = _env_bool("PADDLE_TPU_PREFIX_CACHE", True) \
            if prefix_cache is None else bool(prefix_cache)
        self._pc_root = _PrefixCacheNode(None, 0, None)   # sentinel
        self._pc_nodes: dict[int, _PrefixCacheNode] = {}  # page -> node
        self._pc_clock = 0                                # LRU stamps
        #: per-slot attached cache nodes, in table-row order: the
        #: slot's block table is [shared pages..., private pages...]
        self.slot_shared: list[list] = [[] for _ in range(B)]
        self._compiled = set()         # distinct batching-step shapes

        # observability: a private registry behind gauges()
        self.metrics = MetricsRegistry()
        self._stats = _StatsView(self.metrics)
        self._h_ttft = self.metrics.histogram(
            "serving/ttft_ms", capacity=int(latency_reservoir))
        self._h_itl = self.metrics.histogram(
            "serving/itl_ms", capacity=int(latency_reservoir))
        self._c_spec_steps = self.metrics.counter("spec/steps")
        self._c_spec_drafted = self.metrics.counter("spec/tokens_drafted")
        self._c_spec_accepted = self.metrics.counter(
            "spec/tokens_accepted")
        self._c_spec_rejected = self.metrics.counter(
            "spec/tokens_rejected")
        # seconds spent inside instrumentation (obs_overhead_frac)
        self._obs_s = 0.0
        self._overlap_admission = False

    def _new_pools(self):
        return [torch.zeros(shape, dtype=dt, device=self.device)
                for shape, dt in self._pool_layout]

    def _new_dev_state(self):
        B = self.num_slots
        return (torch.zeros((B,), dtype=torch.int32, device=self.device),
                torch.zeros((B,), dtype=torch.int32, device=self.device),
                torch.zeros((B,), dtype=torch.bool, device=self.device))

    # ---- public API ------------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens, eos_token_id=None,
                    priority=0, ttft_deadline_s=None, deadline_s=None,
                    tenant=None) -> int:
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        self._check_fits(prompt.size, int(max_new_tokens))
        req = ServedRequest(self._next_id, prompt, int(max_new_tokens),
                            eos_token_id if eos_token_id is not None
                            else (self.eos if self.eos >= 0 else None),
                            priority=int(priority),
                            ttft_deadline_s=ttft_deadline_s,
                            deadline_s=deadline_s, tenant=tenant)
        req.t_arrive = time.perf_counter()
        self._next_id += 1
        if req.priority:
            self._has_priorities = True
        if ttft_deadline_s is not None or deadline_s is not None:
            self._lifecycle_seen = True
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

    def _queue_snapshot(self):
        """Copy the queue for a lookup from another thread: ``list`` of
        a deque being mutated raises, so retry."""
        while True:
            try:
                return list(self.queue)
            except RuntimeError:
                continue

    def request(self, request_id) -> ServedRequest | None:
        """The live handle for an id: queued, running or completed."""
        for req in self._queue_snapshot():
            if req is not None and req.request_id == request_id:
                return req
        for req in list(self.slot_req):
            if req is not None and req.request_id == request_id:
                return req
        for req in list(self.completed):
            if req.request_id == request_id:
                return req
        return None

    def cancel(self, request_id) -> bool:
        """Cancel a queued or running request: takes effect at the next
        scheduler turn (pages freed mid-prefill or mid-decode,
        ``RequestCancelled``, tokens already emitted kept). False for an
        unknown or already-finished request."""
        for req in self._queue_snapshot() + list(self.slot_req):
            if req is not None and req.request_id == request_id:
                if req.finished:
                    return False
                req.cancel()
                self._lifecycle_seen = True
                return True
        return False

    def requeue(self, req: ServedRequest):
        """Adopt a request salvaged from a torn-down engine: the prompt
        plus every token already delivered re-prefills through the
        recompute path, so the stream continues where the dead engine
        left it. A request that already holds its full stream completes
        at the next admission."""
        if req.finished:
            self.completed.append(req)
            return
        self._check_fits(req.prompt.size, req.max_new_tokens)
        self._next_id = max(self._next_id, req.request_id + 1)
        if req.priority:
            self._has_priorities = True
        if req.ttft_deadline_s is not None \
                or req.deadline_s is not None or req.cancelled:
            self._lifecycle_seen = True
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any()) \
            or bool(self._prefilling.any())

    def step(self):
        """Admit what fits, advance every slot one scheduler turn (one
        batching step if it advances anything; legacy: every pending
        prefill wave, then one decode chunk if a slot is active), drain
        finished slots. Returns the requests completed here. A step
        failure hits the containment boundary of :meth:`run`."""
        self._admit()
        try:
            if not self._unified:
                self._pump_prefill()
                if self.active.any():
                    self._decode_chunk()
            elif self._worth_step():
                self._harvest_step(self._dispatch_spec_step()
                                   if self._spec else self._dispatch_step())
        except Exception as exc:  # noqa: BLE001 — containment boundary
            if not self._containable(exc):
                raise
            return self._contain_step_failure(exc) + self._drain()
        return self._drain()

    def run(self):
        """Drive until every queued request completes; returns them in
        completion order.

        Pipelined: the next step is dispatched before the previous one's
        packed output is fetched; the device state chains through the
        stream, so the harvest, the drain and the admissions run while
        the successor computes. A slot that finished inside the previous
        step is already inactive in the successor. The successor is
        skipped when no slot is prefilling and every active slot's
        predicted budget is spent.

        Under speculative decoding the same loop runs serially (each
        step harvested before the next is drafted): drafts are made from
        the harvested stream and the device state after it, so a
        pipelined successor would draft from a stale stream.

        The legacy engine runs the same loop with its own hooks: the
        successor is a decode chunk (skipped when no active slot has
        budget left), and one prefill wave is streamed after each turn's
        admissions, so prompts interleave with decode chunks."""
        if not self._unified:
            return self._run_driver(
                spec_dispatch=lambda: self._dispatch_chunk()
                if self._worth_dispatching() else None,
                harvest=self._harvest_chunk,
                after_admit=lambda: self._pump_prefill(max_waves=1),
                idle_turn=self._idle_turn_legacy)
        if self._spec:
            return self._run_driver(spec_dispatch=lambda: None,
                                    harvest=self._harvest_step,
                                    after_admit=lambda: None,
                                    idle_turn=self._idle_turn_spec)
        return self._run_driver(
            spec_dispatch=lambda: self._dispatch_step()
            if self._worth_step() else None,
            harvest=self._harvest_step, after_admit=lambda: None,
            idle_turn=self._idle_turn_unified)

    def _idle_turn_unified(self):
        """Nothing in flight: dispatch a step if it would advance
        anything. Returns (progressed, in-flight record or None)."""
        if self._worth_step():
            return True, self._dispatch_step()
        return False, None

    def _idle_turn_spec(self):
        """Nothing in flight: draft and dispatch one spec step if it would
        advance anything (harvested at the next turn, with no successor
        dispatched before it)."""
        if self._worth_step():
            return True, self._dispatch_spec_step()
        return False, None

    def _idle_turn_legacy(self):
        """Nothing in flight: stream one prefill wave if prompts are
        pending, else dispatch a decode chunk if a slot is active."""
        if self._prefilling.any():
            self._pump_prefill(max_waves=1)
            return True, None
        if self.active.any():
            return True, self._dispatch_chunk()
        return False, None

    def _run_driver(self, spec_dispatch, harvest, after_admit, idle_turn):
        """The scheduler loop every mode shares, with its hooks: the
        successor dispatched before a harvest (``spec_dispatch``, None
        when it would advance nothing), the ``harvest`` of an in-flight
        record, the dispatches after a turn's admissions
        (``after_admit``: the legacy prefill wave) and the turn with
        nothing in flight (``idle_turn`` -> (progressed, in-flight
        record)). Every dispatch and harvest runs inside the containment
        boundary (admission, drain and reap do not: a host scheduler bug
        is not a per-request fault). Overload never stalls: a turn
        without progress while requests wait evicts the youngest,
        lowest-priority occupant for recompute; the stall
        ``RuntimeError`` is left for a pool exhausted with no occupant
        to evict (a leak)."""
        done = []
        inflight = None
        deadlock_evictions = 0
        max_deadlock = max(8, 2 * self.num_slots)
        self._containments_run = 0      # the budget is per run

        def contained(exc, cohort=None):
            """The completions of a contained failure, or None when it
            must escape. ``cohort``: the failed step's dispatch-time
            request snapshot, for the blame."""
            if not self._containable(exc):
                return None
            return self._contain_step_failure(exc, cohort=cohort)

        t_run0 = time.perf_counter()
        try:
            while True:
                if inflight is not None:
                    # the successor first: the device never idles while
                    # the host harvests, drains and admits
                    try:
                        nxt = spec_dispatch()
                    except Exception as exc:  # noqa: BLE001
                        extra = contained(exc)
                        if extra is None:
                            raise
                        inflight = None
                        done.extend(extra)
                        continue
                    try:
                        harvest(inflight)
                    except Exception as exc:  # noqa: BLE001
                        # blame the harvested step's dispatch-time cohort
                        extra = contained(exc, cohort=inflight[1])
                        if extra is None:
                            raise
                        inflight = None
                        done.extend(extra)
                        continue
                    done.extend(self._drain())
                    # admissions overlap nxt's run on the device
                    self._overlap_admission = nxt is not None
                    try:
                        self._admit()
                        try:
                            # a legacy prefill wave is a dispatch: nxt is
                            # abandoned with the rest of the device state
                            after_admit()
                        except Exception as exc:  # noqa: BLE001
                            extra = contained(exc)
                            if extra is None:
                                raise
                            nxt = None
                            done.extend(extra)
                    finally:
                        self._overlap_admission = False
                    inflight = nxt
                    continue
                n_before = len(done)
                self._admit()
                done.extend(self._drain())
                try:
                    progressed, inflight = idle_turn()
                except Exception as exc:  # noqa: BLE001
                    extra = contained(exc)
                    if extra is None:
                        raise
                    inflight = None
                    done.extend(extra)
                    continue
                if progressed or len(done) > n_before:
                    # the cap bounds CONSECUTIVE fruitless evictions
                    deadlock_evictions = 0
                    continue
                if not self.queue:
                    break
                # nothing dispatched, harvested, drained or admitted but
                # requests wait: something undrainable holds the pool
                occupied = [s for s in range(self.num_slots)
                            if self.slot_req[s] is not None]
                if occupied and deadlock_evictions < max_deadlock:
                    victim = min(occupied, key=lambda s: (
                        self.slot_req[s].priority,
                        -self.slot_req[s].t_admit))
                    deadlock_evictions += 1
                    self._evict_slot(victim, requeue=True,
                                     reason="deadlock")
                    continue
                raise RuntimeError(
                    f"serving engine stalled: queued request cannot be "
                    f"admitted (page pool exhausted?): {len(self.queue)} "
                    f"queued, {len(self._free_pages)} free pages, "
                    f"{len(occupied)} occupied slots")
        finally:
            self._stats["run_seconds"] += time.perf_counter() - t_run0
        return done

    # ---- step-failure containment ----------------------------------------

    def _containable(self, exc):
        """Is this step failure containable? Not the audit's
        ``AssertionError``, not a kernel that failed to build or launch,
        and not past the per-run budget (the failure then escapes to the
        ``EngineSupervisor``)."""
        if isinstance(exc, _UNCONTAINABLE):
            return False
        return self._containments_run < self.max_containments

    def _contain_step_failure(self, exc, cohort=None):
        """One failed step must not kill every stream. Every occupied
        slot's request (only ``cohort``'s, when the caller knows the
        failed step's riders) gets a strike; at ``max_strikes`` it is
        quarantined with a typed error, the others requeue for
        recompute replay in arrival order (suspects re-enter alone).
        The device state ran through the failed step, so it is rebuilt.
        Returns the requests completed (quarantined) here."""
        self._containments_run += 1
        self._stats.inc("containments")
        blame = None if cohort is None else \
            {id(r) for r in cohort if r is not None}
        requeue, quarantine = [], []
        for slot in range(self.num_slots):
            req = self.slot_req[slot]
            if req is None or req.finished:
                continue
            if blame is None or id(req) in blame:
                req.strikes += 1
            (quarantine if req.strikes >= self.max_strikes
             else requeue).append(req)
        self._reset_device_state()
        done = []
        for req in requeue:
            req.preemptions += 1
        requeue.sort(key=lambda r: (r.t_arrive, r.request_id))
        self.queue.extendleft(reversed(requeue))
        for req in quarantine:
            done.append(self._finish_error(
                req, RequestQuarantined(req.request_id, repr(exc))))
        self._audit_pages("containment")
        return done

    def _reset_device_state(self):
        """Rebuild the pools, the free list and all per-slot state. The
        old pools are dropped before the new ones are allocated (two sets
        at once may not fit); the allocator reuses memory in stream
        order, so writes still in flight from an abandoned step land
        before any reuse."""
        B = self.num_slots
        self.pools = []
        self.pools = self._new_pools()
        self._free_pages = deque(range(1, self.num_pages))
        self._deferred_free = []
        self.tables[:] = 0
        self.active[:] = False
        self.limits[:] = 0
        self.slot_eos[:] = -1
        self.slot_req = [None] * B
        self.slot_pages = [[] for _ in range(B)]
        # the rebuilt pools are zeroed: drop the whole radix index (its
        # pages are back in the rebuilt free list)
        self.slot_shared = [[] for _ in range(B)]
        self._pc_root = _PrefixCacheNode(None, 0, None)
        self._pc_nodes = {}
        self._slot_prompt = [None] * B
        self._prefilling[:] = False
        self._prefill_off[:] = 0
        self._act_target[:] = False
        self._pred_ctx[:] = 0
        self._reset[:] = False
        self._reset_ctx[:] = 0
        self._act_since[:] = 0
        self._emits_inflight[:] = 0
        self._pending_first[:] = False
        self._echo_inflight[:] = False
        self._dev_tok, self._dev_ctx, self._dev_act = self._new_dev_state()
        # the generator chained through the failed step (greedy streams
        # do not depend on it)
        self._gen = torch.Generator(device=self.device).manual_seed(
            self._seed + self._containments_run)
        self._last_fetch_dispatch_seq = self._seq
        self._last_harvest_seq = self._seq

    # ---- the batching step -----------------------------------------------

    def _worth_step(self):
        """Would a step advance anything? Prefilling slots always do;
        decode slots while the host's ctx prediction leaves budget (an
        eos stop the host cannot see may still give an empty step,
        counted in ``chunks_empty``)."""
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
        """The batching step, on the device. ``inputs`` [B, _in_width]
        int32 holds per slot the prompt tokens streamed, their count
        (nq), whether the prompt completes (last), whether the slot
        decodes afterwards (tgt), its block-table row, ctx limit and eos
        id, and a reset (with the ctx to reset to) that admission or
        eviction asked for. Returns the packed [B, 2 * n + 2] int32
        output: emitted tokens, emitted flags, final ctx, final
        active."""
        ids, nq, last, tgt, tbl, lim, eos, ctx, act, _ = \
            self._step_inputs(inputs)
        tok = self._dev_tok
        is_pre = nq > 0
        lengths = torch.where(is_pre, nq, act.to(torch.int32))
        _, sampled, ctx1, hit_eos, act_pre = self._ragged_pass(
            ids, is_pre, last, tgt, tbl, lim, eos, ctx, lengths)
        # a next token fires for completing prompts and advancing decodes
        fire = (is_pre & last) | (act & ~is_pre)
        nxt = torch.where(fire, sampled, tok)
        still_dec = act & ~is_pre & (ctx1 < lim) & ~hit_eos
        act_c = torch.where(is_pre, act_pre, still_dec)
        toks, emitted, tok_c, ctx_c, act_c = self._decode_steps(
            nxt, ctx1, act_c, tbl, lim, eos, self._n_decode)
        self._stats.inc("forwards", 1 + self._n_decode)
        self._dev_tok, self._dev_ctx, self._dev_act = tok_c, ctx_c, act_c
        return torch.cat([torch.stack([torch.where(fire, nxt, -1)] + toks,
                                      1).to(torch.int32),
                          torch.stack([fire] + emitted, 1).to(torch.int32),
                          ctx_c[:, None], act_c[:, None].to(torch.int32)],
                         dim=1)

    def _decode_steps(self, tok, ctx, act, tbl, lim, eos, n):
        """``n`` decode micro-steps, one ``[num_slots, 1]`` forward each:
        an active slot feeds its pending token, samples the next and
        stops at its ctx limit or its eos. Returns (tokens a step, -1
        where inactive; emitted flags a step; the final token, ctx and
        active)."""
        toks, emitted = [], []
        for _ in range(n):
            lg, _ = self.model(tok[:, None], caches=self.pools, pos=ctx,
                               tables=(tbl, act))
            nx = torch.where(act, self._sample(lg[:, -1].float()), tok)
            ctx_n = ctx + act.to(torch.int32)
            still = act & (ctx_n < lim) & ((eos < 0) | (nx != eos))
            toks.append(torch.where(act, nx, -1))
            emitted.append(act)
            tok, ctx, act = nx, ctx_n, still
        return toks, emitted, tok, ctx, act

    @torch.no_grad()
    def _device_prefill(self, inputs):
        """A legacy prefill wave, on the device: one ``[num_slots,
        prefill_chunk]`` forward over the prompt tokens staged in
        ``inputs`` (the step's rows; slots with none are length 0),
        written into the pools at each slot's ctx; where a prompt ends,
        its first token is sampled at its last row and stays on the
        device, and the slot turns active if it decodes afterwards. No
        output."""
        C, B = self.prefill_chunk, self.num_slots
        ids, nq, last, tgt, tbl, _, _, ctx, act, _ = \
            self._step_inputs(inputs)
        nq = nq.contiguous()          # a column of the inputs
        logits, _ = self.model(ids, caches=self.pools, pos=ctx,
                               tables=(tbl, nq))
        idx = (nq - 1).clamp(0, C - 1).long()
        sampled = self._sample(
            logits[torch.arange(B, device=ids.device), idx].float())
        fire = last & (nq > 0)
        self._stats.inc("forwards")
        self._dev_tok = torch.where(fire, sampled, self._dev_tok)
        self._dev_ctx = ctx + nq
        self._dev_act = torch.where(fire, tgt, act)

    @torch.no_grad()
    def _device_chunk(self, inputs, n):
        """A legacy decode chunk, on the device: ``n`` micro-steps over
        the active slots (:meth:`_decode_steps`). A slot whose prefill's
        first token is already its eos does not decode. Returns the
        packed [B, 2n + 3] int32: tokens, emitted flags, the token each
        slot held on entry (the first-token echo), final ctx and
        active."""
        _, _, _, _, tbl, lim, eos, ctx, act, _ = self._step_inputs(inputs)
        first = self._dev_tok
        toks, emitted, tok, ctx, act = self._decode_steps(
            first, ctx, act, tbl, lim, eos, n)
        self._stats.inc("forwards", n)
        self._dev_tok, self._dev_ctx, self._dev_act = tok, ctx, act
        return torch.cat([torch.stack(toks, 1).to(torch.int32),
                          torch.stack(emitted, 1).to(torch.int32),
                          first[:, None], ctx[:, None],
                          act[:, None].to(torch.int32)], dim=1)

    def _step_inputs(self, inputs):
        """Unpack a step's input rows on the device: ids [B, C], nq, last,
        tgt, the block-table rows, limits, eos ids, the ctx after the
        resets, the active flags after the resets and the stale
        instant-eos guard, and the columns past those (the spec step's
        draft counts)."""
        C, MP = self.prefill_chunk, self.pages_per_slot
        tbl = inputs[:, C + 3:C + 3 + MP].contiguous()
        lim, eos, reset, ctx0 = inputs[:, C + 3 + MP:C + 7 + MP].unbind(1)
        reset = reset.bool()
        ctx = torch.where(reset, ctx0, self._dev_ctx)
        act = self._dev_act & ~reset & ((eos < 0) | (self._dev_tok != eos))
        return (inputs[:, :C], inputs[:, C], inputs[:, C + 1].bool(),
                inputs[:, C + 2].bool(), tbl, lim, eos, ctx, act,
                inputs[:, C + 7 + MP:])

    def _ragged_pass(self, ids, is_pre, last, tgt, tbl, lim, eos, ctx,
                     lengths):
        """The first forward of both steps: the ragged pass over
        ``lengths`` rows a slot (decode slots carry their device-resident
        pending token in stream column 0), the sample at each slot's last
        row, and what it means for a completing prompt. Returns (logits,
        sampled, ctx + lengths, whether the sample is the slot's eos, the
        activation of completing prompts)."""
        C, B = self.prefill_chunk, self.num_slots
        ids[:, 0] = torch.where(is_pre, ids[:, 0], self._dev_tok)
        logits, _ = self.model(ids, caches=self.pools, pos=ctx,
                               tables=(tbl, lengths))
        idx = (lengths - 1).clamp(0, C - 1).long()
        sampled = self._sample(
            logits[torch.arange(B, device=ids.device), idx].float())
        ctx1 = ctx + lengths
        hit_eos = (eos >= 0) & (sampled == eos)
        act_pre = is_pre & last & tgt & (ctx1 < lim) & ~hit_eos
        return logits, sampled, ctx1, hit_eos, act_pre

    @torch.no_grad()
    def _device_spec_step(self, inputs):
        """The speculative batching step, on the device: the plain step's
        ragged pass (same inputs, plus each slot's draft count nd in the
        last column), where a decoding slot rides its pending token and
        its drafts as ``1 + nd`` rows, and no decode tail. The drafts are
        verified (``spec_decode.verify_drafts``); a slot emits its
        accepted drafts and the token after them, trimmed by its ctx
        budget and by an eos inside the chunk (the eos itself is
        emitted). Accepting commits by advancing ctx over KV already
        written; rejected rows stay behind ctx. Returns the packed [B,
        2(K+1) + 4] int32: tokens, emitted flags, ctx, active, committed
        drafts, drafted count."""
        K = self._spec_k
        ids, nq, last, tgt, tbl, lim, eos, ctx, act, nd = \
            self._step_inputs(inputs)
        nd = nd[:, 0]
        tok = self._dev_tok
        is_pre = nq > 0
        dec = act & ~is_pre
        # drafts were clamped against the host's view: re-gate on the
        # device's (the eos guard may have retired the slot)
        nd = torch.where(dec, nd, 0)
        lengths = torch.where(is_pre, nq, torch.where(dec, 1 + nd, 0))
        drafts = ids[:, 1:K + 1].clone()
        # a completing prompt's first token is the sample at its last row
        logits, sampled, ctx1, _, act_pre = self._ragged_pass(
            ids, is_pre, last, tgt, tbl, lim, eos, ctx, lengths)
        n_acc, fin = verify_drafts(logits[:, :K + 1].float(), drafts, nd,
                                   self.greedy, self.temperature, self._gen)
        n_acc, fin = n_acc.to(torch.int32), fin.to(torch.int32)
        # the emission ladder: accepted drafts, then the target's token
        jk = torch.arange(K + 1, device=ids.device)[None, :]
        e = torch.where(jk < n_acc[:, None],
                        torch.nn.functional.pad(drafts, (0, 1)),
                        fin[:, None])
        hit = ((eos[:, None] >= 0) & (e == eos[:, None])).to(torch.int32)
        alive = (jk <= n_acc[:, None]) & (ctx[:, None] + jk < lim[:, None]) \
            & (torch.cumsum(hit, 1) - hit == 0) & dec[:, None]
        n_emit = alive.sum(1, dtype=torch.int32)
        ctx_dec = ctx + n_emit
        last_e = e.gather(1, (n_emit - 1).clamp(0, K).long()[:, None])[:, 0]
        still_dec = dec & (n_emit > 0) & (ctx_dec < lim) \
            & ((eos < 0) | (last_e != eos))
        fire_pre = is_pre & last
        toks = torch.where(dec[:, None], e, -1)
        toks[:, 0] = torch.where(fire_pre, sampled, toks[:, 0])
        emitted = alive.clone()
        emitted[:, 0] |= fire_pre
        tok_f = torch.where(dec, torch.where(n_emit > 0, last_e, tok),
                            torch.where(fire_pre, sampled, tok))
        ctx_f = torch.where(dec, ctx_dec, ctx1)
        act_f = torch.where(is_pre, act_pre,
                            torch.where(dec, still_dec, act))
        committed = torch.where(
            dec, torch.minimum(n_acc, (n_emit - 1).clamp(min=0)), 0)
        self._stats.inc("forwards")
        self._dev_tok, self._dev_ctx, self._dev_act = tok_f, ctx_f, act_f
        return torch.cat([toks.to(torch.int32), emitted.to(torch.int32),
                          ctx_f[:, None], act_f[:, None].to(torch.int32),
                          committed[:, None].to(torch.int32),
                          nd[:, None]], dim=1)

    def _launch(self, inputs, device_step):
        """Run ``device_step`` on ``inputs`` (host int32). On the card:
        the inputs go up from a pinned buffer without blocking and the
        packed output comes back into a pinned buffer behind the step's
        kernels; returns (pinned output, event). On the CPU: the packed
        tensor itself. A step without output (the legacy prefill wave)
        returns None; its event still guards its input buffer."""
        if self._ring is None:
            return device_step(torch.from_numpy(inputs))
        pin_in, pin_out, event = self._ring.take()
        pin_in.numpy()[...] = inputs
        packed = device_step(pin_in.to(self.device, non_blocking=True))
        if packed is None:
            event.record()
            return None
        # the first rows * width elements: a contiguous view, whatever
        # the width (the legacy chunk's follows its length)
        out = pin_out.view(-1)[:packed.numel()].view(packed.shape)
        out.copy_(packed, non_blocking=True)
        event.record()
        return out, event

    @staticmethod
    def _fetch(handle):
        """The packed output of a launched step, on the host; on the
        card this waits on the step's event alone."""
        if isinstance(handle, torch.Tensor):
            return handle.numpy()
        pin_out, event = handle
        event.synchronize()
        return pin_out.numpy().copy()

    def _dispatch_step(self):
        """Stage the step's inputs, launch it (not waiting for it) and
        update the host's bookkeeping (prompt progress is exact; decode
        activity is a prediction the harvest refines). Returns the
        in-flight record for :meth:`_harvest_step`."""
        inputs, n_pre = self._stage_inputs()
        n_steps = 1 + self._n_decode
        self._compiled.add(("unified", self.prefill_chunk, n_steps))
        self._count_dispatch(inputs, n_pre, n_steps)
        packed = self._launch(inputs, self._device_step)
        return self._book_dispatch(packed, inputs, n_steps, self._n_decode)

    def _dispatch_spec_step(self):
        """Launch one speculative step: prompt chunks as in
        :meth:`_dispatch_step`; every decoding slot with budget asks the
        draft source for up to K tokens, clamped to ``limit - ctx - 1``
        so every verify write stays inside its row. The host's ctx
        (``_pred_ctx``) is exact here: the spec loop harvests each step
        before drafting the next."""
        B, C, K = self.num_slots, self.prefill_chunk, self._spec_k
        inputs, n_pre = self._stage_inputs()
        drafting = [s for s in range(B)
                    if self.active[s] and not self._prefilling[s]
                    and self.slot_req[s] is not None
                    and int(self.limits[s]) - int(self._pred_ctx[s]) > 1]
        if drafting:
            drafts, counts = self._spec_source.propose(self, drafting, K)
            for s in drafting:
                c = min(int(counts[s]), K,
                        int(self.limits[s]) - int(self._pred_ctx[s]) - 1)
                if c > 0:
                    inputs[s, 1:1 + c] = drafts[s, :c]
                    inputs[s, -1] = c
        self._compiled.add(("spec", C, 1 + K))
        self._count_dispatch(inputs, n_pre, 1 + K)
        self._c_spec_steps.inc()
        packed = self._launch(inputs, self._device_spec_step)
        # no decode tail: a completing prompt lands its first token only
        return self._book_dispatch(packed, inputs, 1 + K, 0)

    def _stage_inputs(self, prompts=True):
        """The step's input rows on the host: the next prompt chunk of up
        to ``admit_batch`` prefilling slots (none when not ``prompts``:
        a legacy decode chunk), the block tables, limits, eos ids and the
        pending device resets (consumed here). Returns (inputs,
        prefilling slots staged)."""
        B, C, MP = self.num_slots, self.prefill_chunk, self.pages_per_slot
        inputs = np.zeros((B, self._in_width), np.int32)
        n_pre = 0
        for slot in range(B):
            if not prompts or not self._prefilling[slot] \
                    or n_pre >= self.admit_batch:
                continue
            prm = self._slot_prompt[slot]
            off = int(self._prefill_off[slot])
            v = min(C, len(prm) - off)
            inputs[slot, :v] = prm[off:off + v]
            inputs[slot, C] = v
            inputs[slot, C + 1] = off + v == len(prm)
            inputs[slot, C + 2] = self._act_target[slot]
            n_pre += 1
        inputs[:, C + 3:C + 3 + MP] = self.tables
        inputs[:, C + 3 + MP] = self.limits
        inputs[:, C + 4 + MP] = self.slot_eos
        inputs[:, C + 5 + MP] = self._reset
        inputs[:, C + 6 + MP] = self._reset_ctx
        self._reset[:] = False
        return inputs, n_pre

    def _count_dispatch(self, inputs, n_pre, n_steps):
        """Advance the dispatch sequence and count the step."""
        nq = inputs[:, self.prefill_chunk]
        B = self.num_slots
        self._seq += 1
        self._last_fetch_dispatch_seq = self._seq
        # a slot advances this step if it decodes with budget left or
        # streams prompt tokens
        n_active = int(np.sum((self.active
                               & (self.limits > self._pred_ctx))
                              | (nq > 0)))
        _t_obs = time.perf_counter()
        self._stats.inc("chunks")
        self._stats.inc("unified_steps")
        self._stats.inc("chunk_slot_steps", B * n_steps)
        if n_pre:
            self._stats.inc("prefill_waves")
        self._stats.inc("active_slot_steps", n_active * n_steps)
        self._obs_s += time.perf_counter() - _t_obs

    def _book_dispatch(self, packed, inputs, n_steps, tail):
        """The host's bookkeeping after a launch: prompt progress, the
        activation of completing prompts (their first token and ``tail``
        decode micro-steps land in this step) and the ctx prediction of
        decoding slots (``tail + 1`` more). Returns the in-flight
        record."""
        B, C = self.num_slots, self.prefill_chunk
        nq = inputs[:, C]
        last = inputs[:, C + 1].astype(bool)
        tgt = inputs[:, C + 2].astype(bool)
        emits = np.zeros((B,), bool)
        for slot in range(B):
            if nq[slot] > 0:
                self._prefill_off[slot] += nq[slot]
                if last[slot]:
                    req = self.slot_req[slot]
                    tl = len(self._slot_prompt[slot])
                    req.t_prefill_done = time.perf_counter()
                    self._prefilling[slot] = False
                    # the first token and the decode tail land in THIS
                    # step; mirrors of an earlier in-flight step must
                    # not clobber the activation
                    self.active[slot] = bool(tgt[slot])
                    self._act_since[slot] = self._seq
                    self._pred_ctx[slot] = min(
                        int(self.limits[slot]), tl + tail)
                    # the prompt's full pages are final now (decode
                    # writes land past tl): publish them for sharing
                    self._pc_insert(slot)
                    emits[slot] = True
            elif self.active[slot] \
                    and self.limits[slot] > self._pred_ctx[slot]:
                self._pred_ctx[slot] = min(
                    int(self.limits[slot]),
                    int(self._pred_ctx[slot]) + tail + 1)
                emits[slot] = True
        self._emits_inflight += emits.astype(np.int32)
        return (packed, list(self.slot_req), emits, n_steps, self._seq)

    def _harvest_step(self, rec):
        """Fetch one in-flight step's packed output and apply it: append
        emitted tokens, refresh the ctx/active mirrors (unless the slot
        was re-admitted, or activated by a later dispatch, since this
        step went out)."""
        packed, snap_req, emits, n_steps, seq = rec
        arr = self._fetch(packed)
        self._last_harvest_seq = max(self._last_harvest_seq, seq)
        self._release_deferred()
        toks_np = arr[:, :n_steps]
        emitted_np = arr[:, n_steps:2 * n_steps].astype(bool)
        ctx_m = arr[:, 2 * n_steps]
        act_m = arr[:, 2 * n_steps + 1].astype(bool)
        t_now = time.perf_counter()
        appended = 0
        for slot in range(self.num_slots):
            req = snap_req[slot]
            if req is not self.slot_req[slot]:
                continue      # slot re-admitted since this dispatch
            if emits[slot]:
                self._emits_inflight[slot] -= 1
            if self._act_since[slot] <= seq:
                self.active[slot] = act_m[slot]
                self._pred_ctx[slot] = max(int(self._pred_ctx[slot]),
                                           int(ctx_m[slot]))
            if req is None or req.finished:
                continue
            # a clean harvest exonerates its riders: one solo step clears
            # a suspect
            req.strikes = 0
            for j in range(n_steps):
                if emitted_np[slot, j]:
                    if not req.tokens:
                        req.t_first = t_now
                    req.tokens.append(int(toks_np[slot, j]))
                    appended += 1
        _t_obs = time.perf_counter()
        self._stats.inc("tokens_emitted", appended)
        if appended == 0:
            self._stats.inc("chunks_empty")
        # a spec step's two accounting columns: committed and drafted
        if arr.shape[1] > 2 * n_steps + 2:
            drafted = int(arr[:, 2 * n_steps + 3].sum())
            if drafted:
                committed = int(arr[:, 2 * n_steps + 2].sum())
                self._c_spec_drafted.inc(drafted)
                self._c_spec_accepted.inc(committed)
                self._c_spec_rejected.inc(drafted - committed)
        self._obs_s += time.perf_counter() - _t_obs

    # ---- the legacy engine: prefill waves and decode chunks --------------

    def _pump_prefill(self, max_waves=None):
        """Dispatch prefill waves until every prefilling slot has streamed
        its whole prompt (or ``max_waves`` waves went out: the interleave
        throttle). Nothing is fetched: a wave's completion is known on
        the host (prompt lengths are), and a completed prompt's first
        token waits on the device for the next chunk's echo."""
        while self._prefilling.any():
            if max_waves is not None and max_waves <= 0:
                return
            inputs, _ = self._stage_inputs()
            C = self.prefill_chunk
            self._compiled.add(("prefill", C))
            self._seq += 1
            self._stats.inc("prefill_waves")
            self._launch(inputs, self._device_prefill)
            for slot in np.flatnonzero(inputs[:, C] > 0):
                self._prefill_off[slot] += inputs[slot, C]
                if not inputs[slot, C + 1]:
                    continue
                # the prompt's last wave: the first token stays on the
                # device until the next chunk echoes it (or the drain
                # reads it, for a slot no chunk follows)
                req = self.slot_req[slot]
                req.t_prefill_done = time.perf_counter()
                self._prefilling[slot] = False
                self._pred_ctx[slot] = len(self._slot_prompt[slot])
                self._pending_first[slot] = True
                self._act_since[slot] = self._seq
                # an instant eos (first token == stop token) is found on
                # the device at the next chunk's entry
                self.active[slot] = bool(self._act_target[slot])
                # the prompt's full pages are final: publish them
                self._pc_insert(slot)
            if max_waves is not None:
                max_waves -= 1

    def _worth_dispatching(self):
        """Could a decode chunk advance any slot? Exact for
        length-limited slots (the host's ctx prediction); an eos stop
        the host cannot see may still give an empty chunk
        (``chunks_empty``)."""
        return bool(np.any(self.active & (self.limits > self._pred_ctx)))

    def _next_chunk_len(self):
        """The adaptive chunk length: the least predicted remaining
        budget of the active slots, rounded down to a power of two, at
        most ``decode_chunk`` (so no slot oversteps its limit inside a
        chunk, and the lengths stay on a ladder)."""
        if not self.adaptive_chunk:
            return self.decode_chunk
        rem = (self.limits - self._pred_ctx)[self.active
                                             & (self.limits
                                                > self._pred_ctx)]
        if rem.size == 0:
            return self.decode_chunk
        m = int(rem.min())
        if m >= self.decode_chunk:
            return self.decode_chunk
        return 1 << (m.bit_length() - 1)

    def _dispatch_chunk(self):
        """Launch one decode chunk (not waiting for it) and advance the
        host's ctx prediction. Returns the in-flight record for
        :meth:`_harvest_chunk`: the slots' requests and pending
        first-token echoes as dispatched (a slot may be drained and
        re-admitted before the harvest)."""
        n = self._next_chunk_len()
        self._compiled.add(("chunk", n))
        self._seq += 1
        self._last_fetch_dispatch_seq = self._seq
        # a slot the chunk can advance: active with budget left
        n_active = int(np.sum(self.active & (self.limits > self._pred_ctx)))
        _t_obs = time.perf_counter()
        self._stats.inc("chunks")
        self._stats.inc("chunk_slot_steps", self.num_slots * n)
        self._stats.inc("active_slot_steps", n_active * n)
        self._obs_s += time.perf_counter() - _t_obs
        inputs, _ = self._stage_inputs(prompts=False)
        packed = self._launch(inputs,
                              lambda x: self._device_chunk(x, n))
        self._pred_ctx = np.where(
            self.active, np.minimum(self.limits, self._pred_ctx + n),
            self._pred_ctx).astype(np.int32)
        rec = (packed, list(self.slot_req), self._pending_first.copy(), n,
               self._seq)
        self._echo_inflight |= self._pending_first
        self._pending_first[:] = False
        return rec

    def _harvest_chunk(self, rec):
        """Fetch one in-flight chunk's packed output and apply it: the
        echoed first tokens, the emitted tokens and the active mirrors
        (unless the slot was re-admitted, or activated by a later
        prefill wave, since the chunk went out)."""
        packed, snap_req, pending, n, seq = rec
        arr = self._fetch(packed)
        self._last_harvest_seq = max(self._last_harvest_seq, seq)
        self._release_deferred()
        toks_np = arr[:, :n]
        emitted_np = arr[:, n:2 * n].astype(bool)
        first = arr[:, 2 * n]
        act_m = arr[:, 2 * n + 2].astype(bool)
        t_now = time.perf_counter()
        appended = 0
        for slot in range(self.num_slots):
            req = snap_req[slot]
            if req is not self.slot_req[slot]:
                continue    # evicted or re-admitted since the dispatch
            if pending[slot]:
                # the echo is delivered: the slot may drain from here on
                self._echo_inflight[slot] = False
            if self._act_since[slot] <= seq:
                self.active[slot] = act_m[slot]
            if req is None:
                continue
            if pending[slot]:
                if not req.tokens:
                    req.t_first = t_now
                req.tokens.append(int(first[slot]))
                appended += 1
            if req.finished:
                continue
            req.strikes = 0     # a clean harvest exonerates its riders
            for j in range(n):
                if emitted_np[slot, j]:
                    if not req.tokens:
                        req.t_first = t_now
                    req.tokens.append(int(toks_np[slot, j]))
                    appended += 1
        _t_obs = time.perf_counter()
        self._stats.inc("tokens_emitted", appended)
        if appended == 0:
            self._stats.inc("chunks_empty")
        self._obs_s += time.perf_counter() - _t_obs

    def _decode_chunk(self):
        self._harvest_chunk(self._dispatch_chunk())

    # ---- observability ---------------------------------------------------

    def gauges(self) -> dict:
        """The JAX engine's serving gauges:

        - ``slot_occupancy``: emitted tokens / dispatched slot-steps;
        - ``active_occupancy``: slot-steps of slots that could advance /
          dispatched slot-steps;
        - ``prefill_overlap_frac``: admissions made while a step was in
          flight;
        - ``tokens_per_s``: emitted tokens / seconds inside run();
        - ``ttft_ms_p50/p99``, ``itl_ms_p50/p99``: arrival to first token
          on the host, and (t_done - t_first) / (tokens - 1), over the
          bounded reservoirs;
        - ``compiled_programs``: distinct shapes of the batching step
          (steady state 1; legacy: the prefill wave's and each chunk
          length's);
        - the counters of steps, tokens, admissions and completions, the
          reliability and prefix-cache counters, the queue depth, the
          prefix cache's resident pages, and the ``kv_quant_*`` pool
          geometry (bits of a pool element, bytes of the data pools and
          of the scales pools);
        - ``spec_steps``, ``spec_tokens_drafted``, ``spec_tokens_accepted``
          and ``spec_tokens_rejected`` (drafted = accepted + rejected), and
          ``spec_accept_rate`` = accepted / drafted."""
        s = self._stats.as_dict()
        steps = s["chunk_slot_steps"]
        pc = s["prefix_cache_hits"] + s["prefix_cache_misses"]
        data = [p for p in self.pools if p.dim() == 4]
        return {
            "slot_occupancy": s["tokens_emitted"] / steps if steps
            else 0.0,
            "active_occupancy": s["active_slot_steps"] / steps if steps
            else 0.0,
            "prefill_overlap_frac": (s["prefills_overlapped"]
                                     / s["prefills"]) if s["prefills"]
            else 0.0,
            "tokens_per_s": (s["tokens_emitted"] / s["run_seconds"])
            if s["run_seconds"] else 0.0,
            "ttft_ms_p50": self._h_ttft.percentile(50),
            "ttft_ms_p99": self._h_ttft.percentile(99),
            "itl_ms_p50": self._h_itl.percentile(50),
            "itl_ms_p99": self._h_itl.percentile(99),
            "compiled_programs": len(self._compiled),
            "chunks_dispatched": s["chunks"],
            "chunks_empty": s["chunks_empty"],
            "prefill_waves": s["prefill_waves"],
            "unified_steps": s["unified_steps"],
            "tokens_emitted": s["tokens_emitted"],
            "prefills": s["prefills"],
            "requests_completed": s["requests_completed"],
            "obs_overhead_frac": (self._obs_s / s["run_seconds"])
            if s["run_seconds"] else 0.0,
            "preempt_evictions": s["preempt_evictions"],
            "preempt_recompute_tokens": s["preempt_recompute_tokens"],
            "requests_cancelled": s["requests_cancelled"],
            "deadline_expired": (s["deadline_ttft_expired"]
                                 + s["deadline_total_expired"]),
            "shed_rejections": s["shed_rejections"],
            "queue_depth": len(self.queue),
            "quarantined": s["quarantined"],
            "containments": s["containments"],
            "prefix_cache_hits": s["prefix_cache_hits"],
            "prefix_cache_misses": s["prefix_cache_misses"],
            "prefix_cache_hit_rate": s["prefix_cache_hits"] / pc if pc
            else 0.0,
            "prefix_cache_tokens_saved": s["prefix_cache_tokens_saved"],
            "prefix_cache_evictions": s["prefix_cache_evictions"],
            "prefix_cache_cow_forks": s["prefix_cache_cow_forks"],
            "prefix_cache_pages": len(self._pc_nodes),
            "kv_quant_bits": 8 * data[0].element_size(),
            "kv_quant_pool_bytes": sum(p.numel() * p.element_size()
                                       for p in data),
            "kv_quant_scale_pool_bytes": sum(
                p.numel() * p.element_size() for p in self.pools
                if p.dim() == 3),
            "spec_steps": self._c_spec_steps.value,
            "spec_tokens_drafted": self._c_spec_drafted.value,
            "spec_tokens_accepted": self._c_spec_accepted.value,
            "spec_tokens_rejected": self._c_spec_rejected.value,
            "spec_accept_rate": (self._c_spec_accepted.value
                                 / self._c_spec_drafted.value)
            if self._c_spec_drafted.value else 0.0,
        }

    def reset_gauges(self):
        """Zero the counters and the latency reservoirs (after a warm-up
        run, say). The set of step shapes is kept."""
        for k in self._stats:
            self._stats[k] = 0.0 if k == "run_seconds" else 0
        for c in (self._c_spec_steps, self._c_spec_drafted,
                  self._c_spec_accepted, self._c_spec_rejected):
            c.set(0)
        self._h_ttft.reset()
        self._h_itl.reset()
        self._obs_s = 0.0

    # ---- pages -----------------------------------------------------------

    def _alloc_pages(self, n):
        if len(self._free_pages) < n and self._pc_nodes:
            # allocation pressure: reclaim unreferenced cache pages (LRU)
            # first, a warm cache must not deny what a cold pool grants.
            # Pages already deferred behind the in-flight harvest WILL
            # arrive, so they count against the shortfall.
            deferred = sum(len(p) for _, p in self._deferred_free)
            short = n - len(self._free_pages) - deferred
            if short > 0:
                self._pc_evict(short)
        if len(self._free_pages) < n:
            return None
        return [self._free_pages.popleft() for _ in range(n)]

    def _release_pages(self, pages, safe=False):
        """Return pages to the free pool. ``safe=True`` (the drain) frees
        at once: a drained slot is inactive in every dispatched step, so
        its writes go to the trash page. Pages of an EVICTED (still
        device-active) slot wait until every step dispatched so far has
        been harvested (``_deferred_free``)."""
        if not pages:
            return
        if safe or self._last_harvest_seq >= \
                self._last_fetch_dispatch_seq:
            self._free_pages.extend(pages)
        else:
            self._deferred_free.append(
                (self._last_fetch_dispatch_seq, list(pages)))

    def _release_deferred(self):
        """Move deferred pages whose gating step has been harvested back
        into the free pool (every harvest calls it)."""
        if not self._deferred_free:
            return
        keep = []
        for gate, pages in self._deferred_free:
            if gate <= self._last_harvest_seq:
                self._free_pages.extend(pages)
            else:
                keep.append((gate, pages))
        self._deferred_free = keep

    def _audit_pages(self, where):
        """Every page lives in exactly one place (the free list, an
        occupied slot's private list, the prefix-cache index, the
        deferred set, or the trash page 0), and every cache node's
        refcount equals its live slot attachments. Quantized pools keep
        the [k, v, k_scales, v_scales] geometry with f32 scales on the
        same page axis. Raises ``AssertionError``; a no-op unless the
        audit is on."""
        if not self._audit:
            return
        held = [p for pages in self.slot_pages for p in pages]
        cached = list(self._pc_nodes)
        deferred = [p for _, pages in self._deferred_free for p in pages]
        allp = list(self._free_pages) + held + cached + deferred
        if len(allp) + 1 != self.num_pages \
                or len(set(allp)) != len(allp) or 0 in allp:
            raise AssertionError(
                f"serving page accounting broken at {where}: "
                f"free={len(self._free_pages)} held={len(held)} "
                f"cached={len(cached)} deferred={len(deferred)} "
                f"(+1 trash) != {self.num_pages} pages, "
                f"dupes={len(allp) - len(set(allp))}, "
                f"trash_leaked={0 in allp}")
        refs: dict[int, int] = {}
        for nodes in self.slot_shared:
            for node in nodes:
                refs[node.page] = refs.get(node.page, 0) + 1
        for node in self._pc_nodes.values():
            expect = refs.get(node.page, 0)
            if node.ref != expect or node.ref < 0:
                raise AssertionError(
                    f"prefix-cache refcount broken at {where}: page "
                    f"{node.page} ref={node.ref} but {expect} live "
                    f"attachment(s)")
            if node.parent is not self._pc_root \
                    and node.parent.ref < node.ref:
                raise AssertionError(
                    f"prefix-cache chain broken at {where}: page "
                    f"{node.page} ref={node.ref} exceeds parent page "
                    f"{node.parent.page} ref={node.parent.ref}")
        for page in refs:
            if page not in self._pc_nodes:
                raise AssertionError(
                    f"prefix-cache attachment to unindexed page "
                    f"{page} at {where}")
        if self.kv_quant != "none":
            n_layers = self.cfg.num_hidden_layers
            if len(self.pools) != 4 * n_layers:
                raise AssertionError(
                    f"quantized pool count broken at {where}: "
                    f"{len(self.pools)} pools, expected {4 * n_layers}")
            for i, p in enumerate(self.pools):
                want = (self._pool_shape if i % 4 < 2
                        else self._scale_shape)
                if tuple(p.shape) != want:
                    raise AssertionError(
                        f"quantized pool geometry broken at {where}: "
                        f"pool {i} shape {tuple(p.shape)} != {want}")
                if i % 4 >= 2 and p.dtype != torch.float32:
                    raise AssertionError(
                        f"scales pool {i} dtype {p.dtype} at {where}: "
                        f"scales must stay f32")

    # ---- prefix cache: radix index and copy-on-write ---------------------

    def _pc_match(self, eff):
        """Longest cached full-page prefix of the admission prompt, one
        ``page_size`` block per level. Returns the node chain, root
        excluded."""
        if not self._prefix_cache:
            return []
        nodes, cur, ps = [], self._pc_root, self.page_size
        for i in range(len(eff) // ps):
            child = cur.children.get(eff[i * ps:(i + 1) * ps].tobytes())
            if child is None:
                break
            nodes.append(child)
            cur = child
        return nodes

    def _pc_pin(self, nodes):
        """Incref a matched chain (attach, or pin against eviction)."""
        self._pc_clock += 1
        for node in nodes:
            node.ref += 1
            node.stamp = self._pc_clock

    def _pc_unpin(self, nodes):
        self._pc_clock += 1
        for node in nodes:
            node.ref -= 1
            node.stamp = self._pc_clock

    def _pc_detach(self, slot):
        """Drop a slot's shared-page attachments (drain or eviction):
        decref only, the pages stay resident (that residency is the
        cache)."""
        if self.slot_shared[slot]:
            self._pc_unpin(self.slot_shared[slot])
            self.slot_shared[slot] = []

    def _pc_insert(self, slot):
        """Publish a slot's full prompt pages into the radix index when
        its prompt completes: ownership moves page by page from the
        slot's private list to new nodes (the slot stays attached, ref
        1). A level another slot published first keeps this slot's
        duplicate page private (it dies at drain): re-pointing a live
        block table is never worth the race. A later attacher's step
        runs after this one on the stream, so it reads the writes."""
        if not self._prefix_cache:
            return
        eff = self._slot_prompt[slot]
        ps = self.page_size
        shared = self.slot_shared[slot]
        cur = shared[-1] if shared else self._pc_root
        self._pc_clock += 1
        for lvl in range(len(shared), len(eff) // ps):
            if not self.slot_pages[slot]:
                break
            key = eff[lvl * ps:(lvl + 1) * ps].tobytes()
            if key in cur.children:
                break
            page = self.slot_pages[slot].pop(0)
            node = _PrefixCacheNode(key, page, cur)
            node.ref = 1
            node.stamp = self._pc_clock
            cur.children[key] = node
            self._pc_nodes[page] = node
            shared.append(node)
            cur = node

    def _pc_evictable(self):
        """Pages the LRU could reclaim now (ref-0 nodes)."""
        return sum(1 for n in self._pc_nodes.values() if n.ref == 0)

    def _pc_evict(self, n_pages):
        """Reclaim up to ``n_pages`` unreferenced cache pages, LRU first
        among childless ref-0 nodes (leaves first, so every chain stays
        root-contiguous). Freed pages follow the deferred-release rule:
        a step dispatched while a since-drained reader was attached may
        still read them."""
        freed = []
        # one snapshot and a heap: nodes change state only through our
        # own evictions, and a parent joins when its last child goes
        heap = [(n.stamp, n.page) for n in self._pc_nodes.values()
                if n.ref == 0 and not n.children]
        heapq.heapify(heap)
        while heap and len(freed) < n_pages:
            _, page = heapq.heappop(heap)
            victim = self._pc_nodes.get(page)
            if victim is None or victim.ref or victim.children:
                continue
            del victim.parent.children[victim.key]
            del self._pc_nodes[page]
            freed.append(page)
            parent = victim.parent
            if parent is not self._pc_root and parent.ref == 0 \
                    and not parent.children:
                heapq.heappush(heap, (parent.stamp, parent.page))
        if freed:
            self._stats.inc("prefix_cache_evictions", len(freed))
            self._release_pages(freed)
        return len(freed)

    def _pc_cow(self, src, dst):
        """Copy-on-write fork: page ``dst`` becomes a private copy of the
        shared page ``src`` in every pool (codes and scales alike), by
        one ``_foreach_copy_`` over the page views (fp8 through a uint8
        view). It goes to the current stream behind every dispatched
        step, so it reads the prefix owner's finished writes and every
        later step sees it."""
        pools = [p.view(torch.uint8) if p.dtype == torch.float8_e4m3fn
                 else p for p in self.pools]
        torch._foreach_copy_([p[:, dst] for p in pools],
                             [p[:, src] for p in pools])
        self._stats.inc("prefix_cache_cow_forks")

    @property
    def prefix_cache_pages(self):
        """Physical pages owned by the prefix-cache index (referenced and
        evictable)."""
        return len(self._pc_nodes)

    def reset_prefix_cache(self):
        """Drop every unreferenced cache entry (a cold/warm comparison
        without rebuilding the engine). Returns the pages reclaimed."""
        n = self._pc_evict(len(self._pc_nodes))
        self._audit_pages("reset_prefix_cache")
        return n

    # ---- admission and lifecycle -----------------------------------------

    def _admission_key(self, req):
        # higher priority first; FIFO (arrival, then id) within a class:
        # a preempted request keeps its arrival and its queue position
        return (-req.priority, req.t_arrive, req.request_id)

    def _next_candidate(self):
        if not self.queue:
            return None
        if not self._has_priorities:
            return self.queue[0]
        return min(self.queue, key=self._admission_key)

    def _already_complete(self, req):
        """A replayed request that already holds its full stream."""
        if not req.tokens:
            return False
        eos = req.eos_token_id
        return (eos is not None and req.tokens[-1] == eos) \
            or len(req.tokens) >= req.max_new_tokens

    def _complete_ok(self, req):
        """Normal completion (the drain, or an already-complete
        replay)."""
        req.finished = True
        req.t_done = time.perf_counter()
        eos = req.eos_token_id
        req.finish_reason = "eos" if (
            eos is not None and req.tokens
            and req.tokens[-1] == eos) else "length"
        req.strikes = 0        # innocence proven by completion
        self._record_latency(req)
        self.completed.append(req)
        self._stats.inc("requests_completed")

    def _finish_error(self, req, err):
        """Complete a request with a typed error, keeping the tokens
        already emitted."""
        req.finished = True
        req.error = err
        req.t_done = time.perf_counter()
        if isinstance(err, RequestCancelled):
            req.finish_reason = "cancelled"
            self._stats.inc("requests_cancelled")
        elif isinstance(err, DeadlineExceeded):
            req.finish_reason = "deadline"
            self._stats.inc("deadline_ttft_expired" if err.kind == "ttft"
                            else "deadline_total_expired")
        else:
            req.finish_reason = "quarantined"
            self._stats.inc("quarantined")
        self._record_latency(req)
        self.completed.append(req)
        return req

    def _clear_slot(self, slot, device=False):
        """The one per-slot teardown (drain and eviction share it).
        ``device=True`` (eviction) also deactivates the slot on the
        device: the next step resets its ctx and active flag; a drained
        slot already went inactive inside its step."""
        self._pc_detach(slot)        # shared pages: decref, stay cached
        self.slot_pages[slot] = []
        self.slot_req[slot] = None
        self._slot_prompt[slot] = None
        self.tables[slot] = 0
        self._pred_ctx[slot] = 0
        self.limits[slot] = 0
        self.slot_eos[slot] = -1
        self._prefill_off[slot] = 0
        self._act_target[slot] = False
        if device:
            self.active[slot] = False
            self._prefilling[slot] = False
            self._emits_inflight[slot] = 0
            self._pending_first[slot] = False
            self._echo_inflight[slot] = False
            self._reset[slot] = True
            self._reset_ctx[slot] = 0

    def _evict_slot(self, slot, requeue, reason="preempt", error=None):
        """Tear an occupied slot out mid-flight: deactivate it on the
        host and the device (an in-flight step's stale view is dropped
        at harvest by the slot_req identity check), reclaim its pages
        (deferred past any step that could still write them), then
        requeue the request for recompute or complete it with a typed
        error."""
        req = self.slot_req[slot]
        if requeue:
            self._stats.inc("preempt_evictions")
            self._stats.inc("preempt_pages_reclaimed",
                            len(self.slot_pages[slot]))
        self._release_pages(self.slot_pages[slot])
        self._clear_slot(slot, device=True)
        record_hop(req, "preempt" if requeue else "evict", reason=reason,
                   tokens=len(req.tokens))
        if requeue:
            req.preemptions += 1
            self.queue.appendleft(req)
        elif error is not None:
            self._finish_error(req, error)
        return req

    def _preempt_for(self, req, need, need_slot=False):
        """Recompute preemption: evict strictly LOWER-priority occupants
        (lowest priority, then latest admitted, first) until ``req`` has
        a slot (``need_slot``) and ``need`` pages are free or provably
        arriving (deferred, or evictable cache). Equal priorities never
        preempt: pure overload queues."""
        victims = [s for s in range(self.num_slots)
                   if self.slot_req[s] is not None
                   and self.slot_req[s].priority < req.priority]
        victims.sort(key=lambda s: (self.slot_req[s].priority,
                                    -self.slot_req[s].t_admit))
        projected = len(self._free_pages) + sum(
            len(p) for _, p in self._deferred_free) \
            + self._pc_evictable()
        # feasibility first: if evicting every victim cannot reach
        # ``need``, evict none
        if projected + sum(len(self.slot_pages[s])
                           for s in victims) < need:
            return False
        evicted = 0
        for s in victims:
            if projected >= need and (evicted or not need_slot):
                break
            projected += len(self.slot_pages[s])
            self._evict_slot(s, requeue=True, reason="preempt")
            evicted += 1
        if need_slot and not evicted:
            return False
        return projected >= need

    def _lifecycle_error(self, req, now):
        if req.cancelled:
            return RequestCancelled(req.request_id)
        if req.deadline_s is not None \
                and now - req.t_arrive > req.deadline_s:
            return DeadlineExceeded(req.request_id, "total",
                                    req.deadline_s)
        if req.ttft_deadline_s is not None and not req.t_first \
                and now - req.t_arrive > req.ttft_deadline_s:
            return DeadlineExceeded(req.request_id, "ttft",
                                    req.ttft_deadline_s)
        return None

    def _reap(self):
        """Once a scheduler turn: cancelled or expired requests leave the
        queue, running ones are evicted (pages reclaimed mid-prefill or
        mid-decode); each completes with its typed error."""
        done = []
        now = time.perf_counter()
        self._reap_turn += 1
        if self.queue and (self._lifecycle_seen
                           or self._reap_turn % 32 == 0):
            drop = [(req, err) for req in self.queue
                    if (err := self._lifecycle_error(req, now))
                    is not None]
            if drop:
                self._lifecycle_seen = True
            for req, err in drop:
                self.queue.remove(req)
                done.append(self._finish_error(req, err))
        for slot in range(self.num_slots):
            req = self.slot_req[slot]
            if req is None or req.finished:
                continue
            err = self._lifecycle_error(req, now)
            if err is not None:
                self._evict_slot(slot, requeue=False,
                                 reason=type(err).__name__, error=err)
                done.append(req)
        return done

    def _admit(self):
        """Move queued requests into free slots: allocate pages, stage
        the slot as PREFILLING. Priority first, then FIFO; with no slot
        or pages free, a strictly higher-priority candidate preempts
        lower-priority occupants. A request implicated by a step failure
        (``strikes > 0``) runs alone."""
        while self.queue:
            req = self._next_candidate()
            if self._already_complete(req):
                self.queue.remove(req)
                self._complete_ok(req)
                self._done_pending.append(req)
                continue
            if any(r is not None and r.strikes for r in self.slot_req):
                return         # a suspect runs alone, nothing joins it
            occupied = any(r is not None for r in self.slot_req)
            if req.strikes and occupied:
                return         # suspects wait for an empty engine
            gen = len(req.tokens)
            remaining = req.max_new_tokens - gen
            eff_len = req.prompt.size + gen
            need_total = -(-(eff_len + remaining) // self.page_size)
            slot = next((s for s in range(self.num_slots)
                         if self.slot_req[s] is None
                         and not self.active[s]), None)
            if slot is None and not self._has_priorities:
                return   # no slot and nobody to preempt
            if gen:
                # recompute re-admission: prompt + generated tokens
                eff = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int32)])
            else:
                eff = req.prompt
            # cached-prefix fast path: shared pages are attached, not
            # allocated, and pinned before any allocation so the LRU
            # cannot reclaim them mid-admission
            shared = self._pc_match(eff)
            # copy-on-write: the WHOLE admission prompt is cached, but
            # the last token must re-prefill for its logits; its write
            # lands in the last shared page, which is forked
            cow = bool(shared) \
                and len(shared) * self.page_size >= len(eff)
            start = len(eff) - 1 if cow \
                else len(shared) * self.page_size
            need = need_total - len(shared) + (1 if cow else 0)
            self._pc_pin(shared)
            if slot is None:
                if not self._preempt_for(req, need, need_slot=True):
                    self._pc_unpin(shared)
                    return
                slot = next((s for s in range(self.num_slots)
                             if self.slot_req[s] is None
                             and not self.active[s]), None)
                if slot is None:
                    self._pc_unpin(shared)
                    return
            pages = self._alloc_pages(need)
            if pages is None and self._has_priorities \
                    and self._preempt_for(req, need):
                pages = self._alloc_pages(need)
            if pages is None:
                self._pc_unpin(shared)
                return   # reclaimed pages still deferred, or overload:
                         # the candidate stays queued
            attach = shared
            if cow:
                fork = shared[-1]
                self._pc_cow(fork.page, pages[0])
                self._pc_unpin([fork])
                attach = shared[:-1]
            if self._prefix_cache:
                self._stats.inc("prefix_cache_hits" if start
                                else "prefix_cache_misses")
                if start:
                    self._stats.inc("prefix_cache_tokens_saved", start)
            self.queue.remove(req)
            if gen:
                self._stats.inc("preempt_recompute_tokens", gen)
            self._stage_slot(slot, req, pages, eff, remaining,
                             attach=attach, start=start)

    def _stage_slot(self, slot, req, pages, eff, remaining, attach=(),
                    start=0):
        """Bind an admitted request to a slot: block-table row, limits,
        prefill progress, and the device reset of its ctx to ``start``
        (the cached prefix, in tokens: prefill resumes there). ``eff``
        is the admission prompt, ``remaining`` the generation budget
        left, ``attach`` the pinned cached-prefix chain whose pages head
        the table."""
        tl = len(eff)
        self.slot_pages[slot] = pages
        self.slot_shared[slot] = list(attach)
        self._slot_prompt[slot] = eff
        row = np.zeros((self.pages_per_slot,), np.int32)
        row[:len(attach)] = [n.page for n in attach]
        row[len(attach):len(attach) + len(pages)] = pages
        self.tables[slot] = row
        req.t_admit = time.perf_counter()
        record_hop(req, "admit", slot=slot, cached=int(start),
                   replayed=len(req.tokens))
        self._stats.inc("prefills")
        if self._overlap_admission:
            self._stats.inc("prefills_overlapped")
        self.slot_req[slot] = req
        self._prefilling[slot] = True
        self._prefill_off[slot] = start
        self._emits_inflight[slot] = 0
        self._act_target[slot] = remaining > 1
        self._pred_ctx[slot] = start
        self._reset[slot] = True
        self._reset_ctx[slot] = start
        self.slot_eos[slot] = -1 if req.eos_token_id is None \
            else int(req.eos_token_id)
        # ctx counts CACHE entries; one generated token is always pending
        # outside the cache, so the n-th token lands when ctx reaches
        # tl + n - 1
        self.limits[slot] = tl + remaining - 1

    # ---- completion ------------------------------------------------------

    def _record_latency(self, req):
        """Book a finished request's TTFT and inter-token latency into
        the bounded reservoirs."""
        _t_obs = time.perf_counter()
        if req.t_first:
            self._h_ttft.observe((req.t_first - req.t_arrive) * 1e3)
            if len(req.tokens) > 1:
                self._h_itl.observe(
                    (req.t_done - req.t_first) * 1e3
                    / (len(req.tokens) - 1))
        record_hop(req, "finish", reason=req.finish_reason,
                   tokens=len(req.tokens))
        self._obs_s += time.perf_counter() - _t_obs

    def _drain(self):
        """Reap cancelled and expired requests, then finish every
        occupied slot that is done prefilling, has no step in flight
        that may emit for it (legacy: nor a chunk carrying its first
        token's echo), and is no longer active; its pages return to the
        free list (its writes go to the trash page in every step
        dispatched since). A legacy slot that went inactive with its
        first token never echoed (a one-token request that no chunk
        followed) reads that token from the device here."""
        done = self._reap()
        if self._done_pending:
            done.extend(self._done_pending)
            self._done_pending = []
        for slot in range(self.num_slots):
            req = self.slot_req[slot]
            if req is None or self._prefilling[slot] \
                    or self._emits_inflight[slot] \
                    or self._echo_inflight[slot] or self.active[slot]:
                continue
            if self._pending_first[slot]:
                req.t_first = time.perf_counter()
                req.tokens.append(int(self._dev_tok[slot]))
                self._stats.inc("tokens_emitted")
                self._pending_first[slot] = False
            finished_now = not req.finished
            self._release_pages(self.slot_pages[slot], safe=True)
            self._clear_slot(slot)
            if finished_now:
                self._complete_ok(req)
            done.append(req)
        self._audit_pages("drain")
        return done
