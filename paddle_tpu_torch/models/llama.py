"""Llama for training, for ``generate`` over a dense KV cache and for
serving over paged KV pools.

Port of ``paddle_tpu/models/llama.py``: ``LlamaConfig`` (the ``tiny``,
``llama_1b``, ``llama3_8b`` and ``llama3_70b`` presets, the recompute
fields), the dense training path and both cache paths of
``LlamaAttention``/``LlamaMLP``/``LlamaDecoderLayer``/``LlamaModel``/
``LlamaForCausalLM``,
``LlamaPretrainingCriterion``, ``rope_with_offset``,
``_alloc_kv_caches``/``init_kv_cache`` and ``_paged_attention_step``
(bf16/f32 pools, and int8/fp8 pools with their scales).

Caches without ``tables`` are the dense [B, max_len, KVH, D] caches of
``generate`` (``generation.GenerationMixin``): RoPE at ``pos + [0..S)``
and ``nn.functional.sdpa_with_cache``, a scalar ``pos`` for the whole
batch. Caches with ``tables`` are the engine's paged pools.

Training (no caches): ``model(ids, labels=ids)`` returns ``(logits,
loss)``, the shifted next-token cross entropy, and ``loss.backward()``
runs torch autograd through the kernels' ``autograd.Function``s. The
stack is always the unrolled one (the port has no ``scan_layers``):

- ``FLAGS_fused_rmsnorm_residual`` (on by default) carries the un-added
  ``(hidden, residual)`` pair between layers, so each residual add and
  the RMSNorm after it, the final norm included, are one
  ``fused_rms_norm_residual`` (K3/K4); off, each add is its own op in
  the input dtype followed by its own RMSNorm. Both give the same
  numbers: addition commutes, and the fused add rounds where the
  unfused one does.
- ``use_recompute`` recomputes layers in the backward
  (``incubate.recompute``): whole layers (``full``), or the norms,
  projections and MLP with flash attention outside the recomputed
  regions (``core_attn``/``full_attn``, every ``core_attn_interval``-th
  layer); every ``full_save_interval``-th layer is not recomputed.
- ``FLAGS_fused_linear_cross_entropy`` (off by default; ``hapi.Model.
  fit`` turns it on) takes the labelled loss through
  ``ops.fused_ce.fused_linear_cross_entropy`` (K10/K11) and returns
  ``(None, loss)``, without logits; it needs an untied ``lm_head``.

The serving path (caches) keeps the unfused stack, as the JAX package's
does.

Attribute names match the JAX package, so the state-dict keys do
(``llama.layers.0.self_attn.q_proj.weight``, ...); ``torch.nn.Linear``
holds its weight as [out, in] where Paddle holds [in, out], which
``paddle_tpu_torch.convert`` accounts for.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..framework import flags
from ..generation import GenerationMixin
from ..incubate.recompute import recompute
from ..nn import Linear, RMSNorm
from ..nn import functional as F
from ..ops import paged_attention as PA
from ..ops.fused_ce import fused_linear_cross_entropy
from ..ops.rope import build_sin_cos, rotate

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "rope_with_offset"]


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    intermediate_size: int = 14336
    max_position_embeddings: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    use_recompute: bool = False
    # "full" recomputes whole decoder layers; "core_attn" (and
    # PaddleNLP's "full_attn", the same structure here) keeps flash
    # attention outside the recomputed regions
    recompute_granularity: str = "full"
    # core_attn on every Nth layer only (1 = all)
    core_attn_interval: int = 1
    # every k-th layer is not recomputed at all; 0 = off
    full_save_interval: int = 0
    # weight-only serving quantization: None keeps full precision;
    # "weight_only_int8" / "weight_only_int4" turn the projections and
    # the lm_head into nn.quant.WeightOnlyLinear when the serving engine
    # is built (nn.quant.quantize_for_serving)
    weight_quant: str | None = None

    def __post_init__(self):
        if self.recompute_granularity not in ("full", "core_attn",
                                              "full_attn"):
            raise ValueError(
                f"recompute_granularity={self.recompute_granularity!r} "
                "is not one of 'full' | 'core_attn' | 'full_attn'")
        check_weight_quant(self.weight_quant)

    @classmethod
    def llama3_8b(cls):
        return cls()

    @classmethod
    def llama3_70b(cls):
        return cls(hidden_size=8192, num_hidden_layers=80,
                   num_attention_heads=64, num_key_value_heads=8,
                   intermediate_size=28672)

    @classmethod
    def llama_1b(cls):
        return cls(vocab_size=32000, hidden_size=2048,
                   num_hidden_layers=16, num_attention_heads=16,
                   num_key_value_heads=8, intermediate_size=5632,
                   max_position_embeddings=4096, rope_theta=10000.0)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2,
                   intermediate_size=128, max_position_embeddings=128,
                   rope_theta=10000.0)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def check_weight_quant(mode):
    if mode not in (None, "weight_only_int8", "weight_only_int4"):
        raise ValueError(
            f"weight_quant={mode!r} is not one of "
            "None | 'weight_only_int8' | 'weight_only_int4'")


def rope_with_offset(sin_tab, cos_tab, pos, seq_len):
    """Per-token (sin, cos) [B, S, D/2] at absolute positions
    ``pos + [0..S)``. Positions past the table (chunk padding near
    ``max_position_embeddings``) are clamped onto its last row: their
    tokens are padding, whose writes go to the trash page and whose
    outputs are zeroed, and an index past the end would fault on the
    device (the JAX package's ``jnp.take`` returns NaN there instead)."""
    pid = pos.long()[:, None] + torch.arange(seq_len, device=pos.device)
    pid = pid.clamp_(max=sin_tab.shape[0] - 1)
    return sin_tab[pid], cos_tab[pid]


def slot_positions(pos, batch, device):
    """The per-slot positions [B] int32 of a dense-cache step, whose
    ``pos`` (an int or a 0-d tensor) is one offset for the whole batch:
    a fill or a broadcast on the device, never a copy from the host."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(()).to(torch.int32).expand(batch)
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


def _alloc_kv_caches(cfg, batch_size, max_length, dtype, device):
    """Zero dense KV caches: per layer (k, v) of [B, max_len, KVH, D]."""
    shape = (batch_size, max_length, cfg.num_key_value_heads, cfg.head_dim)
    return [torch.zeros(shape, dtype=dtype, device=device)
            for _ in range(2 * cfg.num_hidden_layers)]


def kv_cache_dtype(model):
    """The dtype of ``generate``'s caches: the model's first floating
    parameter's (a weight-quantized model also holds integer codes)."""
    return next(p.dtype for p in model.parameters() if p.is_floating_point())


def _dense_attention_step(attn, q, k, v, cache, pos, rope):
    """``generate``'s attention over the dense caches ``(k_cache,
    v_cache)``: rotate q/k at ``pos + [0..S)``, write k/v at ``pos`` and
    attend over the cache (``sdpa_with_cache``; in place)."""
    b, s = q.shape[0], q.shape[1]
    sin, cos = rope
    out, _, _ = F.sdpa_with_cache(rotate(q, sin, cos), rotate(k, sin, cos),
                                  v, cache[0], cache[1], pos)
    return attn.o_proj(out.reshape(b, s, attn.num_heads * attn.head_dim))


def _paged_attention_step(attn, q, k, v, cache, ctx, tables, rope,
                          proj=None):
    """Continuous-batching attention over the paged pools: rotate q/k
    (``rope`` the per-token ``(sin, cos)``; None for a model with learned
    positions, GPT-2), write the chunk's k/v into the slot pages at ``ctx
    .. ctx + valid - 1`` (padding and idle slots to trash page 0; in
    place), then attend through
    :func:`ops.paged_attention.ragged_paged_attention` (prefill chunk,
    decode step or idle slot alike) and project through ``proj`` (default
    ``attn.o_proj``). ``cache`` is ``(k_pages, v_pages)``, or ``(k_pages,
    v_pages, k_scales, v_scales)`` for int8/fp8 pools, written quantized
    (``paged_prefill_write_quant``). ``tables`` is ``(block_tables,
    valid)``, both int32."""
    b, s = q.shape[0], q.shape[1]
    tbl, valid = tables
    if rope is not None:
        sin, cos = rope
        q = rotate(q, sin, cos)
        k = rotate(k, sin, cos)
    scales = {}
    if len(cache) == 4:
        PA.paged_prefill_write_quant(*cache, k, v, tbl, ctx, valid)
        scales = dict(k_scales=cache[2], v_scales=cache[3])
    else:
        PA.paged_prefill_write(*cache, k, v, tbl, ctx, valid)
    out = PA.ragged_paged_attention(q, cache[0], cache[1], tbl, ctx, valid,
                                    **scales)
    proj = attn.o_proj if proj is None else proj
    return proj(out.reshape(b, s, attn.num_heads * attn.head_dim))


class LlamaAttention(nn.Module):
    """GQA attention; ``qkv_bias`` gives the q/k/v projections a bias (the
    Qwen2 signature)."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 qkv_bias=False):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        h, d = cfg.hidden_size, self.head_dim
        self.q_proj = Linear(h, self.num_heads * d, bias=qkv_bias, **kw)
        self.k_proj = Linear(h, self.num_kv_heads * d, bias=qkv_bias, **kw)
        self.v_proj = Linear(h, self.num_kv_heads * d, bias=qkv_bias, **kw)
        self.o_proj = Linear(self.num_heads * d, h, bias=False, **kw)

    def _proj(self, x):
        b, s, _ = x.shape
        return (self.q_proj(x).view(b, s, self.num_heads, self.head_dim),
                self.k_proj(x).view(b, s, self.num_kv_heads, self.head_dim),
                self.v_proj(x).view(b, s, self.num_kv_heads, self.head_dim))

    def forward(self, x, rope, cache, ctx, tables):
        """A cache step: over the paged pools (``tables``, per-slot
        ``ctx``), or without ``tables`` over ``generate``'s dense caches
        (``ctx`` the scalar offset). The training path goes through the
        decoder layer's stages (``_qkv_from``, ``_attend``, ``o_proj``)."""
        if tables is None:
            return _dense_attention_step(self, *self._proj(x), cache, ctx,
                                         rope)
        return _paged_attention_step(self, *self._proj(x), cache, ctx,
                                     tables, rope)


def _attend(q, k, v):
    """Causal attention of the training path (flash attention): the part
    ``core_attn`` recompute keeps outside its regions."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=True)


class LlamaMLP(nn.Module):
    """The SwiGLU MLP, ``intermediate`` wide (default the config's)."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 intermediate=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        h, i = cfg.hidden_size, intermediate or cfg.intermediate_size
        self.gate_proj = Linear(h, i, **kw)
        self.up_proj = Linear(h, i, **kw)
        self.down_proj = Linear(i, h, **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device=device, dtype=dtype)
        self.self_attn = LlamaAttention(cfg, device, dtype)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, device=device, dtype=dtype)
        self.mlp = LlamaMLP(cfg, device, dtype)

    def forward(self, x, rope, cache=None, ctx=None, tables=None):
        """The unfused stack: each residual add in the input dtype, then
        its own RMSNorm. Without a cache it is composed of the stages
        that core_attn recompute uses."""
        if cache is not None:
            x = x + self.self_attn(self.input_layernorm(x), rope, cache, ctx,
                                   tables)
            return x + self.mlp(self.post_attention_layernorm(x))
        return self._post_stage(x, _attend(*self._qkv_stage(x, rope)))

    # ---- the unfused stages and core_attn recompute over them ----------
    def _qkv_from(self, h, rope):
        """q [B, S, H, D] and k, v [B, S, KVH, D] from a normed input: the
        projections, and RoPE at positions 0..S-1 on q and k."""
        q, k, v = self.self_attn._proj(h)
        sin, cos = rope
        return rotate(q, sin, cos), rotate(k, sin, cos), v

    def _qkv_stage(self, x, rope):
        return self._qkv_from(self.input_layernorm(x), rope)

    def _post_stage(self, x, ctx):
        b, s, _ = x.shape
        x = x + self.self_attn.o_proj(ctx.reshape(b, s, -1))
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward_core_attn_remat(self, x, rope):
        """Recompute the norms, projections and MLP in the backward, but
        keep flash attention outside the recomputed regions: its output
        is kept, so the backward never re-runs the attention forward."""
        q, k, v = recompute(self._qkv_stage, x, rope, n_outputs=3)
        return recompute(self._post_stage, x, _attend(q, k, v))

    # ---- the fused residual carry (FLAGS_fused_rmsnorm_residual) -------
    # The unfused stack computes x1 = x + attn(norm1(x)); x2 = x1 +
    # mlp(norm2(x1)): each residual add is followed at once by an RMSNorm
    # (the next layer's norm1 for the mlp add). The fused path carries
    # the un-added pair (hidden, residual) between layers, so every
    # add+norm pair is one fused_rms_norm_residual: layer i's mlp output
    # and residual stream fuse into layer i+1's input_layernorm, the
    # attention output and stream into post_attention_layernorm, and
    # LlamaModel fuses the last add into the final norm.

    def _norm_pair(self, norm, hidden, residual):
        """(normed, summed) of the add+norm pair; a None residual (the
        stack's entry) gives the plain norm, with hidden as the stream."""
        if residual is None:
            return norm(hidden), hidden
        return F.fused_rms_norm_residual(hidden, residual, norm.weight,
                                         norm.epsilon)

    def forward_fused(self, hidden, residual, rope):
        """One layer over the (hidden, residual) carry; returns the next
        un-added pair (mlp output, residual stream)."""
        q, k, v, r = self._qkv_stage_fused(hidden, residual, rope)
        return self._post_stage_fused(_attend(q, k, v), r)

    def _qkv_stage_fused(self, hidden, residual, rope):
        y1, r = self._norm_pair(self.input_layernorm, hidden, residual)
        return (*self._qkv_from(y1, rope), r)

    def _post_stage_fused(self, ctx, r):
        b, s, _ = r.shape
        y2, r2 = self._norm_pair(self.post_attention_layernorm,
                                 self.self_attn.o_proj(ctx.reshape(b, s, -1)),
                                 r)
        return self.mlp(y2), r2

    def forward_fused_core_attn_remat(self, hidden, residual, rope):
        """core_attn recompute over the fused carry: the regions of
        :meth:`forward_core_attn_remat`, with the fused kernels inside
        them, so the backward's recompute re-runs K3."""
        q, k, v, r = recompute(self._qkv_stage_fused, hidden, residual,
                               rope, n_outputs=4)
        return recompute(self._post_stage_fused, _attend(q, k, v), r,
                         n_outputs=2)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, device=device,
                                         dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype)
        # RoPE tables: derived, not weights, so outside the state dict
        self.register_buffer("rope_sin", torch.empty(
            config.max_position_embeddings, config.head_dim // 2,
            device=device), persistent=False)
        self.register_buffer("rope_cos", torch.empty_like(self.rope_sin),
                             persistent=False)

    def reset_rope(self):
        sin, cos = build_sin_cos(self.config.max_position_embeddings,
                                 self.config.head_dim,
                                 self.config.rope_theta,
                                 device=self.rope_sin.device)
        self.rope_sin.copy_(sin)
        self.rope_cos.copy_(cos)

    def forward(self, input_ids, caches=None, pos=None, tables=None,
                skip_layers=None):
        """input_ids [B, S]. Without caches: the final hidden states [B, S,
        H] of the training path. With them, a cache step returning
        ``(hidden, caches)``, the caches written in place. With
        ``tables``, a serving step over the paged pools: caches are the
        flat [k0, v0, k1, v1, ...] pools, or [k0, v0, ks0, vs0, k1, ...]
        for quantized pools (the per-layer stride is ``len(caches) //
        num_layers``); pos [B] or [B, 1] cache lengths before the chunk;
        tables ``(block_tables [B, pages], valid)`` where valid is an int
        count per slot or a bool active mask. Without ``tables``, a step
        of ``generate`` over the dense [k0, v0, ...] caches of
        ``init_kv_cache``, ``pos`` the one offset of the whole batch (an
        int or a 0-d tensor). ``skip_layers`` (with caches only: the
        self-speculative draft) lists decoder layers that pass the hidden
        state through and neither write nor read their caches."""
        b, s = input_ids.shape
        if caches is None and skip_layers:
            raise ValueError("skip_layers requires the caches "
                             "(serving) path")
        x = self.embed_tokens(input_ids)
        if caches is None:
            return self._train_stack(x, (self.rope_sin[None, :s],
                                         self.rope_cos[None, :s]))
        skip = frozenset(skip_layers or ())
        if tables is None:
            rope = rope_with_offset(self.rope_sin, self.rope_cos,
                                    slot_positions(pos, b, x.device), s)
            ctx = pos
        else:
            ctx = pos.reshape(b).to(torch.int32)
            tbl, gate = tables
            tables = (tbl.to(torch.int32), gate.to(torch.int32))
            rope = rope_with_offset(self.rope_sin, self.rope_cos, ctx, s)
        stride = len(caches) // len(self.layers)
        for i, layer in enumerate(self.layers):
            if i not in skip:
                x = layer(x, rope, caches[stride * i:stride * (i + 1)], ctx,
                          tables)
        return self.norm(x), caches

    def _train_stack(self, x, rope):
        """The decoder stack and the final norm without caches: fused
        carry or not, recomputed or not (module docstring)."""
        cfg = self.config
        remat = cfg.use_recompute and self.training
        selective = cfg.recompute_granularity in ("core_attn", "full_attn")
        interval = max(int(cfg.core_attn_interval), 1)
        fs = max(int(cfg.full_save_interval), 0)

        def how(i):
            if not remat or (fs and i % fs == fs - 1):
                return "plain"
            return "core_attn" if selective and i % interval == 0 \
                else "full"

        if flags.flag("FLAGS_fused_rmsnorm_residual"):
            hidden, residual = x, None
            for i, layer in enumerate(self.layers):
                mode = how(i)
                if mode == "plain":
                    hidden, residual = layer.forward_fused(hidden, residual,
                                                           rope)
                elif mode == "core_attn":
                    hidden, residual = layer.forward_fused_core_attn_remat(
                        hidden, residual, rope)
                else:
                    hidden, residual = recompute(layer.forward_fused, hidden,
                                                 residual, rope, n_outputs=2)
            if residual is None:
                return self.norm(hidden)
            return F.fused_rms_norm_residual(hidden, residual,
                                             self.norm.weight,
                                             self.norm.epsilon)[0]
        for i, layer in enumerate(self.layers):
            mode = how(i)
            if mode == "plain":
                x = layer(x, rope)
            elif mode == "core_attn":
                x = layer.forward_core_attn_remat(x, rope)
            else:
                x = recompute(layer, x, rope)
        return self.norm(x)


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """Causal LM. Built on ``device`` (``cuda`` unless given; raises with
    no GPU and no device) in ``dtype``, with weights drawn from
    ``torch.Generator`` seeded by ``seed``: N(0, initializer_range) for
    projections and embeddings, ones for norms. ``generate`` decodes over
    dense caches (``generation.GenerationMixin``)."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        # built on the meta device, then materialised once: no throwaway
        # default initialisation of billions of weights
        self.llama = LlamaModel(config, device="meta", dtype=dtype)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, bias=False,
            device="meta", dtype=dtype)
        self.to_empty(device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        dev = self.llama.embed_tokens.weight.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        std = self.config.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=gen)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        self.llama.reset_rope()

    def init_kv_cache(self, batch_size, max_length, dtype=None):
        """Zero dense caches for ``generate``: per layer (k, v) of [B,
        max_len, KVH, D], on the weights' device, in ``dtype`` or the
        first floating parameter's."""
        return _alloc_kv_caches(self.config, batch_size, max_length,
                                dtype or kv_cache_dtype(self),
                                self.llama.embed_tokens.weight.device)

    def _logits(self, hidden):
        if self.lm_head is None:
            return F.linear(hidden, self.llama.embed_tokens.weight)
        return self.lm_head(hidden)    # a WeightOnlyLinear once quantized

    def forward(self, input_ids, labels=None, caches=None, pos=None,
                tables=None, skip_layers=None):
        """The JAX package's signature. With ``caches``: a cache step
        (paged with ``tables``, dense without: :meth:`LlamaModel.
        forward`), ``(logits [B, S, V], caches)`` with the caches updated
        in place (no autograd: the in-place writes must not join a
        graph).
        Without: the training forward, ``logits`` or, given ``labels``,
        ``(logits, loss)`` with the loss over ``logits[:, :-1]`` against
        ``labels[:, 1:]``; ``(None, loss)`` through the fused linear+CE
        when ``FLAGS_fused_linear_cross_entropy`` is on and the
        ``lm_head`` is untied. ``skip_layers``: see
        :meth:`LlamaModel.forward` (with caches only)."""
        if caches is not None:
            with torch.no_grad():
                hidden, caches = self.llama(input_ids, caches, pos, tables,
                                            skip_layers)
                return self._logits(hidden), caches
        hidden = self.llama(input_ids, skip_layers=skip_layers)
        if (labels is not None and self.lm_head is not None
                and flags.flag("FLAGS_fused_linear_cross_entropy")):
            h2 = hidden[:, :-1].reshape(-1, self.config.hidden_size)
            loss = fused_linear_cross_entropy(h2, self.lm_head.weight.t(),
                                              labels[:, 1:].reshape(-1))
            return None, loss
        logits = self._logits(hidden)
        if labels is None:
            return logits
        return logits, _shifted_cross_entropy(logits, labels)


def _shifted_cross_entropy(logits, labels):
    vocab = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                           labels[:, 1:].reshape(-1))


class LlamaPretrainingCriterion(nn.Module):
    """Shifted next-token cross entropy: ``criterion(model(ids), ids)``
    equals the loss of ``model(ids, labels=ids)``.

    ``fuses_with_network_loss`` certifies that contract to
    ``hapi.Model``, whose compiled fit then passes the labels into the
    network and takes its fused linear+CE loss instead of materialising
    the logits."""

    fuses_with_network_loss = True

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.vocab_size = config.vocab_size

    def forward(self, logits, labels):
        return _shifted_cross_entropy(logits, labels)
