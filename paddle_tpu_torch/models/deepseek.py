"""DeepSeek-V2: Multi-head Latent Attention (MLA) with a latent KV cache,
and fine-grained MoE with shared experts.

Port of ``paddle_tpu/models/deepseek.py``: ``DeepseekV2Config`` (its
defaults are DeepSeek-V2's published width; ``tiny``), ``_mla_core`` with
its two regimes, ``DeepseekV2Attention`` (the ``q_lora_rank`` and the
``q_proj`` branches, the decoupled RoPE key, the latent cache),
``DeepseekV2MLP``, ``DeepseekV2MoE`` (``MoELayer`` times
``routed_scaling_factor``, plus the shared experts),
``DeepseekV2DecoderLayer`` and ``DeepseekV2ForCausalLM`` with
``init_kv_cache`` for ``generate``.

Kernels: RMSNorm (K1/K2) on the hidden state and on the latents of q
(``q_lora_rank`` wide) and of kv (``kv_lora_rank`` wide; the projection's
slice is made contiguous first, as K1 takes contiguous rows); under
``FLAGS_fused_rmsnorm_residual`` (on by default) the attention residual
add and the post-attention norm are one ``fused_rms_norm_residual``
(K3/K4), as in the JAX layer; the MLPs and the shared experts SwiGLU
(K5/K6); the routed experts ``MoELayer``, dropless over the grouped
matmuls (K14/K15) under ``moe_dropless``, the capacity path otherwise.

Attention: q/k heads (nope + rope) are wider than v's, which the flash
kernel does not take, so the core is the JAX package's: the exact masked
einsum with an f32 softmax for decoding and short sequences, and
``ops.ring_attention.chunked_attention`` (blockwise, no [B, H, S, S]
tensor) for training at ``Sq >= 2 * _MLA_CHUNK``. Plain PyTorch: the JAX
package computes both outside any Pallas kernel.

The decode cache is the latent: per layer ``[B, T, kv_lora_rank]``
latents and ``[B, T, 1, qk_rope_head_dim]`` rotated keys (576 values a
token and layer at the published width, against 32768 for per-head k/v),
written in place at ``pos``; every step re-expands the whole masked
latent history through ``kv_b_proj``, as the JAX package does. There is
no paged path: ``forward`` takes no ``tables`` and the serving engine
refuses the model. With ``tensor_parallel=True`` under a fleet's
``model`` group of more than one rank, the projections are the JAX
package's parallel layers (``q_a_proj`` and ``kv_a_proj_with_mqa``
row-split over a whole input, ``q_b_proj``/``q_proj`` and ``kv_b_proj``
column-split by heads, ``o_proj`` row-split), each rank holding
``num_attention_heads / mp`` heads, with the MLPs' and the shared
experts' FFN, the embedding and the head split as in ``models.llama``;
the routed experts are whole on every rank of the ``model`` group. Under
a fleet's ``expert`` group of more than one rank each rank holds its
block of the routed experts (``MoELayer``, the output scaled by
``routed_scaling_factor`` after the dispatch); the shared experts stay
replicated. A cache step of a model built so raises (ROADMAP A.7).

The state-dict keys are the JAX package's (``layers.0.self_attn.
kv_b_proj.weight``, ``layers.1.mlp.moe.w_gate``, ...).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..framework import flags
from ..generation import GenerationMixin
from ..incubate.distributed.models.moe import MoELayer
from ..incubate.recompute import recompute
from ..nn import RMSNorm
from ..nn import functional as F
from ..ops.ring_attention import chunked_attention
from ..ops.rope import build_sin_cos, rotate
from ..distributed.parallel_layers import c_identity
from ..distributed.parallel_layers import embedding as tp_embedding
from ..distributed.parallel_layers import normal_ as tp_normal_
from .llama import (_lin, _no_split_cache_step, _shifted_cross_entropy,
                    ep_world, kv_cache_dtype, rope_with_offset, slot_positions,
                    tied_logits, tp_degree)

__all__ = ["DeepseekV2Config", "DeepseekV2ForCausalLM"]


@dataclass
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 5120
    num_hidden_layers: int = 60
    num_attention_heads: int = 128
    # MLA geometry
    q_lora_rank: int | None = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # FFN / MoE geometry
    intermediate_size: int = 12288       # dense layers
    moe_intermediate_size: int = 1536    # per routed expert
    n_routed_experts: int = 160
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1       # leading dense layers
    routed_scaling_factor: float = 16.0
    norm_topk_prob: bool = False
    router_aux_loss_coef: float = 0.001
    # dropless dispatch over the grouped-matmul kernels (see
    # Qwen2MoeConfig)
    moe_dropless: bool = False
    # common
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    use_recompute: bool = False
    # the tensor-parallel layers under a fleet's model group (module
    # docstring); the plain ones without
    tensor_parallel: bool = False

    @classmethod
    def tiny(cls):
        return cls(vocab_size=256, hidden_size=64, num_hidden_layers=3,
                   num_attention_heads=4, q_lora_rank=32,
                   kv_lora_rank=16, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16,
                   intermediate_size=128, moe_intermediate_size=32,
                   n_routed_experts=8, n_shared_experts=1,
                   num_experts_per_tok=2, first_k_dense_replace=1,
                   routed_scaling_factor=1.0, norm_topk_prob=True,
                   max_position_embeddings=64)

    @property
    def qk_head_dim(self):
        return self.qk_nope_head_dim + self.qk_rope_head_dim


#: key-chunk size of the blockwise MLA path; the exact einsum is kept
#: below 2 chunks of sequence, where its one-shot matmul is cheaper
_MLA_CHUNK = 256


def _mla_core(q, k, v, causal_offset=None, valid_len=None):
    """MLA attention: q/k [B, Sq|Sk, H, Dqk], v [B, Sk, H, Dv].
    ``causal_offset`` is the absolute position of q's first row (decode:
    ``pos``; training: None, position 0) and ``valid_len`` masks the
    cache's unwritten tail (decode). Training at ``Sq >= 2 * _MLA_CHUNK``
    runs the blockwise :func:`chunked_attention`; otherwise the exact
    einsum: logits in f32 from the inputs' exact products, the causal
    (and validity) mask at -1e30, softmax in f32, probabilities cast to
    v's dtype."""
    if causal_offset is None and q.shape[1] >= 2 * _MLA_CHUNK:
        return chunked_attention(q, k, v, causal=True, chunk=_MLA_CHUNK)
    sq, sk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(q.shape[-1])
    dev = q.device
    qpos = torch.arange(sq, device=dev)
    if causal_offset is not None:
        qpos = qpos + causal_offset
    kpos = torch.arange(sk, device=dev)
    mask = kpos[None, :] <= qpos[:, None]
    if valid_len is not None:
        mask = mask & (kpos[None, :] < valid_len)
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class DeepseekV2Attention(nn.Module):
    """MLA: latent-compressed KV plus a decoupled RoPE key shared by the
    heads."""

    def __init__(self, cfg: DeepseekV2Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        h, qk, rope = cfg.num_attention_heads, cfg.qk_head_dim, \
            cfg.qk_rope_head_dim
        # this rank's heads (all of them without a model group)
        self.mp_group, self.mp_world, _ = tp_degree(cfg)
        self.num_heads = h // self.mp_world
        # the JAX package's row layers over a whole input: split here
        whole_in = dict(column=False, input_is_parallel=False, **kw)
        if cfg.q_lora_rank:
            self.q_a_proj = _lin(cfg, cfg.hidden_size, cfg.q_lora_rank,
                                 **whole_in)
            self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, cfg.rms_norm_eps,
                                         device=device, dtype=dtype)
            self.q_b_proj = _lin(cfg, cfg.q_lora_rank, h * qk, column=True,
                                 **kw)
        else:
            self.q_proj = _lin(cfg, cfg.hidden_size, h * qk, column=True,
                               **kw)
        # the latent and the shared rope key in one projection
        self.kv_a_proj_with_mqa = _lin(cfg, cfg.hidden_size,
                                       cfg.kv_lora_rank + rope, **whole_in)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps,
                                      device=device, dtype=dtype)
        self.kv_b_proj = _lin(
            cfg, cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            column=True, **kw)
        self.o_proj = _lin(cfg, h * cfg.v_head_dim, cfg.hidden_size,
                           column=False, **kw)

    def _q(self, x, rope):
        cfg = self.cfg
        b, s, _ = x.shape
        if cfg.q_lora_rank:
            q = self.q_b_proj(self.q_a_layernorm(self.q_a_proj(x)))
        else:
            q = self.q_proj(x)
        q = q.view(b, s, self.num_heads, cfg.qk_head_dim)
        q_nope, q_pe = q.split([cfg.qk_nope_head_dim,
                                cfg.qk_rope_head_dim], dim=-1)
        return torch.cat([q_nope, rotate(q_pe, *rope)], dim=-1)

    def _latent(self, x, rope):
        """(normed latent [B, S, R], rotated shared key [B, S, 1, rope])."""
        cfg = self.cfg
        b, s, _ = x.shape
        ckv = self.kv_a_proj_with_mqa(x)
        lat, k_pe = ckv.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim],
                              dim=-1)
        # K1 takes contiguous rows; the slice is a strided view
        latent = self.kv_a_layernorm(lat.contiguous())
        k_pe = k_pe.reshape(b, s, 1, cfg.qk_rope_head_dim)
        return latent, rotate(k_pe, *rope)

    def _expand_kv(self, latent, k_pe):
        """Latents [B, T, R] and rope keys [B, T, 1, rope] -> per-head keys
        [B, T, H, nope + rope] and values [B, T, H, Dv]."""
        cfg = self.cfg
        b, t, _ = latent.shape
        h = self.num_heads
        if self.mp_world > 1:
            # the shared rope key feeds this rank's heads only: its
            # gradient is summed over the model group
            k_pe = c_identity(k_pe, self.mp_group)
        kv = self.kv_b_proj(latent).view(b, t, h, cfg.qk_nope_head_dim
                                         + cfg.v_head_dim)
        k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, t, h, cfg.qk_rope_head_dim)],
                      dim=-1)
        return k, v

    def forward(self, x, rope, cache=None, pos=None):
        """Training (no cache): causal attention over positions 0..S-1.
        Decode: ``cache`` the layer's ``(latents, rope keys)``, written in
        place at ``pos`` (an int or a 0-d tensor; the start clamped to
        ``T - S``, as ``lax.dynamic_update_slice`` clamps it); returns
        ``(out, cache)``."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = self._q(x, rope)
        latent, k_pe = self._latent(x, rope)
        if cache is None:
            ctx = _mla_core(q, *self._expand_kv(latent, k_pe))
            return self.o_proj(ctx.reshape(b, s, -1))
        lat_cache, pe_cache = cache
        t = lat_cache.shape[1]
        rows = torch.arange(s, device=x.device)
        start = pos.clamp(0, t - s) if isinstance(pos, torch.Tensor) \
            else min(max(int(pos), 0), t - s)
        with torch.no_grad():
            lat_cache.index_copy_(1, start + rows,
                                  latent.to(lat_cache.dtype))
            pe_cache.index_copy_(1, start + rows, k_pe.to(pe_cache.dtype))
        k, v = self._expand_kv(lat_cache.to(x.dtype), pe_cache.to(x.dtype))
        ctx = _mla_core(q, k, v, causal_offset=pos, valid_len=pos + s)
        return self.o_proj(ctx.reshape(b, s, -1)), cache


class DeepseekV2MLP(nn.Module):
    def __init__(self, cfg, device=None, dtype=None, intermediate=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inter = intermediate or cfg.intermediate_size
        self.gate_proj = _lin(cfg, cfg.hidden_size, inter, column=True, **kw)
        self.up_proj = _lin(cfg, cfg.hidden_size, inter, column=True, **kw)
        self.down_proj = _lin(cfg, inter, cfg.hidden_size, column=False,
                              **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class DeepseekV2MoE(nn.Module):
    """Fine-grained routed experts (scaled) + always-on shared experts."""

    def __init__(self, cfg: DeepseekV2Config, device=None, dtype=None):
        super().__init__()
        self.scaling = cfg.routed_scaling_factor
        self.moe = MoELayer(
            cfg.hidden_size, cfg.moe_intermediate_size,
            cfg.n_routed_experts,
            gate={"top_k": cfg.num_experts_per_tok,
                  "norm_topk_prob": cfg.norm_topk_prob,
                  "dropless": cfg.moe_dropless},
            device=device, dtype=dtype)
        self.shared_experts = DeepseekV2MLP(
            cfg, device, dtype,
            intermediate=cfg.moe_intermediate_size * cfg.n_shared_experts)

    def forward(self, x):
        return self.moe(x) * self.scaling + self.shared_experts(x)

    @property
    def aux_loss(self):
        return self.moe.aux_loss


class DeepseekV2DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, layer_idx: int, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       **kw)
        self.self_attn = DeepseekV2Attention(cfg, device, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **kw)
        self.is_moe = layer_idx >= cfg.first_k_dense_replace
        self.mlp = DeepseekV2MoE(cfg, device, dtype) if self.is_moe \
            else DeepseekV2MLP(cfg, device, dtype)

    def forward(self, x, rope, cache=None, pos=None):
        if cache is not None:
            attn, cache = self.self_attn(self.input_layernorm(x), rope,
                                         cache, pos)
            x = x + attn
            return x + self.mlp(self.post_attention_layernorm(x)), cache
        attn = self.self_attn(self.input_layernorm(x), rope)
        if flags.flag("FLAGS_fused_rmsnorm_residual"):
            # the attention residual add and the post-attention norm as
            # one kernel, as in the JAX layer
            norm = self.post_attention_layernorm
            y, r = F.fused_rms_norm_residual(attn, x, norm.weight,
                                             norm.epsilon)
            return r + self.mlp(y)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepseekV2ForCausalLM(nn.Module, GenerationMixin):
    """Causal LM. Built on ``device`` (``cuda`` unless given; raises with
    no GPU and no device) in ``dtype``, with weights drawn from a
    ``torch.Generator`` seeded by ``seed`` as the JAX package draws them:
    N(0, initializer_range) for the projections and the embedding, ones
    for the norms, XavierNormal for the router and the expert banks.
    ``generate`` decodes over the latent caches of :meth:`init_kv_cache`.
    """

    def __init__(self, config: DeepseekV2Config, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        cfg, meta = config, "meta"
        self.mp_group, self.mp_world, _ = tp_degree(cfg)
        # built on the meta device, then materialised once
        self.embed_tokens = tp_embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=meta, dtype=dtype,
                                         enabled=cfg.tensor_parallel)
        self.layers = nn.ModuleList(
            [DeepseekV2DecoderLayer(cfg, i, meta, dtype)
             for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=meta,
                            dtype=dtype)
        self.lm_head = None if cfg.tie_word_embeddings else _lin(
            cfg, cfg.hidden_size, cfg.vocab_size, column=True,
            gather_output=True, device=meta, dtype=dtype)
        # RoPE tables of the rope head dim: derived, not weights
        # a cache step raises under expert parallelism (llama.ep_world)
        self.ep_world = ep_world(self)
        self.register_buffer("rope_sin", torch.empty(
            cfg.max_position_embeddings, cfg.qk_rope_head_dim // 2,
            device=meta), persistent=False)
        self.register_buffer("rope_cos", torch.empty_like(self.rope_sin),
                             persistent=False)
        self.to_empty(device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        dev = self.embed_tokens.weight.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        std = self.config.initializer_range
        for mod in self.modules():
            if isinstance(mod, MoELayer):
                mod.reset_parameters(gen)
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                tp_normal_(mod, std, gen)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        cfg = self.config
        sin, cos = build_sin_cos(cfg.max_position_embeddings,
                                 cfg.qk_rope_head_dim, cfg.rope_theta,
                                 device=dev)
        self.rope_sin.copy_(sin)
        self.rope_cos.copy_(cos)

    def init_kv_cache(self, batch_size, max_length, dtype=None):
        """The latent caches of ``generate``: per layer a zero ``[B,
        max_len, kv_lora_rank]`` latent and a zero ``[B, max_len, 1,
        qk_rope_head_dim]`` rope key (two tensors of different shapes),
        on the weights' device, in ``dtype`` or the first floating
        parameter's."""
        cfg = self.config
        dtype = dtype or kv_cache_dtype(self)
        dev = self.embed_tokens.weight.device
        caches = []
        for _ in range(cfg.num_hidden_layers):
            caches.append(torch.zeros(batch_size, max_length,
                                      cfg.kv_lora_rank, dtype=dtype,
                                      device=dev))
            caches.append(torch.zeros(batch_size, max_length, 1,
                                      cfg.qk_rope_head_dim, dtype=dtype,
                                      device=dev))
        return caches

    def _logits(self, hidden):
        if self.lm_head is None:
            return tied_logits(hidden, self.embed_tokens, self.mp_group)
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None, caches=None, pos=None):
        """The JAX package's signature, without ``tables`` (no paged path:
        passing block tables fails). With ``caches``: a step of
        ``generate`` over the latent caches at the batch's one offset
        ``pos``, ``(logits [B, S, V], caches)`` with the caches written
        in place (no autograd). Without: the training forward, ``logits``
        or, given ``labels``, ``(logits, loss)``: the shifted next-token
        cross entropy plus ``router_aux_loss_coef`` times each MoE
        layer's aux loss."""
        cfg = self.config
        b, s = input_ids.shape
        if caches is not None:
            _no_split_cache_step(self)
            with torch.no_grad():
                x = self.embed_tokens(input_ids)
                rope = rope_with_offset(self.rope_sin, self.rope_cos,
                                        slot_positions(pos, b, x.device), s)
                for i, layer in enumerate(self.layers):
                    x, _ = layer(x, rope, caches[2 * i:2 * i + 2], pos)
                return self._logits(self.norm(x)), caches
        if self.training and cfg.use_recompute and cfg.router_aux_loss_coef:
            raise ValueError(
                "router_aux_loss_coef > 0 with use_recompute=True is "
                "unsupported for training: the per-layer aux-loss "
                "attribute cannot cross the recompute boundary. Set "
                "router_aux_loss_coef=0.0 or use_recompute=False.")
        x = self.embed_tokens(input_ids)
        rope = (self.rope_sin[None, :s], self.rope_cos[None, :s])
        for layer in self.layers:
            if cfg.use_recompute and self.training:
                x = recompute(layer, x, rope)
            else:
                x = layer(x, rope)
        logits = self._logits(self.norm(x))
        if labels is None:
            return logits
        loss = _shifted_cross_entropy(logits, labels)
        if cfg.router_aux_loss_coef:
            for layer in self.layers:
                if layer.is_moe and layer.mlp.aux_loss is not None:
                    loss = loss + cfg.router_aux_loss_coef * \
                        layer.mlp.aux_loss
        return logits, loss
