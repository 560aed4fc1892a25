"""Qwen2 (dense) and Qwen2-MoE for training, for ``generate`` over a
dense KV cache and for serving over paged KV pools.

Port of ``paddle_tpu/models/qwen2.py``: ``Qwen2Config`` (``qwen2_7b``,
``tiny``), ``Qwen2MoeConfig`` (``qwen2_moe_a14b``, ``tiny``),
``Qwen2Attention`` (QKV with bias), ``Qwen2MLP``, ``Qwen2MoeBlock``
(routed experts plus a shared expert scaled by a sigmoid gate),
``Qwen2DecoderLayer``, the base model with its recompute dose and router
aux loss, ``Qwen2ForCausalLM``, ``Qwen2MoeForCausalLM`` and
``Qwen2MoePretrainingCriterion``, and ``init_kv_cache`` with the dense
cache branch of the forward (``generate``, through
``generation.GenerationMixin``). The pipeline variants are not ported.

Training (no caches): neox RoPE and flash attention (K7-K9); the
input norm is RMSNorm (K1/K2); under ``FLAGS_fused_rmsnorm_residual``
(on by default) only the attention residual add and the post-attention
norm are one ``fused_rms_norm_residual`` (K3/K4), as in the JAX layer.
The MoE block runs ``MoELayer`` (dropless over the grouped-matmul kernels
K14/K15 when ``moe_dropless``), the MLPs SwiGLU (K5/K6). The stack is
unrolled (the JAX dense stack's ``scan_layers`` gives the same numbers);
``use_recompute`` recomputes whole layers, every ``full_save_interval``-th
one excepted. The loss is over the full shifted logits, plus
``router_aux_loss_coef`` times each MoE layer's aux loss.

Serving (caches, ``tables``): the paged step of ``models.llama`` (K12,
or K13 over quantized pools), the unfused stack. ``generate`` (caches,
no ``tables``): the same stack over dense caches, attention through
``nn.functional.sdpa_with_cache`` (plain ops: XLA in the JAX package),
the MoE block through ``MoELayer`` (K14 when dropless). The state-dict keys are
the JAX package's (``layers.0.self_attn.q_proj.bias``,
``layers.0.mlp.moe.w_gate``, ...).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..framework import flags
from ..generation import GenerationMixin
from ..incubate.distributed.models.moe import MoELayer
from ..incubate.distributed.models.moe.moe_layer import xavier_normal_std
from ..incubate.recompute import recompute
from ..nn import Linear, RMSNorm
from ..nn import functional as F
from ..ops.rope import build_sin_cos, rotate
from .llama import (LlamaAttention, LlamaMLP, LlamaPretrainingCriterion,
                    _alloc_kv_caches, _shifted_cross_entropy,
                    check_weight_quant, kv_cache_dtype, rope_with_offset,
                    slot_positions)

__all__ = ["Qwen2Config", "Qwen2MoeConfig", "Qwen2ForCausalLM",
           "Qwen2MoeForCausalLM", "Qwen2MoePretrainingCriterion"]


@dataclass
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 3584
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    intermediate_size: int = 18944
    max_position_embeddings: int = 32768
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    use_recompute: bool = False
    # every k-th layer is not recomputed at all; 0 = off
    full_save_interval: int = 0
    # weight-only serving quantization: see LlamaConfig
    weight_quant: str | None = None

    def __post_init__(self):
        check_weight_quant(self.weight_quant)

    @classmethod
    def qwen2_7b(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2,
                   intermediate_size=128, max_position_embeddings=128,
                   rope_theta=10000.0)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


@dataclass
class Qwen2MoeConfig(Qwen2Config):
    num_experts: int = 60
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    norm_topk_prob: bool = False
    router_aux_loss_coef: float = 0.001
    capacity_factor: float = 2.0
    # dropless dispatch over the grouped-matmul kernels: no capacity, no
    # token drops, at most E * 128 padding rows
    moe_dropless: bool = False

    @classmethod
    def qwen2_moe_a14b(cls):
        return cls(hidden_size=3584, num_hidden_layers=28,
                   num_attention_heads=28, num_key_value_heads=4)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2,
                   intermediate_size=128, max_position_embeddings=128,
                   rope_theta=10000.0, num_experts=8,
                   num_experts_per_tok=2, moe_intermediate_size=32,
                   shared_expert_intermediate_size=64)


class Qwen2Attention(LlamaAttention):
    """Llama's GQA attention with QKV bias; cache steps go through
    ``forward`` (paged or dense), training through the decoder layer."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__(cfg, device, dtype, qkv_bias=True)


Qwen2MLP = LlamaMLP


class Qwen2MoeBlock(nn.Module):
    """Routed experts plus the shared expert under a sigmoid gate."""

    def __init__(self, cfg: Qwen2MoeConfig, device=None, dtype=None):
        super().__init__()
        self.moe = MoELayer(
            cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts,
            gate={"top_k": cfg.num_experts_per_tok,
                  "capacity_factor": cfg.capacity_factor,
                  "norm_topk_prob": cfg.norm_topk_prob,
                  "dropless": cfg.moe_dropless},
            device=device, dtype=dtype)
        self.shared_expert = Qwen2MLP(
            cfg, device, dtype,
            intermediate=cfg.shared_expert_intermediate_size)
        self.shared_expert_gate = Linear(cfg.hidden_size, 1, bias=False,
                                         device=device, dtype=dtype)

    def forward(self, x):
        routed = self.moe(x)
        shared = self.shared_expert(x)
        gate = torch.sigmoid(self.shared_expert_gate(x))
        return routed + gate * shared

    @property
    def aux_loss(self):
        return self.moe.aux_loss


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, cfg, moe=False, device=None, dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device=device, dtype=dtype)
        self.self_attn = Qwen2Attention(cfg, device, dtype)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, device=device, dtype=dtype)
        self.mlp = Qwen2MoeBlock(cfg, device, dtype) if moe else Qwen2MLP(
            cfg, device, dtype)

    def forward(self, x, rope, cache=None, ctx=None, tables=None):
        if cache is not None:
            x = x + self.self_attn(self.input_layernorm(x), rope, cache, ctx,
                                   tables)
            return x + self.mlp(self.post_attention_layernorm(x))
        b, s, _ = x.shape
        q, k, v = self.self_attn._proj(self.input_layernorm(x))
        sin, cos = rope
        ctx_ = F.scaled_dot_product_attention(
            rotate(q, sin, cos), rotate(k, sin, cos), v, is_causal=True)
        attn = self.self_attn.o_proj(ctx_.reshape(b, s, -1))
        if flags.flag("FLAGS_fused_rmsnorm_residual"):
            # the attention residual add and the post-attention norm as one
            # kernel; the input norm stays plain, as in the JAX layer
            norm = self.post_attention_layernorm
            y, r = F.fused_rms_norm_residual(attn, x, norm.weight,
                                             norm.epsilon)
            return r + self.mlp(y)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x))


class _Qwen2Base(nn.Module, GenerationMixin):
    """The decoder stack with the LM head. Built on ``device`` (``cuda``
    unless given; raises with no GPU and no device) in ``dtype``, with
    weights drawn from a ``torch.Generator`` seeded by ``seed`` as the
    JAX package draws them: N(0, initializer_range) for the projections
    and embeddings, zeros for biases, ones for norms, XavierNormal for
    the router, the expert banks and the shared-expert gate."""

    def __init__(self, config, moe, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self._moe = moe
        cfg, meta = config, "meta"
        # built on the meta device, then materialised once
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=meta, dtype=dtype)
        self.layers = nn.ModuleList(
            [Qwen2DecoderLayer(cfg, moe, meta, dtype)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=meta,
                            dtype=dtype)
        self.lm_head = None if cfg.tie_word_embeddings else Linear(
            cfg.hidden_size, cfg.vocab_size, bias=False, device=meta,
            dtype=dtype)
        # RoPE tables: derived, not weights, so outside the state dict
        self.register_buffer("rope_sin", torch.empty(
            cfg.max_position_embeddings, cfg.head_dim // 2, device=meta),
            persistent=False)
        self.register_buffer("rope_cos", torch.empty_like(self.rope_sin),
                             persistent=False)
        self.to_empty(device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        gen = torch.Generator(device=self.embed_tokens.weight.device)
        gen.manual_seed(int(seed))
        std = self.config.initializer_range
        # the shared-expert gate keeps nn.Linear's default init in the JAX
        # package: XavierNormal over its [H, 1] weight
        gates = {id(m.shared_expert_gate) for m in self.modules()
                 if isinstance(m, Qwen2MoeBlock)}
        for mod in self.modules():
            if id(mod) in gates:
                mod.weight.normal_(0.0, xavier_normal_std(
                    mod.weight.shape[::-1]), generator=gen)
            elif isinstance(mod, MoELayer):
                mod.reset_parameters(gen)
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        sin, cos = build_sin_cos(self.config.max_position_embeddings,
                                 self.config.head_dim, self.config.rope_theta,
                                 device=self.rope_sin.device)
        self.rope_sin.copy_(sin)
        self.rope_cos.copy_(cos)

    def init_kv_cache(self, batch_size, max_length, dtype=None):
        """Zero dense caches for ``generate``: per layer (k, v) of [B,
        max_len, KVH, D], on the weights' device, in ``dtype`` or the
        first floating parameter's."""
        return _alloc_kv_caches(self.config, batch_size, max_length,
                                dtype or kv_cache_dtype(self),
                                self.embed_tokens.weight.device)

    def _logits(self, hidden):
        if self.lm_head is None:
            return F.linear(hidden, self.embed_tokens.weight)
        return self.lm_head(hidden)    # a WeightOnlyLinear once quantized

    def forward(self, input_ids, labels=None, caches=None, pos=None,
                tables=None):
        """The JAX package's signature. With ``caches`` and ``tables``: a
        paged serving step, ``(logits [B, S, V], caches)`` with the flat
        [k0, v0, k1, v1, ...] pools (or [k0, v0, ks0, vs0, ...] for
        quantized ones) written in place (no autograd). With ``caches``
        and no ``tables``: a step of ``generate`` over the dense caches
        of :meth:`init_kv_cache` at the batch's one offset ``pos`` (an
        int or a 0-d tensor), written in place. Without caches: the
        training forward, ``logits`` or, given ``labels``, ``(logits,
        loss)``."""
        cfg = self.config
        if self._moe and self.training and cfg.use_recompute \
                and cfg.router_aux_loss_coef:
            raise ValueError(
                "router_aux_loss_coef > 0 with use_recompute=True is "
                "unsupported for training: the per-layer aux-loss "
                "attribute cannot cross the recompute boundary. Set "
                "router_aux_loss_coef=0.0 or use_recompute=False.")
        b, s = input_ids.shape
        if caches is not None:
            with torch.no_grad():
                x = self.embed_tokens(input_ids)
                if tables is None:
                    rope = rope_with_offset(
                        self.rope_sin, self.rope_cos,
                        slot_positions(pos, b, x.device), s)
                    ctx = pos
                else:
                    ctx = pos.reshape(b).to(torch.int32)
                    tbl, gate = tables
                    tables = (tbl.to(torch.int32), gate.to(torch.int32))
                    rope = rope_with_offset(self.rope_sin, self.rope_cos,
                                            ctx, s)
                # 2 pools a layer, or 4 with the scales of quantized ones
                stride = len(caches) // len(self.layers)
                for i, layer in enumerate(self.layers):
                    x = layer(x, rope, caches[stride * i:stride * (i + 1)],
                              ctx, tables)
                return self._logits(self.norm(x)), caches
        x = self.embed_tokens(input_ids)
        rope = (self.rope_sin[None, :s], self.rope_cos[None, :s])
        fs = max(int(cfg.full_save_interval), 0)
        for i, layer in enumerate(self.layers):
            if cfg.use_recompute and self.training \
                    and not (fs and i % fs == fs - 1):
                x = recompute(layer, x, rope)
            else:
                x = layer(x, rope)
        logits = self._logits(self.norm(x))
        if labels is None:
            return logits
        loss = _shifted_cross_entropy(logits, labels)
        if self._moe and cfg.router_aux_loss_coef:
            for layer in self.layers:
                aux = layer.mlp.aux_loss
                if aux is not None:
                    loss = loss + cfg.router_aux_loss_coef * aux
        return logits, loss


class Qwen2ForCausalLM(_Qwen2Base):
    def __init__(self, config: Qwen2Config, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__(config, False, device, dtype, seed)


class Qwen2MoeForCausalLM(_Qwen2Base):
    def __init__(self, config: Qwen2MoeConfig, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__(config, True, device, dtype, seed)


# the shifted next-token CE, as the JAX package aliases the Llama one
Qwen2MoePretrainingCriterion = LlamaPretrainingCriterion
