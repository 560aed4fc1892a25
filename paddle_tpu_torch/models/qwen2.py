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
``generation.GenerationMixin``), and the pipelined
``Qwen2MoeForCausalLMPipe`` (``Qwen2MoeDecoderLayerPipe`` between the
Llama pipe's embedding and head).

Training (no caches): neox RoPE and flash attention (K7-K9); the
input norm is RMSNorm (K1/K2); under ``FLAGS_fused_rmsnorm_residual``
(on by default) only the attention residual add and the post-attention
norm are one ``fused_rms_norm_residual`` (K3/K4), as in the JAX layer.
The MoE block runs ``MoELayer`` (dropless over the grouped-matmul kernels
K14/K15 when ``moe_dropless``), the MLPs SwiGLU (K5/K6). A dense stack
with ``scan_layers`` (on by default) runs through ``nn.scan.scan_layers``
over the same layers, as the JAX package scans it; a MoE stack, or
``scan_layers=False``, is the plain loop. Either way ``use_recompute``
recomputes whole layers, every ``full_save_interval``-th one excepted
(under the scan only where it tiles the depth, else with the JAX
package's warning). The loss is over the full shifted logits, plus
``router_aux_loss_coef`` times each MoE layer's aux loss.

Context parallelism (``sep_parallel`` under a fleet's ``sep`` group of
more than one rank) is Llama's (``models.llama``): each rank's chunk at
its global RoPE positions, attention through ``context_parallel``, the
shifted loss over the whole sequence. The MoE block runs unchanged on
the rank's tokens (routing is per token); its aux loss and a capacity
dispatch's capacity are over the rank's tokens, as over a pipeline
microbatch's, so the unpartitioned run is matched with dropless dispatch
and the aux loss folded out (the rank's aux losses are averaged over the
group otherwise).

Expert parallelism (a fleet's ``expert`` group of more than one rank,
alone or with ``model``, ``data`` or ``pipe``): each MoE layer holds its
rank's block of experts and dispatches over the group
(``MoELayer``); everything else, the shared expert and its gate
included, is replicated over ``expert``. A cache step (serving,
``generate``) of a model built so raises (ROADMAP A.7).

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

import functools

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
from ..nn.scan import can_scan, scan_layers
from ..ops.rope import build_sin_cos, rotate
from ..distributed.parallel_layers import embedding as tp_embedding
from ..distributed.parallel_layers import normal_ as tp_normal_
from .llama import (LlamaAttention, LlamaEmbeddingPipe, LlamaHeadPipe,
                    LlamaMLP, LlamaPretrainingCriterion, _alloc_kv_caches,
                    _lin, _no_split_cache_step, check_parallel, check_pipe,
                    check_weight_quant, ep_world, kv_cache_dtype, pipe_key,
                    pipe_rope, rope_with_offset, sep_attend, sep_loss,
                    sep_rope_of, slot_positions, tied_logits, tp_degree)

__all__ = ["Qwen2Config", "Qwen2MoeConfig", "Qwen2ForCausalLM",
           "Qwen2MoeForCausalLM", "Qwen2MoePretrainingCriterion",
           "Qwen2MoeDecoderLayerPipe", "Qwen2MoeForCausalLMPipe"]


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
    # the tensor-parallel layers under a fleet's model group of more than
    # one rank (models.llama); context parallelism goes with ROADMAP A.7
    # and raises (check_qwen2_parallel)
    tensor_parallel: bool = False
    sep_parallel: str | None = None
    # the dense training stack through nn.scan.scan_layers (MoE stacks
    # never scan); the same layers either way here (module docstring)
    scan_layers: bool = True
    # every k-th layer is not recomputed at all; 0 = off
    full_save_interval: int = 0
    # weight-only serving quantization: see LlamaConfig
    weight_quant: str | None = None

    def __post_init__(self):
        check_weight_quant(self.weight_quant)
        check_qwen2_parallel(self)

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


def check_qwen2_parallel(cfg):
    """``sep_parallel`` is None, ``ring``, ``ulysses`` or ``allgather``;
    another name raises ``ValueError``."""
    check_parallel(cfg)


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
        ctx_ = sep_attend(self.self_attn.cfg, rotate(q, sin, cos),
                          rotate(k, sin, cos), v)
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


@torch.no_grad()
def init_qwen2_weights(module, gen, std):
    """Every weight under ``module`` from ``gen``, in ``modules()`` order,
    as the JAX package draws them (``_Qwen2Base``'s docstring)."""
    mods = list(module.modules())
    # the shared-expert gate keeps nn.Linear's default init in the JAX
    # package: XavierNormal over its [H, 1] weight
    gates = {id(m.shared_expert_gate) for m in mods
             if isinstance(m, Qwen2MoeBlock)}
    for mod in mods:
        if id(mod) in gates:
            mod.weight.normal_(0.0, xavier_normal_std(
                mod.weight.shape[::-1]), generator=gen)
        elif isinstance(mod, MoELayer):
            mod.reset_parameters(gen)
        elif isinstance(mod, (nn.Linear, nn.Embedding)):
            tp_normal_(mod, std, gen)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)


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
        check_qwen2_parallel(config)
        self.config = config
        self._moe = moe
        cfg, meta = config, "meta"
        self.mp_group, self.mp_world, _ = tp_degree(cfg)
        # built on the meta device, then materialised once
        self.embed_tokens = tp_embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=meta, dtype=dtype,
                                         enabled=cfg.tensor_parallel)
        self.layers = nn.ModuleList(
            [Qwen2DecoderLayer(cfg, moe, meta, dtype)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=meta,
                            dtype=dtype)
        self.lm_head = None if cfg.tie_word_embeddings else _lin(
            cfg, cfg.hidden_size, cfg.vocab_size, column=True,
            gather_output=True, device=meta, dtype=dtype)
        # RoPE tables: derived, not weights, so outside the state dict
        # a cache step raises under expert parallelism (llama.ep_world)
        self.ep_world = ep_world(self)
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
        init_qwen2_weights(self, gen, self.config.initializer_range)
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
            return tied_logits(hidden, self.embed_tokens, self.mp_group)
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
            _no_split_cache_step(self)
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
        rope = sep_rope_of(cfg, self.rope_sin, self.rope_cos, s, x.device)
        remat = cfg.use_recompute and self.training
        # MoE stacks never scan: each layer's aux loss is read after the
        # stack, as in the JAX package
        if cfg.scan_layers and not self._moe and can_scan(self.layers):
            x = scan_layers(self.layers, x, (rope,), remat=remat,
                            full_save_interval=cfg.full_save_interval)
        else:
            fs = max(int(cfg.full_save_interval), 0)
            for i, layer in enumerate(self.layers):
                if remat and not (fs and i % fs == fs - 1):
                    x = recompute(layer, x, rope)
                else:
                    x = layer(x, rope)
        logits = self._logits(self.norm(x))
        if labels is None:
            return logits
        extras = []
        if self._moe and cfg.router_aux_loss_coef:
            for layer in self.layers:
                aux = layer.mlp.aux_loss
                if aux is not None:
                    extras.append(cfg.router_aux_loss_coef * aux)
        return logits, sep_loss(cfg, logits, labels, extras)


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


# ---- the pipeline: the JAX package's Qwen2-MoE pipe model ------------------
# The prologue and epilogue are the Llama pipe's (they read only fields
# Qwen2MoeConfig shares with LlamaConfig); the loss is the plain shifted
# cross entropy: the router's aux loss, an attribute of each MoE layer,
# does not cross a stage, so a pipelined MoE trains with it folded out
# (router_aux_loss_coef 0; load balance still trains through the
# dispatch gradient), as in the JAX package.


class Qwen2MoeDecoderLayerPipe(Qwen2DecoderLayer):
    """MoE decoder layer ``layer_idx`` of the pipeline over one tensor;
    under ``use_recompute`` it recomputes whole, as the unpartitioned
    stack does (``handles_recompute``)."""

    handles_recompute = True

    def __init__(self, cfg, layer_idx, device=None, dtype=None):
        super().__init__(cfg, True, device, dtype)
        self.config = cfg
        self.layer_idx = layer_idx

    def _layer(self, x, rope):
        return Qwen2DecoderLayer.forward(self, x, rope)

    def forward(self, x):
        cfg = self.config
        rope = pipe_rope(cfg, x)
        fs = max(int(cfg.full_save_interval), 0)
        if cfg.use_recompute and self.training and not (
                fs and self.layer_idx % fs == fs - 1):
            return recompute(self._layer, x, rope)
        return self._layer(x, rope)


def Qwen2MoeForCausalLMPipe(config, device=None, dtype=torch.float32, seed=0,
                            **pipeline_kwargs):
    """The pipelined Qwen2-MoE as a ``PipelineLayer`` (the embedding, the
    MoE decoder layers, the norm with the head; under ep > 1 each stage
    rank's MoE layers hold its block of experts); weights from ``seed``
    as ``Qwen2MoeForCausalLM(config, seed=seed)`` draws them;
    ``key_map`` maps its state-dict keys to the layer's."""
    from ..distributed.fleet.meta_parallel import LayerDesc, PipelineLayer
    check_pipe(config)
    n = config.num_hidden_layers
    descs = [LayerDesc(LlamaEmbeddingPipe, config)] + \
        [LayerDesc(Qwen2MoeDecoderLayerPipe, config, i) for i in range(n)] \
        + [LayerDesc(LlamaHeadPipe, config)]
    pipeline_kwargs.setdefault("loss_fn",
                               Qwen2MoePretrainingCriterion(config))
    pipeline_kwargs.setdefault(
        "recompute_interval", 1 if config.use_recompute else 0)
    pipeline_kwargs.setdefault("seg_method", "layer:Qwen2DecoderLayer")
    pipe = PipelineLayer(descs, device=device, dtype=dtype,
                         **pipeline_kwargs)
    pipe.key_map = functools.partial(pipe_key, n, "")
    pipe.reset_parameters(seed, functools.partial(
        init_qwen2_weights, std=config.initializer_range))
    return pipe
