"""Llama for training, for ``generate`` over a dense KV cache and for
serving over paged KV pools.

Port of ``paddle_tpu/models/llama.py``: ``LlamaConfig`` (the ``tiny``,
``llama_1b``, ``llama_2_4b``, ``llama3_8b`` and ``llama3_70b`` presets,
the recompute fields, ``scan_layers``), the dense training path and both
cache paths of ``LlamaAttention``/``LlamaMLP``/``LlamaDecoderLayer``/
``LlamaModel``/``LlamaForCausalLM``, ``LlamaPretrainingCriterion``,
``rope_with_offset``,
``_alloc_kv_caches``/``init_kv_cache`` and ``_paged_attention_step``
(bf16/f32 pools, and int8/fp8 pools with their scales).

Caches without ``tables`` are the dense [B, max_len, KVH, D] caches of
``generate`` (``generation.GenerationMixin``): RoPE at ``pos + [0..S)``
and ``nn.functional.sdpa_with_cache``, a scalar ``pos`` for the whole
batch. Caches with ``tables`` are the engine's paged pools.

Training (no caches): ``model(ids, labels=ids)`` returns ``(logits,
loss)``, the shifted next-token cross entropy, and ``loss.backward()``
runs torch autograd through the kernels' autograd formulas.

With ``scan_layers`` (on by default, as in the JAX package) the stack
runs through ``nn.scan.scan_layers``: each layer's unfused forward over a
single tensor (RMSNorm K1/K2, no fused residual), and with
``use_recompute`` whole layers recomputed, every ``full_save_interval``-
th one saved whole; ``recompute_granularity`` other than ``full`` is
ignored there, with the JAX package's warning. The JAX bench's sections
set ``scan_layers=False``, and so does ``llama_2_4b``. The unrolled stack
(``scan_layers=False``):

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

Tensor parallelism: under a ``fleet`` whose ``model`` group has more than
one rank and ``tensor_parallel`` (on by default, as in the JAX package),
the projections, the embedding and the ``lm_head`` are the parallel
layers of ``distributed.parallel_layers`` (``_lin``, the JAX package's):
each rank holds ``num_attention_heads / mp`` query and
``num_key_value_heads / mp`` KV heads, ``intermediate_size / mp`` FFN
columns and ``vocab_size / mp`` rows of the embedding and the head, all
drawn from the seed as the unsplit model draws them
(``parallel_layers.normal_``), so the sharded run computes the
single-device model. The labelled loss with
``FLAGS_fused_linear_cross_entropy`` is the vocab-parallel fused CE.
``sequence_parallel`` keeps the residual stream split on the sequence
over the ``model`` group (Megatron SP: ``ScatterOp`` after the
embedding, the sequence-parallel linears, ``GatherOp`` after the final
norm, the norms' gradients all-reduced); it takes the unfused stack and
no selective recompute, as in the JAX package. A degree that does not
divide the heads, the FFN or the vocab raises; so does a cache step
(serving, ``generate``) of a split model. Without such a group every
layer is the plain one, and the model computes as without a fleet.

Context parallelism: with ``sep_parallel`` (``ring``, ``ulysses`` or
``allgather``) under a fleet whose ``sep`` group has more than one rank,
each rank runs its own chunk of the sequence
(``fleet.meta_parallel.split_inputs_sequence_dim``, contiguous): RoPE at
the chunk's global positions, the attention through
``context_parallel.sep_attention`` (Ulysses' local attention is the
flash kernels), and with ``labels`` the loss of the unpartitioned model,
the shifted mean over the whole sequence
(``context_parallel.sep_shifted_cross_entropy``: each rank's rows with
the next rank's first label, summed over the group; the head's work and
its logits stay at S_local a rank, which an all-gather of the hidden
states would multiply by the degree). As in the JAX package the stack is
then the unfused one with no selective recompute (no K3/K4), set by the
config whatever the degree; a cache step under such a group raises.

The pipeline (``fleet.meta_parallel``): ``LlamaForCausalLMPipe`` is the
JAX package's ``PipelineLayer`` of ``LlamaEmbeddingPipe``, one
``LlamaDecoderLayerPipe`` a decoder layer (the unrolled stack's layer,
the fused carry's ``(hidden, residual)`` pair handed on from layer to
layer and stage to stage) and ``LlamaHeadPipe``; a stage rank builds
only its own layers, with the weights the same seed gives
``LlamaForCausalLM``.

Attribute names match the JAX package, so the state-dict keys do
(``llama.layers.0.self_attn.q_proj.weight``, ...); ``torch.nn.Linear``
holds its weight as [out, in] where Paddle holds [in, out], which
``paddle_tpu_torch.convert`` accounts for.
"""

from __future__ import annotations

import functools
import re
import warnings
from dataclasses import dataclass

import torch
from torch import nn
from torch.overrides import TorchFunctionMode

from ..device import resolve_device
from ..distributed.parallel_layers import (ColumnParallelLinear,
                                           c_identity, gather_dim, mp_info)
from ..distributed.parallel_layers import embedding as tp_embedding
from ..distributed.parallel_layers import linear as tp_linear
from ..distributed.parallel_layers import normal_ as tp_normal_
from ..framework import flags
from ..generation import GenerationMixin
from ..incubate.recompute import recompute
from ..nn import RMSNorm
from ..nn import functional as F
from ..nn.scan import can_scan, scan_layers
from ..ops import paged_attention as PA
from ..ops.fused_ce import fused_linear_cross_entropy
from ..ops.rope import build_sin_cos, rotate

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "rope_with_offset",
           "LlamaEmbeddingPipe", "LlamaDecoderLayerPipe", "LlamaHeadPipe",
           "LlamaForCausalLMPipe"]


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
    # the tensor-parallel layers under a fleet's model group of more than
    # one rank; the plain layers without one (either value)
    tensor_parallel: bool = True
    # context parallelism over the fleet's sep group: None | "ring" |
    # "ulysses" | "allgather" (check_parallel); the stack is then unfused
    sep_parallel: str | None = None
    # Megatron sequence parallelism over the model group (module
    # docstring); no effect without one
    sequence_parallel: bool = False
    # the training stack through nn.scan.scan_layers: the single-tensor
    # carry (K1/K2), whole layers recomputed in full_save_interval groups;
    # False unrolls it (the fused carry, selective recompute)
    scan_layers: bool = True
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
        check_parallel(self)

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
    def llama_2_4b(cls):
        """The JAX bench's other headline training configuration (2.4B
        parameters: hidden 2560, 32 layers, 20 heads over 4 KV heads, FFN
        6912), with ``core_attn`` recompute on every second layer and the
        unrolled stack."""
        return cls(vocab_size=32000, hidden_size=2560,
                   num_hidden_layers=32, num_attention_heads=20,
                   num_key_value_heads=4, intermediate_size=6912,
                   max_position_embeddings=4096, rope_theta=10000.0,
                   use_recompute=True, recompute_granularity="core_attn",
                   core_attn_interval=2, scan_layers=False)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2,
                   intermediate_size=128, max_position_embeddings=128,
                   rope_theta=10000.0)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def check_parallel(cfg):
    """``sep_parallel`` is None or one of the context-parallel
    implementations (``ring``, ``ulysses``, ``allgather``); another name
    raises, as the JAX package's ``sep_attention`` does."""
    impl = getattr(cfg, "sep_parallel", None)
    if impl is None:
        return
    from ..distributed.fleet.meta_parallel.context_parallel import SEP_IMPLS
    if impl not in SEP_IMPLS:
        raise ValueError(f"unknown sep impl {impl!r}: sep_parallel is "
                         f"None or one of {SEP_IMPLS}")


def sep_of(cfg):
    """The fleet's ``sep`` group when ``cfg.sep_parallel`` is set and the
    group has more than one rank, else None (full attention)."""
    if getattr(cfg, "sep_parallel", None) is None:
        return None
    from ..distributed.fleet.meta_parallel.context_parallel import \
        sep_group
    return sep_group()


def sep_rope_of(cfg, sin_tab, cos_tab, s, device):
    """(sin, cos) [1, s, D/2] of a training forward over ``s`` tokens:
    positions 0..s-1, or under a sep group the rank's global positions
    (tables of the global length built where ``sin_tab`` is shorter)."""
    group = sep_of(cfg)
    if group is None:
        return sin_tab[None, :s], cos_tab[None, :s]
    from ..distributed.fleet.meta_parallel.context_parallel import sep_rope
    return sep_rope(sin_tab, cos_tab, s, group, build=lambda n: _rope_tables(
        n, cfg.head_dim, cfg.rope_theta, str(device)))


def sep_attend(cfg, q, k, v):
    """Causal attention of the training path: ``_attend``, or under a sep
    group ``context_parallel.sep_attention`` by ``cfg.sep_parallel``."""
    if sep_of(cfg) is None:
        return _attend(q, k, v)
    from ..distributed.fleet.meta_parallel.context_parallel import \
        sep_attention
    return sep_attention(q, k, v, causal=True, impl=cfg.sep_parallel)


def sep_loss(cfg, logits, labels, extras=()):
    """The shifted cross entropy plus each of ``extras`` in turn: over
    the whole sequence under a sep group (``sep_shifted_cross_entropy``,
    the extras' sum averaged over the group), else over the given
    one."""
    group = sep_of(cfg)
    if group is None:
        loss = _shifted_cross_entropy(logits, labels)
        for e in extras:
            loss = loss + e
        return loss
    from ..distributed.fleet.meta_parallel.context_parallel import \
        sep_shifted_cross_entropy
    return sep_shifted_cross_entropy(logits, labels, group,
                                     extra=sum(extras) if extras else None)


def tp_degree(cfg):
    """``(group, world, rank)`` of the model-parallel group the model
    splits over: the fleet's when ``tensor_parallel`` is on, else none.
    Raises for a degree that does not divide the heads, and for
    ``sequence_parallel`` without ``tensor_parallel``."""
    group, world, rank = mp_info()
    if world > 1 and not getattr(cfg, "tensor_parallel", False):
        if getattr(cfg, "sequence_parallel", False):
            raise ValueError("sequence_parallel=True needs "
                             "tensor_parallel=True under a model group")
        return None, 1, 0
    heads = [("num_attention_heads", cfg.num_attention_heads)]
    if hasattr(cfg, "num_key_value_heads"):
        heads.append(("num_key_value_heads", cfg.num_key_value_heads))
    for name, n in heads:
        if n % world:
            raise ValueError(f"{name} ({n}) is not divisible by the "
                             f"model-parallel degree {world}")
    return group, world, rank


def _lin(cfg, in_f, out_f, *, column, bias=False, gather_output=False,
         input_is_parallel=True, device=None, dtype=None):
    """The JAX package's ``_lin``: the plain ``Linear``, or the column or
    row parallel layer under a model group (sequence-parallel under
    ``sequence_parallel``, except a gathered output)."""
    return tp_linear(in_f, out_f, column=column, bias=bias,
                     gather_output=gather_output,
                     input_is_parallel=input_is_parallel,
                     sequence_parallel=getattr(cfg, "sequence_parallel",
                                               False) and not gather_output,
                     device=device, dtype=dtype,
                     enabled=getattr(cfg, "tensor_parallel", False))


def ep_world(model) -> int:
    """The largest expert-parallel degree of ``model``'s MoE layers (1
    without any)."""
    from ..incubate.distributed.models.moe import MoELayer
    return max((m.ep for m in model.modules() if isinstance(m, MoELayer)),
               default=1)


def _no_split_cache_step(model):
    if getattr(model, "ep_world", 1) > 1:
        raise NotImplementedError(
            "a cache step (serving, generate) of a model built under "
            "expert parallelism (ep_degree > 1) is not ported: the JAX "
            "engine serves one device (ROADMAP A.7); build the model "
            "without an ep fleet to serve it")
    if model.mp_world > 1:
        raise NotImplementedError(
            "a cache step (serving, generate) of a tensor-parallel model "
            "is not ported (ROADMAP A.7); build the model without a "
            "model-parallel fleet to serve it")
    if sep_of(model.config) is not None:
        raise NotImplementedError(
            "a cache step (serving, generate) under context parallelism "
            "(sep_parallel with a sep group of more than one rank): the "
            "JAX package has no such path (ROADMAP A.7); serve the model "
            "without a sep fleet")


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
        _, world, _ = tp_degree(cfg)
        # this rank's heads (all of them without a model group)
        self.num_heads = cfg.num_attention_heads // world
        self.num_kv_heads = cfg.num_key_value_heads // world
        self.head_dim = cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        h, d = cfg.hidden_size, self.head_dim
        nh, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
        self.q_proj = _lin(cfg, h, nh * d, column=True, bias=qkv_bias, **kw)
        self.k_proj = _lin(cfg, h, kvh * d, column=True, bias=qkv_bias, **kw)
        self.v_proj = _lin(cfg, h, kvh * d, column=True, bias=qkv_bias, **kw)
        self.o_proj = _lin(cfg, nh * d, h, column=False, **kw)

    def _proj(self, x):
        # the sequence from the projections' output: a sequence-parallel
        # projection gathers it
        b = x.shape[0]
        return (self.q_proj(x).view(b, -1, self.num_heads, self.head_dim),
                self.k_proj(x).view(b, -1, self.num_kv_heads, self.head_dim),
                self.v_proj(x).view(b, -1, self.num_kv_heads, self.head_dim))

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
        kw = dict(device=device, dtype=dtype)
        h, i = cfg.hidden_size, intermediate or cfg.intermediate_size
        self.gate_proj = _lin(cfg, h, i, column=True, **kw)
        self.up_proj = _lin(cfg, h, i, column=True, **kw)
        self.down_proj = _lin(cfg, i, h, column=False, **kw)

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
        return self._post_stage(x, sep_attend(self.self_attn.cfg,
                                              *self._qkv_stage(x, rope)))

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
        x = x + self.self_attn.o_proj(ctx.flatten(2))
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
        y2, r2 = self._norm_pair(self.post_attention_layernorm,
                                 self.self_attn.o_proj(ctx.flatten(2)), r)
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
        self.mp_group, self.mp_world, _ = tp_degree(config)
        self.sequence_parallel = config.sequence_parallel and \
            self.mp_world > 1
        self.embed_tokens = tp_embedding(
            config.vocab_size, config.hidden_size, device=device,
            dtype=dtype, enabled=config.tensor_parallel)
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
            return self._train_stack(x, sep_rope_of(
                self.config, self.rope_sin, self.rope_cos, s, x.device))
        _no_split_cache_step(self)
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
        """The decoder stack and the final norm without caches: scanned,
        or unrolled with the fused carry or not, recomputed or not (module
        docstring)."""
        if self.sequence_parallel:
            from ..distributed.fleet.utils.sequence_parallel_utils import (
                GatherOp, ScatterOp)
            if x.shape[1] % self.mp_world:
                raise ValueError(
                    f"sequence_parallel: the sequence ({x.shape[1]}) is "
                    f"not divisible by the model-parallel degree "
                    f"{self.mp_world}")
            return GatherOp(self._stack(ScatterOp(x, 1), rope), 1)
        return self._stack(x, rope)

    def _stack(self, x, rope):
        cfg = self.config
        remat = cfg.use_recompute and self.training
        if cfg.scan_layers and can_scan(self.layers):
            if cfg.recompute_granularity != "full" and remat:
                warnings.warn(
                    "recompute_granularity is ignored under "
                    "scan_layers=True (the scan body remats whole "
                    "layers); set scan_layers=False for selective remat",
                    stacklevel=2)
            return self.norm(scan_layers(
                self.layers, x, (rope,), remat=remat,
                full_save_interval=cfg.full_save_interval))
        # as in the JAX package, sequence and context parallelism take
        # neither selective recompute nor the fused carry
        plain = self.sequence_parallel or cfg.sep_parallel is not None
        selective = cfg.recompute_granularity in ("core_attn", "full_attn") \
            and not plain

        def how(i):
            return recompute_mode(cfg, i, remat, selective)

        if flags.flag("FLAGS_fused_rmsnorm_residual") and not plain:
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


def recompute_mode(cfg, i, remat, selective):
    """How the unrolled stack runs decoder layer ``i``: ``"plain"`` (not
    recomputed: no ``remat``, or every ``full_save_interval``-th layer),
    ``"core_attn"`` (``selective``, every ``core_attn_interval``-th layer)
    or ``"full"``."""
    fs = max(int(cfg.full_save_interval), 0)
    if not remat or (fs and i % fs == fs - 1):
        return "plain"
    interval = max(int(cfg.core_attn_interval), 1)
    return "core_attn" if selective and i % interval == 0 else "full"


class _NoMetaInit(TorchFunctionMode):
    """Building on the meta device and materialising, without torch's
    Python meta decompositions: the modules' default initialisers do
    nothing to meta tensors (they hold no values), and ``empty_like`` of
    one (``to_empty``, the RoPE buffers) is a plain ``empty``. The
    decompositions' first call imports ``torch._dynamo`` and sympy:
    seconds in every fresh process that builds a model (a serving
    worker, a relaunched trainer)."""

    _INITS = frozenset(("normal_", "uniform_", "kaiming_uniform_"))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        t = args[0] if args else kwargs.get("tensor", kwargs.get("input"))
        if isinstance(t, torch.Tensor) and t.is_meta:
            if getattr(func, "__name__", "") in self._INITS:
                return t
            if func is torch.empty_like:
                return torch.empty(
                    t.shape, dtype=kwargs.get("dtype") or t.dtype,
                    device=kwargs.get("device") or t.device,
                    requires_grad=kwargs.get("requires_grad", False))
        return func(*args, **kwargs)


@torch.no_grad()
def init_llama_weights(module, gen, std):
    """Every weight under ``module`` from ``gen``, in ``modules()`` order:
    N(0, std) for projections and embeddings (a split layer's full
    tensor, then its shard), ones for norms."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            tp_normal_(mod, std, gen)
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)


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
        check_parallel(config)
        self.config = config
        # built on the meta device, then materialised once: no throwaway
        # default initialisation of billions of weights
        with _NoMetaInit():
            self.llama = LlamaModel(config, device="meta", dtype=dtype)
            self.lm_head = None if config.tie_word_embeddings else _lin(
                config, config.hidden_size, config.vocab_size, column=True,
                gather_output=True, device="meta", dtype=dtype)
            self.to_empty(device=device)
        self.mp_group, self.mp_world = self.llama.mp_group, \
            self.llama.mp_world
        self.reset_parameters(seed)
        if self.llama.sequence_parallel:
            # the norms see this rank's rows of the sequence only
            from ..distributed.fleet.utils.sequence_parallel_utils import (
                mark_as_sequence_parallel_parameter,
                register_sequence_parallel_allreduce_hooks)
            for mod in self.llama.modules():
                if isinstance(mod, RMSNorm):
                    mark_as_sequence_parallel_parameter(mod.weight)
            register_sequence_parallel_allreduce_hooks(self)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        dev = self.llama.embed_tokens.weight.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        init_llama_weights(self, gen, self.config.initializer_range)
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
            return tied_logits(hidden, self.llama.embed_tokens, self.mp_group)
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
            _no_split_cache_step(self)
            with torch.no_grad():
                hidden, caches = self.llama(input_ids, caches, pos, tables,
                                            skip_layers)
                return self._logits(hidden), caches
        hidden = self.llama(input_ids, skip_layers=skip_layers)
        if (labels is not None and self.lm_head is not None
                and flags.flag("FLAGS_fused_linear_cross_entropy")):
            return None, self._fused_loss(hidden, labels)
        logits = self._logits(hidden)
        if labels is None:
            return logits
        return logits, sep_loss(self.config, logits, labels)

    def _fused_loss(self, hidden, labels):
        """The fused linear+CE of the shifted rows; under a sep group this
        rank's summed loss goes through ``sep_mean``, the rule of
        ``sep_shifted_cross_entropy``."""
        hs = self.config.hidden_size
        group = sep_of(self.config)
        if group is None:
            return fused_head_loss(hidden[:, :-1].reshape(-1, hs),
                                   self.lm_head, labels[:, 1:].reshape(-1))
        from ..distributed.fleet.meta_parallel.context_parallel import (
            sep_mean, sep_shifted_targets)
        targets, keep_last = sep_shifted_targets(labels, group)
        h = hidden if keep_last else hidden[:, :-1]
        mean = fused_head_loss(h.reshape(-1, hs), self.lm_head,
                               targets.reshape(-1))
        return sep_mean(mean * (targets != -100).sum(), targets, group)


def fused_head_loss(h, head, labels):
    """The fused linear+CE of ``h [N, D]`` through ``head``'s weight:
    vocab-parallel over a split ``ColumnParallelLinear``'s group."""
    if isinstance(head, ColumnParallelLinear) and head.mp_world > 1:
        return fused_linear_cross_entropy(
            h, head.weight.t(), labels, group=head.group,
            vocab_start=head.mp_rank * head.out_features)
    return fused_linear_cross_entropy(h, head.weight.t(), labels)


def tied_logits(hidden, embed, group):
    """Logits through a tied embedding table; a vocab-split table's
    partial logits are gathered on the vocab."""
    if getattr(embed, "mp_world", 1) > 1:
        return gather_dim(F.linear(c_identity(hidden, group), embed.weight),
                          -1, group)
    return F.linear(hidden, embed.weight)


def _shifted_cross_entropy(logits, labels):
    vocab = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                           labels[:, 1:].reshape(-1))


class LlamaPretrainingCriterion(nn.Module):
    """Shifted next-token cross entropy: ``criterion(model(ids), ids)``
    equals the loss of ``model(ids, labels=ids)`` (under a sep group, with
    the config's ``sep_parallel``, over the whole sequence from each
    rank's chunk).

    ``fuses_with_network_loss`` certifies that contract to
    ``hapi.Model``, whose compiled fit then passes the labels into the
    network and takes its fused linear+CE loss instead of materialising
    the logits."""

    fuses_with_network_loss = True

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.vocab_size = config.vocab_size
        self.config = config

    def forward(self, logits, labels):
        return sep_loss(self.config, logits, labels)


# ---- the pipeline (fleet.meta_parallel.PipelineLayer) ------------------------
# The JAX package's LlamaForCausalLMPipe: the embedding, the decoder layers
# and the norm with the head, one layer description each, so a stage rank
# holds only its own.


@functools.lru_cache(maxsize=8)
def _rope_tables(max_pos, head_dim, theta, device):
    """The RoPE (sin, cos) tables ``LlamaModel`` keeps as buffers, once a
    device (``device`` as a string)."""
    return build_sin_cos(max_pos, head_dim, theta, device=device)


def pipe_rope(cfg, x):
    """(sin, cos) [1, S, D/2] for the activation ``x`` [B, S, H]:
    ``LlamaModel``'s tables, sliced as it slices them (at the rank's
    global positions under a sep group)."""
    sin, cos = _rope_tables(cfg.max_position_embeddings, cfg.head_dim,
                            cfg.rope_theta, str(x.device))
    return sep_rope_of(cfg, sin, cos, x.shape[1], x.device)


class LlamaEmbeddingPipe(nn.Module):
    """The pipeline's prologue: the token embedding (vocab-parallel under
    a model group)."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.embed_tokens = tp_embedding(
            cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype,
            enabled=cfg.tensor_parallel)

    def forward(self, input_ids):
        return self.embed_tokens(input_ids)


class LlamaDecoderLayerPipe(LlamaDecoderLayer):
    """Decoder layer ``layer_idx`` of the pipeline over one tensor, or the
    ``(hidden, residual)`` pair of the fused carry, which it hands on
    (stage to stage too): the unpartitioned stack's layer ``layer_idx``,
    fused or not and recomputed or not as ``LlamaModel`` runs it (so it
    recomputes itself, ``handles_recompute``)."""

    handles_recompute = True

    def __init__(self, cfg: LlamaConfig, layer_idx, device=None, dtype=None):
        super().__init__(cfg, device, dtype)
        self.cfg = cfg
        self.layer_idx = layer_idx

    def _unfused(self, x, rope):
        return LlamaDecoderLayer.forward(self, x, rope)

    def forward(self, x):
        cfg = self.cfg
        hidden, residual = x if isinstance(x, tuple) else (x, None)
        rope = pipe_rope(cfg, hidden)
        # the scanned stack takes the unfused layer and whole-layer remat,
        # and so does context parallelism
        plain = cfg.scan_layers or cfg.sep_parallel is not None
        selective = cfg.recompute_granularity in ("core_attn", "full_attn") \
            and not plain
        mode = recompute_mode(cfg, self.layer_idx,
                              cfg.use_recompute and self.training, selective)
        if flags.flag("FLAGS_fused_rmsnorm_residual") and not plain:
            if mode == "plain":
                return self.forward_fused(hidden, residual, rope)
            if mode == "core_attn":
                return self.forward_fused_core_attn_remat(hidden, residual,
                                                          rope)
            return recompute(self.forward_fused, hidden, residual, rope,
                             n_outputs=2)
        if residual is not None:
            hidden = hidden + residual
        if mode == "plain":
            return self._unfused(hidden, rope)
        if mode == "core_attn":
            return self.forward_core_attn_remat(hidden, rope)
        return recompute(self._unfused, hidden, rope)


class LlamaHeadPipe(nn.Module):
    """The pipeline's epilogue: the final RMSNorm (fused with the carry's
    last add) and the LM head (column-parallel, gathered, under a model
    group) -> logits."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                            device=device, dtype=dtype)
        self.lm_head = _lin(cfg, cfg.hidden_size, cfg.vocab_size,
                            column=True, gather_output=True, device=device,
                            dtype=dtype)

    def forward(self, x):
        if isinstance(x, tuple):
            h = F.fused_rms_norm_residual(x[0], x[1], self.norm.weight,
                                          self.norm.epsilon)[0]
        else:
            h = self.norm(x)
        return self.lm_head(h)


def pipe_key(n_layers, prefix, key):
    """The ``PipelineLayer`` key of an unpartitioned causal LM's state-dict
    ``key`` (its stack under ``prefix``; the head ``lm_head``): the
    embedding is layer 0, decoder layer ``i`` layer ``i + 1``, the norm
    and the head layer ``n_layers + 1``. Other keys pass unchanged."""
    if not key.startswith(prefix) and not key.startswith("lm_head."):
        return key
    rest = key[len(prefix):] if key.startswith(prefix) else key
    m = re.fullmatch(r"layers\.(\d+)\.(.+)", rest)
    if m:
        return f"run_function.{int(m.group(1)) + 1}.{m.group(2)}"
    if rest.startswith("embed_tokens."):
        return "run_function.0." + rest
    if rest.startswith(("norm.", "lm_head.")):
        return f"run_function.{n_layers + 1}.{rest}"
    return key


def check_pipe(config):
    """What the pipelined models do not take: a tied head and sequence
    parallelism (ROADMAP A.7); context parallelism is taken."""
    check_parallel(config)
    if getattr(config, "tie_word_embeddings", False):
        raise NotImplementedError(
            "tie_word_embeddings in a *Pipe model is not ported: its head "
            "is a layer of its own, as in the JAX package; tie it through "
            "a SharedLayerDesc")
    if getattr(config, "sequence_parallel", False):
        raise NotImplementedError(
            "sequence_parallel under the pipeline is not ported (ROADMAP "
            "A.7, 'Also waiting'); build the *Pipe model without it")


def LlamaForCausalLMPipe(config: LlamaConfig, device=None,
                         dtype=torch.float32, seed=0, **pipeline_kwargs):
    """The pipelined Llama as a ``PipelineLayer``: the embedding, the
    decoder layers and the norm with the head, each stage rank building
    only its own, on ``device`` (``cuda`` unless given) in ``dtype``. The
    weights come from ``seed`` as ``LlamaForCausalLM(config, seed=seed)``
    draws them (``PipelineLayer.reset_parameters`` walks the layers a rank
    lacks through scratch buffers). ``loss_fn`` defaults to
    ``LlamaPretrainingCriterion``, ``recompute_interval`` to 1 under
    ``use_recompute`` (the decoder layers recompute as the unpartitioned
    stack does) and ``seg_method`` to ``layer:LlamaDecoderLayer`` (stages
    cut at decoder layers, as PaddleNLP's pipe model cuts them). The
    layer's ``key_map`` maps ``LlamaForCausalLM``'s state-dict keys to
    its own."""
    from ..distributed.fleet.meta_parallel import LayerDesc, PipelineLayer
    check_pipe(config)
    n = config.num_hidden_layers
    descs = [LayerDesc(LlamaEmbeddingPipe, config)] + \
        [LayerDesc(LlamaDecoderLayerPipe, config, i) for i in range(n)] + \
        [LayerDesc(LlamaHeadPipe, config)]
    pipeline_kwargs.setdefault("loss_fn", LlamaPretrainingCriterion(config))
    pipeline_kwargs.setdefault(
        "recompute_interval", 1 if config.use_recompute else 0)
    pipeline_kwargs.setdefault("seg_method", "layer:LlamaDecoderLayer")
    pipe = PipelineLayer(descs, device=device, dtype=dtype,
                         **pipeline_kwargs)
    pipe.key_map = functools.partial(pipe_key, n, "llama.")
    pipe.reset_parameters(seed, functools.partial(
        init_llama_weights, std=config.initializer_range))
    return pipe
