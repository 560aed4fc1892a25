"""GPT-2 for training, for ``generate`` over a dense KV cache and for
serving over paged KV pools.

Port of ``paddle_tpu/models/gpt2.py``: ``GPT2Config`` (``small``,
``tiny``, ``weight_quant``), ``GPT2Attention`` (the fused ``c_attn``,
split as [b, s, 3, H, D]), ``GPT2MLP`` (tanh GELU), the pre-norm
``GPT2Block``, ``GPT2Model`` (learned position embeddings, offset by
``pos`` when caching) and ``GPT2ForCausalLM`` (the head tied to ``wte``:
``hidden @ wte.weight.T``).

Training (no caches): LayerNorm in plain PyTorch (the JAX package has no
kernel for it), attention through ``nn.functional.
scaled_dot_product_attention``: flash attention (K7-K9) at dropout 0,
the plain path with live attention dropout, as the JAX package routes.
Dropout draws from the model's ``torch.Generator`` (``dropout_seed``),
so its masks differ from the JAX package's by design. The stack is
unrolled (the JAX package's ``scan_layers`` gives the same numbers).

Caches without ``tables``: ``generate``'s dense [B, max_len, H, D]
caches through ``nn.functional.sdpa_with_cache``. With ``tables``: the
engine's paged pools through ``models.llama._paged_attention_step``
without RoPE and with ``c_proj`` as the output projection (K12, K13 over
int8/fp8 pools). Positions past the table (chunk padding near
``max_position_embeddings``) are clamped onto its last row: their tokens
are padding, and an index past the end would fault on the device.

The state-dict keys are the JAX package's (``gpt2.wte.weight``,
``gpt2.h.0.attn.c_attn.weight``, ...); the tied head adds none.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..generation import GenerationMixin
from ..nn import Dropout, LayerNorm, Linear
from ..nn import functional as F
from .llama import (_paged_attention_step, check_weight_quant,
                    kv_cache_dtype)

__all__ = ["GPT2Config", "GPT2Model", "GPT2ForCausalLM"]


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    # weight-only serving quantization: see LlamaConfig
    weight_quant: str | None = None

    def __post_init__(self):
        check_weight_quant(self.weight_quant)

    @classmethod
    def small(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=128, hidden_dropout_prob=0.0,
                   attention_dropout_prob=0.0)


def split_heads(qkv, heads):
    """A fused projection [B, S, 3 * H * D] -> contiguous q, k, v [B, S,
    H, D] (the kernels take contiguous tensors)."""
    b, s, _ = qkv.shape
    return tuple(t.contiguous()
                 for t in qkv.view(b, s, 3, heads, -1).unbind(2))


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        kw = dict(device=device, dtype=dtype)
        self.c_attn = Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.c_proj = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.attn_dropout = cfg.attention_dropout_prob
        self.generator = generator

    def forward(self, x, cache=None, pos=None, tables=None):
        b, s, e = x.shape
        q, k, v = split_heads(self.c_attn(x), self.num_heads)
        if cache is not None and tables is not None:
            return _paged_attention_step(self, q, k, v, cache, pos, tables,
                                         None, proj=self.c_proj)
        if cache is not None:
            ctx, _, _ = F.sdpa_with_cache(q, k, v, cache[0], cache[1], pos)
            return self.c_proj(ctx.reshape(b, s, e))
        ctx = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.attn_dropout,
            training=self.training, generator=self.generator)
        return self.c_proj(ctx.reshape(b, s, e))


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.c_fc = Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.c_proj = Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate=True))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        eps = cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(cfg.hidden_size, eps, **kw)
        self.attn = GPT2Attention(cfg, device, dtype, generator)
        self.ln_2 = LayerNorm(cfg.hidden_size, eps, **kw)
        self.mlp = GPT2MLP(cfg, device, dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob, generator)

    def forward(self, x, cache=None, pos=None, tables=None):
        if cache is not None:
            x = x + self.attn(self.ln_1(x), cache, pos, tables)
            return x + self.mlp(self.ln_2(x))
        x = x + self.dropout(self.attn(self.ln_1(x)))
        return x + self.dropout(self.mlp(self.ln_2(x)))


class GPT2Model(nn.Module):
    def __init__(self, config: GPT2Config, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size, **kw)
        self.drop = Dropout(config.hidden_dropout_prob, generator)
        self.h = nn.ModuleList([GPT2Block(config, device, dtype, generator)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              **kw)

    def forward(self, input_ids, caches=None, pos=None, tables=None):
        """input_ids [B, S]. Without caches: the final hidden states of the
        training path. With them, ``(hidden, caches)`` of a cache step,
        the caches written in place: with ``tables`` the paged pools
        ([k0, v0, ...], or [k0, v0, ks0, vs0, ...] quantized; ``pos`` [B]
        or [B, 1] cache lengths, tables ``(block_tables, valid)``),
        without them ``generate``'s dense caches at the batch's one offset
        ``pos`` (an int or a 0-d tensor)."""
        b, s = input_ids.shape
        dev = input_ids.device
        positions = torch.arange(s, device=dev)
        if caches is None:
            x = self.drop(self.wte(input_ids) + self.wpe(positions))
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        if tables is None:
            ctx = pos
            start = pos.reshape(1, 1).long() \
                if isinstance(pos, torch.Tensor) else int(pos)
        else:
            ctx = pos.reshape(b).to(torch.int32)
            tbl, gate = tables
            tables = (tbl.to(torch.int32), gate.to(torch.int32))
            start = ctx.long()[:, None]
        positions = (positions + start).clamp_(
            max=self.config.max_position_embeddings - 1)
        x = self.wte(input_ids) + self.wpe(positions)
        stride = len(caches) // len(self.h)
        for i, block in enumerate(self.h):
            x = block(x, caches[stride * i:stride * (i + 1)], ctx, tables)
        return self.ln_f(x), caches


class GPT2ForCausalLM(nn.Module, GenerationMixin):
    """GPT-2 with the head tied to ``wte``. Built on ``device`` (``cuda``
    unless given; raises with no GPU and no device) in ``dtype``, with
    weights drawn from a ``torch.Generator`` seeded by ``seed`` as the
    JAX package draws them: N(0, initializer_range) for the projections
    and embeddings, zeros for biases, ones and zeros for the LayerNorms.
    Dropout draws from a generator on the same device seeded by
    ``dropout_seed``."""

    def __init__(self, config: GPT2Config, device=None, dtype=torch.float32,
                 seed=0, dropout_seed=0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.dropout_generator = torch.Generator(device=device).manual_seed(
            int(dropout_seed))
        # built on the meta device, then materialised once
        self.gpt2 = GPT2Model(config, "meta", dtype, self.dropout_generator)
        self.to_empty(device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        gen = torch.Generator(device=self.gpt2.wte.weight.device)
        gen.manual_seed(int(seed))
        reset_dense_parameters(self, gen, self.config.initializer_range)

    def init_kv_cache(self, batch_size, max_length, dtype=None):
        """Zero dense caches for ``generate``: per layer (k, v) of [B,
        max_len, H, D], on the weights' device, in ``dtype`` or the first
        floating parameter's."""
        cfg = self.config
        shape = (batch_size, max_length, cfg.num_attention_heads,
                 cfg.hidden_size // cfg.num_attention_heads)
        dtype = dtype or kv_cache_dtype(self)
        return [torch.zeros(shape, dtype=dtype,
                            device=self.gpt2.wte.weight.device)
                for _ in range(2 * cfg.num_hidden_layers)]

    def forward(self, input_ids, labels=None, caches=None, pos=None,
                tables=None):
        """The JAX package's signature. With ``caches``: a cache step
        (:meth:`GPT2Model.forward`), ``(logits [B, S, V], caches)`` with
        the caches written in place (no autograd). Without: ``logits``
        or, given ``labels``, ``(logits, loss)`` with the loss over
        ``logits[:, :-1]`` against ``labels[:, 1:]``."""
        if caches is not None:
            with torch.no_grad():
                hidden, caches = self.gpt2(input_ids, caches, pos, tables)
                return F.linear(hidden, self.gpt2.wte.weight), caches
        logits = F.linear(self.gpt2(input_ids), self.gpt2.wte.weight)
        if labels is None:
            return logits
        vocab = self.config.vocab_size
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                               labels[:, 1:].reshape(-1))
        return logits, loss


@torch.no_grad()
def reset_dense_parameters(model, gen, std):
    """The JAX package's initialisers for a model of Linear, Embedding and
    LayerNorm layers: N(0, std) weights from ``gen``, zero biases, unit
    LayerNorm scales."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.weight.normal_(0.0, std, generator=gen)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
